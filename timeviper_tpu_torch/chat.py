"""Interactive chat CLI (counterpart of timeviper_tpu/chat.py).

    python -m timeviper_tpu_torch.chat --checkpoint ckpts/timeviper-9b \
        [--video path.mp4] [--fps 1.0 --max_frames 256] [--int8] [--device cuda]

Loads the checkpoint onto the card (or `--device`), optionally samples frames
from a video, and runs a REPL over `TimeViperModel.chat`.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="TimeViper chat (PyTorch + CUDA)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--video", default=None)
    p.add_argument("--fps", type=float, default=1.0)
    p.add_argument("--min_frames", type=int, default=8)
    p.add_argument("--max_frames", type=int, default=256)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default: the CUDA card)")
    args = p.parse_args(argv)

    from timeviper_tpu_torch.models.api import load_pretrained_vlm
    from timeviper_tpu_torch.ops.sampling import SamplingParams

    model = load_pretrained_vlm(
        args.checkpoint,
        max_new_tokens=args.max_new_tokens,
        sampling=SamplingParams(temperature=args.temperature),
        quantize_int8=args.int8,
        device=args.device,
    )

    frames = None
    if args.video:
        from timeviper_tpu_torch.data.video import load_video

        frames, _, meta = load_video(
            args.video, sampling="fps", fps=args.fps,
            min_frames=args.min_frames, max_frames=args.max_frames,
        )
        print(f"[loaded {frames.shape[0]} frames from {args.video} "
              f"({meta.duration:.0f}s)]")

    print("TimeViper chat — empty line or Ctrl-D to exit")
    seed = 0
    while True:
        try:
            text = input("you> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not text:
            break
        reply = model.chat(text, frames=frames, rng_seed=seed)
        seed += 1
        print(f"model> {reply}")


if __name__ == "__main__":
    main()
