"""Host-side video IO + frame sampling.

Replaces the decord-based loaders (reference: timeviper/data/data.py:343-416,
eval/utils/vision_process.py:84-233, eval/vllm_inference/utils.py:13-66).
Video decode is input-pipeline work and stays on the CPU host (SURVEY.md §2.2
N8); the device sees ready frame arrays, streamed in via `jax.device_put`
double-buffering (data/loader.py).

Backends are probed in order native (our C++ libav decoder,
native/videodec.cpp — the decord replacement) → decord → PyAV → OpenCV and
gated gracefully.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Frame index sampling (reference vision_process.py:84-133)
# ---------------------------------------------------------------------------


def uniform_indices(num_frames: int, total_frames: int) -> np.ndarray:
    """`num_frames` evenly spaced indices over [0, total_frames).

    Exact reference semantics (vision_process.py:84-100): an INTEGER
    linspace over [0, total] (each point truncated), then integer
    floor-div midpoints — NOT float midpoints truncated at the end.
    """
    if num_frames < total_frames:
        splits = np.linspace(0, total_frames, num_frames + 1).astype(np.int64)
        return (splits[:-1] + splits[1:]) // 2
    return np.arange(total_frames, dtype=np.int64)


def fps_indices(
    video_fps: float,
    total_frames: int,
    fps: Optional[float] = 1.0,
    min_frames: int = 1,
    max_frames: int = -1,
) -> np.ndarray:
    """Frame indices at `fps` output rate — exact reference semantics
    (vision_process.py:103-134):

    * stride `video_fps / fps` from frame 0, rounded (half-to-even, like
      torch.round), filtered to < total_frames;
    * truncated to the FIRST `max_frames` (not re-spread uniformly);
    * padded to a multiple of 4 by repeating the last index (the IV2 clip
      size — the model always sees whole 4-frame clips);
    * if still under `min_frames`, replaced wholesale by
      `uniform_indices(min_frames, total_frames)`.
    """
    delta = 1.0 if fps is None else video_fps / fps
    idx = np.round(np.arange(0, total_frames, delta)).astype(np.int64)
    idx = idx[idx < total_frames]
    if 0 < max_frames < len(idx):
        idx = idx[:max_frames]
    if len(idx) % 4 != 0 and len(idx) > 0:
        idx = np.concatenate(
            [idx, np.full((4 - len(idx) % 4,), idx[-1], np.int64)])
    if len(idx) < min_frames:
        idx = uniform_indices(min_frames, total_frames)
    return idx


def round_by_factor(n, factor: int) -> int:
    return round(n / factor) * factor


def ceil_by_factor(n, factor: int) -> int:
    return math.ceil(n / factor) * factor


def floor_by_factor(n, factor: int) -> int:
    return math.floor(n / factor) * factor


# reference vision_process.py:38-41
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768


def smart_nframes(
    total_frames: int,
    video_fps: float,
    fps: Optional[float] = None,
    nframes: Optional[int] = None,
    min_frames: int = FPS_MIN_FRAMES,
    max_frames: Optional[int] = None,
    frame_factor: int = FRAME_FACTOR,
) -> int:
    """Qwen2-VL-style frame-count pick — exact reference semantics
    (vision_process.py:386-431): either a fixed `nframes` rounded to the
    frame factor, or duration·fps clamped to
    [ceil_by_factor(min), floor_by_factor(min(max, total))] then floored
    to the factor."""
    assert not (fps is not None and nframes is not None), (
        "Only accept either `fps` or `nframes`")
    if nframes is not None:
        n = round_by_factor(nframes, frame_factor)
    else:
        fps = FPS if fps is None else fps
        lo = ceil_by_factor(min_frames, frame_factor)
        hi = floor_by_factor(
            min(FPS_MAX_FRAMES, total_frames) if max_frames is None
            else max_frames,
            frame_factor,
        )
        n = total_frames / video_fps * fps
        n = min(min(max(n, lo), hi), total_frames)
        n = floor_by_factor(n, frame_factor)
    if not (frame_factor <= n <= total_frames):
        raise ValueError(
            f"nframes should be in [{frame_factor}, {total_frames}], got {n}")
    return n


def timestamp_indices(
    total_frames: int,
    video_fps: float,
    video_start: float = 0.0,
    video_end: Optional[float] = None,
    **smart_kwargs,
) -> Tuple[np.ndarray, float]:
    """Clip-window sampling — the decord timestamp monkey-patch semantics
    (eval/vllm_inference/utils.py:13-57): clamp [video_start, video_end]
    to frame numbers, pick `smart_nframes` over the effective span, and
    linspace (rounded) inside [start_frame, end_frame - 1].

    Returns (indices, sample_fps)."""
    if video_end is None:
        video_end = total_frames / video_fps
    start_frame = max(0, int(video_start * video_fps))
    end_frame = min(total_frames, int(video_end * video_fps))
    if end_frame <= start_frame:
        end_frame = start_frame + 1
        if end_frame > total_frames:
            end_frame = total_frames
            start_frame = max(0, end_frame - 1)
    effective = end_frame - start_frame
    n = smart_nframes(effective, video_fps, **smart_kwargs)
    if effective == 0:
        idx = np.asarray([start_frame], np.int64)
    else:
        idx = np.round(
            np.linspace(start_frame, end_frame - 1, n)).astype(np.int64)
    sample_fps = n / max(effective, 1e-6) * video_fps
    return idx, sample_fps


# ---------------------------------------------------------------------------
# Decode backends
# ---------------------------------------------------------------------------


@dataclass
class VideoMeta:
    total_frames: int
    fps: float
    duration: float


def _load_native(path: str, indices: np.ndarray) -> Tuple[np.ndarray, VideoMeta]:
    from timeviper_tpu_torch.data import native_video as nv

    w, h, fps, total, duration = nv.probe(path)
    frames = nv.read_frames(path, indices)
    return frames, VideoMeta(total, fps, duration)


def load_subtitle(
    srt_path: str,
    timestamps: Optional[Sequence[float]] = None,
    max_chars: int = 0,
) -> str:
    """Parse an .srt subtitle file into one text block, optionally keeping
    only cues overlapping the sampled-frame timestamps (reference
    eval/utils/vision_process.py:52-83 subtitle loading for cgbench)."""
    import re

    def to_sec(t: str) -> float:
        h, m, rest = t.split(":")
        s, ms = rest.split(",")
        return int(h) * 3600 + int(m) * 60 + int(s) + int(ms) / 1000.0

    cues = []
    with open(srt_path, encoding="utf-8", errors="ignore") as f:
        blocks = re.split(r"\n\s*\n", f.read())
    for block in blocks:
        lines = [ln.strip() for ln in block.strip().splitlines() if ln.strip()]
        if len(lines) < 2 or "-->" not in lines[1 if lines[0].isdigit() else 0]:
            continue
        ts_line = lines[1] if lines[0].isdigit() else lines[0]
        text_lines = lines[2:] if lines[0].isdigit() else lines[1:]
        try:
            start_s, end_s = [to_sec(t.strip()) for t in ts_line.split("-->")]
        except Exception:
            continue
        cues.append((start_s, end_s, " ".join(text_lines)))
    if timestamps is not None:
        ts = list(timestamps)
        cues = [
            (s, e, txt) for s, e, txt in cues
            if any(s <= t <= e for t in ts)
        ]
    text = " ".join(txt for _, _, txt in cues)
    if max_chars and len(text) > max_chars:
        text = text[:max_chars]
    return text


def probe_backend() -> Optional[str]:
    # native libav decoder first (the decord replacement; always available
    # when g++ + ffmpeg libs exist), then python backends
    from timeviper_tpu_torch.data.native_video import native_video_available

    if native_video_available():
        return "native"
    for name, mod in (("decord", "decord"), ("pyav", "av"), ("opencv", "cv2")):
        try:
            __import__(mod)
            return name
        except ImportError:
            continue
    return None


def _load_decord(path: str, indices: np.ndarray) -> Tuple[np.ndarray, VideoMeta]:
    import decord

    vr = decord.VideoReader(path, num_threads=2)
    meta = VideoMeta(len(vr), float(vr.get_avg_fps()),
                     len(vr) / max(float(vr.get_avg_fps()), 1e-6))
    frames = vr.get_batch(list(indices)).asnumpy()
    return frames, meta


def _load_pyav(path: str, indices: np.ndarray) -> Tuple[np.ndarray, VideoMeta]:
    import av

    with av.open(path) as container:
        stream = container.streams.video[0]
        total = stream.frames or 0
        fps = float(stream.average_rate or 30.0)
        want = set(int(i) for i in indices)
        frames = {}
        for i, frame in enumerate(container.decode(stream)):
            if total == 0:
                pass
            if i in want:
                frames[i] = frame.to_ndarray(format="rgb24")
            if len(frames) == len(want):
                break
        total = total or (max(frames) + 1 if frames else 0)
        out = np.stack([frames[int(i)] for i in indices if int(i) in frames])
    return out, VideoMeta(total, fps, total / max(fps, 1e-6))


def _load_opencv(path: str, indices: np.ndarray) -> Tuple[np.ndarray, VideoMeta]:
    import cv2

    cap = cv2.VideoCapture(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    for i in indices:
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])  # BGR -> RGB
    cap.release()
    return np.stack(frames), VideoMeta(total, fps, total / max(fps, 1e-6))


def video_meta(path: str) -> VideoMeta:
    backend = probe_backend()
    if backend == "native":
        from timeviper_tpu_torch.data import native_video as nv

        w, h, fps, total, duration = nv.probe(path)
        return VideoMeta(total, fps, duration)
    if backend == "decord":
        import decord

        vr = decord.VideoReader(path, num_threads=1)
        fps = float(vr.get_avg_fps())
        return VideoMeta(len(vr), fps, len(vr) / max(fps, 1e-6))
    if backend == "pyav":
        import av

        with av.open(path) as c:
            s = c.streams.video[0]
            fps = float(s.average_rate or 30.0)
            total = s.frames or int(
                (c.duration or 0) / 1e6 * fps
            )
            return VideoMeta(total, fps, total / max(fps, 1e-6))
    if backend == "opencv":
        import cv2

        cap = cv2.VideoCapture(path)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        cap.release()
        return VideoMeta(total, fps, total / max(fps, 1e-6))
    raise RuntimeError("No video decode backend (decord/pyav/opencv) available")


def load_video(
    path: str,
    *,
    sampling: str = "fps",
    fps: float = 1.0,
    num_frames: Optional[int] = None,
    min_frames: int = 4,
    max_frames: int = 256,
) -> Tuple[np.ndarray, np.ndarray, VideoMeta]:
    """Decode sampled frames.

    Returns (frames (F, H, W, 3) uint8, timestamps (F,) float seconds, meta).
    `sampling`: "fps" (reference eval default, 1 fps clamped 32-256,
    evaluate.py:100-110) or "uniform" (fixed `num_frames`).
    """
    meta = video_meta(path)
    if sampling == "uniform":
        assert num_frames is not None
        idx = uniform_indices(num_frames, meta.total_frames)
    else:
        idx = fps_indices(meta.fps, meta.total_frames, fps, min_frames, max_frames)
    backend = probe_backend()
    loader = {"native": _load_native, "decord": _load_decord,
              "pyav": _load_pyav, "opencv": _load_opencv}[backend]
    frames, meta = loader(path, idx)
    ts = idx.astype(np.float64) / max(meta.fps, 1e-6)
    return frames, ts, meta
