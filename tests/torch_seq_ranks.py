"""Two-rank runs of the port's sequence-parallel path on the CPU, for
tests/test_torch_dist.py, tests/test_torch_seq_parallel.py and
tests/test_torch_seq_parallel_generate.py.

Every rank is a spawned process that imports torch and the port and never
JAX (a process that imports JAX may load a TPU plugin where one is
installed). `spawn_ranks` or `running` starts the ranks over gloo with a
`make_mesh(data=1, seq=2)` mesh, the parent writes the inputs (numpy
arrays, the port's state dict) to a folder, and each rank function returns
a dict of tensors that the parent reads back per rank. Under `running` the
ranks start up while the parent makes their inputs, and run while it
computes its references.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(rank: int, world: int, port: int, fn, folder: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        from timeviper_tpu_torch.parallel.sharding import make_mesh

        mesh = make_mesh(data=1, seq=world)
        out = fn(rank, mesh, folder)
        torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    except Exception:
        with open(os.path.join(folder, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def start_ranks(fn, folder: str, world: int = 2):
    """Start fn(rank, mesh, folder) on `world` gloo ranks and return at once,
    so that the caller can compute its references while they run;
    `join_ranks` waits for them."""
    return mp.spawn(_run, args=(world, _free_port(), fn, folder), nprocs=world, join=False)


def join_ranks(ctx, folder: str, world: int = 2) -> list:
    """Wait for the ranks of `start_ranks`; returns each rank's result dict."""
    try:
        while not ctx.join():
            pass
    except Exception:
        errs = [open(os.path.join(folder, f)).read() for f in sorted(os.listdir(folder))
                if f.endswith(".err")]
        raise RuntimeError("\n".join(errs) or "a rank failed") from None
    return [torch.load(os.path.join(folder, f"rank{r}.pt")) for r in range(world)]


def spawn_ranks(fn, folder: str, world: int = 2) -> list:
    """Run fn(rank, mesh, folder) on `world` gloo ranks; returns each rank's
    result dict."""
    return join_ranks(start_ranks(fn, folder, world), folder, world)


@contextlib.contextmanager
def running(fn, folder: str, world: int = 2):
    """Start the ranks of fn, which wait for `save_inputs`; yields a list
    that holds each rank's result dict once the block has ended. If the
    block raises, the ranks are told to stop and the error goes on."""
    ctx = start_ranks(fn, folder, world)
    results: list = []
    try:
        yield results
    except BaseException:
        open(os.path.join(folder, "abort"), "w").close()
        with contextlib.suppress(Exception):
            join_ranks(ctx, folder, world)
        raise
    results.extend(join_ranks(ctx, folder, world))


def load_inputs(folder: str) -> dict:
    """The inputs of `save_inputs`, waiting until the parent has written them."""
    path = os.path.join(folder, "inputs.pt")
    while not os.path.exists(path):
        if os.path.exists(os.path.join(folder, "abort")):
            raise RuntimeError("the parent failed before it wrote the inputs")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def save_inputs(folder: str, **inputs) -> None:
    tmp = os.path.join(folder, "inputs.pt.tmp")
    torch.save(inputs, tmp)
    os.replace(tmp, os.path.join(folder, "inputs.pt"))  # the ranks never see half a file


def build_model(inp: dict):
    """The port's VLM of the inputs' arch and state dict, f32 on the CPU."""
    from timeviper_tpu_torch.models.vlm import TimeViperVLM

    model = TimeViperVLM(inp["arch"], torch.float32, device="cpu")
    model.load_state_dict(inp["state"])
    return model.eval()


# ---------------------------------------------------------------------------
# tests/test_torch_dist.py: the collectives
# ---------------------------------------------------------------------------


def collectives(rank: int, mesh, folder: str) -> dict:
    from timeviper_tpu_torch.parallel import sharding as sh

    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    xb = x.to(torch.bfloat16) / 3
    return {
        "index": sh.axis_index(mesh, "seq"), "size": sh.axis_size(mesh, "seq"),
        "data_size": sh.axis_size(mesh, "data"),
        "stacked": sh.all_gather(x, mesh, "seq"),
        "tiled": sh.all_gather(x, mesh, "seq", dim=1, tiled=True),
        "bf16": sh.all_gather(xb, mesh, "seq"),
        "shift": sh.ppermute(x, mesh, "seq", [(0, 1)]),
        "ring": sh.ppermute(xb, mesh, "seq", [(0, 1), (1, 0)]),
        "sum": sh.psum(x, mesh, "seq"), "sum_bf16": sh.psum(xb, mesh, "seq"),
        "ints": sh.all_gather(torch.tensor([rank + 5]), mesh, "seq"),
    }


# ---------------------------------------------------------------------------
# tests/test_torch_seq_parallel.py: the pieces, and the backbone's prefill
# ---------------------------------------------------------------------------


def pieces(rank: int, mesh, folder: str) -> dict:
    from timeviper_tpu_torch.parallel import seq_parallel as sp

    inp = load_inputs(folder)
    T = torch.from_numpy
    out = {}
    Lloc = inp["conv_x"].shape[1] // 2
    span = slice(rank * Lloc, (rank + 1) * Lloc)
    # the halo conv, a segment start on the seam
    w, b, seq = (T(inp[k]) for k in ("conv_w", "conv_b", "conv_seq"))
    out["halo_conv"] = sp._halo_conv(T(inp["conv_x"])[:, span], w, b, "silu", mesh,
                                     seq[:, span].contiguous())
    out["halo_conv_plain"] = sp._halo_conv(T(inp["conv_x"])[:, span], w, b, "silu", mesh)
    # the compacted conv over the kept rows
    keep = T(inp["conv_keep"])
    out["compact_conv"] = sp._compact_conv(T(inp["conv_x"])[:, span], w, b, "silu", mesh,
                                           keep[span])
    # ssd, with and without packed segments
    x, dt, A, B_, C, D, dtb = (T(inp[k]) for k in ("x", "dt", "A", "B", "C", "D", "dt_bias"))
    L2 = x.shape[1] // 2
    s2 = slice(rank * L2, (rank + 1) * L2)
    kw = dict(mesh=mesh, chunk_size=inp["chunk"], D=D, dt_bias=dtb, return_final_state=True)
    for name, sidx in (("ssd", None), ("ssd_seq", T(inp["ssd_seq"]))):
        y, st = sp.ssd_seq_sharded(x[:, s2], dt[:, s2], A, B_[:, s2], C[:, s2],
                                   seq_idx=None if sidx is None else sidx[:, s2].contiguous(), **kw)
        out[name], out[name + "_state"] = y, st
    mask = T(inp["ssd_mask"])
    y, st = sp.ssd_seq_sharded(x[:, s2], dt[:, s2], A, B_[:, s2], C[:, s2],
                               dt_mask=mask[:, s2], **kw)
    out["ssd_masked"], out["ssd_masked_state"] = y, st
    # attention: ring and gathered, with pads and a fully masked block
    q, k, v = (T(inp[n]) for n in ("q", "k", "v"))
    La = q.shape[1] // 2
    sa = slice(rank * La, (rank + 1) * La)
    for tag, valid in (("pad", T(inp["valid_pad"])), ("dead", T(inp["valid_dead"]))):
        out[f"ring_{tag}"] = sp.attention_seq_ring(q[:, sa], k[:, sa], v[:, sa], mesh=mesh,
                                                   valid_g=valid)
        out[f"gathered_{tag}"] = sp.attention_seq_sharded(q[:, sa], k[:, sa], v[:, sa],
                                                          mesh=mesh, kv_valid=valid)
    return out


def pieces_and_prefill(rank: int, mesh, folder: str) -> dict:
    """`pieces`, then `prefill`, on one spawn."""
    return {**pieces(rank, mesh, folder), **prefill(rank, mesh, folder)}


def prefill(rank: int, mesh, folder: str) -> dict:
    """nano_prefill_seq_parallel on each case of the inputs: logits-only
    (the ring), with fill_cache, with the fused conv, packed, pdrop. A case
    with `decode` then asks a question of its cache (the continuation) and
    runs decode steps on it."""
    from timeviper_tpu_torch.models.nano import nano_decode_step
    from timeviper_tpu_torch.models.prefix_cache import nano_forward_continue
    from timeviper_tpu_torch.parallel.seq_parallel import nano_prefill_seq_parallel
    from timeviper_tpu_torch.parallel.sharding import make_mesh

    inp = load_inputs(folder)
    model = build_model(inp)
    llm, cfg = model.llm_backbone, inp["arch"].llm
    out = {}
    for name, case in inp["cases"].items():
        kw = dict(case)
        emb = torch.from_numpy(kw.pop("embeds"))
        if "seq_idx" in kw:
            kw["seq_idx"] = torch.from_numpy(kw["seq_idx"])
        merge = model.merge_modules if kw.pop("merge", False) else None
        decode = kw.pop("decode", None)
        # the weights do not depend on the scan's chunk; K5's fusion takes
        # chunks of a multiple of 128 rows
        c = dataclasses.replace(cfg, chunk_size=kw.pop("chunk", cfg.chunk_size))
        m = make_mesh(data=2) if kw.pop("data_mesh", False) else mesh
        out[name] = nano_prefill_seq_parallel(llm, c, emb, m, merge_params=merge, **kw)
        if decode is None:
            continue
        logits, cache = out[name]
        with torch.no_grad():
            q, qcache = nano_forward_continue(
                llm, cfg, llm.embeddings(torch.tensor([decode["suffix"]])), cache,
                pdrop_params=merge)
            out[name + "_question"] = q
            out[name + "_question_kv_valid"] = qcache["kv_valid"]
            steps, tok = [], logits[:, -1].argmax(-1)[:, None]
            for _ in range(decode["steps"]):
                step_logits, cache = nano_decode_step(llm, cfg, tok, cache, pdrop_params=merge)
                steps.append(step_logits)
                tok = step_logits.argmax(-1)[:, None]
            out[name + "_steps"] = torch.stack(steps)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_seq_parallel_generate.py: the entry points
# ---------------------------------------------------------------------------


def generate(rank: int, mesh, folder: str) -> dict:
    """The frame-sharded encode, the Generator (plain, pdrop, a question on a
    pdrop prefix), the engine and the eval CLI, on a `seq` mesh."""
    from timeviper_tpu_torch.models.generate import Generator
    from timeviper_tpu_torch.parallel.seq_parallel import encode_frames_seq_parallel
    from timeviper_tpu_torch.serving import Request, ServingEngine

    inp = load_inputs(folder)
    model = build_model(inp)
    arch = inp["arch"]
    out = {"encode": encode_frames_seq_parallel(model, arch, inp["pixels"], mesh)}
    kw = inp["gen_kw"]
    gen = Generator(model, arch, mesh=mesh, **kw)
    ids, px, img = inp["ids"], inp["pixels"], inp["img"]
    res = gen.generate(ids, pixels=px, image_token_id=img)
    out["tokens"], out["first"] = torch.from_numpy(res.token_ids), res.first_logits
    res = gen.generate(ids, pixels=px, image_token_id=img, use_pdrop=True)
    out["pdrop_tokens"], out["pdrop_first"] = torch.from_numpy(res.token_ids), res.first_logits
    pre, question = inp["prefix_ids"], inp["question"]
    st = gen.prefill_prefix(pre, pixels=px, image_token_id=img, use_pdrop=True,
                            suffix_budget=16)
    out["prefix_kv_valid"] = st.cache["kv_valid"]
    res = gen.generate(question, prefix=st)
    out["prefix_tokens"], out["prefix_first"] = torch.from_numpy(res.token_ids), res.first_logits

    eng = ServingEngine(model, arch, mesh=mesh, cache_dtype=torch.float32,
                        **inp["engine_kw"])
    reqs = [Request(request_id=i, **r) for i, r in enumerate(inp["requests"])]
    out["engine"] = [list(r.output_ids) for r in eng.run(reqs)]
    _eval_cli(rank, inp["eval"])
    return out


def _fake_load_video(path, **kw):
    """tests/test_torch_api.py's stand-in decoder: 4 frames of 28 px from
    the seed in the file name."""
    from timeviper_tpu_torch.data.video import VideoMeta

    frames = np.random.default_rng(int(path[-5])).integers(0, 255, (4, 28, 28, 3),
                                                             dtype=np.uint8)
    return frames, np.arange(4) / 1.0, VideoMeta(4, 1.0, 4.0)


def _eval_cli(rank: int, ev_inp: dict) -> None:
    """eval/evaluate.py's main with --mesh_seq 2 on every rank, then on rank
    0 alone without a mesh, each into its own folder (the benchmark loader
    and the video decoder replaced as tests/test_torch_api.py replaces
    them)."""
    import timeviper_tpu_torch.data.video as video_mod
    import timeviper_tpu_torch.eval.evaluate as ev

    ev.load_benchmark = lambda name, root, split: list(ev_inp["records"])
    video_mod.load_video = _fake_load_video
    ev.main(ev_inp["argv"] + ["--mesh_seq", "2", "--output_dir", ev_inp["mesh_dir"]])
    if rank == 0:
        ev.main(ev_inp["argv"] + ["--output_dir", ev_inp["one_dir"]])

