"""Parallelism of the port (counterpart of timeviper_tpu/parallel/): the
mesh, its collectives and the sharding rules (sharding.py), tensor and FSDP
parallelism of the modules (tensor_parallel.py), and the sequence-parallel
prefill and encode (seq_parallel.py). The pipeline runner
(`PipelineRunner`) waits for the next parallelism slice (ROADMAP Queue 1
item 4).

The names below load their module on first use: the model modules import
tensor_parallel.py, and seq_parallel.py imports them."""

_LAZY = {"make_mesh": "sharding", "shard_model": "tensor_parallel",
         "nano_prefill_seq_parallel": "seq_parallel",
         "encode_frames_seq_parallel": "seq_parallel"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(name)
