"""Parallelism of the port (counterpart of timeviper_tpu/parallel/): the
mesh and the `seq` axis's collectives (sharding.py) and the
sequence-parallel prefill and encode (seq_parallel.py). The tensor-parallel
and FSDP rules, the pipeline runner (`PipelineRunner`) and the training
half wait for the next parallelism slice (ROADMAP Queue 1 item 3)."""

from timeviper_tpu_torch.parallel.seq_parallel import (  # noqa: F401
    encode_frames_seq_parallel,
    nano_prefill_seq_parallel,
)
from timeviper_tpu_torch.parallel.sharding import make_mesh  # noqa: F401
