"""Multi-process start-up (counterpart of timeviper_tpu/utils/dist.py).

JAX needs one `jax.distributed.initialize()` per process; PyTorch needs one
process group per process, and the caller names its backend: "nccl" when
each rank has a card of its own, "gloo" on the CPU or when the caller puts
several ranks on one card. Nothing here switches backend after a failure.

`detect_process_env` reads where this process sits in the JAX package's
order: SLURM, then OMPI, then a single process. Between OMPI and the single
process it also reads torchrun's RANK / WORLD_SIZE / LOCAL_RANK /
MASTER_ADDR / MASTER_PORT, the launcher's own variables, which stand where
the TPU runtime's topology stands for JAX. Explicit arguments of
`initialize_distributed` override what it finds.
"""

from __future__ import annotations

import os
from typing import Optional

from timeviper_tpu_torch.utils.overwatch import initialize_overwatch

overwatch = initialize_overwatch("dist")


def detect_process_env() -> dict:
    """(process_id, num_processes, coordinator_address, local_rank, launcher)
    from the environment; the first three as the JAX package gives them for
    SLURM, OMPI and a single process."""
    env = os.environ
    if "SLURM_PROCID" in env:
        nodelist = env.get("SLURM_STEP_NODELIST", "")
        head = nodelist.split(",")[0].replace("[", "").split("-")[0] or None
        return {
            "process_id": int(env["SLURM_PROCID"]),
            "num_processes": int(env.get("SLURM_NTASKS", 1)),
            "coordinator_address": env.get("COORDINATOR_ADDRESS",
                                           f"{head}:8476" if head else None),
            "local_rank": int(env.get("SLURM_LOCALID", 0)),
            "launcher": "slurm",
        }
    if "OMPI_COMM_WORLD_RANK" in env:
        return {
            "process_id": int(env["OMPI_COMM_WORLD_RANK"]),
            "num_processes": int(env["OMPI_COMM_WORLD_SIZE"]),
            "coordinator_address": env.get("COORDINATOR_ADDRESS"),
            "local_rank": int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", 0)),
            "launcher": "ompi",
        }
    if "RANK" in env and "WORLD_SIZE" in env:
        addr = env.get("MASTER_ADDR")
        return {
            "process_id": int(env["RANK"]),
            "num_processes": int(env["WORLD_SIZE"]),
            "coordinator_address": (f"{addr}:{env.get('MASTER_PORT', '29500')}"
                                    if addr else None),
            "local_rank": int(env.get("LOCAL_RANK", 0)),
            "launcher": "torchrun",
        }
    return {"process_id": 0, "num_processes": 1, "coordinator_address": None, "local_rank": 0,
            "launcher": None}


def initialize_distributed(
    backend: str,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group over `backend` ("nccl" or "gloo") when the run
    has more than one process; a no-op on one (returns False). With "nccl"
    the process's current card becomes cuda:{local rank}. Under torchrun the
    group meets at torchrun's own store (env://), else at tcp://address."""
    import torch
    import torch.distributed as dist

    env = detect_process_env()
    num = num_processes if num_processes is not None else env["num_processes"]
    if num <= 1 and coordinator_address is None:
        overwatch.info("single-process run; no process group")
        return False
    if dist.is_initialized():
        return True
    addr = coordinator_address or env["coordinator_address"]
    if addr is None:
        raise RuntimeError("a multi-process run needs a coordinator address (host:port)")
    rank = process_id if process_id is not None else env["process_id"]
    if backend == "nccl":
        torch.cuda.set_device(env["local_rank"])
    torchrun = coordinator_address is None and env["launcher"] == "torchrun"
    dist.init_process_group(backend, init_method="env://" if torchrun else f"tcp://{addr}",
                            world_size=num, rank=rank)
    overwatch.info(f"process group ({backend}) initialized: rank {dist.get_rank()} / "
                   f"{dist.get_world_size()}")
    return True
