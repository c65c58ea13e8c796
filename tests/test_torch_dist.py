"""The port's multi-process start-up and mesh (timeviper_tpu_torch/utils/dist.py,
timeviper_tpu_torch/parallel/sharding.py).

* `detect_process_env` gives the JAX package's process id, process count
  and coordinator on the same SLURM, OMPI and single-process environments,
  and reads torchrun's variables where JAX sees a single process.
* `initialize_distributed` is a no-op on one process; `make_mesh` refuses a
  missing process group (a model axis too) and a seq and a model axis
  together (the next parallelism slice); a
  rank's default device is cuda:{local rank} as `detect_process_env` reads
  it from SLURM, OMPI or torchrun (a card count stubbed), it raises when
  that card is missing, and without a card at all.
* The collectives on a 2-rank gloo mesh (tests/torch_seq_ranks.py): the
  axis index and size, all_gather stacked and tiled (bf16 and integers too),
  ppermute's shift (zeros where nothing arrives) and ring, psum (bf16 summed
  in f32): exact.
"""

import pytest
import torch
import torch_seq_ranks as ranks

from timeviper_tpu.utils import dist as jax_dist
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.parallel.sharding import make_mesh
from timeviper_tpu_torch.utils import dist

LAUNCH_VARS = ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_STEP_NODELIST", "SLURM_LOCALID",
               "COORDINATOR_ADDRESS", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
               "OMPI_COMM_WORLD_LOCAL_RANK", "RANK", "WORLD_SIZE", "LOCAL_RANK",
               "MASTER_ADDR", "MASTER_PORT")
ENVS = {
    "single": {},
    "slurm": dict(SLURM_PROCID="3", SLURM_NTASKS="8", SLURM_STEP_NODELIST="node[01-04]",
                  SLURM_LOCALID="1"),
    "slurm_coordinator": dict(SLURM_PROCID="0", SLURM_NTASKS="2",
                              COORDINATOR_ADDRESS="10.0.0.1:1234"),
    "ompi": dict(OMPI_COMM_WORLD_RANK="2", OMPI_COMM_WORLD_SIZE="4",
                 OMPI_COMM_WORLD_LOCAL_RANK="2", COORDINATOR_ADDRESS="head:9000"),
    # SLURM first, as the JAX package orders the sources
    "slurm_and_torchrun": dict(SLURM_PROCID="1", SLURM_NTASKS="2", RANK="5", WORLD_SIZE="6"),
}


def _env(monkeypatch, env):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_detect_process_env_matches_jax(monkeypatch, name):
    _env(monkeypatch, ENVS[name])
    got, want = dist.detect_process_env(), jax_dist.detect_process_env()
    assert {k: got[k] for k in want} == want


def test_torchrun_variables_are_read(monkeypatch):
    _env(monkeypatch, dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="1", MASTER_ADDR="10.1.2.3",
                           MASTER_PORT="29400"))
    assert dist.detect_process_env() == {"process_id": 3, "num_processes": 4,
                                         "coordinator_address": "10.1.2.3:29400",
                                         "local_rank": 1, "launcher": "torchrun"}
    assert jax_dist.detect_process_env()["num_processes"] == 1  # JAX reads no torchrun


def test_single_process_start_up_and_mesh_refusals(monkeypatch):
    _env(monkeypatch, {})
    assert dist.initialize_distributed("gloo") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):  # a model axis takes ranks
        make_mesh(model=2)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(seq=2)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        make_mesh(seq=2, model=2)
    if not torch.cuda.is_available():
        monkeypatch.setenv("LOCAL_RANK", "1")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("launcher, env, want", [
    ("slurm", dict(SLURM_PROCID="3", SLURM_NTASKS="4", SLURM_LOCALID="1"), "cuda:1"),
    ("ompi", dict(OMPI_COMM_WORLD_RANK="2", OMPI_COMM_WORLD_SIZE="4",
                  OMPI_COMM_WORLD_LOCAL_RANK="0"), "cuda:0"),
    ("torchrun", dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1"), "cuda:1"),
    ("one process", dict(SLURM_PROCID="0", SLURM_NTASKS="1", SLURM_LOCALID="1"), "cuda"),
    ("missing card", dict(OMPI_COMM_WORLD_RANK="2", OMPI_COMM_WORLD_SIZE="4",
                          OMPI_COMM_WORLD_LOCAL_RANK="2"), None),
])
def test_rank_device_follows_the_launcher(monkeypatch, launcher, env, want):
    """Two cards stubbed: each rank's default device is its launcher's local
    rank, and a local rank with no card of its own raises."""
    _env(monkeypatch, env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    if want is None:
        with pytest.raises(RuntimeError, match="no card of its own"):
            resolve_device()
    else:
        assert resolve_device() == torch.device(want)
    assert resolve_device("cpu") == torch.device("cpu")


def test_collectives_on_two_gloo_ranks(tmp_path):
    got = ranks.spawn_ranks(ranks.collectives, str(tmp_path))
    xs = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r for r in range(2)]
    xb = [x.to(torch.bfloat16) / 3 for x in xs]
    for r, out in enumerate(got):
        assert (out["index"], out["size"], out["data_size"]) == (r, 2, 1)
        assert torch.equal(out["stacked"], torch.stack(xs))
        assert torch.equal(out["tiled"], torch.cat(xs, dim=1))
        assert out["bf16"].dtype == torch.bfloat16 and torch.equal(out["bf16"], torch.stack(xb))
        assert torch.equal(out["shift"], xs[0] if r == 1 else torch.zeros(2, 3))
        assert torch.equal(out["ring"], xb[1 - r])
        assert torch.equal(out["sum"], xs[0] + xs[1])
        assert torch.equal(out["sum_bf16"], (xb[0].float() + xb[1].float()).to(torch.bfloat16))
        assert out["ints"].tolist() == [[5], [6]]
