"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py).

The port and the JAX package get the same inputs, made with numpy from a
seed, and are compared in float32 on the CPU. torch runs single-threaded so
that it does not starve the JAX test workers running beside it.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def t(a) -> torch.Tensor:
    """numpy (or JAX) array -> a torch tensor that owns a copy."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    """torch or JAX array -> float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def packed_seq(B: int, L: int, pad: int, cut: int) -> np.ndarray:
    """Segment ids of a left-padded packed row: `pad` rows of -1, then
    segment 0 up to `cut`, then segment 1."""
    row = np.concatenate([np.full(pad, -1), np.zeros(cut - pad), np.ones(L - cut)])
    return np.tile(row.astype(np.int32), (B, 1))


def row_pads(B: int, L: int, pads) -> np.ndarray:
    """Segment ids of B rows, row b with a -1 left pad of pads[b] rows (at
    most L - 1), then one segment 0: a batched prefill's rows."""
    seg = np.zeros((B, L), np.int32)
    for b, pad in enumerate(pads):
        seg[b, :min(pad, L - 1)] = -1
    return seg


def require_cuda() -> torch.device:
    """Skip unless a CUDA card is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
