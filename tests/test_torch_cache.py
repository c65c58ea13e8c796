"""models/cache.py:init_nano_cache has the JAX package's layout."""

import jax.numpy as jnp
import torch

from timeviper_tpu.config import tiny_nano_config
from timeviper_tpu.models.cache import init_nano_cache as jax_init_nano_cache
from timeviper_tpu_torch.models.cache import init_nano_cache


def test_init_nano_cache_matches_jax_layout():
    cfg = tiny_nano_config()
    got = init_nano_cache(cfg, 2, 40, torch.bfloat16)
    want = jax_init_nano_cache(cfg, 2, 40, jnp.bfloat16)
    assert (got["length"], got["valid_from"]) == (0, 0)
    for lt, lj in zip(got["layers"], want["layers"]):
        assert lt.keys() == lj.keys()
        flat_t = {**lt.get("conv_state", {}), **{k: v for k, v in lt.items() if k != "conv_state"}}
        flat_j = {**lj.get("conv_state", {}), **{k: v for k, v in lj.items() if k != "conv_state"}}
        for k in flat_j:
            assert tuple(flat_t[k].shape) == flat_j[k].shape, k
            assert str(flat_t[k].dtype).split(".")[-1] == str(flat_j[k].dtype), k
            assert not flat_t[k].any()
