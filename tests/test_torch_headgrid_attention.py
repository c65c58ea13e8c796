"""ops/headgrid_attention.py (K10a's plain version) against the TPU kernel
itself, scripts/microbench_vit_attn.py:_headgrid_kernel, run in Pallas
interpret mode, for hpp 1, 2 and 4 and do_exp on and off. The script
benchmarks when it is imported, so `pad_heads`, `_headgrid_kernel` and
`headgrid_attention` are taken from its source with `ast` and run in a
namespace of small shapes (B 2, T 40 and 65, H 16, hd 72 padded to 128) whose
`pl.pallas_call` interprets; the script itself is left as it is. f32 inputs,
so both sides' casts are exact: 1e-5 (sums in other orders)."""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from torch_parity import n, rng, t

from timeviper_tpu_torch.ops.headgrid_attention import (
    headgrid_attention,
    headgrid_attention_plain,
    pad_heads,
)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "microbench_vit_attn.py"
B, T, H, HD = 2, 40, 16, 72


@functools.lru_cache(maxsize=None)
def _script(T=T):
    """The script's three functions, defined in a namespace of small shapes."""
    tree = ast.parse(SCRIPT.read_text())
    wanted = {"pad_heads", "_headgrid_kernel", "headgrid_attention"}
    defs = [node for node in tree.body
            if isinstance(node, ast.FunctionDef) and node.name in wanted]
    assert {d.name for d in defs} == wanted
    interp = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec)
    ns = dict(jax=jax, jnp=jnp, functools=functools, pl=interp, pltpu=pltpu, B=B, T=T, H=H,
              HD=HD)
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(SCRIPT), "exec"), ns)
    return ns


@functools.lru_cache(maxsize=None)
def _inputs(T=T):
    qkv = (rng(0).standard_normal((B, T, 3 * H * HD)) * 0.3).astype(np.float32)
    padded = np.asarray(_script(T)["pad_heads"](jnp.asarray(qkv), 128))
    return qkv, padded


def test_pad_heads_matches_the_script():
    qkv, padded = _inputs()
    np.testing.assert_array_equal(n(pad_heads(t(qkv), H, HD)), padded)


@pytest.mark.parametrize("seq", [T, 65])
@pytest.mark.parametrize("do_exp", [True, False])
@pytest.mark.parametrize("hpp", [1, 2, 4])
def test_plain_version_matches_the_tpu_kernel(hpp, do_exp, seq):
    """The plain version against the TPU kernel at T 40 and at T 65 (64 keys
    and one more, the CUDA kernel's key tile whole and then ragged)."""
    _, padded = _inputs(seq)
    want = jax.jit(functools.partial(_script(seq)["headgrid_attention"], hd=128, hpp=hpp,
                                     do_exp=do_exp))(jnp.asarray(padded))
    got = headgrid_attention(t(padded), H, hpp, scale=1.0 / HD ** 0.5, do_exp=do_exp)
    assert got.shape == (B, seq, H * 128)
    np.testing.assert_allclose(n(got), np.asarray(want, np.float64), rtol=1e-5, atol=1e-5)
    # the padded columns stay zero
    assert not got.reshape(B, seq, H, 128)[..., HD:].any()
