"""The port's AdamW (train/optim.py) step for step against the JAX package's
optax optimizer (build_optimizer, apply_freeze): every schedule, global-norm
clipping that triggers, weight decay on the parameters of two or more dims,
per-module learning rates and freezing. Same f32 parameters and gradients
from a numpy seed. Tolerance 1e-5 relative (1e-6 absolute): the same formulas
over six updates, rounded to f32 at other places (the port takes the
schedule in double precision, XLA fuses the chain)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import rng

from timeviper_tpu.train import optim as jopt
from timeviper_tpu_torch.train import optim as topt

SHAPES = {"vision_backbone": {"w": (3, 4), "b": (4,)},
          "projector": {"w": (4, 5), "b": (5,)},
          "llm_backbone": {"w": (5, 2), "norm": (2,)}}


def _trees(seed):
    r = rng(seed)
    return {m: {k: r.standard_normal(s).astype(np.float32) for k, s in d.items()}
            for m, d in SHAPES.items()}


def _flat(tree):
    return {f"{m}.{k}": v for m, d in tree.items() for k, v in d.items()}


CFGS = [
    dict(schedule="cosine", warmup_steps=2, total_steps=8, weight_decay=0.1,
         max_grad_norm=0.5, projector_lr=3e-2),
    dict(schedule="linear", warmup_steps=0, total_steps=6, weight_decay=0.0,
         max_grad_norm=100.0, vision_lr=1e-3),
    dict(schedule="constant", warmup_steps=3, weight_decay=0.05, max_grad_norm=1.0,
         llm_lr=5e-3),
    dict(schedule="constant", warmup_steps=0, max_grad_norm=0.0),
]


@pytest.mark.parametrize("cfg_kw", CFGS)
@pytest.mark.parametrize("trainable", [None, "projector"])
def test_adamw_matches_optax(cfg_kw, trainable):
    cfg_kw = dict(learning_rate=1e-2, **cfg_kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, _trees(0))
    tx = jopt.apply_freeze(jopt.build_optimizer(jopt.OptimConfig(**cfg_kw), jparams),
                           jparams, trainable)
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(np.array(v)))
               for k, v in _flat(_trees(0)).items()}
    opt = topt.apply_freeze(topt.build_optimizer(topt.OptimConfig(**cfg_kw), tparams),
                            trainable)
    @jax.jit  # one compile a case, not one per primitive and shape
    def jstep(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    for step in range(6):
        grads = _trees(100 + step)
        jg = jax.tree_util.tree_map(lambda g: jnp.asarray(g * (1 + step)), grads)
        jparams, jstate = jstep(jg, jstate, jparams)
        opt.update({k: torch.from_numpy(v * (1 + step)) for k, v in _flat(grads).items()})
        for k, want in _flat(jax.tree_util.tree_map(np.asarray, jparams)).items():
            np.testing.assert_allclose(tparams[k].detach().numpy(), want, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} after update {step}")
    if trainable:  # a frozen 1-D parameter never moves (no decay on 1-D)
        np.testing.assert_array_equal(tparams["vision_backbone.b"].detach().numpy(),
                                      _trees(0)["vision_backbone"]["b"])


@pytest.mark.parametrize("kw", [dict(schedule="cosine", warmup_steps=3, total_steps=10),
                                dict(schedule="linear", warmup_steps=2, total_steps=7),
                                dict(schedule="constant", warmup_steps=4)])
def test_schedules_match_optax(kw):
    cfg_t, cfg_j = topt.OptimConfig(**kw), jopt.OptimConfig(**kw)
    sched_t, sched_j = topt.lr_schedule(0.5, cfg_t), jopt._lr_schedule(0.5, cfg_j)
    for count in range(14):
        np.testing.assert_allclose(sched_t(count), float(sched_j(count)), rtol=1e-6,
                                   atol=1e-8, err_msg=str(count))
