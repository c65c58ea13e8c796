"""The layer-streamed offload trainer (train/offload.py) against the JAX
package's StreamedTrainer and HostAdamW, and against the port's own
monolithic step (tests/test_offload.py): f32 masters and AdamW moments on
the host, each layer streamed in, recomputed in the backward and updated on
the host at once.

`HostAdamW` equals the JAX package's bitwise, optax.adamw to rtol 1e-6 (the
JAX test's) and the port's AdamW (train/optim.py) to 1e-6 on a matrix with
weight decay, over three steps. One
`StreamedTrainer` step on the tiny nano backbone (f32) gives the monolithic
`nano_forward` loss to 1e-6 relative and, after one update, the port's AdamW
step on the monolithic gradients to 1e-6 (Adam eps 1e-4, as
tests/test_torch_train_step.py takes it: with 1e-8 an element with a near-zero
gradient moves by its f32 rounding divided by itself), on an untied and a
tied backbone. The same step from JAX-initialised weights (bridged with
params.py:nano_state_dict) gives the JAX StreamedTrainer's loss to 1e-6
relative and every updated master to 1e-6, untied and tied (Adam eps 1e-4
on both sides, as above). Two steps lower the loss.
"""

import jax
import numpy as np
import optax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from torch_parity import n, rng, t

from timeviper_tpu import config as jax_config
from timeviper_tpu.models.nano import init_nano_params
from timeviper_tpu.train.offload import HostAdamW as JaxHostAdamW
from timeviper_tpu.train.offload import StreamedTrainer as JaxStreamedTrainer
from timeviper_tpu_torch.config import tiny_nano_config
from timeviper_tpu_torch.models.nano import NanoModel, nano_forward
from timeviper_tpu_torch.params import nano_state_dict
from timeviper_tpu_torch.train.offload import HostAdamW, StreamedTrainer, host_params
from timeviper_tpu_torch.train.optim import AdamW, OptimConfig


def test_host_adamw_matches_optax_the_jax_host_adamw_and_the_ports_adamw():
    p0 = rng(0).standard_normal((3, 4)).astype(np.float32)
    grads = [rng(i + 1).standard_normal((3, 4)).astype(np.float32) for i in range(3)]
    p, pj = {"w": p0.copy()}, {"w": p0.copy()}
    opt, jopt = HostAdamW(p, lr=1e-2, weight_decay=0.01), JaxHostAdamW(pj, lr=1e-2,
                                                                       weight_decay=0.01)
    ox = {"w": jnp.asarray(p0.copy())}
    tx = optax.adamw(1e-2, weight_decay=0.01)
    st = tx.init(ox)
    tp = {"w": torch.nn.Parameter(t(p0))}
    topt = AdamW(tp, OptimConfig(learning_rate=1e-2, weight_decay=0.01, schedule="constant",
                                 max_grad_norm=0.0))
    for g in grads:
        for o, params in ((opt, p), (jopt, pj)):
            o.step += 1
            o.update_tree(params, o.mu, o.nu, {"w": g})
        upd, st = tx.update({"w": jnp.asarray(g)}, st, ox)
        ox = optax.apply_updates(ox, upd)
        topt.update({"w": t(g)})
    np.testing.assert_array_equal(p["w"], pj["w"])
    np.testing.assert_allclose(p["w"], np.asarray(ox["w"]), rtol=1e-6, atol=1e-7)
    # the port's AdamW takes its bias corrections in f32, as optax does
    np.testing.assert_allclose(p["w"], n(tp["w"]), rtol=0, atol=1e-6)


def _backbone(tied: bool, **kw):
    cfg = tiny_nano_config(tie_word_embeddings=tied, **kw)
    model = NanoModel(cfg, torch.float32, "cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    return cfg, model


@pytest.mark.parametrize("tied", [False, True])
def test_one_streamed_step_matches_the_monolithic_step(tied):
    cfg, model = _backbone(tied)
    B, L, lr = 2, 33, 1e-3
    ids = rng(1).integers(3, 500, (B, L))
    labels = ids.copy()
    labels[:, :7] = -100  # a prompt-masked prefix
    trainer = StreamedTrainer(cfg, host_params(model), lr=lr, compute_dtype=torch.float32,
                              logits_chunk=8, device="cpu")
    trainer.opt.eps = 1e-4
    loss = trainer.train_step(ids, labels)

    params = dict(model.named_parameters())
    out = nano_forward(model, cfg, input_ids=t(ids[:, :-1]))
    want = F.cross_entropy(out["logits"].reshape(-1, cfg.vocab_size),
                           t(labels[:, 1:]).reshape(-1).long(), ignore_index=-100)
    grads = torch.autograd.grad(want, list(params.values()))
    opt = AdamW(params, OptimConfig(learning_rate=lr, schedule="constant", max_grad_norm=0.0,
                                    eps=1e-4))
    opt.update(dict(zip(params, grads)))
    np.testing.assert_allclose(loss, float(want.detach()), rtol=1e-6)
    assert set(trainer.host) == set(params)
    for k, p in params.items():
        np.testing.assert_allclose(trainer.host[k], n(p), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("tied", [False, True])
def test_one_streamed_step_matches_the_jax_streamed_trainer(tied):
    jcfg = jax_config.tiny_nano_config(tie_word_embeddings=tied)
    jhost = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                   init_nano_params(jax.random.PRNGKey(4), jcfg, jnp.float32))
    cfg = tiny_nano_config(tie_word_embeddings=tied)
    host = {k: v.numpy().copy() for k, v in nano_state_dict(jhost, cfg).items()}
    ids = rng(6).integers(3, 500, (2, 33))
    labels = ids.copy()
    labels[:, :5] = -100
    jtrainer = JaxStreamedTrainer(jcfg, jhost, lr=1e-3, compute_dtype=jnp.float32)
    trainer = StreamedTrainer(cfg, host, lr=1e-3, compute_dtype=torch.float32, logits_chunk=8,
                              device="cpu")
    jtrainer.opt.eps = trainer.opt.eps = 1e-4
    want = jtrainer.train_step(ids.astype(np.int32), labels.astype(np.int32))
    got = trainer.train_step(ids, labels)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want_host = {k: v.numpy() for k, v in nano_state_dict(jhost, cfg).items()}
    assert set(trainer.host) == set(want_host)
    for k, w in want_host.items():
        np.testing.assert_allclose(trainer.host[k], w, rtol=0, atol=1e-6, err_msg=k)


def test_two_streamed_steps_lower_the_loss():
    cfg, model = _backbone(False, num_hidden_layers=4, hybrid_override_pattern="M-*-")
    ids = rng(3).integers(3, 500, (1, 48))
    trainer = StreamedTrainer(cfg, host_params(model), lr=3e-3, compute_dtype=torch.float32,
                              device="cpu")
    losses = [trainer.train_step(ids, ids) for _ in range(3)]
    assert losses[-1] < losses[0], losses
    assert trainer.opt.step == 3
    moved = host_params(model)
    assert all(not np.array_equal(moved[k], v) for k, v in trainer.host.items()
               if k.endswith("weight") and ".norm" not in k)
