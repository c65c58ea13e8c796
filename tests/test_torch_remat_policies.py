"""The remat policies (models/remat.py) against the JAX package's
(tests/test_nano_backbone.py:test_remat_policies_grads_identical): a policy
changes what a checkpointed block keeps for the backward, never the
gradients. On the tiny nano and qwen2 backbones, with two packed segments,
every policy's gradients equal "full"'s bitwise (the same f32 ops run on the
CPU, kept or recomputed) and the JAX policy's to 1e-5 of each leaf's largest
magnitude; the Trainer takes `remat_policy` as the JAX TrainerConfig does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import tiny_nano_config, tiny_qwen2_config
from timeviper_tpu.models import nano as jax_nano
from timeviper_tpu.models import qwen2 as jax_qwen2
from timeviper_tpu_torch.models.nano import NanoModel, nano_forward
from timeviper_tpu_torch.models.qwen2 import Qwen2Model, qwen2_forward
from timeviper_tpu_torch.models.remat import POLICIES, remat_policy
from timeviper_tpu_torch.params import nano_state_dict, qwen2_state_dict

L = 32
IDS = rng(5).integers(0, 512, (1, L))
SEQ = np.concatenate([np.zeros((1, 13)), np.ones((1, L - 13))], axis=1).astype(np.int32)
FAMILIES = {  # three layers: one of each nano block type; two qwen2 layers
    "nano": (functools.partial(tiny_nano_config, num_hidden_layers=3,
                               hybrid_override_pattern="M*-"),
             jax_nano.init_nano_params, jax_nano.nano_forward, NanoModel, nano_forward,
             lambda tree, cfg: nano_state_dict(tree, cfg)),
    "qwen2": (functools.partial(tiny_qwen2_config, num_hidden_layers=2),
              jax_qwen2.init_qwen2_params, jax_qwen2.qwen2_forward,
              Qwen2Model, qwen2_forward, lambda tree, cfg: qwen2_state_dict(tree)),
}


@functools.lru_cache(maxsize=None)
def _jax(family):
    make_cfg, init, fwd, _, _, bridge = FAMILIES[family]
    cfg = make_cfg()

    def grad(p, pol):
        def loss(p):
            kw = dict(remat=True, remat_policy=pol) if family == "nano" else dict(remat=pol)
            out = fwd(p, cfg, input_ids=jnp.asarray(IDS), seq_idx=jnp.asarray(SEQ), **kw)
            lp = jax.nn.log_softmax(out["logits"][:, :-1], axis=-1)
            return -jnp.take_along_axis(lp, jnp.asarray(IDS)[:, 1:, None], axis=-1).mean()
        return jax.grad(loss)(p)

    @jax.jit
    def params_and_grads(key):  # the weights and every policy's gradients, one compile
        p = init(key, cfg, jnp.float32)
        return p, {pol: grad(p, pol) for pol in POLICIES}

    params, grads = jax.tree_util.tree_map(np.asarray, params_and_grads(jax.random.PRNGKey(0)))
    return cfg, params, grads, bridge


def _port_grads(family, policy):
    cfg, params, _, bridge = _jax(family)
    model = FAMILIES[family][3](cfg, torch.float32, "cpu")
    model.load_state_dict(bridge(params, cfg))
    out = FAMILIES[family][4](model, cfg, input_ids=t(IDS), seq_idx=t(SEQ), remat=policy)
    loss = torch.nn.functional.cross_entropy(out["logits"][0, :-1], t(IDS)[0, 1:].long())
    names = [k for k, p in model.named_parameters()]
    got = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return dict(zip(names, got))


@pytest.mark.parametrize("family", ["nano", "qwen2"])
def test_policies_keep_the_gradients(family):
    cfg, params, jgrads, bridge = _jax(family)
    full = _port_grads(family, "full")
    for policy in POLICIES:
        got = full if policy == "full" else _port_grads(family, policy)
        want = bridge(jgrads[policy], cfg)
        assert set(got) == set(want)
        for k, g in got.items():
            assert torch.equal(g, full[k]), (policy, k)
            w = n(want[k])
            np.testing.assert_allclose(n(g), w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-6),
                                       err_msg=f"{policy} {k}")


def test_policy_names():
    assert remat_policy(True) == "full" and remat_policy(False) is None
    assert [remat_policy(p) for p in POLICIES] == list(POLICIES)
    with pytest.raises(ValueError, match="remat_policy"):
        remat_policy("everything")


def test_trainer_takes_the_policy(tmp_path):
    """TrainerConfig(remat_policy=...) as in the JAX trainer; `remat=False`
    turns the checkpoints off whatever the policy, and `remat` names no
    policy itself."""
    from timeviper_tpu_torch.config import VLMConfig, tiny_vit_config
    from timeviper_tpu_torch.models.vlm import VLMArch, init_vlm_params
    from timeviper_tpu_torch.train.optim import OptimConfig
    from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

    arch = VLMArch(vlm=VLMConfig(arch_specifier="tome_mlp-2"), vision=tiny_vit_config(),
                   llm=tiny_nano_config())
    model = init_vlm_params(arch, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    for kw, want in ((dict(remat_policy="dots_scan"), "dots_scan"),
                     (dict(remat=False, remat_policy="scan"), False),
                     (dict(remat="full", remat_policy="scan"), "scan")):
        cfg = TrainerConfig(run_dir=str(tmp_path), resume=False, **kw)
        assert Trainer(arch, model, OptimConfig(), cfg, device="cpu").remat == want
    with pytest.raises(ValueError, match="remat_policy"):
        Trainer(arch, model, OptimConfig(),
                TrainerConfig(run_dir=str(tmp_path), resume=False, remat="dots"), device="cpu")
