"""A trainable vision tower: its gradients against jax.grad of the JAX
forward, f32 on the CPU, for SigLIP and DINOv2 (through the plain block
loop and through TIMEVIPER_VIT_FUSED_LN=1, whose norms are ops/layernorm.py's
FusedLNFn / FusedLNResFn with the JAX package's LayerNorm gradient) and for
InternVideo2. The JAX side runs its attention oracle (and the fused norm's
custom VJP, its Pallas forward in interpret mode), jitted; the port runs
the plain attention under autograd. Every parameter's gradient, bridged by
params.py as the weights are, within 1e-4 of its largest magnitude.

Also: the ViT attention backward's plain version (the formulas the kernel
computes, from the forward's output and row log-sum-exp) against jax.vjp
of the JAX oracle, in the fused qkv layout and with v a column slice; and
one Trainer step with LoRA on the LLM and the tower and projector trained,
the tower at its own `vision_lr`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import InternVideo2Config as JaxIV2Config
from timeviper_tpu.config import tiny_vit_config
from timeviper_tpu.models import internvideo2 as jax_iv2
from timeviper_tpu.models import vit as jax_vit
from timeviper_tpu.ops import vit_attention as jax_va
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.config import InternVideo2Config
from timeviper_tpu_torch.models import vit as vit_mod
from timeviper_tpu_torch.models.internvideo2 import InternVideo2, internvideo2_forward
from timeviper_tpu_torch.models.vit import ViT, vit_forward
from timeviper_tpu_torch.ops.layernorm import fused_ln
from timeviper_tpu_torch.ops.flash_attention import flash_lse_plain
from timeviper_tpu_torch.ops.vit_attention import (
    vit_attention_bwd_plain,
    vit_attention_plain,
    vit_attention_qkv_bwd_plain,
    vit_attention_qkv_plain,
)
from timeviper_tpu_torch.params import iv2_state_dict, vit_state_dict

DINO = dict(use_class_token=True, num_register_tokens=1, use_layer_scale=True,
            hidden_act="gelu")
IV2 = dict(image_size=28, patch_size=14, num_frames=2, hidden_size=32, intermediate_size=64,
           num_hidden_layers=3, num_attention_heads=2, x_vis_return_idx=-2)


def _perturbed(params, seed):
    """Non-trivial 1-D leaves (norms, biases, LayerScale) and prefix tokens."""
    r = rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * r.standard_normal(a.shape)).astype(np.float32)
        if a.ndim == 1 or (a.ndim == 3 and a.shape[1] <= 4) else np.asarray(a), params)


@functools.lru_cache(maxsize=None)
def _case(family: str):
    """(cfg, JAX params, pixels, cotangent, state_dict bridge)."""
    r = rng(5)
    if family == "internvideo2":
        cfg = JaxIV2Config(**IV2)
        params = jax.jit(jax_iv2.init_internvideo2_params, static_argnums=(1, 2))(
            jax.random.PRNGKey(0), cfg, jnp.float32)
        px = r.random((2, 2, 28, 28, 3), np.float32)  # two clips of two frames
        tokens = 2 * 4
        return cfg, _perturbed(params, 1), px, r.standard_normal(
            (2, tokens, 32)).astype(np.float32), iv2_state_dict
    extra = DINO if family == "dinov2" else {}
    cfg = tiny_vit_config(**extra, hidden_size=128, intermediate_size=256)
    params = jax.jit(jax_vit.init_vit_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), cfg, jnp.float32)
    px = r.random((2, 28, 28, 3), np.float32)
    return cfg, _perturbed(params, 1), px, r.standard_normal((2, 4, 128)).astype(np.float32), \
        functools.partial(vit_state_dict, cfg=cfg)


def _jax_forward(family):
    if family == "internvideo2":
        return jax_iv2.internvideo2_forward
    return jax_vit.vit_forward


@pytest.mark.parametrize("family,fused", [("siglip", False), ("siglip", True),
                                          ("dinov2", False), ("dinov2", True),
                                          ("internvideo2", False)])
def test_tower_gradients_match_jax(family, fused, monkeypatch):
    monkeypatch.setenv("TIMEVIPER_VIT_FUSED_LN", "1" if fused else "0")
    cfg, params, px, ct, bridge = _case(family)
    fwd = _jax_forward(family)

    def loss(p):
        return jnp.sum(fwd(p, cfg, jnp.asarray(px)) * ct)

    want = bridge(jax.jit(jax.grad(loss))(params))

    if family == "internvideo2":
        pcfg = InternVideo2Config(**IV2)
        model = InternVideo2(pcfg, torch.float32, "cpu")
        run = internvideo2_forward
    else:
        pcfg = tcfg.ViTConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        model = ViT(pcfg, torch.float32, "cpu")
        run = vit_forward
    model.load_state_dict(bridge(params))
    calls = []
    monkeypatch.setattr(vit_mod, "fused_ln", lambda *a, **k: calls.append(1) or fused_ln(*a, **k))
    feats = run(model, pcfg, t(px))
    (feats * t(ct)).sum().backward()
    assert len(calls) == (2 * (pcfg.num_hidden_layers - 1) if fused else 0)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        a, b = n(got[name].grad), n(g)
        scale = max(np.abs(b).max(), 1e-6)
        assert np.abs(a - b).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("T,H,hd,layout", [(65, 2, 72, "fused"), (33, 2, 64, "fused"),
                                           (40, 2, 88, "split")])
def test_attention_backward_plain_matches_jax_vjp(T, H, hd, layout):
    """The backward kernel's plain version, from the plain forward's output
    and row log-sum-exp, against jax.vjp of the JAX oracle
    (encoder_attention_qkv / encoder_attention off the TPU), f32."""
    r = rng(11)
    B = 2
    qkv = r.standard_normal((B, T, 3 * H * hd)).astype(np.float32)
    g = r.standard_normal((B, T, H * hd)).astype(np.float32)
    if layout == "fused":
        want = jax.jit(lambda x, ct: jax.vjp(
            lambda y: jax_va.encoder_attention_qkv(y, H, hd), x)[1](ct)[0])(
            jnp.asarray(qkv), jnp.asarray(g))
        q, k, _ = t(qkv).reshape(B, T, 3, H, hd).unbind(2)
        out = vit_attention_qkv_plain(t(qkv), H, hd)
        got = vit_attention_qkv_bwd_plain(t(qkv), out, t(g), H, hd,
                                          flash_lse_plain(q, k, causal=False))
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(want)).max())
        return
    q, k = (r.standard_normal((B, T, H, hd)).astype(np.float32) for _ in range(2))
    v = qkv[..., 2 * H * hd:].reshape(B, T, H, hd)
    want = jax.jit(lambda a, b, c, ct: jax.vjp(jax_va.encoder_attention, a, b, c)[1](ct))(
        *(jnp.asarray(x) for x in (q, k, v, g.reshape(B, T, H, hd))))
    tq, tk = t(q), t(k)
    tv = t(qkv)[..., 2 * H * hd:].view(B, T, H, hd)
    out = vit_attention_plain(tq, tk, tv)
    got = vit_attention_bwd_plain(tq, tk, tv, out, t(g).view(B, T, H, hd),
                                  flash_lse_plain(tq, tk, causal=False))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(n(a), b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("vision_lr", [0.0, 1e-3])
def test_trainer_trains_the_tower_at_its_own_rate(tmp_path, vision_lr):
    """LoRA on the LLM plus trainable_modules="vision_backbone,projector"
    (timeviper_tpu/train/lora.py:trainable_lora_state): one Trainer step
    moves the LoRA factors, the projector and, at a vision_lr above 0, the
    tower; the LLM's own weights stay frozen."""
    from timeviper_tpu_torch.config import VLMConfig, tiny_nano_config
    from timeviper_tpu_torch.data.loader import collate
    from timeviper_tpu_torch.models.vlm import VLMArch, init_vlm_params
    from timeviper_tpu_torch.train.lora import add_lora
    from timeviper_tpu_torch.train.optim import OptimConfig
    from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

    img = 500
    arch = VLMArch(vlm=VLMConfig(arch_specifier="tome_mlp-2"), vision=tcfg.tiny_vit_config(),
                   llm=tiny_nano_config())
    model = init_vlm_params(arch, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    add_lora(model, generator=torch.Generator().manual_seed(1))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    r = rng(3)
    items = [{"input_ids": np.asarray([5, 6, img, img, 9, 10, 11, 12]),
              "labels": np.asarray([-100] * 5 + [10, 11, 12]),
              "pixels": r.standard_normal((2, 28, 28, 3)).astype(np.float32)}
             for _ in range(2)]
    trainer = Trainer(arch, model, OptimConfig(learning_rate=3e-3, vision_lr=vision_lr,
                                               schedule="constant", total_steps=4),
                      TrainerConfig(run_dir=str(tmp_path / "run"), max_steps=1, save_every=100,
                                    resume=False, lora=True,
                                    trainable_modules="vision_backbone,projector"),
                      device="cpu")
    metrics = trainer.train_step(collate(items, img, arch.tokens_per_frame))
    assert float(metrics["grad_norm/vision_backbone"]) > 0
    moved = {k for k, v in model.named_parameters() if not torch.equal(v, before[k])}
    tower = {k for k in before if k.startswith("vision_backbone.")}
    assert {k for k in before if k.startswith("projector.")} <= moved
    assert any(".lora_" in k for k in moved)
    assert not any(k.startswith("llm_backbone.") and ".lora_" not in k for k in moved)
    assert (tower & moved) == (tower if vision_lr > 0 else set())
