"""SigLIP ViT vision tower (counterpart of timeviper_tpu/models/vit.py).

Features are the penultimate block's patch tokens with no final norm, as the
reference's timm patch takes them, so the last block is never run and is not
built. The patch embedding is a matmul over flattened (p, p, 3) patches,
which equals the VALID strided conv. Attention reads q, k and v straight from
the fused qkv projection (ops/vit_attention.py, kernel K3 on the card).

int8: train/quantize.py swaps the blocks' linears for Int8Linears, whose
int8 path TIMEVIPER_VIT_INT8_MXU switches (ops/int8_linear.py); the patch
embedding stays in its dtype, as the JAX package's 4-D patch kernel does.
TIMEVIPER_VIT_FUSED_LN=1 runs the blocks through `_vit_blocks_fused_ln`: each
residual add and the LayerNorm after it are one call of ops/layernorm.py:
fused_ln (K8 on the card), which emits int8 rows straight to a calibrated
W8A8 projection.

Left out for now: class/register tokens and LayerScale (DINOv2), resizing the
position embedding to another grid.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from timeviper_tpu_torch.config import ViTConfig
from timeviper_tpu_torch.ops import int8_linear
from timeviper_tpu_torch.ops.int8_linear import VIT_SWITCH, Int8Linear, w8a8_matmul_prequant
from timeviper_tpu_torch.ops.layernorm import fused_ln, fused_ln_supported
from timeviper_tpu_torch.ops.vit_attention import encoder_attention_qkv


class LayerNorm(nn.Module):
    """LayerNorm with f32 parameters and statistics; returns the input dtype."""

    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def _act(name: str):
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu":
        return F.gelu
    raise ValueError(name)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype, device):
        super().__init__()
        d = cfg.hidden_size
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(d, cfg.layer_norm_eps, device)
        self.attn = nn.ModuleDict({
            "qkv": nn.Linear(d, 3 * d, bias=cfg.qkv_bias, **kw),
            "proj": nn.Linear(d, d, **kw),
        })
        self.norm2 = LayerNorm(d, cfg.layer_norm_eps, device)
        self.mlp = nn.ModuleDict({
            "fc1": nn.Linear(d, cfg.intermediate_size, **kw),
            "fc2": nn.Linear(cfg.intermediate_size, d, **kw),
        })


class ViT(nn.Module):
    INT8_SWITCH = VIT_SWITCH  # the int8 path's switch (ops/int8_linear.py)
    # a 4-D (p, p, 3, D) leaf in the JAX package, which never quantizes it
    KEEP_FULL_PRECISION = ("patch_embed",)

    def __init__(self, cfg: ViTConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        if cfg.use_class_token or cfg.num_register_tokens or cfg.use_layer_scale:
            raise NotImplementedError("class/register tokens and LayerScale are not ported")
        p, d = cfg.patch_size, cfg.hidden_size
        self.patch_embed = nn.Linear(p * p * 3, d, dtype=dtype, device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches, d, dtype=torch.float32, device=device))
        self.layers = nn.ModuleList(
            ViTBlock(cfg, dtype, device) for _ in range(cfg.num_hidden_layers - 1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights as the JAX init draws them: N(0, 0.02) matrices and
        position embedding, zero biases, unit LayerNorms."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)


def vit_forward(model: ViT, cfg: ViTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (B, H, W, 3) -> penultimate-block patch features (B, P, D)."""
    B, H = pixels.shape[:2]
    p = cfg.patch_size
    grid = H // p
    if grid * grid != cfg.num_patches:
        raise NotImplementedError("position-embedding resize is not ported")
    w = model.patch_embed.weight
    crop = pixels[:, : grid * p, : grid * p].to(w.dtype)
    patches = (crop.reshape(B, grid, p, grid, p, 3).permute(0, 1, 3, 2, 4, 5)
               .reshape(B, grid * grid, p * p * 3))
    x = model.patch_embed(patches) + model.pos_embed.to(w.dtype)

    act = _act(cfg.hidden_act)
    nh = cfg.num_attention_heads
    hd = cfg.hidden_size // nh
    if _use_fused_ln(cfg):
        return _vit_blocks_fused_ln(model, cfg, x, act, nh, hd)
    for layer in model.layers:
        qkv = layer.attn["qkv"](layer.norm1(x))
        x = x + layer.attn["proj"](encoder_attention_qkv(qkv, nh, hd))
        x = x + layer.mlp["fc2"](act(layer.mlp["fc1"](layer.norm2(x))))
    return x


def _use_fused_ln(cfg: ViTConfig) -> bool:
    """TIMEVIPER_VIT_FUSED_LN=1 and a width the fused norm takes; never while
    calibration captures, which must see the bf16 norm outputs
    (timeviper_tpu/models/vit.py:200)."""
    if os.environ.get("TIMEVIPER_VIT_FUSED_LN", "0") != "1" or int8_linear.ACT_AMAX_SINK is not None:
        return False
    return fused_ln_supported(cfg.hidden_size)


def _vit_blocks_fused_ln(model: ViT, cfg: ViTConfig, x, act, nh: int, hd: int):
    """The encoder blocks with each residual add moved into the next
    LayerNorm, one fused_ln call per norm; a calibrated W8A8 projection after
    a norm takes the int8 rows fused_ln emits (timeviper_tpu/models/vit.py:216)."""
    eps = cfg.layer_norm_eps

    def inv_of(lin):
        return lin.act_inv if isinstance(lin, Int8Linear) else None

    def matmul(lin, n, inv):
        return w8a8_matmul_prequant(lin, n, x.dtype) if inv is not None else lin(n)

    pending = None  # (residual, delta): the add owed to the next norm
    for layer in model.layers:
        qkv_p, fc1_p = layer.attn["qkv"], layer.mlp["fc1"]
        inv1 = inv_of(qkv_p)
        if pending is None:
            n = fused_ln(x, layer.norm1.weight, layer.norm1.bias, eps=eps, act_inv=inv1)
        else:
            x, n = fused_ln(pending[1], layer.norm1.weight, layer.norm1.bias, eps=eps,
                            residual=pending[0], act_inv=inv1)
        out = layer.attn["proj"](encoder_attention_qkv(matmul(qkv_p, n, inv1), nh, hd))
        inv2 = inv_of(fc1_p)
        x, n = fused_ln(out, layer.norm2.weight, layer.norm2.bias, eps=eps, residual=x,
                        act_inv=inv2)
        pending = (x, layer.mlp["fc2"](act(matmul(fc1_p, n, inv2))))
    return pending[0] + pending[1] if pending is not None else x
