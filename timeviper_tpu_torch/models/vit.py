"""SigLIP and DINOv2 ViT vision towers (counterpart of
timeviper_tpu/models/vit.py).

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

DINOv2: the position embedding covers the patches only, and the CLS and
register tokens are prepended after it is added; LayerScale multiplies each
block's two residual branches by gamma rounded to their dtype, and the
features drop the prefix tokens.

The position table keeps the size it was loaded at (a DINOv2 checkpoint's
37 x 37 against the registry's 27 x 27 grid: `pos_embed` takes the loaded
tensor's shape), and `vit_forward` resizes it to the input's grid whenever
the two differ, as JAX `_resize_pos_embed` does with jax.image.resize's
cubic: `resize_weights` builds the same separable matrices as JAX's
scale_and_translate (Keys' cubic, a = -0.5, on half-pixel centres, widened
by the scale when it shrinks the grid, renormalised at the edges), in f32.
It is not F.interpolate's bicubic (a = -0.75, clamped taps, no
antialiasing).
"""

from __future__ import annotations

import math
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


class LayerScale(nn.Module):
    """A float32 gamma (the JAX `{"gamma": ...}` leaf); the product is taken
    in the branch's dtype, gamma rounded to it first."""

    def __init__(self, d: int, init: float, device=None):
        super().__init__()
        self.init = init
        self.gamma = nn.Parameter(torch.full((d,), init, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


def layer_scale(ls, x: torch.Tensor) -> torch.Tensor:
    """x through an optional LayerScale."""
    return x if ls is None else ls(x)


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
        scale = cfg.use_layer_scale
        self.ls1 = LayerScale(d, cfg.layer_scale_init, device) if scale else None
        self.ls2 = LayerScale(d, cfg.layer_scale_init, device) if scale else None


class ViT(nn.Module):
    INT8_SWITCH = VIT_SWITCH  # the int8 path's switch (ops/int8_linear.py)
    # a 4-D (p, p, 3, D) leaf in the JAX package, which never quantizes it
    KEEP_FULL_PRECISION = ("patch_embed",)

    def __init__(self, cfg: ViTConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        p, d = cfg.patch_size, cfg.hidden_size
        self.patch_embed = nn.Linear(p * p * 3, d, dtype=dtype, device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches, d, dtype=torch.float32, device=device))
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, d, dtype=torch.float32, device=device))
                          if cfg.use_class_token else None)
        self.reg_tokens = (nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d,
                                                    dtype=torch.float32, device=device))
                           if cfg.num_register_tokens else None)
        self.layers = nn.ModuleList(
            ViTBlock(cfg, dtype, device) for _ in range(cfg.num_hidden_layers - 1))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the position table takes the loaded size (vit_forward resizes it)
        pos = state_dict.get(prefix + "pos_embed")
        if pos is not None and pos.shape != self.pos_embed.shape:
            self.pos_embed = nn.Parameter(torch.empty(
                pos.shape, dtype=self.pos_embed.dtype, device=self.pos_embed.device),
                requires_grad=self.pos_embed.requires_grad)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights as the JAX init draws them: N(0, 0.02) matrices and
        position embedding, zero biases, unit LayerNorms, zero CLS and
        register tokens, LayerScale at its init value."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, LayerScale):
                mod.gamma.fill_(mod.init)
        for tok in (self.cls_token, self.reg_tokens):
            if tok is not None:
                tok.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)


def vit_forward(model: ViT, cfg: ViTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (B, H, W, 3) -> penultimate-block patch features (B, P, D), the
    prefix (CLS, register) tokens dropped."""
    B, H = pixels.shape[:2]
    p = cfg.patch_size
    grid = H // p
    w = model.patch_embed.weight
    crop = pixels[:, : grid * p, : grid * p].to(w.dtype)
    patches = (crop.reshape(B, grid, p, grid, p, 3).permute(0, 1, 3, 2, 4, 5)
               .reshape(B, grid * grid, p * p * 3))
    x = model.patch_embed(patches) + resize_pos_embed(model.pos_embed, grid).to(w.dtype)
    prefix = [tok.to(x.dtype).expand(B, -1, -1) for tok in (model.cls_token, model.reg_tokens)
              if tok is not None]
    if prefix:  # after the position add (timm's no_embed_class order)
        x = torch.cat(prefix + [x], dim=1)

    act = _act(cfg.hidden_act)
    nh = cfg.num_attention_heads
    hd = cfg.hidden_size // nh
    if _use_fused_ln(cfg):
        return _vit_blocks_fused_ln(model, cfg, x, act, nh, hd)
    for layer in model.layers:
        qkv = layer.attn["qkv"](layer.norm1(x))
        x = x + layer_scale(layer.ls1, layer.attn["proj"](encoder_attention_qkv(qkv, nh, hd)))
        x = x + layer_scale(layer.ls2, layer.mlp["fc2"](act(layer.mlp["fc1"](layer.norm2(x)))))
    return x[:, cfg.num_prefix_tokens:]


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5, at |offsets| x (jax.image's)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) f32 weights of jax.image.resize(method="cubic") along one
    axis, built as its compute_weight_mat builds them (antialiased, no
    translation)."""
    f32 = torch.float32
    scale = torch.tensor(n_out / n_in, dtype=f32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(f32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_pos_embed(pos: torch.Tensor, grid: int) -> torch.Tensor:
    """(1, g0^2, D) patch position table -> (1, grid^2, D), f32 (JAX
    timeviper_tpu/models/vit.py:_resize_pos_embed); the table itself where
    the grids agree."""
    g0 = int(round(math.sqrt(pos.shape[1])))
    if g0 == grid:
        return pos
    w = resize_weights(g0, grid, pos.device)
    out = torch.einsum("hwd,hH,wW->HWd", pos.reshape(g0, g0, -1).float(), w, w)
    return out.reshape(1, grid * grid, -1)


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
        x, n = fused_ln(layer_scale(layer.ls1, out), layer.norm2.weight, layer.norm2.bias,
                        eps=eps, residual=x, act_inv=inv2)
        pending = (x, layer_scale(layer.ls2, layer.mlp["fc2"](act(matmul(fc1_p, n, inv2)))))
    x = pending[0] + pending[1] if pending is not None else x
    return x[:, cfg.num_prefix_tokens:]
