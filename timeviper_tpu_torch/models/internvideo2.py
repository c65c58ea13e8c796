"""InternVideo2-1B video-native ViT-g (counterpart of
timeviper_tpu/models/internvideo2.py).

Clips of `num_frames` (4) frames go through a tubelet patch embedding, a CLS
token is prepended and the 3-D sin-cos position table (a zero row for CLS) is
added, then `effective_depth` (39 of 40) pre-norm blocks run: RMSNorm, a
bias-free qkv projection, RMSNorm of q and of k over all 1408 channels before
the head split, whole-clip attention (ops/vit_attention.py:encoder_attention,
kernel K6 on the card), LayerScale on both branches, an exact-GELU MLP. The
features are the patch tokens with CLS dropped; the VLM's projector merges
each clip's 4 x 256 tokens jointly (models/projector.py, local_num_frames).

Attention reads q and k as the norm gives them and v as a column slice of
the qkv projection, so no head layout is copied.

int8 (train/quantize.py): every linear of the tower, the flattened 2-D
tubelet kernel too, is quantized by the same size rule as in the JAX
package and takes TIMEVIPER_VIT_INT8_MXU as its switch, as the JAX tower's
linears go through the ViT's `_apply_linear`
(timeviper_tpu/models/internvideo2.py:37-45). The forward reads its compute
dtype from the tower, never from a weight that may have been quantized.

Left out for now: the attention-pooling head and resizing the position table
of a pretrained checkpoint (`interpolate_pos_embed`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from timeviper_tpu_torch.config import InternVideo2Config
from timeviper_tpu_torch.models.nano import RMSNorm
from timeviper_tpu_torch.models.vit import LayerScale
from timeviper_tpu_torch.ops.int8_linear import VIT_SWITCH
from timeviper_tpu_torch.ops.norms import rms_norm
from timeviper_tpu_torch.ops.vit_attention import encoder_attention

LAYER_SCALE_INIT = 1e-5


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(embed_dim: int, grid_size: int, t_size: int,
                            cls_token: bool = True) -> np.ndarray:
    """(t_size*grid^2 [+1], embed_dim) float64: the first quarter of the
    channels encodes time, the rest the (h, w) grid; a zero row for CLS."""
    if embed_dim % 4:
        raise ValueError(f"embed_dim {embed_dim} is not a multiple of 4")
    dim_s = embed_dim // 4 * 3
    dim_t = embed_dim // 4
    gh = np.arange(grid_size, dtype=np.float64)
    grid = np.stack(np.meshgrid(gh, gh), axis=0).reshape(2, -1)  # (w, h) order
    pos_s = np.concatenate([_sincos_1d(dim_s // 2, grid[0]),
                            _sincos_1d(dim_s // 2, grid[1])], axis=1)
    pos_t = _sincos_1d(dim_t, np.arange(t_size, dtype=np.float64))
    pos_t = np.repeat(pos_t[:, None, :], grid_size * grid_size, axis=1)
    pos_s = np.repeat(pos_s[None, :, :], t_size, axis=0)
    pos = np.concatenate([pos_t, pos_s], axis=-1).reshape(-1, embed_dim)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos


class IV2Block(nn.Module):
    def __init__(self, cfg: InternVideo2Config, dtype, device):
        super().__init__()
        d = cfg.hidden_size
        kw = dict(dtype=dtype, device=device)
        self.norm1 = RMSNorm(d, device)
        self.attn = nn.ModuleDict({
            "qkv": nn.Linear(d, 3 * d, bias=cfg.qkv_bias, **kw),
            "q_norm": RMSNorm(d, device),
            "k_norm": RMSNorm(d, device),
            "proj": nn.Linear(d, d, **kw),
        })
        self.ls1 = LayerScale(d, LAYER_SCALE_INIT, device)
        self.norm2 = RMSNorm(d, device)
        self.mlp = nn.ModuleDict({
            "fc1": nn.Linear(d, cfg.intermediate_size, **kw),
            "fc2": nn.Linear(cfg.intermediate_size, d, **kw),
        })
        self.ls2 = LayerScale(d, LAYER_SCALE_INIT, device)


class InternVideo2(nn.Module):
    """The tower's weights: only the `effective_depth` blocks the features
    come from are built, as the JAX init builds them."""

    INT8_SWITCH = VIT_SWITCH  # the int8 path's switch (ops/int8_linear.py)

    def __init__(self, cfg: InternVideo2Config, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype  # the compute dtype, whether or not a linear is quantized
        d = cfg.hidden_size
        t_size = cfg.num_frames // cfg.tubelet_size
        self.patch_embed = nn.Linear(cfg.tubelet_size * cfg.patch_size * cfg.patch_size * 3, d,
                                     dtype=dtype, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, dtype=torch.float32, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, t_size * cfg.grid_size ** 2 + 1, d,
                                                  dtype=torch.float32, device=device))
        self.layers = nn.ModuleList(IV2Block(cfg, dtype, device)
                                    for _ in range(cfg.effective_depth))
        self._grid, self._t_size = cfg.grid_size, t_size

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights as the JAX init draws them: N(0, 0.02) matrices
        (the patch embedding too), zero biases, unit RMSNorms, LayerScale
        1e-5, a zero CLS token and the fixed sin-cos position table."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, LayerScale):
                mod.gamma.fill_(mod.init)
        self.cls_token.zero_()
        pos = get_3d_sincos_pos_embed(self.cls_token.shape[-1], self._grid, self._t_size)
        self.pos_embed.copy_(torch.from_numpy(pos).float()[None])


def internvideo2_forward(model: InternVideo2, cfg: InternVideo2Config, clips: torch.Tensor,
                         keep_cls: bool = False) -> torch.Tensor:
    """clips (B, T, H, W, 3), T == cfg.num_frames -> (B, T*grid^2, D) patch
    features (CLS dropped unless `keep_cls`)."""
    B, T, H, W, _ = clips.shape
    ps, tb, d = cfg.patch_size, cfg.tubelet_size, cfg.hidden_size
    g = H // ps
    if T % tb or g * ps != H or W != H:
        raise ValueError(f"clips of {T} frames of {H}x{W} do not tile into tubelets of "
                         f"{tb} x {ps}x{ps}")
    # (B, T', g, g, tb, ps, ps, 3): one matmul with the flattened tubelet kernel
    x = (clips.to(model.dtype).reshape(B, T // tb, tb, g, ps, g, ps, 3)
         .permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, (T // tb) * g * g, tb * ps * ps * 3))
    x = model.patch_embed(x)
    # CLS before the position add: the table's row 0 is CLS's (zero)
    x = torch.cat([model.cls_token.to(x.dtype).expand(B, -1, -1), x], dim=1)
    x = x + model.pos_embed.to(x.dtype)

    nh = cfg.num_attention_heads
    hd = d // nh
    eps = cfg.layer_norm_eps
    for layer in model.layers:
        Tk = x.shape[1]
        qkv = layer.attn["qkv"](rms_norm(x, layer.norm1.weight, eps))
        q, k, v = qkv.split(d, dim=-1)
        # the q and k norms span all heads; v stays a strided slice of qkv
        q = rms_norm(q, layer.attn["q_norm"].weight, eps).view(B, Tk, nh, hd)
        k = rms_norm(k, layer.attn["k_norm"].weight, eps).view(B, Tk, nh, hd)
        out = encoder_attention(q, k, v.view(B, Tk, nh, hd))
        x = x + layer.ls1(layer.attn["proj"](out.reshape(B, Tk, d)))
        h = F.gelu(layer.mlp["fc1"](rms_norm(x, layer.norm2.weight, eps)))
        x = x + layer.ls2(layer.mlp["fc2"](h))
    return x if keep_cls else x[:, 1:]


def encode_frames_iv2(model: InternVideo2, cfg: InternVideo2Config,
                      frames: torch.Tensor) -> torch.Tensor:
    """(F, H, W, 3) -> (F // num_frames, clip_tokens, D): frames group into
    clips of cfg.num_frames."""
    Fn, T = frames.shape[0], cfg.num_frames
    if Fn % T:
        raise ValueError(f"{Fn} frames do not group into clips of {T}")
    return internvideo2_forward(model, cfg, frames.reshape(Fn // T, T, *frames.shape[1:]))
