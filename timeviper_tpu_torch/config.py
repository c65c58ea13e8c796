"""Configuration dataclasses and registries of the port (its own copy of what
it uses from timeviper_tpu/config.py: the pdrop micro-DSL, NanoConfig, ViTConfig,
InternVideo2Config, VLMConfig, the tiny test configs and the registry entries
of the ported families).

The port imports nothing of the JAX package, not even its JAX-free modules,
so these definitions are kept here; tests/test_torch_config.py holds every
registry entry the port builds equal, field for field, to the original.
Backbones of the family the port does not build (qwen2) keep their registry
ids with the family only, so that asking for one raises NotImplementedError
in models/api.py:build_arch.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# pdrop micro-DSL
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PdropStage:
    """One pdrop stage of the `type_layer_ratio` micro-DSL: e.g.
    "uni_14_0.8-attn_18_0.6" keeps 80% of the visual tokens, chosen
    uniformly, before layer 14, then 60% ranked by the last prompt token's
    attention (that layer's q/k projections: an attention layer) before layer
    18. Ratios count against the original visual tokens."""

    compress_type: str  # "uni" | "attn"
    layer: int
    ratio: float


def parse_pdrop_type(pdrop_type: str) -> Tuple[PdropStage, ...]:
    stages = []
    for part in pdrop_type.split("-"):
        typ, layer, ratio = part.split("_")
        stages.append(PdropStage(typ, int(layer), float(ratio)))
    return tuple(stages)


# ---------------------------------------------------------------------------
# LLM backbone
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NanoConfig:
    """Nemotron-H hybrid (Mamba-2 / attention / MLP) backbone config, with
    Nemotron-Nano-9B-v2 defaults. `hybrid_override_pattern` chars: M = Mamba-2
    mixer, * = attention, - = MLP."""

    vocab_size: int = 131072
    hidden_size: int = 4096
    intermediate_size: int = 21504
    num_hidden_layers: int = 52
    hybrid_override_pattern: str = (
        "M-M-M-M*-M-M-M-M-M*-M-M-M-M-M*-M-M-M-M-M*-M-M-M-M-M-"
    )
    num_attention_heads: int = 32
    head_dim: int = 128
    num_key_value_heads: int = 8
    mlp_hidden_act: str = "relu2"
    attention_bias: bool = False
    mlp_bias: bool = False
    use_bias: bool = False
    layer_norm_epsilon: float = 1e-5
    residual_in_fp32: bool = False
    rescale_prenorm_residual: bool = True
    # Mamba-2 mixer
    ssm_state_size: int = 128
    mamba_num_heads: int = 128
    mamba_n_groups: int = 8
    mamba_head_dim: int = 64
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_hidden_act: str = "silu"
    time_step_limit: Tuple[float, float] = (0.0, float("inf"))
    time_step_min: float = 0.001
    time_step_max: float = 0.1
    time_step_floor: float = 1e-4
    use_conv_bias: bool = True
    mamba_proj_bias: bool = False
    chunk_size: int = 256
    # compression: pdrop stages and the TransV merge (models/pdrop.py)
    use_pdrop: bool = False
    pdrop_type: Optional[str] = None
    merge_module: str = "no_merge"  # "no_merge" | "CrossAttention"
    # misc
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if len(self.hybrid_override_pattern) != self.num_hidden_layers:
            raise ValueError("hybrid_override_pattern must have one char per layer")
        if not re.match(r"^[*\-M]+$", self.hybrid_override_pattern):
            raise ValueError(f"bad hybrid_override_pattern {self.hybrid_override_pattern!r}")
        for st in self.pdrop_stages:
            # the JAX package meets such a stage only inside the forward, as
            # a KeyError of the missing q/k projections
            if st.compress_type == "attn" and st.layer not in self.attention_layer_indices:
                raise ValueError(f"pdrop stage {st}: an attn stage ranks with its layer's q/k "
                                 f"projections, and layer {st.layer} is not an attention "
                                 f"layer {self.attention_layer_indices}")

    @property
    def mamba_intermediate_size(self) -> int:
        return self.mamba_num_heads * self.mamba_head_dim

    @property
    def conv_dim(self) -> int:
        return self.mamba_intermediate_size + 2 * self.mamba_n_groups * self.ssm_state_size

    @property
    def layers_block_type(self) -> Tuple[str, ...]:
        return tuple({"M": "mamba", "*": "attention", "-": "mlp"}[c]
                     for c in self.hybrid_override_pattern)

    @property
    def attention_layer_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, c in enumerate(self.hybrid_override_pattern) if c == "*")

    @property
    def mamba_layer_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, c in enumerate(self.hybrid_override_pattern) if c == "M")

    @property
    def pdrop_stages(self) -> Tuple[PdropStage, ...]:
        if not self.use_pdrop or self.pdrop_type is None:
            return ()
        return parse_pdrop_type(self.pdrop_type)


def tiny_nano_config(**overrides) -> NanoConfig:
    """A tiny Nano config for tests (same structure, small dims)."""
    base = dict(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=6,
        hybrid_override_pattern="M-M*M-", num_attention_heads=4, head_dim=16,
        num_key_value_heads=2, ssm_state_size=16, mamba_num_heads=8, mamba_n_groups=2,
        mamba_head_dim=8, chunk_size=16,
    )
    base.update(overrides)
    return NanoConfig(**base)


# ---------------------------------------------------------------------------
# Vision backbone
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ViTConfig:
    """ViT config (SigLIP and DINOv2). Features come from the penultimate block."""

    image_size: int = 384
    patch_size: int = 14
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    layer_norm_eps: float = 1e-6
    use_class_token: bool = False
    num_register_tokens: int = 0
    qkv_bias: bool = True
    hidden_act: str = "gelu_tanh"
    use_layer_scale: bool = False
    layer_scale_init: float = 1e-5

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.use_class_token else 0) + self.num_register_tokens


SIGLIP_SO400M_384 = ViTConfig(
    image_size=384, patch_size=14, hidden_size=1152, intermediate_size=4304,
    num_hidden_layers=27, num_attention_heads=16, use_class_token=False,
    hidden_act="gelu_tanh",
)
SIGLIP_SO400M_224 = dataclasses.replace(SIGLIP_SO400M_384, image_size=224)
SIGLIP_B16_384 = ViTConfig(
    image_size=384, patch_size=16, hidden_size=768, intermediate_size=3072,
    num_hidden_layers=12, num_attention_heads=12, use_class_token=False,
    hidden_act="gelu_tanh",
)
SIGLIP_B16_256 = dataclasses.replace(SIGLIP_B16_384, image_size=256)
SIGLIP_B16_224 = dataclasses.replace(SIGLIP_B16_384, image_size=224)
DINOV2_L_384 = ViTConfig(
    image_size=384, patch_size=14, hidden_size=1024, intermediate_size=4096,
    num_hidden_layers=24, num_attention_heads=16, use_class_token=True,
    num_register_tokens=4, hidden_act="gelu", use_layer_scale=True,
)


def tiny_vit_config(**overrides) -> ViTConfig:
    base = dict(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
                num_hidden_layers=3, num_attention_heads=2)
    base.update(overrides)
    return ViTConfig(**base)


@dataclass(frozen=True)
class InternVideo2Config:
    """InternVideo2-1B video-native ViT-g: clips of `num_frames` frames, a
    tubelet patch embedding, a CLS token and 3-D sin-cos positions; features
    from block `effective_depth` - 1 (39 of 40 for x_vis_return_idx -2)."""

    image_size: int = 224
    patch_size: int = 14
    tubelet_size: int = 1
    num_frames: int = 4
    hidden_size: int = 1408
    intermediate_size: int = 6144  # mlp_ratio 48/11 * 1408
    num_hidden_layers: int = 40
    num_attention_heads: int = 16
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = False
    x_vis_return_idx: int = -2
    use_checkpoint: bool = False
    # the CLIP-aligned attention-pooling head of full checkpoints (not ported)
    clip_embed_dim: int = 768
    attn_pool_num_heads: int = 16
    # checkpoints are pretrained at 8 temporal positions
    pretrain_t_size: int = 8

    @property
    def effective_depth(self) -> int:
        return self.num_hidden_layers + self.x_vis_return_idx + 1

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def hidden_act(self) -> str:
        return "gelu"


# ---------------------------------------------------------------------------
# Registries (string ids -> configs)
# ---------------------------------------------------------------------------

VISION_MODEL_REGISTRY: Dict[str, Dict[str, Any]] = {
    "siglip-vit-b16-224px": {"family": "siglip", "config": SIGLIP_B16_224},
    "siglip-vit-b16-256px": {"family": "siglip", "config": SIGLIP_B16_256},
    "siglip-vit-b16-384px": {"family": "siglip", "config": SIGLIP_B16_384},
    "siglip-vit-so400m": {"family": "siglip", "config": SIGLIP_SO400M_224},
    "siglip-vit-so400m-384px": {"family": "siglip", "config": SIGLIP_SO400M_384},
    "dinov2-vit-l": {"family": "dinov2", "config": DINOV2_L_384},
    "internvideo2-1b-16-224px": {"family": "internvideo2", "config": InternVideo2Config()},
    "dinosiglip-vit-so-384px": {"family": "multi",
                                "backbones": ["dinov2-vit-l", "siglip-vit-so400m-384px"]},
    "debug-vit-tiny": {"family": "siglip", "config": tiny_vit_config()},
}

LLM_MODEL_REGISTRY: Dict[str, Dict[str, Any]] = {
    "nano-9b-v2": {"family": "nano", "config": NanoConfig()},
    "nano-9b-v2-base": {"family": "nano", "config": NanoConfig()},
    "nemotron-h-8b-base": {"family": "nano", "config": NanoConfig(num_hidden_layers=52)},
    "debug-nano-tiny": {"family": "nano", "config": tiny_nano_config(vocab_size=128)},
    # not built by the port
    "qwen2.5-7b-instruct": {"family": "qwen2", "config": None},
    "qwen2.5-7b-base": {"family": "qwen2", "config": None},
    "qwen2.5-3b-instruct": {"family": "qwen2", "config": None},
    "qwen2-7b": {"family": "qwen2", "config": None},
    "qwen2-1.5b": {"family": "qwen2", "config": None},
}


def get_vision_backbone_config(vision_backbone_id: str) -> Dict[str, Any]:
    """Resolve a vision backbone id; `"a+b"` names a multi-tower encoder."""
    if "+" in vision_backbone_id:
        for b in vision_backbone_id.split("+"):
            if b not in VISION_MODEL_REGISTRY:
                raise ValueError(f"Vision backbone `{b}` is not supported!")
        return {"family": "multi", "backbones": vision_backbone_id.split("+"),
                "identifier": vision_backbone_id}
    if vision_backbone_id not in VISION_MODEL_REGISTRY:
        raise ValueError(f"Vision backbone `{vision_backbone_id}` is not supported!")
    entry = dict(VISION_MODEL_REGISTRY[vision_backbone_id])
    entry["identifier"] = vision_backbone_id
    return entry


def get_llm_backbone_config(llm_backbone_id: str) -> Dict[str, Any]:
    if llm_backbone_id not in LLM_MODEL_REGISTRY:
        raise ValueError(f"LLM backbone `{llm_backbone_id}` is not supported!")
    entry = dict(LLM_MODEL_REGISTRY[llm_backbone_id])
    entry["identifier"] = llm_backbone_id
    return entry


# ---------------------------------------------------------------------------
# VLM
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VLMConfig:
    """Top-level VLM assembly config. `arch_specifier` is e.g. ``"tome_mlp-16"``
    (ToMe to 16 tokens per frame, then an MLP) or ``"gelu_mlp"``."""

    model_id: str = "timeviper"
    vision_backbone_id: str = "siglip-vit-so400m-384px"
    llm_backbone_id: str = "nano-9b-v2"
    arch_specifier: str = "tome_mlp-16"
    visual_token_order: str = "raw"  # raw | ascending | descending
    image_token: str = "<image>"
    disable_data_packing: bool = False

    @property
    def num_compressed_tokens(self) -> int:
        parts = self.arch_specifier.split("-")
        return int(parts[-1]) if parts[-1].isdigit() else -1

    @property
    def projector_type(self) -> str:
        return self.arch_specifier.split("-")[0]
