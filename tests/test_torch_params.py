"""The weights bridge (params.py:from_jax_numpy): a JAX-initialised VLM
pytree becomes the port's state_dict, key for key, as owned copies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n

from timeviper_tpu.config import InternVideo2Config as JaxIV2Config
from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.models.vlm import VLMArch as JaxArch
from timeviper_tpu.models.vlm import init_vlm_params as jax_init_vlm_params
from timeviper_tpu_torch.config import InternVideo2Config as PortIV2Config
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy, to_tensor

VLM = VLMConfig(arch_specifier="tome_mlp-2")


def test_from_jax_numpy_fills_every_weight():
    arch = VLMArch(vlm=VLM, vision=tiny_vit_config(), llm=tiny_nano_config())
    jarch = JaxArch(vlm=VLM, vision=arch.vision, llm=arch.llm, llm_family="nano")
    params = jax_init_vlm_params(jax.random.PRNGKey(0), jarch, jnp.bfloat16)
    model = TimeViperVLM(arch, torch.bfloat16, device="cpu")
    sd = from_jax_numpy(params, arch)
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    lm = params["llm_backbone"]
    mamba = lm["layers"][0]["mixer"]
    # (in, out) kernels become (out, in) weights; bf16 stays bf16
    w = model.llm_backbone.layers[0].mixer.in_proj["x"].weight
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(w), n(jnp.asarray(mamba["in_proj"]["x"]["kernel"]).T))
    np.testing.assert_array_equal(n(model.llm_backbone.layers[0].mixer.conv1d["B"].weight),
                                  n(mamba["conv1d"]["B"]["weight"]))
    pe = params["vision_backbone"]["patch_embed"]["kernel"]
    np.testing.assert_array_equal(n(model.vision_backbone.patch_embed.weight),
                                  n(jnp.asarray(pe).reshape(-1, pe.shape[-1]).T))
    # the penultimate-feature tower is built without its last block
    assert len(model.vision_backbone.layers) == arch.vision.num_hidden_layers - 1


def test_to_tensor_owns_its_memory():
    leaf = jnp.arange(6, dtype=jnp.float32)
    out = to_tensor(leaf)
    out += 1  # a read-only view of the JAX buffer would raise here
    np.testing.assert_array_equal(np.asarray(leaf), np.arange(6))


TINY_IV2 = dict(image_size=28, patch_size=14, num_frames=2, hidden_size=32,
                intermediate_size=64, num_hidden_layers=3, num_attention_heads=2)


@pytest.mark.parametrize("family", ["internvideo2", "dinov2", "multi"])
def test_from_jax_numpy_fills_every_weight_of_the_other_towers(family):
    """InternVideo2 (every one of its effective_depth blocks, q/k norms,
    LayerScale, CLS, the sin-cos table), DINOv2 (CLS, registers, LayerScale)
    and a two-tower pytree (a tower and a projector per backbone key)."""
    dino = tiny_vit_config(use_class_token=True, num_register_tokens=2, use_layer_scale=True,
                           hidden_act="gelu")
    if family == "internvideo2":
        kw = dict(vision=JaxIV2Config(**TINY_IV2), vision_family=family)
        pkw = dict(vision=PortIV2Config(**TINY_IV2), vision_family=family)
    elif family == "dinov2":
        kw = pkw = dict(vision=dino, vision_family=family)
    else:
        towers = (("tiny-a", "siglip", tiny_vit_config()), ("tiny-b", "dinov2", dino))
        kw = pkw = dict(vision=towers[0][2], vision_family=family, vision_backbones=towers)
    jarch = JaxArch(vlm=VLM, llm=tiny_nano_config(), llm_family="nano", **kw)
    arch = VLMArch(vlm=VLM, llm=tiny_nano_config(), **pkw)
    params = jax_init_vlm_params(jax.random.PRNGKey(0), jarch, jnp.bfloat16)
    model = TimeViperVLM(arch, torch.bfloat16, device="cpu")
    missing, unexpected = model.load_state_dict(from_jax_numpy(params, arch), strict=True)
    assert not missing and not unexpected
    if family == "internvideo2":
        vb = params["vision_backbone"]
        assert len(model.vision_backbone.layers) == len(vb["layers"]) == 2
        np.testing.assert_array_equal(n(model.vision_backbone.pos_embed), n(vb["pos_embed"]))
        np.testing.assert_array_equal(n(model.vision_backbone.patch_embed.weight),
                                      n(jnp.asarray(vb["patch_embed"]["kernel"]).T))
    elif family == "multi":
        assert set(model.projector) == set(params["projector"]) == {"tiny_a", "tiny_b"}
        assert model.vision_backbone["tiny_b"].reg_tokens.shape == (1, 2, 32)
