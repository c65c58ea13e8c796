"""The weights bridge (params.py:from_jax_numpy): a JAX-initialised VLM
pytree becomes the port's state_dict, key for key, as owned copies."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import n

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.models.vlm import VLMArch as JaxArch
from timeviper_tpu.models.vlm import init_vlm_params as jax_init_vlm_params
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
