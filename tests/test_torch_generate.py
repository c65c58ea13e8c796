"""The whole slice: JAX-initialised weights, bridged with from_jax_numpy;
JAX Generator.generate and the port's Generator.generate on the same prompt
(<image> tokens plus seeded pixels, greedy, 5 new tokens) give the same ids
and first-token logits. Tiny sizes, f32; tolerance 1e-3 on the logits (the
band chunked-vs-sequential SSD orderings leave after several layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, rng

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.models import generate as jax_gen
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy

IMG = 500


@pytest.mark.parametrize("n_frames", [0, 3])
def test_generate_matches_jax(n_frames):
    vlm = VLMConfig(arch_specifier="tome_mlp-2")
    arch = VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=tiny_nano_config())
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=arch.vision, llm=arch.llm, llm_family="nano")
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))

    ids = [5, 6] + [IMG] * n_frames + [9, 10, 11]
    pixels = rng(1).random((n_frames, 28, 28, 3), np.float32) if n_frames else None
    jg = jax_gen.Generator(params, jarch, terminator_ids=[-2], pad_token_id=0,
                           max_new_tokens=5, cache_dtype=jnp.float32)
    want = jg.generate(ids, pixels=pixels, image_token_id=IMG)
    tg = Generator(model, arch, terminator_ids=[-2], pad_token_id=0, max_new_tokens=5)
    got = tg.generate(ids, pixels=pixels, image_token_id=IMG)
    assert got.token_ids.tolist() == want.token_ids.tolist()
    assert got.num_generated == want.num_generated == 5

    # the prompt layout and the first-token logits of the JAX prefill
    plan, bucket, pad, ids_arr, gidx, seq = jg._plan_prompt(ids, IMG)
    mine = tg._plan_prompt(ids, IMG)
    assert (bucket, pad) == mine[1:3]
    for a, b in zip((ids_arr, gidx, seq), mine[3:]):
        np.testing.assert_array_equal(a, b)
    visual = (jg.encode_frames(pixels) if n_frames
              else jnp.zeros((0, arch.llm.hidden_size), jnp.float32))
    first, _ = jg._get_prefill(bucket, bucket + 5)(
        params, jnp.asarray(ids_arr), jnp.asarray(gidx), jnp.asarray(seq), visual, pad)
    np.testing.assert_allclose(n(got.first_logits), n(first), rtol=1e-3, atol=1e-3)


def test_generate_stops_at_a_terminator():
    vlm = VLMConfig(arch_specifier="tome_mlp-2")
    arch = VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=tiny_nano_config())
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.llm_backbone.reset_parameters(torch.Generator().manual_seed(0))
    probe = Generator(model, arch, terminator_ids=[], max_new_tokens=4).generate([5, 6, 7])
    first = int(probe.token_ids[0])
    out = Generator(model, arch, terminator_ids=[first], max_new_tokens=4).generate([5, 6, 7])
    assert out.token_ids.tolist() == [first] and out.num_generated == 1
