"""Questions on a cached prefix: Generator.prefill_prefix, then
Generator.generate(prefix=...), against the JAX package's Generator on the
tiny VLM of tests/test_prefix_cache.py (tiny SigLIP, `tome_mlp-2`, the
6-layer `M-M*M-` backbone with chunk 16), JAX-initialised weights bridged
with from_jax_numpy, f32. The prefix holds text and two frames; two
questions of 3 and 12 tokens (one suffix bucket of 16 rows, the budget)
give the same greedy tokens, in either order, and the prefix serves both.
Both Generators raise the same ValueErrors: pixels with a prefix, an empty
suffix, a suffix bucket over the budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rng

from timeviper_tpu.config import NanoConfig, VLMConfig, tiny_vit_config
from timeviper_tpu.models import generate as jax_gen
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy

IMG = 200
LLM = NanoConfig(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=6,
                 hybrid_override_pattern="M-M*M-", num_attention_heads=2, head_dim=16,
                 num_key_value_heads=1, ssm_state_size=16, mamba_num_heads=4, mamba_n_groups=2,
                 mamba_head_dim=8, chunk_size=16)


def test_questions_on_a_prefix_match_jax():
    vlm = VLMConfig(arch_specifier="tome_mlp-2")
    arch = VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=LLM)
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=arch.vision, llm=LLM, llm_family="nano")
    params = jax.jit(jax_vlm.init_vlm_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jnp.float32)
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    kw = dict(terminator_ids=[-2], pad_token_id=0, max_new_tokens=4)
    jg = jax_gen.Generator(params, jarch, cache_dtype=jnp.float32, **kw)
    tg = Generator(model, arch, **kw)

    prefix_ids = [5, 6, IMG, IMG, 7, 8]
    pixels = rng(1).random((2, 28, 28, 3), np.float32)
    questions = [[13, 14, 15], list(range(20, 32))]
    jstate = jg.prefill_prefix(prefix_ids, pixels=pixels, image_token_id=IMG, suffix_budget=16)
    tstate = tg.prefill_prefix(prefix_ids, pixels=pixels, image_token_id=IMG, suffix_budget=16)
    assert (tstate.bucket, tstate.cache_len, tstate.suffix_budget, tstate.pad) == (
        jstate.bucket, jstate.cache_len, jstate.suffix_budget, jstate.pad)
    want = [jg.generate(q, prefix=jstate).token_ids.tolist() for q in questions]
    got = [tg.generate(q, prefix=tstate).token_ids.tolist() for q in questions[::-1]][::-1]
    assert got == want and all(len(w) == 4 for w in want)

    for args, match in (((questions[0], pixels), "prefix cache"), (([], None), "empty"),
                        ((list(range(20)), None), "suffix_budget")):
        for gen, state in ((jg, jstate), (tg, tstate)):
            with pytest.raises(ValueError, match=match):
                gen.generate(args[0], pixels=args[1], prefix=state)
