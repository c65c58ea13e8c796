"""W8A8 serving on the qwen2 backbone against the JAX package, f32 on the
CPU: a tiny VLM (tiny SigLIP, `tome_mlp-2`) over tiny_qwen2_config, its
backbone quantized (min_size 4,096, so q_proj, o_proj and the MLP quantize
and the 2,048-element k_proj and v_proj stay as they are, q's bias riding
with its int8 leaf) and calibrated in both packages, the JAX int8 leaves
bridged across.

The JAX calibration is given a tree in its init's dict order
(tests/test_torch_int8_generate.py:jit_in_order): it pairs each captured
maximum with a leaf in dict order, which under a jitted init's sorted keys
would pair them with the wrong layers (ROADMAP Queue 3). The port records
each maximum against its module.

Checked: the set of quantized linears, every act_inv (1e-5), and the
Generator's greedy tokens and first logits against the JAX Generator's
(1e-3 of their largest magnitude, as the nano W8A8 test): weight-only (the
int8 switch "auto", which takes the dequantized weights on the CPU in both
packages) and W8A8 (TIMEVIPER_LLM_INT8_MXU=1 on both sides, the int8
product), with tied and untied embeddings (an int8 lm_head's f32 dequant,
or the embedding table)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_int8_generate import jit_in_order
from torch_parity import n, rng, t

from timeviper_tpu.config import VLMConfig, tiny_qwen2_config, tiny_vit_config
from timeviper_tpu.models import generate as jax_gen
from timeviper_tpu.models import qwen2 as jq
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.train import quantize as jax_quant
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.qwen2 import qwen2_forward
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.ops.int8_linear import Int8Linear
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.train.quantize import calibrate_act_scales, quantize_params_int8

IMG = 500
MIN_SIZE = 4096
KW = dict(terminator_ids=[-2], pad_token_id=0, max_new_tokens=5)


def _quantized_paths(tree, prefix=""):
    out = set()
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            out.add(prefix)
        for k, v in tree.items():
            out |= _quantized_paths(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out |= _quantized_paths(v, f"{prefix}.{i}")
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def quantized(request):
    tied = request.param
    vlm = VLMConfig(arch_specifier="tome_mlp-2", llm_backbone_id="qwen2.5-7b-instruct")
    lcfg = tiny_qwen2_config(tie_word_embeddings=tied)
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=tiny_vit_config(), llm=lcfg, llm_family="qwen2")
    arch = VLMArch(vlm=vlm, vision=tcfg.tiny_vit_config(),
                   llm=tcfg.tiny_qwen2_config(tie_word_embeddings=tied), llm_family="qwen2")
    params = jit_in_order(lambda key: jax_vlm.init_vlm_params(key, jarch, jnp.float32),
                          jax.random.PRNGKey(0))
    # the JAX quantize stays eager: under jax.jit its scales differ in the last bit
    lqp = jax_quant.quantize_params_int8(params["llm_backbone"], min_size=MIN_SIZE)
    cal_ids = rng(1).integers(10, 400, (1, 40)).astype(np.int32)
    lq = jax_quant.calibrate_act_scales(
        lambda p, b: jq.qwen2_forward(p, lcfg, input_ids=b, logits_to_keep=1)["logits"],
        lqp, [jnp.asarray(cal_ids)])
    qparams = dict(params, llm_backbone=lq)

    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))
    llm = quantize_params_int8(model.llm_backbone, min_size=MIN_SIZE)
    calibrate_act_scales(lambda m, b: qwen2_forward(m, arch.llm, input_ids=b, logits_to_keep=1),
                         llm, [t(cal_ids).long()])
    return arch, jarch, qparams, model


def test_the_same_linears_quantize_and_calibrate(quantized):
    arch, _, qparams, model = quantized
    mine = {name for name, m in model.llm_backbone.named_modules() if isinstance(m, Int8Linear)}
    want = _quantized_paths(qparams["llm_backbone"])
    assert mine == want
    assert "layers.0.self_attn.q_proj" in mine and "layers.0.self_attn.k_proj" not in mine
    assert ("lm_head" in mine) == (not arch.llm.tie_word_embeddings)
    assert model.llm_backbone.layers[0].self_attn.q_proj.bias is not None
    sd = from_jax_numpy(qparams, arch)
    state = model.state_dict()
    assert sd.keys() == state.keys()
    n_inv = 0
    for k, v in sd.items():
        if k.endswith("act_inv"):
            np.testing.assert_allclose(float(state[k]), float(v), rtol=1e-5, err_msg=k)
            n_inv += 1
    # every quantized linear the prefill reaches (not lm_head: its logits
    # take the f32 dequant, not the int8 product)
    assert n_inv == len(mine) - ("lm_head" in mine)


@pytest.mark.parametrize("int8_mxu", ["auto", "1"])
def test_w8a8_generate_matches_jax(quantized, int8_mxu, monkeypatch):
    monkeypatch.setenv("TIMEVIPER_LLM_INT8_MXU", int8_mxu)
    # the JAX Generator keeps its executables per arch across the process;
    # the switch is read when they are traced
    monkeypatch.setattr(jax_gen, "_EXECUTABLE_CACHE", {})
    arch, jarch, qparams, model = quantized
    model.load_state_dict(from_jax_numpy(qparams, arch))
    r = rng(2)
    ids = [5, 6] + [IMG] * 3 + [9, 10, 11]
    pixels = r.random((3, 28, 28, 3), np.float32)
    jg = jax_gen.Generator(qparams, jarch, cache_dtype=jnp.float32, **KW)
    want = jg.generate(ids, pixels=pixels, image_token_id=IMG)
    got = Generator(model, arch, **KW).generate(ids, pixels=pixels, image_token_id=IMG)
    assert got.token_ids.tolist() == want.token_ids.tolist()
    plan, bucket, pad, ids_arr, gidx, seq = jg._plan_prompt(ids, IMG)
    first, _ = jg._get_prefill(bucket, bucket + 5)(
        qparams, jnp.asarray(ids_arr), jnp.asarray(gidx), jnp.asarray(seq),
        jg.encode_frames(pixels), pad)
    err = np.abs(n(got.first_logits) - n(first)).max()
    assert err <= 1e-3 * np.abs(n(first)).max(), err
