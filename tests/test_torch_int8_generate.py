"""The W8A8 int8 serving slice: a tiny VLM (a ViT of width 128, so the fused
LayerNorm takes it; a Nano whose group channel block and state are 128, so
the fused decode step takes it, with chunks of 128 for the fused conv) is
quantized and calibrated in both packages, the JAX qparams (with the fused
in_proj leaf) are bridged across, and with the three fusions and both int8
switches on, the port's Generator.generate gives the JAX Generator's greedy
tokens, its first logits within 1e-3 of their largest magnitude (f32).

On the CPU the JAX package takes its unfused conv and decode paths (their
switches also ask for the TPU) and runs its fused LayerNorm in interpret
mode; the port takes the plain versions of its three fused calls, which the
test counts."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import n, rng, t

from timeviper_tpu.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu.models import generate as jax_gen
from timeviper_tpu.models import nano as jax_nano
from timeviper_tpu.models import vit as jax_vit
from timeviper_tpu.models import vlm as jax_vlm
from timeviper_tpu.train import quantize as jax_quant
from timeviper_tpu_torch.models import nano as nano_mod
from timeviper_tpu_torch.models import vit as vit_mod
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.nano import nano_forward
from timeviper_tpu_torch.models.vit import vit_forward
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy
from timeviper_tpu_torch.train.quantize import (
    calibrate_act_scales,
    fuse_decode_in_proj,
    quantize_params_int8,
)

IMG = 500
SWITCHES = ("TIMEVIPER_FUSED_CONV", "TIMEVIPER_FUSED_DECODE", "TIMEVIPER_VIT_FUSED_LN",
            "TIMEVIPER_LLM_INT8_MXU", "TIMEVIPER_VIT_INT8_MXU")


def _count(monkeypatch, module, name, calls):
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(name) or fn(*a, **k))


def test_int8_fused_generate_matches_jax(monkeypatch):
    for s in SWITCHES:
        monkeypatch.setenv(s, "1")
    vlm = VLMConfig(arch_specifier="tome_mlp-2")
    vcfg = tiny_vit_config(hidden_size=128, intermediate_size=256)
    lcfg = tiny_nano_config(mamba_num_heads=8, mamba_head_dim=32, ssm_state_size=128,
                            chunk_size=128)
    arch = VLMArch(vlm=vlm, vision=vcfg, llm=lcfg)
    jarch = jax_vlm.VLMArch(vlm=vlm, vision=vcfg, llm=lcfg, llm_family="nano")
    params = jax_vlm.init_vlm_params(jax.random.PRNGKey(0), jarch, jnp.float32)
    model = TimeViperVLM(arch, torch.float32, device="cpu")
    model.load_state_dict(from_jax_numpy(params, arch))

    r = rng(1)
    cal_px = r.random((3, 28, 28, 3), np.float32)
    cal_ids = r.integers(10, 400, (1, 40)).astype(np.int32)
    vq = jax_quant.calibrate_act_scales(
        lambda p, b: jax_vit.vit_forward(p, vcfg, b),
        jax_quant.quantize_params_int8(params["vision_backbone"], min_size=1),
        [jnp.asarray(cal_px)])
    lq = jax_quant.calibrate_act_scales(
        lambda p, b: jax_nano.nano_forward(p, lcfg, input_ids=b, logits_to_keep=1)["logits"],
        jax_quant.quantize_params_int8(params["llm_backbone"], min_size=1),
        [jnp.asarray(cal_ids)])
    qparams = dict(params, vision_backbone=vq, llm_backbone=jax_quant.fuse_decode_in_proj(lq))

    # the port's own quantize and calibration give the same scales, and the
    # modules the bridged JAX leaves load into
    vt, lt = model.vision_backbone, model.llm_backbone
    calibrate_act_scales(lambda m, b: vit_forward(m, vcfg, b),
                         quantize_params_int8(vt, min_size=1), [t(cal_px)])
    calibrate_act_scales(lambda m, b: nano_forward(m, lcfg, input_ids=b, logits_to_keep=1),
                         quantize_params_int8(lt, min_size=1), [t(cal_ids).long()])
    fuse_decode_in_proj(lt)
    sd = from_jax_numpy(qparams, arch)
    mine = model.state_dict()
    assert sd.keys() == mine.keys()
    for k, v in sd.items():
        if k.endswith("act_inv"):
            np.testing.assert_allclose(float(mine[k]), float(v), rtol=1e-5, err_msg=k)
    model.load_state_dict(sd)

    ids = [5, 6] + [IMG] * 3 + [9, 10, 11]
    pixels = r.random((3, 28, 28, 3), np.float32)
    jg = jax_gen.Generator(qparams, jarch, terminator_ids=[-2], pad_token_id=0,
                           max_new_tokens=5, cache_dtype=jnp.float32)
    want = jg.generate(ids, pixels=pixels, image_token_id=IMG)

    calls = []
    _count(monkeypatch, nano_mod, "ssd_conv_scan_fused", calls)
    _count(monkeypatch, nano_mod, "fused_mamba_decode", calls)
    _count(monkeypatch, vit_mod, "fused_ln", calls)
    tg = Generator(model, arch, terminator_ids=[-2], pad_token_id=0, max_new_tokens=5)
    got = tg.generate(ids, pixels=pixels, image_token_id=IMG)
    n_mamba = lcfg.layers_block_type.count("mamba")
    assert calls.count("ssd_conv_scan_fused") == n_mamba
    assert calls.count("fused_mamba_decode") == 4 * n_mamba  # 5 tokens, 4 decode steps
    assert calls.count("fused_ln") == 2 * (vcfg.num_hidden_layers - 1)
    assert got.token_ids.tolist() == want.token_ids.tolist()

    plan, bucket, pad, ids_arr, gidx, seq = jg._plan_prompt(ids, IMG)
    first, _ = jg._get_prefill(bucket, bucket + 5)(
        qparams, jnp.asarray(ids_arr), jnp.asarray(gidx), jnp.asarray(seq),
        jg.encode_frames(pixels), pad)
    err = np.abs(n(got.first_logits) - n(first)).max()
    assert err <= 1e-3 * np.abs(n(first)).max(), err
