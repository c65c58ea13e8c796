"""The port's own copies of the JAX package's JAX-free modules equal the
originals: timeviper_tpu_torch/config.py (every registry entry the port
builds, field for field, and the pdrop micro-DSL) and
timeviper_tpu_torch/data/fusion.py (plans and fused labels on several
layouts). The port imports neither original."""

from dataclasses import asdict

import numpy as np
import pytest

from timeviper_tpu import config as jcfg
from timeviper_tpu.data import fusion as jfusion
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.data import fusion as tfusion

VISION_IDS = [k for k, v in tcfg.VISION_MODEL_REGISTRY.items() if v["family"] == "siglip"]
LLM_IDS = [k for k, v in tcfg.LLM_MODEL_REGISTRY.items() if v["family"] == "nano"]


@pytest.mark.parametrize("vid", VISION_IDS)
def test_vision_registry_matches(vid):
    got, want = tcfg.get_vision_backbone_config(vid), jcfg.get_vision_backbone_config(vid)
    assert got["family"] == want["family"] == "siglip"
    assert asdict(got["config"]) == asdict(want["config"])
    assert got["config"].num_patches == want["config"].num_patches


@pytest.mark.parametrize("lid", LLM_IDS)
def test_llm_registry_matches(lid):
    got, want = tcfg.get_llm_backbone_config(lid), jcfg.get_llm_backbone_config(lid)
    assert got["family"] == want["family"] == "nano"
    g, w = got["config"], want["config"]
    assert asdict(g) == asdict(w)
    assert (g.layers_block_type, g.mamba_intermediate_size, g.conv_dim) == (
        w.layers_block_type, w.mamba_intermediate_size, w.conv_dim)


def test_unported_ids_keep_their_family_and_tiny_configs_match():
    for reg_t, reg_j in ((tcfg.VISION_MODEL_REGISTRY, jcfg.VISION_MODEL_REGISTRY),
                         (tcfg.LLM_MODEL_REGISTRY, jcfg.LLM_MODEL_REGISTRY)):
        assert set(reg_t) == set(reg_j)
        assert all(reg_t[k]["family"] == reg_j[k]["family"] for k in reg_t)
    assert asdict(tcfg.tiny_nano_config(mamba_n_groups=8)) == asdict(
        jcfg.tiny_nano_config(mamba_n_groups=8))
    assert asdict(tcfg.tiny_vit_config()) == asdict(jcfg.tiny_vit_config())
    for spec in ("tome_mlp-16", "gelu_mlp", "tome_mlp-2"):
        a, b = tcfg.VLMConfig(arch_specifier=spec), jcfg.VLMConfig(arch_specifier=spec)
        assert asdict(a) == asdict(b)
        assert (a.num_compressed_tokens, a.projector_type) == (
            b.num_compressed_tokens, b.projector_type)
    with pytest.raises(ValueError):
        tcfg.get_llm_backbone_config("no-such-model")


@pytest.mark.parametrize("pdrop_type", ["uni_14_0.8-attn_18_0.6", "uni_1_0.5",
                                        "attn_7_0.25-uni_40_0.9"])
def test_pdrop_dsl_matches(pdrop_type):
    """parse_pdrop_type, PdropStage and NanoConfig.pdrop_stages, copied from
    timeviper_tpu/config.py:18-45, :131-134, on the 9B (its attention layers
    are 7, 18, 29, 40)."""
    got, want = tcfg.parse_pdrop_type(pdrop_type), jcfg.parse_pdrop_type(pdrop_type)
    assert [asdict(s) for s in got] == [asdict(s) for s in want]
    kw = dict(use_pdrop=True, pdrop_type=pdrop_type, merge_module="CrossAttention")
    g, w = tcfg.NanoConfig(**kw), jcfg.NanoConfig(**kw)
    assert asdict(g) == asdict(w)
    assert [asdict(s) for s in g.pdrop_stages] == [asdict(s) for s in w.pdrop_stages]
    assert tcfg.NanoConfig(pdrop_type=pdrop_type).pdrop_stages == ()  # use_pdrop off


IMG = 500
LAYOUTS = [
    # (input_ids, tokens_per_frame, txt_seq_lens)
    ([5, 6, 7, 8], 4, None),                                    # text only
    ([5, IMG, IMG, IMG, 9, 10], 3, None),                       # one clip
    ([IMG, IMG, 9, 10, 11, 12, 13], 16, None),                  # frames first
    ([5, IMG, IMG, 9, 1, 2, IMG, 3, 4], 2, [4, 5]),            # packed, two samples
    ([5, 6, 7, IMG, 9, 10, 11, 12], 5, [3, 5]),                # packed, text-only first
]


@pytest.mark.parametrize("ids,tpf,lens", LAYOUTS)
def test_plan_fusion_and_fuse_labels_match(ids, tpf, lens):
    got = tfusion.plan_fusion(ids, IMG, tpf, lens)
    want = jfusion.plan_fusion(ids, IMG, tpf, lens)
    for f in ("fused_len", "text_len", "num_visual", "sample_layouts"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("gather_idx", "is_visual", "position_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.seq_idx is None) == (want.seq_idx is None)
    if got.seq_idx is not None:
        np.testing.assert_array_equal(got.seq_idx, want.seq_idx)
    labels = np.random.default_rng(len(ids)).integers(0, 100, len(ids))
    labels[:2] = tfusion.IGNORE_INDEX
    np.testing.assert_array_equal(tfusion.fuse_labels(got, labels),
                                  jfusion.fuse_labels(want, labels))
    assert tfusion.IGNORE_INDEX == jfusion.IGNORE_INDEX


@pytest.mark.parametrize("vid", ["dinov2-vit-l", "internvideo2-1b-16-224px",
                                 "dinosiglip-vit-so-384px"])
def test_other_vision_registry_entries_match(vid):
    """The DINOv2 and InternVideo2 configs field for field, their derived
    sizes, and the two-tower entry's backbone ids."""
    got, want = tcfg.get_vision_backbone_config(vid), jcfg.get_vision_backbone_config(vid)
    assert got["family"] == want["family"]
    assert got.get("backbones") == want.get("backbones")
    if "config" in want:
        g, w = got["config"], want["config"]
        assert type(g).__name__ == type(w).__name__
        assert asdict(g) == asdict(w)
        props = ("grid_size", "hidden_act") + (
            ("effective_depth",) if vid.startswith("internvideo2") else
            ("num_patches", "num_prefix_tokens"))
        assert [getattr(g, p) for p in props] == [getattr(w, p) for p in props]
    for lid in ("qwen2-7b", "qwen2.5-3b-instruct"):
        assert tcfg.get_llm_backbone_config(lid)["config"] is None
