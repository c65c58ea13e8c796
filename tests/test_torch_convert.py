"""The port's checkpoint converter (timeviper_tpu_torch/train/convert.py)
against the JAX package's: a reference-layout state dict made from a numpy
seed goes through JAX's `convert_vlm_checkpoint` + params.py:from_jax_numpy
and through the port's `convert_vlm_checkpoint`; the two state_dicts must
hold the same keys, dtypes and bits, in float32 and in bfloat16, and load
into the port's model with strict=True. JAX's converters are numpy: nothing
here compiles.

The reference layouts come from `chip_smoke.py:reference_state_dict` (the
inverse of the port's converter, which the card's checkpoint phase writes
with), so each case also holds the round trip: the port's f32 conversion
gives back the state_dict the reference was made from."""

import datetime

import numpy as np
import pytest
import torch
from torch_parity import rng

import jax.numpy as jnp
from chip_smoke import reference_state_dict
from timeviper_tpu.train import convert as jconv
from timeviper_tpu_torch import config as tcfg
from timeviper_tpu_torch.config import VLMConfig
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.params import from_jax_numpy, merge_state_dict
from timeviper_tpu_torch.train import convert as tconv

DTYPES = {"f32": (torch.float32, np.dtype("float32")),
          "bf16": (torch.bfloat16, np.dtype(jnp.bfloat16))}
VLM2 = VLMConfig(arch_specifier="tome_mlp-2")
DINO = dict(use_class_token=True, num_register_tokens=2, use_layer_scale=True,
            hidden_act="gelu")
PDROP = dict(use_pdrop=True, pdrop_type="uni_2_0.8-attn_3_0.6", merge_module="CrossAttention")


def _iv2():
    return tcfg.InternVideo2Config(image_size=28, patch_size=14, num_frames=2, hidden_size=32,
                                   intermediate_size=64, num_hidden_layers=3,
                                   num_attention_heads=2, x_vis_return_idx=-2)


def _arch(case: str) -> VLMArch:
    vit, nano = tcfg.tiny_vit_config(), tcfg.tiny_nano_config()
    if case == "nano":
        return VLMArch(vlm=VLM2, vision=vit, llm=nano)
    if case == "nano_tied":
        return VLMArch(vlm=VLM2, vision=vit, llm=tcfg.tiny_nano_config(tie_word_embeddings=True))
    if case == "qwen2":
        return VLMArch(vlm=VLM2, vision=vit, llm=tcfg.tiny_qwen2_config(), llm_family="qwen2")
    if case == "qwen2_tied":
        return VLMArch(vlm=VLM2, vision=vit, llm_family="qwen2",
                       llm=tcfg.tiny_qwen2_config(tie_word_embeddings=True))
    if case == "dinov2":
        return VLMArch(vlm=VLM2, vision=tcfg.tiny_vit_config(**DINO), llm=nano,
                       vision_family="dinov2")
    if case in ("iv2", "iv2_gamma", "iv2_interp", "iv2_pool"):
        return VLMArch(vlm=VLM2, vision=_iv2(), llm=nano, vision_family="internvideo2")
    if case == "fused_projector":
        return VLMArch(vlm=VLMConfig(arch_specifier="fused_tome_mlp-2"), vision=vit, llm=nano)
    if case == "multi":
        towers = (("tiny-a", "siglip", vit), ("tiny-b", "dinov2", tcfg.tiny_vit_config(**DINO)))
        return VLMArch(vlm=VLM2, vision=vit, llm=nano, vision_family="multi",
                       vision_backbones=towers)
    if case == "transv":
        return VLMArch(vlm=VLM2, vision=vit, llm=tcfg.tiny_nano_config(**PDROP))
    raise KeyError(case)


def _source(arch: VLMArch, seed: int):
    """The port's state_dict with every tensor drawn from the seed, and the
    reference state dict made from it (numpy f32 for JAX, torch for the
    port)."""
    shapes = TimeViperVLM(arch, torch.float32, device="meta").state_dict()
    r = rng(seed)
    src = {k: torch.from_numpy(r.standard_normal(v.shape).astype(np.float32))
           for k, v in shapes.items()}
    return src, {k: v.contiguous() for k, v in reference_state_dict(src, arch).items()}


def _edit(case: str, arch: VLMArch, ref: dict, seed: int) -> dict:
    """The layout variants the converters take besides the plain one."""
    r = rng(seed + 1)
    pre = "vision_backbone.featurizer."
    if case == "nano_tied":  # the pre-load_hook name, and a stored lm_head
        ref["llm_backbone.llm.backbone.embedding.weight"] = ref.pop(
            "llm_backbone.llm.backbone.embeddings.weight")
        ref["llm_backbone.llm.lm_head.weight"] = torch.ones(
            arch.llm.vocab_size, arch.llm.hidden_size)
    if case == "iv2_gamma":  # timm-style LayerScale
        for k in [k for k in ref if k.endswith((".ls1.weight", ".ls2.weight"))]:
            ref[k.replace(".weight", ".gamma")] = ref.pop(k)
    if case == "iv2_interp":  # a table at the 8 pretraining positions
        cfg = arch.vision
        ref[f"{pre}pos_embed"] = torch.from_numpy(r.standard_normal(
            (1, 8 * cfg.grid_size ** 2 + 1, cfg.hidden_size)).astype(np.float32))
    if case == "iv2_pool":  # the clip projector, without a q bias
        d, e = arch.vision.hidden_size, arch.vision.clip_embed_dim
        cp = f"{pre}clip_projector."
        for name in ("norm1_q", "norm1_k", "norm1_v"):
            ref[f"{cp}{name}.weight"] = torch.from_numpy(r.standard_normal(d).astype(np.float32))
            ref[f"{cp}{name}.bias"] = torch.from_numpy(r.standard_normal(d).astype(np.float32))
        for name, shape in (("q.weight", (d, d)), ("k.weight", (d, d)), ("v.weight", (d, d)),
                            ("proj.weight", (e, d)), ("k_bias", d), ("v_bias", d),
                            ("proj.bias", e)):
            ref[f"{cp}cross_attn.{name}"] = torch.from_numpy(
                r.standard_normal(shape).astype(np.float32))
    return ref


def _jax_state_dict(ref: dict, arch: VLMArch, np_dtype) -> dict:
    sd = {k: v.numpy() for k, v in ref.items()}
    tree = jconv.convert_vlm_checkpoint(sd, arch, dtype=np_dtype)
    if arch.llm.merge_module == "CrossAttention":
        llm = {k[len("llm_backbone.llm."):]: v for k, v in sd.items()
               if k.startswith("llm_backbone.llm.")}
        tree["merge_modules"] = jconv.convert_nano_merge_modules(llm, arch.llm, np_dtype)
    return from_jax_numpy(tree, arch)


CASES = ["nano", "nano_tied", "qwen2", "qwen2_tied", "dinov2", "iv2", "iv2_gamma",
         "iv2_interp", "iv2_pool", "fused_projector", "multi", "transv"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_convert_matches_jax_bitwise(case, dtype):
    arch = _arch(case)
    tdt, ndt = DTYPES[dtype]
    src, ref = _source(arch, seed=CASES.index(case))
    ref = _edit(case, arch, ref, seed=CASES.index(case))
    got = tconv.convert_vlm_checkpoint(ref, arch, dtype=tdt)
    want = _jax_state_dict(ref, arch, ndt)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert got[k].shape == want[k].shape, (k, got[k].shape, want[k].shape)
        assert torch.equal(got[k], want[k]), k
    if case == "iv2_pool":  # the pooling head loads into a tower built with it
        from timeviper_tpu_torch.models.internvideo2 import InternVideo2

        tower = InternVideo2(arch.vision, tdt, "cpu", attn_pool=True)
        tower.load_state_dict({k[len("vision_backbone."):]: v for k, v in got.items()
                               if k.startswith("vision_backbone.")}, strict=True)
        return
    TimeViperVLM(arch, tdt, device="cpu").load_state_dict(got, strict=True)
    if dtype == "f32" and case not in ("iv2_interp", "nano_tied"):
        assert sorted(got) == sorted(src)
        assert all(torch.equal(got[k], src[k]) for k in src)


def test_jax_whole_vlm_converter_drops_the_merge_modules():
    """The fault the port did not copy: JAX's convert_vlm_checkpoint never
    calls convert_nano_merge_modules, so a TransV checkpoint loads without
    its merge modules there (and its Generator then serves without the
    transfer); the port's converter loads them."""
    arch = _arch("transv")
    src, ref = _source(arch, seed=7)
    tree = jconv.convert_vlm_checkpoint({k: v.numpy() for k, v in ref.items()}, arch)
    assert "merge_modules" not in tree
    got = tconv.convert_vlm_checkpoint(ref, arch)
    merge = {k: v for k, v in got.items() if k.startswith("merge_modules.")}
    assert sorted(merge) == sorted(k for k in src if k.startswith("merge_modules."))
    assert all(torch.equal(v, src[k]) for k, v in merge.items())
    assert {k.split(".")[1] for k in merge} == {"0", "1"}


def test_convert_keeps_the_file_dtype_without_a_cast():
    """dtype=None (the loader's path): every leaf as the file stores it,
    bf16 weights as bf16 and an f32 norm as f32, with no copy of a
    renamed tensor."""
    arch = _arch("nano")
    _, ref = _source(arch, seed=3)
    ref = {k: (v.to(torch.bfloat16) if v.ndim >= 2 else v) for k, v in ref.items()}
    got = tconv.convert_vlm_checkpoint(ref, arch, dtype=None)
    for k, v in got.items():
        assert v.dtype == (torch.bfloat16 if v.ndim >= 2 else torch.float32), k
    emb = "llm_backbone.embeddings.weight"
    assert got[emb].data_ptr() == ref["llm_backbone.llm.backbone.embeddings.weight"].data_ptr()


def test_merge_modules_of_a_jax_list_bridge_the_same():
    """The port's merge converter against JAX's per-stage list through
    params.py:merge_state_dict, in bf16 (alpha stays f32)."""
    arch = _arch("transv")
    _, ref = _source(arch, seed=9)
    llm = {k[len("llm_backbone.llm."):]: v for k, v in ref.items()
           if k.startswith("llm_backbone.llm.")}
    got = tconv.convert_nano_merge_modules(llm, arch.llm, torch.bfloat16)
    want = merge_state_dict(jconv.convert_nano_merge_modules(
        {k: v.numpy() for k, v in llm.items()}, arch.llm, np.dtype(jnp.bfloat16)))
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
    assert got["0.alpha"].dtype == torch.float32


def test_load_torch_state_dict_reads_bin_and_safetensors(tmp_path, monkeypatch):
    """A torch zip file comes back memory-mapped and as stored; a
    .safetensors file through its reader; a file that needs unpickling is
    refused unless TIMEVIPER_UNSAFE_TORCH_LOAD=1, as in the JAX package."""
    sd = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3), "b": torch.ones(3)}
    torch.save({"model": sd}, tmp_path / "w.bin")
    got = tconv.load_torch_state_dict(str(tmp_path / "w.bin"))
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    assert got["a"].dtype == torch.bfloat16
    from safetensors.torch import save_file

    save_file(sd, str(tmp_path / "w.safetensors"))
    got = tconv.load_torch_state_dict(str(tmp_path / "w.safetensors"))
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    torch.save({"a": sd["a"], "saved": datetime.date(2020, 1, 1)}, tmp_path / "p.bin")
    monkeypatch.delenv("TIMEVIPER_UNSAFE_TORCH_LOAD", raising=False)
    with pytest.raises(RuntimeError, match="TIMEVIPER_UNSAFE_TORCH_LOAD"):
        tconv.load_torch_state_dict(str(tmp_path / "p.bin"))
    monkeypatch.setenv("TIMEVIPER_UNSAFE_TORCH_LOAD", "1")
    assert torch.equal(tconv.load_torch_state_dict(str(tmp_path / "p.bin"))["a"], sd["a"])
