"""High-level model API: load a checkpoint, get a text-in / text-out model
(counterpart of timeviper_tpu/models/api.py).

The reference's equivalent is `GenericTimeViperVLM.from_pretrained`
(generic_vlm.py:874-910) + the registry factories (model/__init__.py:40-133).
A checkpoint directory contains:

* `config.json` — {"model_id", "vision_backbone_id", "llm_backbone_id",
  "arch_specifier", "conv_template", "use_pdrop", "pdrop_type",
  "merge_module"} (the keys the reference persists);
* the reference's torch weights, `.bin` / `.pt` / `.safetensors` files,
  converted on load (train/convert.py); an `orbax/` folder is the JAX
  package's own format and is refused;
* tokenizer files readable by HF AutoTokenizer.

`load_vlm_weights` is the weight half (config, convert, cast, load,
quantize); `load_pretrained_vlm` calls it, then reads the tokenizer and
builds the processor, the chat template and the Generator
(`assemble_model`). Both put the model on the card unless `device` names
another device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from timeviper_tpu_torch.config import (
    VLMConfig,
    get_llm_backbone_config,
    get_vision_backbone_config,
)
from timeviper_tpu_torch.data.conversation import CONV_TEMPLATES, ChatTemplate
from timeviper_tpu_torch.data.image_processing import transform_for_family
from timeviper_tpu_torch.data.processor import Processor
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.models.generate import Generator
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch
from timeviper_tpu_torch.ops.sampling import SamplingParams

WEIGHT_SUFFIXES = (".bin", ".pt", ".safetensors")


def build_arch(vlm_cfg: VLMConfig) -> VLMArch:
    """The static configs of a model id: the siglip, dinov2 and internvideo2
    towers, or several of them ("multi": a registry entry such as
    dinosiglip-vit-so-384px, or ids joined as "a+b"), with a nano or a qwen2
    backbone."""
    ventry = get_vision_backbone_config(vlm_cfg.vision_backbone_id)
    lentry = get_llm_backbone_config(vlm_cfg.llm_backbone_id)
    if ventry["family"] == "multi":
        towers = []
        for bid in ventry["backbones"]:
            sub = get_vision_backbone_config(bid)
            towers.append((bid, sub["family"], sub["config"]))
        return VLMArch(vlm=vlm_cfg, vision=towers[0][2], llm=lentry["config"],
                       llm_family=lentry["family"], vision_family="multi",
                       vision_backbones=tuple(towers))
    return VLMArch(vlm=vlm_cfg, vision=ventry["config"], llm=lentry["config"],
                   llm_family=lentry["family"], vision_family=ventry["family"])


@dataclass
class TimeViperModel:
    """Loaded VLM + processor + generation engine."""

    arch: VLMArch
    model: TimeViperVLM
    processor: Processor
    template: ChatTemplate
    generator: Generator
    default_use_pdrop: bool = False

    def prefill_video_prefix(self, input_ids: Sequence[int] | np.ndarray, pixels,
                             suffix_budget: int = 1024):
        """Prefill a shared `system + <video>` prefix once; returns a
        PrefixState reusable by generate(prefix=...) for every question on
        the same video (models/prefix_cache.py)."""
        return self.generator.prefill_prefix(
            list(np.asarray(input_ids).tolist()), pixels=pixels,
            image_token_id=self.processor.image_token_id, suffix_budget=suffix_budget,
            use_pdrop=self.default_use_pdrop)

    def generate(self, input_ids: Sequence[int] | np.ndarray, pixels=None,
                 answer_prompt: Optional[str] = None, rng_seed: int = 0,
                 use_pdrop: Optional[bool] = None, prefix=None) -> str:
        """One prompt -> decoded completion text. With `prefix`,
        `input_ids` is the post-video suffix only."""
        answer_ids = self.processor.tokenize(answer_prompt) if answer_prompt else None
        out = self.generator.generate(
            list(np.asarray(input_ids).tolist()), pixels=pixels,
            image_token_id=self.processor.image_token_id, answer_prompt_ids=answer_ids,
            use_pdrop=self.default_use_pdrop if use_pdrop is None else use_pdrop,
            rng_seed=rng_seed, prefix=prefix)
        toks = [int(t) for t in out.token_ids
                if t >= 0 and t not in self.processor.terminator_ids]
        return self.processor.decode(toks).strip()

    def chat(self, user_text: str, frames: Optional[np.ndarray] = None, **kw) -> str:
        nf = 0 if frames is None else frames.shape[0]
        prompt = self.template.prompt_for_generation(
            ("<image>" * nf + "\n" if nf else "") + user_text)
        enc = self.processor(prompt, videos=[list(frames)] if nf else None)
        return self.generate(enc["input_ids"], pixels=enc["pixels"], **kw)


def checkpoint_arch(checkpoint: str, use_pdrop: bool = False) -> Tuple[VLMArch, Dict[str, Any]]:
    """(arch, config.json) of a checkpoint directory. The pdrop settings
    persist on the checkpoint config, as the reference carries them on
    NemotronHConfig (configuration_nano.py:179)."""
    with open(os.path.join(checkpoint, "config.json")) as f:
        meta = json.load(f)
    arch = build_arch(VLMConfig(
        model_id=meta.get("model_id", "timeviper"),
        vision_backbone_id=meta.get("vision_backbone_id", "siglip-vit-so400m-384px"),
        llm_backbone_id=meta.get("llm_backbone_id", "nano-9b-v2"),
        arch_specifier=meta.get("arch_specifier", "tome_mlp-16")))
    if use_pdrop or meta.get("use_pdrop"):
        arch = dataclasses.replace(arch, llm=dataclasses.replace(
            arch.llm, use_pdrop=True,
            pdrop_type=meta.get("pdrop_type", arch.llm.pdrop_type),
            merge_module=meta.get("merge_module", arch.llm.merge_module)))
    return arch, meta


def _cast_rule(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The JAX loader's cast (timeviper_tpu/models/api.py:205-207): a leaf
    with ndim >= 2 in `dtype`, the rest in float32."""
    return t.to(dtype if t.ndim >= 2 else torch.float32)


@torch.no_grad()
def load_vlm_weights(checkpoint: str, use_pdrop: bool = False, dtype=torch.bfloat16,
                     quantize_int8: bool = False, device=None
                     ) -> Tuple[TimeViperVLM, VLMArch, Dict[str, Any]]:
    """The weight half of `load_pretrained_vlm`: config.json -> arch, every
    weight file of the directory (memory-mapped) -> train/convert.py ->
    the model on `device` (the card by default). Returns (model, arch,
    config.json).

    Each tensor takes the JAX loader's values (ndim >= 2 rounded to `dtype`,
    the rest float32) and is stored in the type the port's module keeps for
    it (a bf16 model keeps its norms, conv taps and position tables in
    float32 and its biases in bf16). The model is built on the meta device
    and its tensors are assigned one by one, so the device holds one copy
    of the weights while they load. `quantize_int8` swaps the backbone's
    linears for weight-only int8 ones (train/quantize.py)."""
    from timeviper_tpu_torch.train.convert import (
        convert_vlm_checkpoint,
        load_torch_state_dict,
    )

    device = resolve_device(device)
    arch, meta = checkpoint_arch(checkpoint, use_pdrop)
    if os.path.isdir(os.path.join(checkpoint, "orbax")):
        raise ValueError(f"{checkpoint}/orbax is the JAX package's checkpoint format; the "
                         "port reads the reference's torch weight files (.bin, .pt, "
                         ".safetensors)")
    weight_files = sorted(f for f in os.listdir(checkpoint) if f.endswith(WEIGHT_SUFFIXES))
    if not weight_files:
        raise FileNotFoundError(f"no {'/'.join(WEIGHT_SUFFIXES)} weight file in {checkpoint}")
    sd: Dict[str, torch.Tensor] = {}
    for wf in weight_files:
        sd.update(load_torch_state_dict(os.path.join(checkpoint, wf)))
    converted = convert_vlm_checkpoint(sd, arch, dtype=None)
    del sd

    model = TimeViperVLM(arch, dtype, device="meta")
    if not _has_attn_pool(model):
        # the Generator never runs InternVideo2's pooling head; the port's
        # towers are built without it
        converted = {k: v for k, v in converted.items() if ".attn_pool." not in k}
    want = model.state_dict()
    loaded = {}
    for name, src in converted.items():
        held = want.get(name)
        value = _cast_rule(src, dtype)
        out = torch.empty(value.shape, dtype=value.dtype if held is None else held.dtype,
                          device=device)
        loaded[name] = out.copy_(value)
    model.load_state_dict(loaded, strict=True, assign=True)
    del converted, loaded
    if quantize_int8:
        from timeviper_tpu_torch.train.quantize import quantize_params_int8

        quantize_params_int8(model.llm_backbone)
    return model.eval(), arch, meta


def _has_attn_pool(model: TimeViperVLM) -> bool:
    return any(getattr(m, "attn_pool", None) is not None for m in model.modules())


def assemble_model(model: TimeViperVLM, arch: VLMArch, meta: Dict[str, Any], tokenizer,
                   conv_template: Optional[str] = None, max_new_tokens: int = 128,
                   use_pdrop: bool = False, sampling: SamplingParams = SamplingParams(),
                   speculative: Optional[str] = None, n_draft: int = 7,
                   mesh=None) -> TimeViperModel:
    """The loaded model + a tokenizer (any HF-like tokenizer: encode, decode,
    add_special_tokens, convert_tokens_to_ids, eos_token_id, pad_token_id)
    -> the processor, the chat template and the Generator."""
    ventry = get_vision_backbone_config(arch.vlm.vision_backbone_id)
    transform = transform_for_family(
        ventry["family"] if ventry["family"] != "multi" else "siglip", arch.vision.image_size)
    processor = Processor.build(tokenizer, transform, arch.llm_family)
    template = CONV_TEMPLATES[conv_template or meta.get(
        "conv_template", "nano_base" if arch.llm_family == "nano" else "qwen2")]
    generator = Generator(
        model, arch, terminator_ids=processor.terminator_ids,
        pad_token_id=tokenizer.pad_token_id or 0, max_new_tokens=max_new_tokens,
        sampling=sampling, speculative=speculative, n_draft=n_draft, mesh=mesh)
    return TimeViperModel(arch=arch, model=model, processor=processor, template=template,
                          generator=generator,
                          default_use_pdrop=bool(use_pdrop or meta.get("use_pdrop")))


def load_pretrained_vlm(
    checkpoint: str,
    conv_template: Optional[str] = None,
    max_new_tokens: int = 128,
    use_pdrop: bool = False,
    dtype=torch.bfloat16,
    sampling: SamplingParams = SamplingParams(),
    quantize_int8: bool = False,
    mesh=None,
    speculative: Optional[str] = None,
    n_draft: int = 7,
    device=None,
) -> TimeViperModel:
    """Load a VLM checkpoint dir (see the module docstring for its layout)
    onto `device` (the card unless named).

    `quantize_int8=True` applies weight-only int8 to the LLM backbone
    (train/quantize.py). `speculative="ngram"` turns on prompt-lookup
    speculative decoding for greedy generation (models/speculative.py):
    n_draft drafted tokens verified per forward, token-identical output.
    `mesh` (parallel/sharding.py:make_mesh) makes the Generator parallel:
    a `seq` axis shards each prefill's row, each rank holding a whole copy
    of the weights on its own card (cuda:{LOCAL_RANK} by default), as the
    JAX package replicates them over `seq`; a `model` axis shards the
    weights by heads, hidden units and vocabulary (JAX models/api.py:233-236,
    no FSDP: parallel/tensor_parallel.py:shard_model). An int8 base on a
    model axis raises."""
    model, arch, meta = load_vlm_weights(checkpoint, use_pdrop=use_pdrop, dtype=dtype,
                                         quantize_int8=quantize_int8, device=device)
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(checkpoint, use_fast=True)
    return assemble_model(model, arch, meta, tokenizer, conv_template=conv_template,
                          max_new_tokens=max_new_tokens, use_pdrop=use_pdrop,
                          sampling=sampling, speculative=speculative, n_draft=n_draft,
                          mesh=mesh)
