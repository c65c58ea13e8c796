"""Model assembly from the registry ids (counterpart of
timeviper_tpu/models/api.py:build_arch).

`load_pretrained_vlm` and `TimeViperModel.chat` wait for the model's weights,
tokenizer and config.json; until then the port is driven through
`Generator.generate` with token ids and pixel arrays.
"""

from __future__ import annotations

from timeviper_tpu_torch.config import (
    VLMConfig,
    get_llm_backbone_config,
    get_vision_backbone_config,
)
from timeviper_tpu_torch.models.vlm import VLMArch


def build_arch(vlm_cfg: VLMConfig) -> VLMArch:
    ventry = get_vision_backbone_config(vlm_cfg.vision_backbone_id)
    lentry = get_llm_backbone_config(vlm_cfg.llm_backbone_id)
    if ventry["family"] != "siglip" or lentry["family"] != "nano":
        raise NotImplementedError(
            f"{ventry['family']} + {lentry['family']} is not ported; siglip + nano is")
    return VLMArch(vlm=vlm_cfg, vision=ventry["config"], llm=lentry["config"],
                   llm_family=lentry["family"], vision_family=ventry["family"])
