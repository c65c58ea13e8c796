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
