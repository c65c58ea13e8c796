"""The port's entry points put their tensors on the CUDA card unless the
caller names a device, and without a card they raise instead of falling back
to the CPU (every CPU test passes device="cpu")."""

import pytest
import torch

from timeviper_tpu_torch.config import VLMConfig, tiny_nano_config, tiny_vit_config
from timeviper_tpu_torch.device import resolve_device
from timeviper_tpu_torch.models.vlm import TimeViperVLM, VLMArch, init_cache, init_vlm_params
from timeviper_tpu_torch.train.optim import OptimConfig
from timeviper_tpu_torch.train.trainer import Trainer, TrainerConfig

ARCH = VLMArch(vlm=VLMConfig(arch_specifier="tome_mlp-2"), vision=tiny_vit_config(),
               llm=tiny_nano_config())


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")


def test_init_vlm_params_without_a_device_raises_on_a_cardless_machine():
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_vlm_params(ARCH, torch.Generator().manual_seed(0))


def test_other_entry_points_without_a_device_raise_on_a_cardless_machine(tmp_path):
    _no_card()
    with pytest.raises(RuntimeError):
        TimeViperVLM(ARCH, torch.float32)
    with pytest.raises(RuntimeError):
        init_cache(ARCH, 1, 8)
    model = init_vlm_params(ARCH, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    with pytest.raises(RuntimeError):
        Trainer(ARCH, model, OptimConfig(), TrainerConfig(run_dir=str(tmp_path)))


def test_an_explicit_cpu_device_builds_there():
    model = init_vlm_params(ARCH, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    cache = init_cache(ARCH, 1, 8, torch.float32, device="cpu")
    assert cache["layers"][0]["ssm_state"].device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")
