"""The port imports no JAX and nothing of the JAX package: the machine with
the card has no JAX, and the port keeps its own copies of what it needs."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

MODULES = [
    "timeviper_tpu_torch", "timeviper_tpu_torch.params",
    "timeviper_tpu_torch.ops._cuda", "timeviper_tpu_torch.ops.norms",
    "timeviper_tpu_torch.ops.conv", "timeviper_tpu_torch.ops.ssd",
    "timeviper_tpu_torch.ops.attention", "timeviper_tpu_torch.ops.ssd_kernel",
    "timeviper_tpu_torch.ops.flash_attention", "timeviper_tpu_torch.ops.vit_attention",
    "timeviper_tpu_torch.ops.tome", "timeviper_tpu_torch.ops.sampling",
    "timeviper_tpu_torch.models.vit", "timeviper_tpu_torch.models.projector",
    "timeviper_tpu_torch.models.cache", "timeviper_tpu_torch.models.nano",
    "timeviper_tpu_torch.models.vlm", "timeviper_tpu_torch.models.generate",
    "timeviper_tpu_torch.models.api", "timeviper_tpu_torch.config",
    "timeviper_tpu_torch.device", "timeviper_tpu_torch.data.fusion",
    "timeviper_tpu_torch.data.loader", "timeviper_tpu_torch.train.lora",
    "timeviper_tpu_torch.train.optim", "timeviper_tpu_torch.train.step",
    "timeviper_tpu_torch.train.checkpoint", "timeviper_tpu_torch.train.trainer",
    "timeviper_tpu_torch.ops.int8_linear", "timeviper_tpu_torch.ops.layernorm",
    "timeviper_tpu_torch.ops.decode_fused", "timeviper_tpu_torch.train.quantize",
    "timeviper_tpu_torch.models.internvideo2", "timeviper_tpu_torch.ops.block_attention",
    "timeviper_tpu_torch.models.prefix_cache", "timeviper_tpu_torch.models.longctx",
    "timeviper_tpu_torch.ops.headgrid_attention", "timeviper_tpu_torch.serving",
    "timeviper_tpu_torch.serving.engine", "timeviper_tpu_torch.bench",
    "timeviper_tpu_torch.bench.microbench_vit_attn", "timeviper_tpu_torch.bench.microbench_flash",
    "timeviper_tpu_torch.bench.attention_ab", "timeviper_tpu_torch.bench.ssd_ab",
    "timeviper_tpu_torch.bench.train_ab", "timeviper_tpu_torch.models.pdrop",
    "timeviper_tpu_torch.models.qwen2", "timeviper_tpu_torch.ops.rope",
    "timeviper_tpu_torch.models.speculative", "timeviper_tpu_torch.train.convert",
    "timeviper_tpu_torch.data.conversation", "timeviper_tpu_torch.data.templates",
    "timeviper_tpu_torch.data.image_processing", "timeviper_tpu_torch.data.native_build",
    "timeviper_tpu_torch.data.native", "timeviper_tpu_torch.data.processor",
    "timeviper_tpu_torch.data.video", "timeviper_tpu_torch.data.native_video",
    "timeviper_tpu_torch.chat", "timeviper_tpu_torch.eval", "timeviper_tpu_torch.eval.answers",
    "timeviper_tpu_torch.eval.cider", "timeviper_tpu_torch.eval.datasets",
    "timeviper_tpu_torch.eval.dvc", "timeviper_tpu_torch.eval.evaluate",
    "timeviper_tpu_torch.eval.judges", "timeviper_tpu_torch.eval.loaders",
    "timeviper_tpu_torch.eval.meteor", "timeviper_tpu_torch.eval.meteor_py",
    "timeviper_tpu_torch.eval.ptb", "timeviper_tpu_torch.eval.scoring",
    "timeviper_tpu_torch.data.datasets", "timeviper_tpu_torch.models.remat",
    "timeviper_tpu_torch.train.offload", "timeviper_tpu_torch.train.cli",
    "timeviper_tpu_torch.utils", "timeviper_tpu_torch.utils.overwatch",
    "timeviper_tpu_torch.utils.profiling", "timeviper_tpu_torch.utils.dist",
    "timeviper_tpu_torch.parallel", "timeviper_tpu_torch.parallel.sharding",
    "timeviper_tpu_torch.parallel.seq_parallel", "timeviper_tpu_torch.parallel.tensor_parallel",
    "chip_smoke",
]
REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = "\n".join([
        "import importlib, sys",
        *(f"importlib.import_module({m!r})" for m in MODULES),
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in",
        "             ('jax', 'jaxlib', 'timeviper_tpu'))",
        "assert not bad, bad",
        "import timeviper_tpu_torch.ops._cuda as c",
        "assert c._lib is None  # nothing is built at import",
    ])
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("module,flag", [("timeviper_tpu_torch.chat", "--checkpoint"),
                                         ("timeviper_tpu_torch.eval.evaluate", "--checkpoint"),
                                         ("timeviper_tpu_torch.train.cli", "--data_config")])
def test_cli_help_imports_no_jax(module, flag):
    """`python -m <cli> --help` prints its flags and loads no JAX."""
    code = "\n".join([
        "import runpy, sys",
        f"sys.argv = [{module!r}, '--help']",
        "try:",
        f"    runpy.run_module({module!r}, run_name='__main__')",
        "except SystemExit as e:",
        "    assert e.code == 0, e.code",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in",
        "             ('jax', 'jaxlib', 'timeviper_tpu'))",
        "assert not bad, bad",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert flag in out and "--device" in out


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    """No CPU fallback: without CUDA, or copied alone into an empty directory,
    the script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
