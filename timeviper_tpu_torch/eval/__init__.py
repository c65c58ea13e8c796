"""Benchmark evaluation harness (reference: evaluate.py + eval/vllm_inference)."""

from timeviper_tpu_torch.eval.answers import extract_answer, get_dataset_type  # noqa: F401
from timeviper_tpu_torch.eval.loaders import BENCHMARKS, load_benchmark  # noqa: F401
from timeviper_tpu_torch.eval.scoring import (  # noqa: F401
    calc_score,
    compute_IoU,
    load_scored_data,
    mcq_is_correct,
)
