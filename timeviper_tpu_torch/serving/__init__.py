"""Serving (counterpart of timeviper_tpu/serving): the slot-batched engine."""

from timeviper_tpu_torch.serving.engine import Request, ServingEngine  # noqa: F401
