"""Profiling and debug tripwires (counterpart of timeviper_tpu/utils/
profiling.py).

* `profile_ctx` wraps a region in a `torch.profiler` trace of the host and,
  where there is a card, the device; the Chrome trace is written to
  `<logdir>/trace.json` (view it in Perfetto or chrome://tracing);
* `nan_debug` turns on `torch.autograd.set_detect_anomaly` for the region,
  the opt-in form of the reference's always-on anomaly mode (train.py:50):
  the backward raises at the first op that gives a NaN, naming the forward
  op that made it.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch


@contextmanager
def profile_ctx(logdir: str = "timeviper_profile"):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextmanager
def nan_debug(enable: bool = True):
    old = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(old)
