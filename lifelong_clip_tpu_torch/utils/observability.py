"""Step timing and profiling.

Counterpart of ``lifelong_clip_tpu/utils/observability.py``:

  * ``StepTimer``: per-step latency percentiles over a rolling window, on
    the host's clock: a step's device work counts only as far as the host
    waits for it inside the timed region;
  * ``profile_trace``: ``torch.profiler`` over a region (CPU and CUDA
    activities), written as a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, List

import numpy as np

log = logging.getLogger("lifelong_clip_tpu_torch")


class StepTimer:
    """Rolling step-latency stats. Call ``tick()`` around each step."""

    def __init__(self, window: int = 256):
        self.window = window
        self.samples: List[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            return
        self.samples.append(time.perf_counter() - self._t0)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        self._t0 = None

    @contextlib.contextmanager
    def tick(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        a = np.asarray(self.samples) * 1e3
        return {"p50_ms": float(np.percentile(a, 50)),
                "p90_ms": float(np.percentile(a, 90)),
                "p99_ms": float(np.percentile(a, 99)),
                "mean_ms": float(a.mean())}


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """torch.profiler trace around a region (Chrome trace JSON in logdir)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
