"""Profiling hooks (SURVEY §5: the reference has no tracing at all), the
counterpart of ``lego_loam_tpu.utils.tracing``.

Two layers:
  * `trace(dir)` — context manager around torch.profiler (host and, where
    a card is present, device activity) that writes a Chrome / Perfetto
    trace into `dir` on exit;
  * `StageTimer` — lightweight named wall-clock stages for the host loop,
    aggregated like utils.metrics.MetricsRecorder.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: `with trace('/tmp/trace'): pipeline step(s)`.

    The host's ops (the kernels' custom ops among them, as ``lego::knn``
    and the like) and, on a card, its kernels; on exit the trace is written
    to `log_dir`/trace_<pid>_<ns>.json, which chrome://tracing and
    ui.perfetto.dev open."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Named wall-clock stages with summary percentiles.

    A host clock that does not synchronise: under CUDA's asynchronous
    launches a stage times the host's dispatch of its work, not the card's
    execution, unless the caller synchronises inside the stage."""

    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append((time.perf_counter() - t0) * 1e3)

    def summary(self) -> dict:
        out = {}
        for name, vals in self.samples.items():
            v = np.asarray(vals)
            out[name] = {
                "n": int(v.size),
                "mean_ms": float(v.mean()),
                "p50_ms": float(np.percentile(v, 50)),
                "p95_ms": float(np.percentile(v, 95)),
            }
        return out
