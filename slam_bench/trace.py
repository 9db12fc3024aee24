"""The traced run's instruments, all applied from outside the program.

* Host cadence and syncs: every chunk outside the profiled ones runs with
  torch.cuda.set_sync_debug_mode("warn") (each host sync is a warning) and
  with the batch's per-step function wrapped to stamp the host clock at
  each step, without a sync.
* Device chunk: one chunk under torch.profiler recording device activity
  only (host op events stretch the host's part): device busy time (the
  union of its activity intervals), the window, events, kernel totals.
* Layer chunk: one more chunk under torch.profiler with host events, with
  a record_function range around each function named in
  ``slam_bench/ranges/<name>.json`` and a keeper around each launcher that
  a metric reader names (``CAPTURE``), which stores what the reader's
  ``keep`` takes from the launch's arguments and outputs, without device
  work.  A range's or an op's device time is that of the kernels launched
  inside it.
"""

from __future__ import annotations

import functools
import importlib
import json
import time
import warnings
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

HERE = Path(__file__).resolve().parent
STEP_FN = ("lego_loam_tpu_torch.models.batch", "scan_step")
HOST_LOOP = "host loop (between ranges)"
# the profiled device (a rehearsal on the CPU profiles the CPU instead)
DEVICE_ACTIVITY = ProfilerActivity.CUDA
DEVICE_TYPE = torch.autograd.DeviceType.CUDA


def _patch(module: str, attr: str, make):
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    new = functools.wraps(orig)(make(orig))
    setattr(mod, attr, new)
    return mod, attr, orig


def _unpatch(patches) -> None:
    for mod, attr, orig in reversed(patches):
        setattr(mod, attr, orig)


def ranges() -> dict:
    """{range name: (module, attribute)} of slam_bench/ranges/*.json."""
    out = {}
    for f in sorted((HERE / "ranges").glob("*.json")):
        spec = json.loads(f.read_text())
        out[f.stem] = (spec["module"], spec["attr"])
    return out


def _device_events(prof, events=None):
    """The device's activities, without the device-side copies of the host
    ranges (kineto's gpu_user_annotation, named as the range)."""
    skip = set(ranges()) | {"process_chunk"}
    return [e for e in (prof.events() if events is None else events)
            if e.device_type == DEVICE_TYPE
            and e.name not in skip]


def _merge(spans):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Tracer:
    """Runs the traced window's chunks and keeps what the readers read."""

    def __init__(self, captures: dict):
        # {reader name: (module, attr, keep)}
        self.captures = captures
        self.kept = {name: [] for name in captures}
        self.host_step_ms: list = []
        self.syncs_per_chunk: list = []
        self.device: dict = {}
        self.layers: dict = {}
        self.ops: dict = {}
        self.gaps: list = []
        self._layer_events = None

    @staticmethod
    def warm_profiler() -> None:
        """A throwaway session: the first of a process can record no device
        activity while the tracer starts."""
        with profile(activities=[DEVICE_ACTIVITY]):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def counted(self, fn):
        """fn() with host step stamps and sync warnings counted."""
        stamps = []

        def make(orig):
            def stamped(*a, **kw):
                stamps.append(time.perf_counter())
                return orig(*a, **kw)
            return stamped

        patches = [_patch(*STEP_FN, make)]
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            _unpatch(patches)
        self.host_step_ms += [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        self.syncs_per_chunk.append(
            sum("synchroniz" in str(w.message) for w in caught))
        return out

    def device_chunk(self, fn, steps: int):
        """fn() (one chunk of `steps` steps) under a device-only profile."""
        torch.cuda.synchronize()
        with profile(activities=[DEVICE_ACTIVITY]) as prof:
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        ev = _device_events(prof)
        merged = _merge((e.time_range.start, e.time_range.end) for e in ev)
        busy = sum(b - a for a, b in merged) * 1e-6
        totals: dict = {}
        for e in ev:
            totals[e.name] = totals.get(e.name, 0.0) + e.device_time_total * 1e-6
        self.device = {"busy_s": busy, "window_s": wall, "events": len(ev),
                       "steps": steps, "totals": totals}
        return out

    def layer_chunk(self, fn):
        """fn() under a host and device profile, with the ranges and the
        readers' keepers in place."""
        patches = []

        def ranged(name):
            def make(orig):
                def inner(*a, **kw):
                    with record_function(name):
                        return orig(*a, **kw)
                return inner
            return make

        def keeper(name, keep):
            def make(orig):
                def inner(*a, **kw):
                    out = orig(*a, **kw)
                    self.kept[name].append(keep(a, out))
                    return out
                return inner
            return make

        try:
            for name, (module, attr) in ranges().items():
                patches.append(_patch(module, attr, ranged(name)))
            for name, (module, attr, keep) in self.captures.items():
                patches.append(_patch(module, attr, keeper(name, keep)))
            torch.cuda.synchronize()
            with profile(activities=list({ProfilerActivity.CPU,
                                          DEVICE_ACTIVITY})) as prof:
                with record_function("process_chunk"):
                    out = fn()
                torch.cuda.synchronize()
        finally:
            _unpatch(patches)
        self._layer_events = prof
        return out

    def parse(self) -> None:
        """Range and op device times and the idle gaps of the layer chunk
        (after the window: reading a trace takes seconds)."""
        prof, self._layer_events = self._layer_events, None
        events = prof.events()
        host = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CPU]
        names = set(ranges()) | {"process_chunk"}
        by_name: dict = {}
        for e in host:
            by_name.setdefault(e.name, []).append(e)
        for name in names:
            evs = by_name.get(name, [])
            self.layers[name] = (len(evs), sum(e.device_time_total for e in evs) * 1e-6)
        # an op's device time: its innermost events (a vmapped op calls
        # itself once more on the batch), so each kernel counts once
        for name, evs in by_name.items():
            if "::" not in name or not name.startswith("lego"):
                continue
            evs = sorted(evs, key=lambda e: e.time_range.start)
            inner = [e for e, nxt in zip(evs, evs[1:] + [None])
                     if nxt is None or nxt.time_range.start >= e.time_range.end]
            self.ops[name] = (len(inner), sum(e.device_time_total for e in inner) * 1e-6)
        dev = _merge((e.time_range.start, e.time_range.end)
                     for e in _device_events(prof, events))
        longest = sorted(((b - a, a) for (_, a), (b, _) in zip(dev, dev[1:])),
                         reverse=True)[:10]
        # a gap is named by the innermost range open on the host as it began
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for n in names for e in by_name.get(n, []))
        self.gaps = []
        for length, a in longest:
            open_ = [nm for s, t, nm in spans if s <= a < t]
            self.gaps.append((open_[-1] if open_ else HOST_LOOP, length * 1e-6))

    def breakdown(self) -> dict:
        ops = sorted(self.device.get("totals", {}).items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.gaps]}
