"""One run of one cell: set-up, the measured window, the traced sub-windows
and the comparison that decides `correct`.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name in BENCHMARK.json:

* ``configs[].file``: the configuration as it is run (the sensor's
  published geometry, the pipeline's settings, ``mid_row``);
* ``slam_bench/traffic/<traffic>.json``: the mix's parameters (traffic.py);
* ``slam_bench/workloads/<cell>.json``: the cell's limits for `correct`;
* ``slam_bench/metrics/<metric>.py``: a per-layer metric's reader, with
  ``read(t)`` returning a number or None (nothing to read), and optionally
  ``CAPTURE = (module, launcher)`` and ``keep(args, out)``, what it keeps of
  each launch in the traced layer chunk;
* ``slam_bench/ranges/<name>.json``: a function the traced layer chunk
  wraps in a profiler range of that name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lego_loam_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the cell's entry in BENCHMARK.json
    config: dict           # the configuration file
    traffic: dict          # the traffic mix file
    limits: dict           # from the cell's file
    end_to_end: list       # metric entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, traffic: dict | None = None) -> Cell:
    """The cell `name` and everything it names, read by name; `traffic`
    overrides parameters of its mix."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = root / HERE.name
    mix = json.loads((here / "traffic" / f"{entry['traffic']}.json").read_text())
    mix.update(traffic or {})
    if mix["loop_closure"]:
        # check.py does not yet hold the loop layer to the reference: with
        # loop closure on, `correct` would pass whatever the loop check did
        raise SystemExit(f"{name}: no comparison covers loop closure yet")
    cellfile = json.loads((here / "workloads" / f"{name}.json").read_text())
    return Cell(name, entry, json.loads((root / conf["file"]).read_text()), mix,
                cellfile["limits"],
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(name: str):
    """The reader module of per-layer metric `name`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def pipeline_config(cell: Cell):
    """The port's PipelineConfig of the cell, held to the file's sensor."""
    from lego_loam_tpu_torch.config import config_for

    c, mix = cell.config, cell.traffic
    cfg = config_for(c["sensor"]["name"], **c["pipeline"],
                     loop_closure_enabled=bool(mix["loop_closure"]))
    for key, want in c["sensor"].items():
        if getattr(cfg.sensor, key) != want:
            raise SystemExit(f"{cell.config['sensor']['name']}: the program's "
                             f"sensor has {key}={getattr(cfg.sensor, key)!r}, "
                             f"the configuration {want!r}")
    return cfg


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", hooks: dict | None = None) -> dict:
    """One run.  `t_start` is the host clock at the process's start (set-up
    counts from it).  `hooks` (checks of the comparison itself) may hold
    "pipeline" (called with the BatchPipeline once built), "inputs" (maps a
    chunk's (xyz, valid, ring)), "result" (maps a chunk's result) and
    "counts" (takes the program's place in check.judge's per-scan counts)."""
    import torch

    from lego_loam_tpu_torch.models.batch import BatchPipeline
    from slam_bench import check, traffic as tr
    from slam_bench.raycast import Sensor
    from slam_bench.trace import Tracer

    hooks = hooks or {}
    mix, sens = cell.traffic, cell.config["sensor"]
    cuda = device == "cuda"
    cfg = pipeline_config(cell)
    sensor = Sensor(**{f.name: sens[f.name] for f in dataclasses.fields(Sensor)})
    B, C = int(mix["batch"]), int(mix["chunk"])
    every = int(mix["loop_check_every"])

    readers = {m["name"]: reader(m["name"]) for m in cell.per_layer} if trace else {}
    tracer = Tracer({n: (*r.CAPTURE, r.keep) for n, r in readers.items()
                     if hasattr(r, "CAPTURE")})
    if trace and cuda:
        tracer.warm_profiler()

    bank = tr.make_bank(mix, sensor, bool(cell.config["mid_row"]), seed, device)
    offs = tr.offsets(mix, seed)
    bp = BatchPipeline(cfg, B, loop_check_every=every, device=device)
    if "pipeline" in hooks:
        hooks["pipeline"](bp)
    results, step = [], 0

    def chunk():
        nonlocal step
        x = tr.gather(bank, tr.scan_index(mix, offs, step, C), sens["use_ring"])
        if "inputs" in hooks:
            x = hooks["inputs"](*x)
        step += C
        return lambda: bp.process_chunk(*x)

    def keep(res):
        results.append(hooks["result"](res) if "result" in hooks else res)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(int(mix["warm_chunks"])):
        keep(chunk()())
    n_kf0 = bp.mstate.n_kf.clone()
    sync()
    setup_s = time.perf_counter() - t_start

    n0 = len(results)
    t0 = time.perf_counter()
    k = 0
    while True:
        late = time.perf_counter() - t0 >= seconds
        if not trace and late:
            break
        if trace and late and k >= 3:
            break
        run = chunk()
        if trace and k == 1:
            keep(tracer.device_chunk(run, C))
        elif trace and k == 2:
            keep(tracer.layer_chunk(run))
        elif trace:
            keep(tracer.counted(run))
        else:
            keep(run())
        k += 1
    sync()
    window_s = time.perf_counter() - t0
    scans = B * C * (len(results) - n0)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the timed path's outputs, then the state is freed before the reference
    out = check.collect(results, bp.mstate.n_kf, n_kf0)
    S, w0 = out["did_map"].shape[0], n0 * C
    rows = tr.scan_index(mix, offs, 0, S)
    picks = check.count_samples(seed, B, w0, S)
    sample = [tuple(a.cpu().numpy() for a in (
        bank.xyz[rows[b, s]], bank.valid[rows[b, s]], bank.ring)) for b, s in picks]
    metrics = {}
    if trace:
        tracer.parse()
        for name, r in readers.items():
            v = r.read(_Reading(tracer, cfg, torch.cuda.get_device_name() if cuda
                                else "cpu"))
            if v is not None:
                unit = next(m["unit"] for m in cell.per_layer if m["name"] == name)
                metrics[name] = {"value": float(v), "unit": unit}
    bank_R, bank_t = bank.R, bank.t
    del bp, results, bank, tracer.kept
    if cuda:
        torch.cuda.empty_cache()

    vals = check.judge(out, sample, rows, w0, bank_R, bank_t, sens,
                       cell.config["pipeline"], seed, hooks.get("counts"))
    checks = {n: [vals[n], cell.limits.get(n)] for n in check.ORDER}
    res_diag = {k: v for k, v in vals.items() if k not in check.ORDER}
    correct = all(lim is not None and v <= lim for v, lim in checks.values())
    window_steps = S - w0
    failed = int((~np.isfinite(out["fused_t"][:, w0:])).any(-1).sum())
    if not trace:
        value = {"scans_per_s": scans / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": value[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    res = {"correct": correct, "attempted": B * window_steps, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and tracer.device:
        dev["busy_s"] = tracer.device["busy_s"]
        dev["window_s"] = tracer.device["window_s"]
        res["breakdown"] = tracer.breakdown()
    res["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    res["_diag"] = res_diag
    res["_window"] = {"seconds": window_s, "steps": window_steps,
                      "steps_total": S, "setup_s": setup_s}
    return res


class _Reading:
    """What a per-layer reader reads: the tracer's records, the pipeline's
    configuration and the card's peaks (None where the card is not in the
    table)."""

    def __init__(self, tracer, cfg, kind: str):
        from slam_bench.roofline import PEAKS

        self.host_step_ms = tracer.host_step_ms
        self.syncs_per_chunk = tracer.syncs_per_chunk
        self.device = tracer.device
        self.layers = tracer.layers
        self.ops = tracer.ops
        self.kept = tracer.kept
        self.cfg = cfg
        self.peaks = PEAKS.get(kind)

    def op_share(self, op: str, bound_s: float):
        """100 x bound / the op's device time, or None if it did not run."""
        n, secs = self.ops.get(op, (0, 0.0))
        if n == 0 or secs <= 0 or bound_s <= 0 or math.isnan(bound_s):
            return None
        return 100.0 * bound_s / secs
