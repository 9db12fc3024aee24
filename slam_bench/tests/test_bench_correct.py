"""The comparison that decides `correct`, driven through a whole run on
the CPU at a size a test run holds (2 sequences on 2 of the mix's courses,
a warm chunk and one measured chunk of 12 scans, whatever the CPU's speed;
the program's plain kernel versions): a sound run is correct and loads
nothing of JAX; the control (the reference's front end computed in
bfloat16, in the program's place) and each fault the cells can have,
planted under the timed path, are not."""

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

from slam_bench import harness
from slam_bench import faults

ROOT = Path(__file__).resolve().parents[2]
CELL = "vlp16_fleet_replay"
SMALL = {"batch": 2, "chunk": 12, "warm_chunks": 1,
         "courses": [[3.0, 14.0, 1], [7.0, -8.0, -1]]}
# a window shorter than a chunk: the run hands in exactly one
SECONDS = 0.01
SEED = 2 ** 31 + 77


def run(hooks=None) -> dict:
    torch.set_num_threads(4)
    cell = harness.load_cell(CELL, traffic=SMALL)
    return harness.run_cell(cell, SEED, SECONDS, False, time.perf_counter(),
                            device="cpu", hooks=hooks)


def failed_checks(res) -> list:
    return [n for n, c in res["checks"].items() if not c["value"] <= c["limit"]]


SOUND = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r})
T = time.perf_counter()
import torch
torch.set_num_threads(4)
from slam_bench import harness
cell = harness.load_cell({CELL!r}, traffic={SMALL!r})
res = harness.run_cell(cell, {SEED}, {SECONDS}, False, T, device="cpu")
print(json.dumps({{"correct": res["correct"], "checks": res["checks"],
                   "forbidden": harness.forbidden_modules()}}))
"""


def test_a_sound_run_is_correct_and_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SOUND], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == []
    assert res["correct"], res["checks"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import lego_loam_tpu_torch  # noqa: F401  its name begins with the JAX package's

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lego_loam_tpu.models",
                        types.ModuleType("lego_loam_tpu.models"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib", "lego_loam_tpu.models"]


def test_the_control_fails():
    res = run(faults.HOOKS["bf16"])
    assert not res["correct"]
    assert {"px_gap", "ground_gap", "seg_gap"} & set(failed_checks(res))


def test_a_step_that_returns_its_state_unchanged_fails(monkeypatch):
    from lego_loam_tpu_torch.models import batch

    monkeypatch.setattr(batch, "scan_step", faults.frozen(batch.scan_step))
    res = run()
    assert not res["correct"]
    assert {"rpe_p95_m", "kf_bad"} <= set(failed_checks(res))


def test_half_of_the_batch_left_out_fails():
    res = run(faults.HOOKS["half"])
    assert not res["correct"]
    assert {"rpe_p95_deg", "px_gap", "ground_gap", "seg_gap"} & set(failed_checks(res))


def test_an_answer_altered_where_it_is_produced_fails():
    res = run(faults.HOOKS["alter"])
    assert not res["correct"]
    assert "rpe_p95_m" in failed_checks(res)


def test_a_traced_run_reports_its_cells_per_layer_metrics(monkeypatch):
    """The traced window's instruments and readers, rehearsed on the CPU
    (the profiler records the CPU as the device): every number reported is
    a per-layer metric of the cell, and the host-side ones are there."""
    from slam_bench import trace

    monkeypatch.setattr(trace, "DEVICE_ACTIVITY", torch.profiler.ProfilerActivity.CPU)
    monkeypatch.setattr(trace, "DEVICE_TYPE", torch.autograd.DeviceType.CPU)
    for name in ("synchronize", "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    # the traced window runs three chunks at least
    cell = harness.load_cell(CELL, traffic=dict(SMALL, chunk=4))
    res = harness.run_cell(cell, SEED, SECONDS, True, time.perf_counter(),
                           device="cpu")
    names = {m["name"] for m in cell.per_layer}
    assert set(res["metrics"]) <= names
    assert {"host_ms_per_step", "syncs_per_chunk", "frontend_device_ms_per_step",
            "mapping_device_ms_per_solve", "device_kernels_per_step"} <= set(res["metrics"])
    assert res["correct"], res["checks"]
