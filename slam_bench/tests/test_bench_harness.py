"""The harness finds every configuration, traffic mix, cell, range and
per-layer metric reader by the name BENCHMARK.json gives it, and the file
keeps to the benchmark's contract."""

import json
import re
from pathlib import Path

import pytest

from lego_loam_tpu_torch.config import SENSOR_PRESETS
from slam_bench import harness, trace
from slam_bench.check import ORDER

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slam_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.entry["chips"] == 1
    assert set(c.limits) == set(ORDER)
    assert {m["name"] for m in c.end_to_end} == {"scans_per_s", "setup_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in {e["name"] for e in c.end_to_end}
    cfg = harness.pipeline_config(c)
    assert cfg.loop_closure_enabled == c.traffic["loop_closure"]
    assert cfg.max_keyframes == 4096 and not cfg.deskew


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    f = ROOT / conf["file"]
    assert f.is_file() and conf["file"].startswith("slam_bench/")
    data = json.loads(f.read_text())
    assert data["reduced"] == conf["reduced"] == []
    assert data["assumed"]
    spec = SENSOR_PRESETS[data["sensor"]["name"]]
    for key, want in data["sensor"].items():
        assert getattr(spec, key) == want, key


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(metric):
    r = harness.reader(metric["name"])
    assert callable(r.read)
    if hasattr(r, "CAPTURE"):
        assert callable(r.keep)
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert metric["moves"] == "scans_per_s"
    cells = metric.get("workloads", CELLS)
    assert set(cells) <= set(CELLS)
    # every cell it lists reports the end-to-end metric it moves
    for cell in cells:
        names = {m["name"] for m in harness.load_cell(cell).end_to_end}
        assert metric["moves"] in names


def test_a_mix_with_loop_closure_on_is_refused():
    """No number of check.py holds the loop layer to the reference yet."""
    with pytest.raises(SystemExit, match="loop closure"):
        harness.load_cell(CELLS[0], traffic={"loop_closure": True})


def test_ranges_name_functions_of_the_program():
    import importlib

    got = trace.ranges()
    assert {"frontend_step", "mapping_step"} <= set(got)
    for module, attr in got.values():
        assert callable(getattr(importlib.import_module(module), attr))


def test_a_new_cell_is_files_only(tmp_path):
    """A later cell, mix and metric reader are new files found by name:
    a copy of the benchmark with one more of each loads it."""
    import shutil

    shutil.copytree(ROOT / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "vlp16_fleet_small", "config": "vlp16_lego",
                               "traffic": "fleet8", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((ROOT / "slam_bench/traffic/fleet256.json").read_text())
    (tmp_path / "slam_bench/traffic/fleet8.json").write_text(
        json.dumps(dict(mix, batch=8)))
    (tmp_path / "slam_bench/workloads/vlp16_fleet_small.json").write_text(
        (ROOT / "slam_bench/workloads/vlp16_fleet_replay.json").read_text())
    c = harness.load_cell("vlp16_fleet_small", root=tmp_path)
    assert c.traffic["batch"] == 8 and c.config["sensor"]["name"] == "vlp16"
