"""The port's soak (lego_loam_tpu_torch/examples/soak.py) on the CPU: its
ring world and lap poses equal to examples/soak.py's, and a tiny ring
course whose pool of 8 keyframes fills and is thinned inside the pipeline,
with the JAX script's JSON line.  torch runs on one thread."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.examples import soak
from lego_loam_tpu_torch.io import synthetic as syn
from tests.torch_courses import LOOP

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
# a pool of 8 keyframes that a 12-scan lap fills (a solve a scan): LOOP's
# capacities, 2 history keyframes, 5 ICP steps, a revisit 0.5 s apart
SOAK_CFG = config_for("vlp16", **dict(LOOP, max_keyframes=8,
                                      history_keyframe_search_num=2,
                                      loop_icp_iters=5, loop_min_time_gap=0.5))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def _jax_script_functions(*names) -> dict:
    """Functions of examples/soak.py, taken from its source and run on the
    port's synthetic module (the script itself configures jax at import)."""
    tree = ast.parse((EXAMPLES / "soak.py").read_text())
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"np": np, "syn": syn, "RADIUS": 50.0}
    exec(compile(ast.Module(body=defs, type_ignores=[]), "soak.py", "exec"), ns)
    return {n: ns[n] for n in names}


def test_soak_course_is_the_scripts():
    ref = _jax_script_functions("ring_world", "lap_poses")
    a, b = soak.ring_world(), ref["ring_world"]()
    np.testing.assert_array_equal(a.boxes, b.boxes)
    np.testing.assert_array_equal(a.cylinders, b.cylinders)
    per_lap = soak.scans_per_lap(soak.RADIUS, soak.STEP, soak.CHUNK)
    assert per_lap == 3136
    for (Ra, ta), (Rb, tb) in zip(soak.lap_poses(per_lap), ref["lap_poses"](per_lap)):
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(ta, tb)


def test_soak_fills_and_compacts_in_the_pipeline():
    out = soak.run(n_laps=1, chunk=4, radius=2.0, step=1.0, cfg=SOAK_CFG,
                   device="cpu", log=_quiet)
    rec, extra = out["record"], out["extra"]
    src = (EXAMPLES / "soak.py").read_text()
    keys = re.findall(r'^        "(\w+)":', src[src.index("rec = {"):], re.M)
    assert list(rec) == keys[:len(rec)] and len(rec) == 14
    json.dumps(rec)
    assert rec["n_scans"] == extra["scans_per_lap"] == 12
    # the pool of 8 filled and the pipeline thinned it, more than once
    assert extra["compactions_in_pipeline"] >= 2 and extra["compaction_chunks"]
    assert max(n for _, n in extra["n_kf_samples"]) == SOAK_CFG.max_keyframes - 1
    assert rec["n_kf_final"] < SOAK_CFG.max_keyframes
    assert np.isfinite(rec["ate_corrected_m"]) and rec["ate_corrected_m"] < soak.ATE_LIMIT
    assert out["pipeline"].compactions == extra["compactions_in_pipeline"]
    assert extra["loop_check_ms_end"] > 0 and extra["peak_mem_bytes"] is None
    # at K = 8 the pool refills within a chunk, so its samples may see no fall
    assert not [f for f in soak.failures(rec, SOAK_CFG) if "overflow" in f or "ATE" in f]


def test_soak_failures():
    """The JAX script's four checks (examples/soak.py:153-162), each."""
    ok = dict(compactions_observed=1, n_kf_final=4000, n_loop_edges_final=3,
              ate_corrected_m=1.2)
    cfg = soak.make_config()
    assert soak.failures(ok, cfg) == []
    for change, msg in ((dict(compactions_observed=0), "compaction never fired"),
                        (dict(n_kf_final=4096), "pool overflowed"),
                        (dict(n_loop_edges_final=0), "no loop edges"),
                        (dict(ate_corrected_m=5.0), "corrected ATE 5.00 m"),
                        (dict(ate_corrected_m=float("nan")), "corrected ATE nan m")):
        bad = soak.failures(dict(ok, **change), cfg)
        assert len(bad) == 1 and bad[0].startswith(msg), bad


def test_soak_main_arguments(monkeypatch):
    assert soak.parse_args([]) == (4, 64, False)
    assert soak.parse_args(["6", "32", "--cpu"]) == (6, 32, True)
    calls = []
    monkeypatch.setattr(soak, "run", lambda *a, **kw: calls.append((a, kw)) or {
        "record": {}, "extra": {}})
    monkeypatch.setattr(soak, "failures", lambda rec, cfg: [])
    soak.main(["2", "16", "--cpu"])
    (a, kw), = calls
    assert a == (2, 16) and kw["device"] == "cpu" and kw["cfg"].max_keyframes == 4096
