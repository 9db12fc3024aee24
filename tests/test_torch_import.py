"""The PyTorch port stands alone: it imports without jax, its config mirrors
lego_loam_tpu.config field for field, and its synthetic raycaster casts
byte-identical scans."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import lego_loam_tpu.config as jcfg
import lego_loam_tpu_torch.config as tcfg
from lego_loam_tpu.io import synthetic as jsyn
from lego_loam_tpu_torch.io import synthetic as tsyn

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
import lego_loam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m == "lego_loam_tpu" or m.startswith("lego_loam_tpu.")]
assert not bad, bad
print(" ".join(names))
"""
# the IMU slice's modules, among every module the walk imports
IMU_SLICE = ("models.imu", "io.checkpoint", "io.kitti", "io.rosbag",
             "io.synthetic", "utils.math3d", "utils.convert")
# the chunked-replay slice's: E1, the PCD export, the native reader, the
# debug dumps and the pipeline that drives them
CHUNK_SLICE = ("ops.eig6", "io.pcd", "native", "native.fast_io", "utils.debug",
               "models.pipeline")
# the fleet-batching slice's: the batch pipeline and the kernel build, whose
# custom ops' vmap rules it reaches
BATCH_SLICE = ("models.batch", "kernels.build")
# the distributed back end's
PARALLEL_SLICE = ("parallel", "parallel.comm", "parallel.graph",
                  "parallel.map_sharded", "parallel.backend_sharded")


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 42     # every module of the port
    assert {f"lego_loam_tpu_torch.{m}"
            for m in IMU_SLICE + CHUNK_SLICE + BATCH_SLICE + PARALLEL_SLICE} <= names


def test_shared_test_courses_import_without_jax():
    """tests/torch_courses.py (the courses chip_smoke.py drives on the
    card, where jax is not installed) imports neither jax nor the JAX
    package."""
    code = _IMPORT_ALL.split("import lego_loam_tpu_torch as pkg")[0] + (
        "import tests.torch_courses as c\n"
        "from lego_loam_tpu_torch import VLP16\n"
        "bad = [m for m in sys.modules if m == 'lego_loam_tpu' "
        "or m.startswith('lego_loam_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(c.loop_course(VLP16, 1)[1]), len(c.fast_yaw_imu(0)),\n"
        "      c.quat_from_mat(c.yaw_R(0.0)).tolist())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "2 10 [0.0, 0.0, 0.0, 1.0]"


def _fields(cls):
    # the two packages' SensorSpec classes differ; compare presets by value
    return [(f.name, dataclasses.asdict(f.default)
             if dataclasses.is_dataclass(f.default) else f.default)
            for f in dataclasses.fields(cls)]


def test_config_mirror_field_for_field():
    assert _fields(tcfg.PipelineConfig) == _fields(jcfg.PipelineConfig)
    assert _fields(tcfg.SensorSpec) == _fields(jcfg.SensorSpec)
    assert tcfg.SENSOR_PRESETS.keys() == jcfg.SENSOR_PRESETS.keys()
    for name, spec in jcfg.SENSOR_PRESETS.items():
        assert dataclasses.asdict(tcfg.SENSOR_PRESETS[name]) == dataclasses.asdict(spec)
    for name in jcfg.SENSOR_PRESETS:
        a = dataclasses.asdict(tcfg.config_for(name, map_iters=7))
        b = dataclasses.asdict(jcfg.config_for(name, map_iters=7))
        assert a == b
    t, j = tcfg.DEFAULT_CONFIG, jcfg.DEFAULT_CONFIG
    assert (t.segment_theta, t.segment_alpha_x, t.segment_alpha_y) == (
        j.segment_theta, j.segment_alpha_x, j.segment_alpha_y)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_scans_byte_identical(seed):
    jw, tw = jsyn.default_world(seed), tsyn.default_world(seed)
    np.testing.assert_array_equal(jw.boxes, tw.boxes)
    np.testing.assert_array_equal(jw.cylinders, tw.cylinders)
    jposes = jsyn.circle_trajectory(5, radius=9.0)
    tposes = tsyn.circle_trajectory(5, radius=9.0)
    for (jR, jt), (tR, tt) in zip(jposes, tposes):
        np.testing.assert_array_equal(jR, tR)
        np.testing.assert_array_equal(jt, tt)
    for k in (0, 3):
        R, t = jposes[k]
        a = jsyn.raycast(jw, R, t, jcfg.VLP16, noise=0.01,
                         rng=np.random.default_rng(seed + k))
        b = tsyn.raycast(tw, R, t, tcfg.VLP16, noise=0.01,
                         rng=np.random.default_rng(seed + k))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
