"""The map export the port's replay ends in, against the JAX package's, on
the CPU:

  * one seeded keyframe pool (numpy), loaded into both pipelines (the JAX
    package's global_map and dump_keyframe are host NumPy: nothing is
    compiled): global_map for every block kind, with and without a radius,
    byte-equal; the four export_maps files byte-identical; dump_keyframe's
    files byte-identical;
  * save_pcd / load_pcd round trips, binary and ascii, each file read the
    same by both packages;
  * dump_stages on one SMALL scan: the same stage counts, and clouds within
    1e-5 m (the front ends agree to float32 rounding, tests/test_torch_frontend.py);
  * the port's native reader (built from native/fast_io.cpp at first use)
    against the JAX package's fast_io: read_kitti_bin, a pad_scan_native
    fuzz and the prefetcher's order, as tests/test_io.py checks the JAX
    package's.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.io import pcd as jpcd
from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline
from lego_loam_tpu.native import fast_io as jfast
from lego_loam_tpu.utils import debug as jdebug
from lego_loam_tpu.utils.math3d import Pose as JPose
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import pcd as tpcd
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from lego_loam_tpu_torch.native import fast_io as tfast
from lego_loam_tpu_torch.utils import debug as tdebug
from lego_loam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

from tests.torch_courses import SMALL, slice_course, yaw_R

N_KF = 9
POOL_FIELDS = ("kf_R", "kf_t", "kf_corner", "kf_corner_valid", "kf_surf",
               "kf_surf_valid", "kf_outlier", "kf_outlier_valid", "n_kf")


@pytest.fixture(scope="module")
def pipelines():
    """Both pipelines holding one seeded pool of N_KF keyframes."""
    cfg = config_for("vlp16", **SMALL)
    rng = np.random.default_rng(21)
    st = state_to_numpy(LegoLoamPipeline(cfg, "cpu").mstate)
    pool = {"kf_R": st.kf_R.copy(), "kf_t": st.kf_t.copy()}
    for k in range(N_KF):
        pool["kf_R"][k] = yaw_R(rng.uniform(-np.pi, np.pi)).astype(np.float32)
        pool["kf_t"][k] = rng.uniform(-20, 20, 3).astype(np.float32)
    for name in ("corner", "surf", "outlier"):
        blk = getattr(st, f"kf_{name}").copy()
        val = getattr(st, f"kf_{name}_valid").copy()
        blk[:N_KF] = rng.uniform(-30, 30, blk[:N_KF].shape).astype(np.float32)
        val[:N_KF] = rng.random(val[:N_KF].shape) < 0.6
        pool[f"kf_{name}"], pool[f"kf_{name}_valid"] = blk, val
    pool["n_kf"] = np.asarray(N_KF, np.int32)
    latest = (st.aft_mapped.R, pool["kf_t"][N_KF - 1])
    tpipe = LegoLoamPipeline(cfg, "cpu")
    tpipe.mstate = state_from_numpy(st._replace(
        aft_mapped=st.aft_mapped._replace(t=latest[1]), **pool), "cpu")
    jpipe = JaxPipeline(jconfig_for("vlp16", **SMALL))
    jpipe.mstate = jpipe.mstate._replace(
        aft_mapped=JPose(jnp.asarray(latest[0]), jnp.asarray(latest[1])),
        **{k: jnp.asarray(v) for k, v in pool.items()})
    return tpipe, jpipe


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("what", ["surf", "corner", "outlier"])
def test_global_map_equal(pipelines, what):
    tpipe, jpipe = pipelines
    for kw in ({}, {"radius": 15.0}, {"radius": 25.0, "center": np.array([1.0, -2.0, 0.5])}):
        a, b = tpipe.global_map(what, **kw), jpipe.global_map(what, **kw)
        assert a.dtype == b.dtype and a.shape == b.shape and len(a) > 0, kw
        assert a.tobytes() == b.tobytes(), kw
    assert len(tpipe.global_map(what, radius=15.0)) < len(tpipe.global_map(what))


def test_export_maps_and_keyframe_dump_byte_identical(pipelines, tmp_path):
    tpipe, jpipe = pipelines
    t_out, j_out = tmp_path / "port", tmp_path / "jax"
    written = tpcd.export_maps(tpipe, str(t_out))
    jpcd.export_maps(jpipe, str(j_out))
    ta, ja = _files(t_out), _files(j_out)
    assert sorted(ta) == ["cornerMap.pcd", "finalCloud.pcd", "surfaceMap.pcd",
                          "trajectory.pcd"]
    assert ta == ja
    assert written[str(t_out / "trajectory.pcd")] == N_KF
    np.testing.assert_array_equal(tpcd.load_pcd(str(t_out / "surfaceMap.pcd")),
                                  tpipe.global_map("surf"))
    for k in (0, N_KF - 1):
        assert (tdebug.dump_keyframe(tpipe, k, str(t_out / "kf"))
                == jdebug.dump_keyframe(jpipe, k, str(j_out / "kf")))
    assert _files(t_out / "kf") == _files(j_out / "kf")


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_round_trip(tmp_path, binary):
    pts = np.random.default_rng(3).uniform(-60, 60, (500, 3)).astype(np.float32)
    tp, jp = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    tpcd.save_pcd(tp, pts, binary=binary)
    jpcd.save_pcd(jp, pts, binary=binary)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    got = tpcd.load_pcd(tp)
    np.testing.assert_array_equal(got, jpcd.load_pcd(tp))
    if binary:
        np.testing.assert_array_equal(got, pts)
    else:   # "%.6f" text
        np.testing.assert_allclose(got, pts, atol=5e-6)
    empty = str(tmp_path / "empty.pcd")
    tpcd.save_pcd(empty, np.zeros((0, 3), np.float32), binary=binary)
    assert tpcd.load_pcd(empty).shape == (0, 3)


def test_dump_stages_matches_jax(tmp_path):
    cfg = config_for("vlp16", **SMALL)
    _, scans = slice_course(cfg.sensor, 1)
    tc = tdebug.dump_stages(cfg, *scans[0], out_dir=str(tmp_path / "t"),
                            prefix="f0_", device="cpu")
    jc = jdebug.dump_stages(jconfig_for("vlp16", **SMALL), *scans[0],
                            out_dir=str(tmp_path / "j"), prefix="f0_")
    assert tc == jc
    assert all(tc[s] > 0 for s in ("projected", "ground", "segmented", "sharp",
                                   "less_flat"))
    for stage in tc:
        a = tpcd.load_pcd(str(tmp_path / "t" / f"f0_{stage}.pcd"))
        b = jpcd.load_pcd(str(tmp_path / "j" / f"f0_{stage}.pcd"))
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=stage)


def test_native_reader_matches_jax_package(tmp_path):
    assert tfast.available(), tfast.build_info
    assert os.path.dirname(tfast.build_info["path"]) == str(tfast.BUILD_DIR)
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(3000, 4)).astype(np.float32)
    p = str(tmp_path / "scan.bin")
    pts.tofile(p)
    got = tfast.read_kitti_bin(p)
    assert got.tobytes() == pts.tobytes() == jfast.read_kitti_bin(p).tobytes()

    rng = np.random.default_rng(11)
    for _ in range(30):
        n = int(rng.integers(0, 300))
        cols = int(rng.choice([3, 4]))
        cap = int(rng.integers(1, 400))
        pts = rng.normal(size=(n, cols)).astype(np.float32)
        for bad in (np.nan, np.inf, -np.inf):
            pts[rng.random((n, cols)) < 0.07] = bad
        x_t, v_t = tfast.pad_scan_native(pts, cap)
        x_j, v_j = jfast.pad_scan_native(pts, cap)
        assert x_t.tobytes() == x_j.tobytes() and np.array_equal(v_t, v_j)

    paths, clouds = [], []
    for k in range(6):
        c = rng.normal(size=(100 + 10 * k, 4)).astype(np.float32)
        paths.append(str(tmp_path / f"{k:06d}.bin"))
        c.tofile(paths[-1])
        clouds.append(c)
    pf = tfast.Prefetcher(paths)
    got = list(pf)
    pf.close()
    assert len(got) == len(clouds)
    for g, c in zip(got, clouds):
        assert g.tobytes() == c.tobytes()
