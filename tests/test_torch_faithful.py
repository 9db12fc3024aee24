"""The reference-faithful configuration (tests/torch_courses.FAITHFUL:
sequential sector picks, the two-step odometry, the 3-point surf plane, no
ground-label gate, no prominence gate) in the port on the CPU.

  * the feature-label step in the sequential order (K2's plain version,
    what a CPU scan runs) against the JAX package's label_features and
    against the NumPy oracle of the C++ reference's order
    (tests/oracle_features.oracle_extract), on tests/test_features.py's
    scan and config, and on one HDL-64E scan (rows from elevation math,
    each point moved into the middle of its row by mid_row), one packed
    scan fed to all three: labels and
    picked masks equal to the JAX package's, labels equal to the oracle's,
    exactly;
  * LegoLoamPipeline.process_scan in FAITHFUL with tests/torch_courses.py's
    SMALL capacities over the 6-scan slice course against the JAX
    package's process_scan: fused poses within 1 cm / 0.1 deg (the bound
    of tests/test_torch_pipeline.py, whose docstring says why), the packed
    stats and the mapping cadence equal, and the same keyframes;
  * BatchPipeline in FAITHFUL at B = 2 over 4 scans in chunks of 2 against
    each sequence alone through LegoLoamPipeline.process_chunk (plain
    versions on the CPU): every pose within 1 mm / 0.01 deg (the bound of
    tests/test_torch_batch.py), stats, did_map and keyframe counts equal,
    and no vmap per-example fallback.

The odometry's three schedules with either surf fit are held to the JAX
package in tests/test_torch_backend.py::test_odometry_step_modes, and E1
at 3x3 in tests/test_torch_eig6.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline
from lego_loam_tpu.ops.features import label_features as jlabel_features
from lego_loam_tpu.types import SegmentedScan as JSegmentedScan
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.models import batch as bt
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from lego_loam_tpu_torch.ops import eig6, features
from lego_loam_tpu_torch.ops.compaction import segment_scan
from lego_loam_tpu_torch.ops.projection import project_scan

from tests import oracle_features as ofeat
from tests.test_torch_backend import _rot_err_deg
from tests.test_torch_batch import FALLBACK, second_course
from tests.test_torch_sensor_rows import mid_row
from tests.torch_courses import FAITHFUL, SMALL, slice_course

POS_TOL, ROT_TOL_DEG = 1e-2, 0.1     # against the JAX package
SAME_M, SAME_DEG = 1e-3, 0.01        # the batch against the port alone


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several workers share the host; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan(preset):
    """(jax cfg, port cfg, packed scan) of one scan: tests/test_features.py's
    at VLP-16, a mid-row HDL-64E scan without a ring channel otherwise.
    The port packs it (the packed fields equal the JAX package's,
    tests/test_torch_frontend.py::test_compaction)."""
    kw = dict(sector_parallel=False, edge_prominence=0.0)
    jcfg, tcfg = jconfig_for(preset, **kw), config_for(preset, **kw)
    world = syn.default_world(seed=5)
    xyz, valid, ring = syn.raycast(world, np.eye(3), np.array([1.0, -2.0, 1.6]),
                                   tcfg.sensor, noise=0.01)
    if not tcfg.sensor.use_ring:
        xyz, ring = mid_row(xyz, tcfg.sensor), None
    img = project_scan(torch.as_tensor(xyz), torch.as_tensor(valid), tcfg,
                       None if ring is None else torch.as_tensor(ring))
    return jcfg, tcfg, segment_scan(img, tcfg)[0]


@pytest.mark.parametrize("preset", ["vlp16", "hdl64e"])
def test_sequential_picks_match_jax_and_oracle(preset):
    jcfg, tcfg, tp = _scan(preset)
    jp = JSegmentedScan(*(jnp.asarray(v.numpy()) for v in tp))
    n = features.label_features.launches
    lab, pick = features.label_features(tp, tcfg)
    assert features.label_features.launches == n     # CPU: the plain version
    lab_j, pick_j = jax.device_get(jlabel_features(jp, jcfg))
    np.testing.assert_array_equal(lab.numpy(), lab_j)
    np.testing.assert_array_equal(pick.numpy(), pick_j)
    # the oracle's labels (its picked mask is its own bookkeeping, which
    # tests/test_features.py does not hold either)
    lab_o = ofeat.oracle_extract(
        *(getattr(tp, f).numpy() for f in ("rng", "col", "ground", "valid",
                                           "count")), jcfg)[0]
    np.testing.assert_array_equal(lab.numpy(), lab_o)
    assert (lab.numpy() == 2).sum() > 20 and (lab.numpy() == -1).sum() > 50
    # the order matters on this scan: sector_parallel labels differ
    lab_par, _ = features.label_features(tp, tcfg.replace(sector_parallel=True))
    assert not torch.equal(lab_par, lab)


def test_faithful_slice_matches_jax_pipeline():
    jcfg = jconfig_for("vlp16", **dict(SMALL, **FAITHFUL))
    tcfg = config_for("vlp16", **dict(SMALL, **FAITHFUL))
    poses, scans = slice_course(tcfg.sensor)
    jpipe, tpipe = JaxPipeline(jcfg), LegoLoamPipeline(tcfg, "cpu")
    launches = eig6.eig6.launches
    gap_m = gap_deg = 0.0
    for xyz, valid, ring in scans:
        jr = jpipe.process_scan(xyz, valid, ring)
        tr = tpipe.process_scan(xyz, valid, ring)
        assert tr.stats == jr.stats
        assert (tr.mapped_pose is None) == (jr.mapped_pose is None)
        gap_m = max(gap_m, float(np.abs(tr.fused_pose.t.numpy()
                                        - np.asarray(jr.fused_pose.t)).max()))
        gap_deg = max(gap_deg, _rot_err_deg(np.asarray(jr.fused_pose.R),
                                            tr.fused_pose.R.numpy()))
    print(f"FAITHFUL slice: largest fused gap to the JAX package "
          f"{gap_m * 1e3:.4f} mm / {gap_deg:.5f} deg")
    assert gap_m < POS_TOL and gap_deg < ROT_TOL_DEG
    np.testing.assert_allclose(tpipe.keyframe_poses(), jpipe.keyframe_poses(),
                               atol=POS_TOL)
    assert eig6.eig6.launches == launches            # CPU: no kernel
    R0, t0 = poses[0]
    errs = [np.linalg.norm(R0 @ p + t0 - t) for p, (_, t) in zip(tpipe.trajectory, poses)]
    assert np.sqrt(np.mean(np.square(errs))) < 0.15


def _chunk(scans):
    return tuple(np.stack([s[i] for s in scans]) for i in range(3))


@pytest.mark.filterwarnings(f"error:{FALLBACK}")
def test_faithful_batch_matches_each_sequence_alone():
    cfg = config_for("vlp16", **dict(SMALL, **FAITHFUL))
    seqs = [slice_course(cfg.sensor, 4)[1], second_course(cfg.sensor, 4)]
    C = 2
    bp = bt.BatchPipeline(cfg, 2, device="cpu")
    results = [bp.process_chunk(*(np.stack(a) for a in zip(
        *(_chunk(seq[c0:c0 + C]) for seq in seqs)))) for c0 in range(0, 4, C)]
    for b, seq in enumerate(seqs):
        pipe = LegoLoamPipeline(cfg, "cpu")
        alone = [pipe.process_chunk(*_chunk(seq[c0:c0 + C])) for c0 in range(0, 4, C)]
        for res, ref in zip(results, alone):
            assert torch.equal(res.did_map, ref.did_map)
            assert torch.equal(res.stats[b], ref.stats)
            for f in ("odom_poses", "fused_poses", "mapped_poses"):
                got, want = getattr(res, f), getattr(ref, f)
                np.testing.assert_allclose(got.t[b].numpy(), want.t.numpy(),
                                           atol=SAME_M)
                for j in range(want.R.shape[0]):
                    assert _rot_err_deg(want.R[j].numpy(),
                                        got.R[b, j].numpy()) < SAME_DEG
        assert bp.keyframe_counts()[b] == int(pipe.mstate.n_kf)


def test_oracle_course_is_the_oracle_tests():
    """chip_smoke.py's oracle phase drives tests/test_oracle_pipeline.py's
    config and course: tests/torch_courses.ORACLE_CFG gives that test's
    CFG field for field, and oracle_course its poses and scans."""
    import dataclasses

    from tests import test_oracle_pipeline as top
    from tests.torch_courses import ORACLE_CFG, oracle_course

    assert dataclasses.asdict(config_for("vlp16", **ORACLE_CFG)) == \
        dataclasses.asdict(top.CFG)
    poses, scans = oracle_course(top.CFG.sensor, 2)
    want = top.syn.circle_trajectory(15, radius=12.0, arc=0.35)[:2]
    for (R, t), (Rw, tw) in zip(poses, want):
        np.testing.assert_array_equal(R, Rw)
        np.testing.assert_array_equal(t, tw)
    xyz0, valid0, _ = top.syn.raycast(top.syn.default_world(seed=11), *want[1],
                                          top.CFG.sensor, noise=0.01,
                                          rng=np.random.default_rng(501))
    np.testing.assert_array_equal(scans[1][0], xyz0)
    np.testing.assert_array_equal(scans[1][1], valid0)
