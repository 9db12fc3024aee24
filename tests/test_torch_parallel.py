"""The distributed back end (lego_loam_tpu_torch/parallel/) on the CPU, its
ranks threads of this process over real gloo groups (tests/torch_ranks.py),
against the JAX package's parallel/ and against the port's single-device
path.  No JAX shard_map, chunk or batch program is built here but the
sharded back-end step that tests/test_distributed.py builds, with its
config.

Tolerances:
  * the edge list: integer fields equal, residuals within 1e-5 of their
    largest entry; partial blocks summed over 4 shards within 1e-5 of the
    largest entry of one shard's;
  * the sharded pose-graph solve at W = 1, 2, 8 against the JAX package's
    solve_pose_graph_single: 1 mm / 0.01 deg (both are the same exact GN
    steps in float32; the rounding differs);
  * knn_sharded: d2 within 1e-6 of the port's knn on the whole map, the
    same indices where a query's distances are apart by more than that;
  * the sharded mapping step at W = 8 against the JAX package's at W = 8
    from one state: test_torch_backend.py's 5 mm / 0.05 deg, with n_kf and
    the inserted blocks equal; at W = 1 against the port's mapping_step:
    1e-5 m (the same solve; the local map is assembled in the same order);
  * the sharded loop check against the port's loop_closure_step: the same
    closed flag and loop edge, poses within 1e-5 (the clouds come out of
    the pool exactly, then the same check runs);
  * ShardedBackend over a course whose pool compacts: its compaction
    equal to compact_keyframes on the gathered pool; at W = 1 every mapped
    pose within 1 mm of LegoLoamPipeline's and n_kf equal; at W = 2 n_kf
    equal and the largest divergence under 0.15 m, the bound of
    test_sharded_backend_trajectory_parity's first assert (each shard
    voxel-downsamples its own part of the map, so the maps differ by
    design).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.models import mapping as jmp
from lego_loam_tpu.parallel import backend_sharded as jbs
from lego_loam_tpu.parallel import graph as jgraph
from lego_loam_tpu.utils.math3d import Pose as JPose
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import synthetic as tsyn
from lego_loam_tpu_torch.models import loop as tlc
from lego_loam_tpu_torch.models import mapping as tmp
from lego_loam_tpu_torch.models import pipeline as tpl
from lego_loam_tpu_torch.ops.knn import knn
from lego_loam_tpu_torch.parallel import backend_sharded as tbs
from lego_loam_tpu_torch.parallel import graph as tgraph
from lego_loam_tpu_torch.parallel.map_sharded import knn_sharded, merge_candidates
from lego_loam_tpu_torch.utils.convert import (gather_pool, shard_pool,
                                               state_from_numpy, state_to_numpy)

from tests.test_distributed import _loop_state
from tests.test_posegraph import CFG as PG_JCFG
from tests.test_torch_backend import _rot_err_deg
from tests.test_torch_loop import TCFG as LOOP_TCFG
from tests.test_torch_loop import pool  # noqa: F401 -- the fixture
from tests.torch_courses import LOOP, SMALL, slice_course
from tests.torch_ranks import mapping_features, run_ranks, sharded_course

PG_TCFG = config_for("vlp16", **{
    k: getattr(PG_JCFG, k) for k in (
        "deskew", "max_keyframes", "max_map_corner", "max_map_surf",
        "kf_corner_cap", "kf_surf_cap", "kf_outlier_cap", "max_scan_corner_ds",
        "max_scan_surf_ds", "nn_query_tile", "max_loop_edges", "pg_gn_iters")})
# tests/test_distributed.py::test_backend_step_sharded_matches_single's config
STEP_KNOBS = dict(deskew=False, max_keyframes=64, max_map_corner=4096,
                  max_map_surf=16384, kf_corner_cap=512, kf_surf_cap=2048,
                  kf_outlier_cap=512, max_scan_corner_ds=512,
                  max_scan_surf_ds=2048, nn_query_tile=512,
                  mapping_process_every=1, nn_exact=True)
# a pool of 8 that compacts within the course, every scan mapped, at
# tests/torch_courses.LOOP's capacities (half the map of SMALL's: the ranks
# repeat the solve), on an OS1-16 (16 x 1024: a cheaper front end)
COMPACT_CFG = config_for("os1_16", **dict(SMALL, max_keyframes=8,
                                         mapping_process_every=1, **{
                                             k: LOOP[k] for k in (
                                                 "max_map_corner", "kf_corner_cap",
                                                 "kf_surf_cap", "kf_outlier_cap",
                                                 "max_scan_corner_ds",
                                                 "max_scan_surf_ds")}))
COMPACT_SCANS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the ranks are threads, and the suite runs several
    workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(x):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_np_tree(v) for v in x))
    return np.asarray(x)


def _to_jax_state(st, jcfg):
    """A port MappingState (numpy leaves) as the JAX package's, each field
    in the dtype of the JAX package's init_state."""
    ref = jmp.init_state(jcfg)
    vals = {}
    for f in ref._fields:
        r, v = getattr(ref, f), getattr(st, f)
        vals[f] = (JPose(jnp.asarray(v.R, r.R.dtype), jnp.asarray(v.t, r.t.dtype))
                   if isinstance(r, JPose) else jnp.asarray(np.asarray(v), r.dtype))
    return jmp.MappingState(**vals)


def _assert_poses(R, t, R_ref, t_ref, pos, deg, n=None):
    R, t, R_ref, t_ref = (np.asarray(a)[:n] for a in (R, t, R_ref, t_ref))
    np.testing.assert_allclose(t, t_ref, rtol=0, atol=pos)
    for k in range(len(R)):
        assert _rot_err_deg(R_ref[k], R[k]) < deg, k


# ---------------------------------------------------------------- graph.py

@pytest.fixture(scope="module")
def loop_state():
    """tests/test_distributed.py's 32-keyframe circle with one loop edge,
    as host arrays, its keyframes 5 cm off their warm start (which is
    already near the optimum) so that the solve has work to do."""
    state, _, n = _loop_state()
    st = _np_tree(jax.device_get(state))
    kf_t = st.kf_t.copy()
    kf_t[1:n] += np.random.default_rng(0).normal(0, 0.05, (n - 1, 3)).astype(np.float32)
    return st._replace(kf_t=kf_t), n


def test_edge_list_matches_jax(loop_state):
    st, _ = loop_state
    jedges = jgraph.build_edge_list(jax.device_put(st), PG_JCFG)
    tst = state_from_numpy(st, "cpu")
    tedges = tgraph.build_edge_list(tst, PG_TCFG)
    for f in ("src", "dst", "kind", "tri", "lslot"):
        np.testing.assert_array_equal(getattr(tedges, f).numpy(),
                                      np.asarray(getattr(jedges, f)), err_msg=f)
    for f in ("Z_R", "Z_t", "w_rot", "w_trans"):
        np.testing.assert_array_equal(getattr(tedges, f).numpy(),
                                      np.asarray(getattr(jedges, f)), err_msg=f)
    jr = np.asarray(jgraph.edge_residuals(jedges, st.kf_R, st.kf_t))
    tr = tgraph.edge_residuals(tedges, tst.kf_R, tst.kf_t).numpy()
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5 * np.abs(jr).max())
    assert np.abs(jr).max() > 1.0


def test_blocks_summed_over_shards_match_one_shard(loop_state):
    st, _ = loop_state
    tst = state_from_numpy(st, "cpu")
    K, L = PG_TCFG.max_keyframes, PG_TCFG.max_loop_edges
    edges = tgraph.build_edge_list(tst, PG_TCFG, pad_to=tgraph._round_up(K + L + 1, 32))
    whole = tgraph._accumulate_blocks(edges, tst.kf_R, tst.kf_t, K, L)
    parts = [tgraph._accumulate_blocks(tgraph.shard_edges(edges, r, 4), tst.kf_R,
                                       tst.kf_t, K, L) for r in range(4)]
    for i, name in enumerate(("D", "U", "b", "A", "B", "r_loop")):
        total = sum(p[i] for p in parts).numpy()
        ref = whole[i].numpy()
        np.testing.assert_allclose(total, ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
        assert np.abs(ref).max() > 0, name


@pytest.mark.parametrize("world", [1, 2, 8])
def test_sharded_pose_graph_solve_matches_jax(loop_state, world):
    st, n = loop_state
    jR, jt = jax.device_get(jgraph.solve_pose_graph_single(jax.device_put(st), PG_JCFG))
    outs = run_ranks(lambda comm: tgraph.solve_pose_graph_sharded(
        state_from_numpy(st, "cpu"), PG_TCFG, comm), world)
    R, t = outs[0]
    for Rr, tr in outs[1:]:          # replicated: every rank holds the same poses
        assert torch.equal(Rr, R) and torch.equal(tr, t)
    if world == 1:
        R1, t1 = tgraph.solve_pose_graph_single(state_from_numpy(st, "cpu"), PG_TCFG)
        assert torch.equal(R1, R) and torch.equal(t1, t)
    _assert_poses(R.numpy(), t.numpy(), jR, jt, 1e-3, 0.01, n)
    # the solve took the poses back toward the measurements
    assert np.abs(t.numpy()[:n] - st.kf_t[:n]).max() > 0.05


# ---------------------------------------------------------- map_sharded.py

def test_merge_breaks_ties_like_top_k():
    """Equal distances go to the lowest flat index, ranks major."""
    d2 = torch.tensor([[[1.0, 2.0, 2.0]], [[0.5, 2.0, 3.0]]])     # (W=2, Q=1, 3)
    idx = torch.tensor([[[10, 11, 12]], [[20, 21, 22]]])[..., None]
    d, i = merge_candidates(d2, idx, 4)
    assert d.tolist() == [[0.5, 1.0, 2.0, 2.0]]
    assert i[..., 0].tolist() == [[20, 10, 11, 12]]


@pytest.mark.parametrize("world", [2, 4])
def test_knn_sharded_matches_whole_map(world):
    rng = np.random.default_rng(world)
    M, Q, k = 1024, 300, 5
    pts = rng.uniform(-20, 20, (M, 3)).astype(np.float32)
    valid = rng.random(M) > 0.2
    q = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
    tp, tv, tq = map(torch.from_numpy, (pts, valid, q))
    ref_i, ref_d = knn(tq, tp, tv, k)
    shard = M // world
    outs = run_ranks(lambda comm: knn_sharded(
        tq, tp[comm.rank * shard:(comm.rank + 1) * shard],
        tv[comm.rank * shard:(comm.rank + 1) * shard], k, comm), world)
    idx, d2 = outs[0]
    for i_r, d_r in outs[1:]:
        assert torch.equal(i_r, idx) and torch.equal(d_r, d2)
    np.testing.assert_allclose(d2.numpy(), ref_d.numpy(), rtol=0, atol=1e-6)
    rd = ref_d.numpy().astype(np.float64)
    gaps = np.diff(rd, axis=1)
    apart = np.ones_like(rd, bool)
    apart[:, 1:] &= gaps > 1e-6
    apart[:, :-1] &= gaps > 1e-6
    assert apart.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[apart], ref_i.numpy()[apart])


# ------------------------------------------------------ backend_sharded.py

@pytest.fixture(scope="module")
def step_inputs():
    """test_backend_step_sharded_matches_single's course (world seed 5, a
    0.3 rad arc of radius 10 m): the port's pipeline over its first 2
    scans, then the 3rd scan's front end.  Returns the mapping state
    before the 4th solve as host arrays, the solve's clouds, odometry pose
    and features."""
    cfg = config_for("vlp16", **STEP_KNOBS)
    world = tsyn.default_world(seed=5)
    poses = tsyn.circle_trajectory(6, radius=10.0, arc=0.3)
    scans = [tsyn.raycast(world, R, t, cfg.sensor, noise=0.01,
                          rng=np.random.default_rng(50 + k))
             for k, (R, t) in enumerate(poses[:3])]
    pipe = tpl.LegoLoamPipeline(cfg, "cpu", collect_stats=False)
    for s in scans[:2]:
        pipe.process_scan(*s)
    xyz, valid, ring = (torch.as_tensor(a) for a in scans[2])
    ostate, feats, opose, _, _, _ = tpl.frontend_step(
        pipe.ostate, xyz, valid, ring, pipe.mstate.bef_mapped,
        pipe.mstate.aft_mapped, None, cfg, cfg.sensor.use_ring)
    mfeats = feats._replace(less_sharp=ostate.ref_corner, less_flat=ostate.ref_surf)
    return cfg, state_to_numpy(pipe.mstate), tmp.scan_clouds(mfeats, cfg), opose, mfeats


@pytest.fixture(scope="module")
def single_step(step_inputs):
    """The port's mapping_step from step_inputs' state (the map gathered)."""
    cfg, st, _, opose, mfeats = step_inputs
    return tmp.mapping_step(state_from_numpy(st, "cpu"), mfeats, opose, 0.5, cfg,
                            refresh=True)


def test_backend_step_sharded_matches_jax_at_8_ranks(step_inputs, single_step):
    """At 8 ranks against the JAX package's sharded step on its 8-device
    CPU mesh.  The rotation bound is 0.25 deg, not test_torch_backend.py's
    0.05: from this state the two packages' single-device mapping_step
    already differ by 1.62 mm / 0.198 deg (the port's float64 plane fits,
    models/mapping.py FIT_DTYPE, accept 817 surf constraints where the JAX
    package's float32 fits accept 720), and sharding adds nothing on
    either side: the JAX package's step lands on its mapping_step's pose to
    1e-7, and the port's on its own to 1e-5 (asserted here)."""
    cfg, st, clouds, opose, _ = step_inputs
    (cp, cok), (sp, sok), _ = clouds
    jcfg = jconfig_for("vlp16", **STEP_KNOBS)
    mesh = Mesh(np.array(jax.devices()[:8]), ("map",))
    jnew, jT, jn, _ = jax.device_get(jbs.backend_step_sharded(
        _to_jax_state(st, jcfg), *(jnp.asarray(a.numpy()) for a in (cp, cok, sp, sok)),
        JPose(jnp.asarray(opose.R.numpy()), jnp.asarray(opose.t.numpy())), 0.5, jcfg,
        mesh))

    def rank(comm):
        new, T, n_keep, _ = tbs.backend_step_sharded(
            shard_pool(state_from_numpy(st, "cpu"), comm.rank, comm.size),
            cp, cok, sp, sok, opose, 0.5, cfg, comm)
        return new, T, n_keep

    outs = run_ranks(rank, 8)
    new = gather_pool([o[0] for o in outs])
    T = outs[0][1]
    for o in outs[1:]:
        assert torch.equal(o[1].t, T.t) and torch.equal(o[1].R, T.R)
    _assert_poses(T.R[None], T.t[None], jT.R[None], jT.t[None], 5e-3, 0.25)
    T_single = single_step[1]
    _assert_poses(T.R[None], T.t[None], T_single.R[None], T_single.t[None], 1e-5, 1e-3)
    assert int(new.n_kf) == int(jnew.n_kf) == int(st.n_kf) + 1
    slot = int(st.n_kf)
    for f in ("kf_corner", "kf_corner_valid", "kf_surf", "kf_surf_valid"):
        np.testing.assert_array_equal(getattr(new, f)[slot].numpy(),
                                      np.asarray(getattr(jnew, f))[slot], err_msg=f)
    assert min(int(outs[0][2]), int(jn)) >= cfg.map_min_constraints


def test_backend_step_sharded_at_one_rank_is_mapping_step(step_inputs, single_step):
    cfg, st, clouds, opose, _ = step_inputs
    (cp, cok), (sp, sok), outlier = clouds
    ref, T_ref = single_step
    (new, T, _, _), = run_ranks(lambda comm: tbs.backend_step_sharded(
        state_from_numpy(st, "cpu"), cp, cok, sp, sok, opose, 0.5, cfg, comm,
        outlier=outlier), 1)
    np.testing.assert_allclose(T.t.numpy(), T_ref.t.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(T.R.numpy(), T_ref.R.numpy(), rtol=0, atol=1e-5)
    assert int(new.n_kf) == int(ref.n_kf)
    for f in ("kf_outlier", "kf_outlier_valid", "kf_surf", "kf_meas_t"):
        np.testing.assert_allclose(getattr(new, f).numpy(), getattr(ref, f).numpy(),
                                   rtol=0, atol=1e-5, err_msg=f)


@pytest.fixture(scope="module")
def loop_check(pool):  # noqa: F811
    """The port's single-device loop check on tests/test_torch_loop.py's
    pool (12 keyframes), with test_loop_closure_step_matches_jax's graph
    weights."""
    st, _ = pool
    cfg = LOOP_TCFG.replace(pg_trans_sigma=0.05, pg_rot_sigma=0.005)
    return st, cfg, tlc.loop_closure_step(state_from_numpy(st, "cpu"), 40.0, cfg)


def test_loop_closure_step_sharded_matches_single(loop_check):
    st, cfg, (ref, rres) = loop_check
    outs = run_ranks(lambda comm: tbs.loop_closure_step_sharded(
        shard_pool(state_from_numpy(st, "cpu"), comm.rank, comm.size), 40.0, cfg,
        comm), 2)
    new, res = outs[0]
    assert bool(rres.closed) and bool(res.closed)
    assert int(res.candidate) == int(rres.candidate)
    assert int(new.n_loops) == int(ref.n_loops) == 1
    for f in ("loop_i", "loop_j"):
        assert torch.equal(getattr(new, f), getattr(ref, f)), f
    for f in ("loop_R", "loop_t", "loop_w", "kf_R", "kf_t"):
        np.testing.assert_allclose(getattr(new, f).numpy(), getattr(ref, f).numpy(),
                                   rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(new.aft_mapped.t.numpy(), ref.aft_mapped.t.numpy(),
                               rtol=0, atol=1e-5)
    for f in ("kf_t", "loop_t"):           # replicated on both ranks
        assert torch.equal(getattr(outs[1][0], f), getattr(new, f)), f


@pytest.fixture(scope="module")
def compact_course():
    """COMPACT_SCANS scans of tests/torch_courses.slice_course (0.8 m
    apart, so every solve inserts and the pool of 8 compacts at the 8th)
    through LegoLoamPipeline: its front-end outputs (recorded, to feed the
    sharded back ends), mapped poses and keyframe counts."""
    cfg = COMPACT_CFG
    _, scans = slice_course(cfg.sensor, COMPACT_SCANS)
    fronts = []

    def recorded(*a, **kw):
        out = frontend(*a, **kw)
        fronts.append(mapping_features(out[0], out[1], out[2]))
        return out

    frontend, tpl.frontend_step = tpl.frontend_step, recorded
    try:
        pipe = tpl.LegoLoamPipeline(cfg, "cpu", collect_stats=False)
        mapped, n_kf = [], []
        for s in scans:
            mapped.append(pipe.process_scan(*s).mapped_pose)
            n_kf.append(int(pipe.mstate.n_kf))
    finally:
        tpl.frontend_step = frontend
    # a keyframe a solve up to 7, then the 8th solve compacts first (7 -> 6,
    # keyframe 1 dropped) and inserts
    assert n_kf == [1, 2, 3, 4, 5, 6, 7, 7]
    assert float(pipe.mstate.kf_time[1]) > 1.5 * cfg.sensor.scan_period
    return fronts, mapped, n_kf


def _backend_run(comm, fronts):
    be = tbs.ShardedBackend(tmp.init_state(COMPACT_CFG, "cpu"), COMPACT_CFG, comm,
                            compact_check_every=1)
    mapped, _, _ = sharded_course(be, COMPACT_CFG, fronts)
    return mapped, int(be.state.n_kf), be


def test_sharded_backend_at_one_rank_is_the_pipeline(compact_course):
    fronts, ref, n_kf = compact_course
    (mapped, n, be), = run_ranks(lambda comm: _backend_run(comm, fronts), 1)
    assert n == n_kf[-1]
    assert float(be.state.kf_time[1]) > 1.5 * COMPACT_CFG.sensor.scan_period
    _assert_poses(torch.stack([T.R for T in mapped]), torch.stack([T.t for T in mapped]),
                  torch.stack([T.R for T in ref]), torch.stack([T.t for T in ref]),
                  1e-3, 0.01)


def test_sharded_backend_at_two_ranks_tracks_the_pipeline_and_compacts(compact_course):
    fronts, ref, n_kf = compact_course

    def rank(comm):
        mapped, n, be = _backend_run(comm, fronts)
        before = be.state
        be._compact()
        return mapped, n, before, be.state

    outs = run_ranks(rank, 2)
    mapped, n = outs[0][0], outs[0][1]
    assert n == n_kf[-1]
    err = np.linalg.norm(np.stack([T.t.numpy() for T in mapped])
                         - np.stack([T.t.numpy() for T in ref]), axis=1)
    assert err.max() < 0.15, err
    # the compaction: the gathered pool thinned by compact_keyframes
    want = tmp.compact_keyframes(gather_pool([o[2] for o in outs]), COMPACT_CFG)
    got = gather_pool([o[3] for o in outs])
    assert int(got.n_kf) == int(want.n_kf) < n
    for f in tmp.MappingState._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f
