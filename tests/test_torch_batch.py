"""Fleet batching in the port (models/batch.py: BatchPipeline,
batch_chunk_steps, the per-scan step under torch.func.vmap) on the CPU.

  * the four kernels' custom ops under torch.func.vmap: K1 (label
    propagation), K2 (the feature-label step) and K3 (k-NN) over B = 3
    stacked inputs from real SMALL scans, E1 (the degeneracy projection)
    over B = 3 stacks of tests/torch_courses.eig6_spectra, each equal to a
    loop of unbatched calls exactly;
  * BatchPipeline at B = 2 on tests/torch_courses.py's SMALL config over
    two sequences of 6 scans in chunks of 3 (the slice course and a second
    circle in the same world), each sequence against the port's own
    LegoLoamPipeline.process_chunk on it: every odometry, fused and mapped
    pose within 1 mm / 0.01 deg, did_map, the packed stats and the
    keyframe count equal (the largest gap is printed);
  * the same sequences against the JAX package's process_scan at
    tests/test_torch_chunk.py's 1 cm / 0.1 deg, with equal stats and
    mapping cadence.  No JAX chunk_steps or batch_chunk_steps program is
    built: cold, those take minutes on a CPU; the JAX package's own
    tests/test_batch.py holds its BatchPipeline to per-sequence replay;
  * a batched mapping_step whose sequences disagree on the local-map
    refresh (map_stale in one only) against the two unbatched steps;
  * pool thinning under the JAX package's batch policy on two stacked
    states with different keyframe counts, carried across from the JAX
    package, against jax.vmap of its compact_keyframes;
  * a stacked JAX state carried across both ways (utils/convert.py), the
    host fields one a sequence;
  * BatchPipeline's input errors.

Every test runs with vmap's per-example fallback warning ("There is a
performance drop ...") turned into an error: no op of the batch path may
fall back to a loop over the batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map, tree_map_only

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.models import mapping as jmap
from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.models import batch as bt
from lego_loam_tpu_torch.models import mapping as mp
from lego_loam_tpu_torch.models.pipeline import STAT_NAMES, LegoLoamPipeline
from lego_loam_tpu_torch.ops import eig6, features, knn, segmentation
from lego_loam_tpu_torch.ops.compaction import segment_scan
from lego_loam_tpu_torch.ops.features import extract_features
from lego_loam_tpu_torch.ops.ground import mark_ground
from lego_loam_tpu_torch.ops.projection import project_scan
from lego_loam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

from tests.test_torch_backend import _rot_err_deg
from tests.torch_courses import SMALL, eig6_spectra, slice_course

FALLBACK = "There is a performance drop"
pytestmark = pytest.mark.filterwarnings(f"error:{FALLBACK}")

SAME_M, SAME_DEG = 1e-3, 0.01        # the batch against the port, per sequence
JAX_M, JAX_DEG = 1e-2, 0.1           # against the JAX package's process_scan
C = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several workers share the host; one torch thread each (as
    tests/test_torch_chunk.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def second_course(sensor, n: int = 6):
    """The batch's second sequence: a 9 m circle over 0.4 pi in the slice
    course's world (seed 4), 1 cm range noise (seed 100 + index)."""
    world = syn.default_world(seed=4)
    poses = syn.circle_trajectory(12, radius=9.0, arc=0.4 * np.pi)[:n]
    return [syn.raycast(world, R, t, sensor, noise=0.01,
                        rng=np.random.default_rng(100 + k))
            for k, (R, t) in enumerate(poses)]


def _chunk(scans):
    return tuple(np.stack([s[i] for s in scans]) for i in range(3))


@pytest.fixture(scope="module")
def course():
    cfg = config_for("vlp16", **SMALL)
    return cfg, [slice_course(cfg.sensor)[1], second_course(cfg.sensor)]


@pytest.fixture(scope="module")
def batch_run(course):
    cfg, seqs = course
    bp = bt.BatchPipeline(cfg, 2, device="cpu")
    results = []
    for c0 in range(0, len(seqs[0]), C):
        parts = [_chunk(seq[c0:c0 + C]) for seq in seqs]
        results.append(bp.process_chunk(*(np.stack([p[i] for p in parts])
                                          for i in range(3))))
    return bp, results


@pytest.fixture(scope="module")
def port_runs(course):
    cfg, seqs = course
    runs = []
    for seq in seqs:
        pipe = LegoLoamPipeline(cfg, "cpu")
        runs.append((pipe, [pipe.process_chunk(*_chunk(seq[c0:c0 + C]))
                            for c0 in range(0, len(seq), C)]))
    return runs


# ------------------------------------------------------------ kernels

def _stack_tuples(items):
    return type(items[0])(*(None if v is None else torch.stack(
        [getattr(it, f) for it in items]) for f, v in zip(items[0]._fields,
                                                         items[0])))


@pytest.fixture(scope="module")
def kernel_inputs(course):
    """Per-scan inputs of K1, K2 and K3 from 3 scans of the slice course."""
    cfg, seqs = course
    k1, k2, k3 = [], [], []
    imgs = []
    for xyz, valid, ring in seqs[0][:3]:
        img = project_scan(torch.as_tensor(xyz), torch.as_tensor(valid), cfg,
                           torch.as_tensor(ring))
        imgs.append(img)
        ground = mark_ground(img, cfg)
        k1.append(segmentation.label_inputs(
            *segmentation.build_edges(img, ground, cfg)))
        k2.append(segment_scan(img, cfg)[0])
    for b in range(3):
        pts = imgs[b].xyz.reshape(-1, 3)
        ref = imgs[(b + 1) % 3]
        k3.append((pts[::37][:512].contiguous(),
                   ref.xyz.reshape(-1, 3)[::7][:4096].contiguous(),
                   ref.valid.reshape(-1)[::7][:4096].contiguous()))
    return cfg, k1, k2, k3


def _k1(cfg, k1, k2, k3):
    args = [torch.stack(a) for a in zip(*k1)]
    got = torch.func.vmap(segmentation.propagate_labels)(*args)
    want = torch.stack([segmentation.propagate_labels(*a) for a in k1])
    return [(got, want)]


def _k2(cfg, k1, k2, k3):
    got = torch.func.vmap(lambda p: features.label_features(p, cfg))(
        _stack_tuples(k2))
    want = [features.label_features(p, cfg) for p in k2]
    return [(g, torch.stack(w)) for g, w in zip(got, zip(*want))]


def _k3(cfg, k1, k2, k3):
    args = [torch.stack(a) for a in zip(*k3)]
    out = []
    for k in (1, 5):
        got = torch.func.vmap(lambda q, r, v: knn.knn(q, r, v, k, 256))(*args)
        want = [knn.knn(*a, k, 256) for a in k3]
        out += [(g, torch.stack(w)) for g, w in zip(got, zip(*want))]
    return out


def _e1(cfg, k1, k2, k3):
    out = []
    for thresh in (cfg.odom_degen_eig_thresh, cfg.map_degen_eig_thresh):
        Hs = [torch.as_tensor(H) for _, H in eig6_spectra(thresh)]
        n = len(Hs) // 3
        H = torch.stack(Hs[:3 * n]).reshape(3, n, 6, 6)
        got = torch.func.vmap(lambda h: eig6.degeneracy_projection(h, thresh))(H)
        want = [eig6.degeneracy_projection(h, thresh) for h in Hs[:3 * n]]
        out += [(g, torch.stack(w).reshape(g.shape))
                for g, w in zip(got, zip(*want))]
    return out


@pytest.mark.parametrize("case", [_k1, _k2, _k3, _e1],
                         ids=["k1", "k2", "k3", "e1"])
def test_kernel_ops_under_vmap(kernel_inputs, case):
    """One vmapped call of each custom op (one launch on the card) equals
    the loop of unbatched calls bit for bit."""
    for got, want in case(*kernel_inputs):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)


def test_fallback_warning_is_an_error():
    """The module's filter catches vmap's per-example fallback (the op of
    the pool insert before it became index_put_)."""
    arr = torch.zeros((2, 4, 3))

    def ins(a, s, r):
        return a.index_copy_(0, s.reshape(1), r[None])

    with pytest.raises(UserWarning, match=FALLBACK):
        torch.func.vmap(ins)(arr, torch.tensor([1, 2]), torch.ones((2, 3)))


# --------------------------------------------------- the slice, batched

def _pose_gap(R, t, R_ref, t_ref):
    return (float(np.abs(t.numpy() - t_ref.numpy()).max()),
            _rot_err_deg(R_ref.numpy(), R.numpy()))


@pytest.mark.parametrize("b", [0, 1])
def test_batch_matches_port_per_sequence(batch_run, port_runs, b):
    bp, results = batch_run
    pipe, rows = port_runs[b]
    gap_m = gap_deg = 0.0
    for res, ref in zip(results, rows):
        assert torch.equal(res.did_map, ref.did_map)
        assert torch.equal(res.stats[b], ref.stats)
        assert torch.equal(res.loop_closed[b], ref.loop_closed)
        for f in ("odom_poses", "fused_poses", "mapped_poses"):
            got, want = getattr(res, f), getattr(ref, f)
            for j in range(want.t.shape[0]):
                m, deg = _pose_gap(got.R[b, j], got.t[b, j], want.R[j], want.t[j])
                gap_m, gap_deg = max(gap_m, m), max(gap_deg, deg)
    print(f"sequence {b}: largest gap to the port's process_chunk "
          f"{gap_m * 1e3:.6f} mm / {gap_deg:.6f} deg")
    assert gap_m < SAME_M and gap_deg < SAME_DEG
    assert bp.keyframe_counts()[b] == int(pipe.mstate.n_kf)
    assert bp.frame == pipe.frame == 6
    assert bp.mstate.map_age[b] == pipe.mstate.map_age
    np.testing.assert_allclose(bp.mstate.kf_t[b].numpy(), pipe.mstate.kf_t.numpy(),
                               atol=SAME_M)
    traj = torch.cat([t[b] for t in bp.trajectory])
    np.testing.assert_allclose(traj.numpy(), np.stack(pipe.trajectory), atol=SAME_M)


@pytest.mark.parametrize("b", [0, 1])
def test_batch_matches_jax_process_scan(course, batch_run, b):
    _, seqs = course
    _, results = batch_run
    jpipe = JaxPipeline(jconfig_for("vlp16", **SMALL))
    jrows = [jpipe.process_scan(*s) for s in seqs[b]]
    fused = [(r.fused_poses.R[b, j], r.fused_poses.t[b, j]) for r in results
             for j in range(C)]
    stats = torch.cat([r.stats[b] for r in results]).tolist()
    did_map = torch.cat([r.did_map for r in results]).tolist()
    for k, jr in enumerate(jrows):
        assert stats[k] == [jr.stats[n] for n in STAT_NAMES], k
        assert did_map[k] == (jr.mapped_pose is not None), k
        np.testing.assert_allclose(fused[k][1].numpy(), np.asarray(jr.fused_pose.t),
                                   atol=JAX_M)
        assert _rot_err_deg(np.asarray(jr.fused_pose.R), fused[k][0].numpy()) < JAX_DEG
    assert batch_run[0].keyframe_counts()[b] == int(jpipe.mstate.n_kf)


# ---------------------------------------------- disagreeing map refresh

def _clone(state):
    return tree_map_only(torch.Tensor, torch.clone, state)


def _stack2(a, b):
    """Two states stacked on a new leading axis (host fields from `a`)."""
    return tree_map(lambda u, v: torch.stack([u, v])
                    if isinstance(u, torch.Tensor) else u, a, b)


def test_refresh_that_sequences_disagree_on(course, port_runs):
    """One solve of each sequence, map_stale in the first only: under vmap
    the refresh is a per-sequence select (gather for both, keep the first's
    new map and the second's cached one), equal to the unbatched steps."""
    cfg, seqs = course
    inputs = []
    for (pipe, _), seq in zip(port_runs, seqs):
        # the solve's clouds: the odometry's references and the last scan's
        # outliers, at the latest odometry pose
        xyz, valid, ring = (torch.as_tensor(a) for a in seq[-1])
        packed, o_rel, _, _ = segment_scan(project_scan(xyz, valid, cfg, ring), cfg)
        feats = extract_features(packed, o_rel, cfg)
        inputs.append((bt._device_part(pipe.mstate), feats._replace(
            less_sharp=pipe.ostate.ref_corner, less_flat=pipe.ostate.ref_surf),
            pipe.ostate.pose))
    stale = (True, False)
    due = [mp.refresh_due(pipe.mstate.map_age, s, cfg)
           for (pipe, _), s in zip(port_runs, stale)]
    assert due == [True, False]
    want = [mp.mapping_step(_clone(m)._replace(map_stale=s, map_age=pipe.mstate.map_age),
                            f, p, 0.6, cfg)
            for (m, f, p), s, (pipe, _) in zip(inputs, stale, port_runs)]

    stacked, feats, poses = (_stack2(*(x[i] for x in inputs)) for i in range(3))
    got_state, got_T = torch.func.vmap(
        lambda m, f, p, r: mp.mapping_step(m, f, p, 0.6, cfg, refresh=r),
        in_dims=(bt._M_DIMS, 0, 0, 0), out_dims=(bt._M_DIMS, 0))(
            stacked, feats, poses, torch.tensor(due))
    for b, (ws, wT) in enumerate(want):
        m, deg = _pose_gap(got_T.R[b], got_T.t[b], wT.R, wT.t)
        assert m < 1e-5 and deg < 1e-4, (b, m, deg)
        for f in ("map_corner_valid", "map_surf_valid"):
            assert torch.equal(getattr(got_state, f)[b], getattr(ws, f)), (b, f)
        for f in ("map_corner", "map_surf"):
            np.testing.assert_allclose(getattr(got_state, f)[b].numpy(),
                                       getattr(ws, f).numpy(), atol=1e-5)
        assert int(got_state.n_kf[b]) == int(ws.n_kf)
    # the second sequence kept its cached map exactly
    assert torch.equal(got_state.map_surf[1], inputs[1][0].map_surf)
    assert not torch.equal(got_state.map_surf[0], inputs[0][0].map_surf)


# --------------------------------------------------------- pool thinning

THIN = dict(SMALL, max_keyframes=64, max_loop_edges=4)


def _pool(jcfg, n_kf: int, seed: int):
    """A seeded JAX MappingState with n_kf keyframes and three loop edges,
    as host arrays."""
    rng = np.random.default_rng(seed)
    st = jax.device_get(jmap.init_state(jcfg))
    K = jcfg.max_keyframes
    q, _ = np.linalg.qr(rng.standard_normal((K, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    return st._replace(
        kf_R=q.astype(np.float32),
        kf_t=rng.standard_normal((K, 3)).astype(np.float32),
        kf_surf_valid=rng.random(st.kf_surf_valid.shape) > 0.5,
        kf_time=np.arange(K, dtype=np.float32),
        n_kf=np.int32(n_kf),
        loop_i=np.array([n_kf - 1, n_kf - 3, 4, 0], np.int32),
        loop_j=np.array([1, 2, 0, 0], np.int32),
        loop_w=np.array([1.0, 2.0, 3.0, 0.0], np.float32),
        n_loops=np.int32(3),
        map_age=np.int32(seed), map_stale=np.bool_(False))


def _stack_np(states):
    return jax.tree_util.tree_map(lambda *v: np.stack(v), *states)


def test_pool_thinning_follows_jax_batch_policy():
    jcfg, tcfg = jconfig_for("vlp16", **THIN), config_for("vlp16", **THIN)
    st = _stack_np([_pool(jcfg, 50, 1), _pool(jcfg, 20, 2)])
    jc = jax.device_get(jax.vmap(lambda m: jmap.compact_keyframes(m, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, st)))
    bp = bt.BatchPipeline(tcfg, 2, device="cpu")
    # the JAX package's reserve at C = 3: max(40, ceil(3 / 2) + 1) = 40, so
    # the worst sequence at 50 >= 64 - 40 thins both
    bp.mstate = state_from_numpy(st, "cpu")
    bp.n_kf_bound = 50
    bp._maybe_compact(C)
    assert bp.keyframe_counts().tolist() == np.asarray(jc.n_kf).tolist()
    assert bp.n_kf_bound == int(np.max(jc.n_kf))
    assert bp.mstate.map_stale == (True, True)
    assert bp.mstate.map_age == (1, 2)
    tc = state_to_numpy(bp.mstate)
    for f in ("kf_R", "kf_t", "kf_surf_valid", "kf_time", "loop_i", "loop_j",
              "loop_w", "n_loops"):
        np.testing.assert_array_equal(getattr(tc, f), np.asarray(getattr(jc, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tc.kf_meas_R, jc.kf_meas_R, atol=1e-5)
    np.testing.assert_allclose(tc.kf_meas_t, jc.kf_meas_t, atol=1e-5)
    # below the threshold nothing is thinned; a bound below it reads nothing
    small = state_from_numpy(_stack_np([_pool(jcfg, 20, 1), _pool(jcfg, 10, 2)]),
                             "cpu")
    bp.mstate, bp.n_kf_bound = small, 50
    bp._maybe_compact(C)
    assert bp.mstate is small and bp.n_kf_bound == 20
    bp.n_kf_bound = 0
    bp.mstate = None            # no read: a read would fail
    bp._maybe_compact(C)


def test_stacked_state_crosses_both_ways():
    jcfg = jconfig_for("vlp16", **THIN)
    st = _stack_np([_pool(jcfg, 50, 1), _pool(jcfg, 20, 2)])
    tst = state_from_numpy(st, "cpu")
    assert tst.map_age == (1, 2) and tst.map_stale == (False, False)
    assert tst.kf_t.shape == (2, 64, 3) and tst.aft_mapped.R.shape == (2, 3, 3)
    back = state_to_numpy(tst)
    want, got = jax.tree_util.tree_leaves(st), jax.tree_util.tree_leaves(back)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# ---------------------------------------------------------------- errors

def test_input_errors(course):
    cfg, seqs = course
    bp = bt.BatchPipeline(cfg, 2, device="cpu")
    xyz, valid, ring = _chunk(seqs[0][:2])
    with pytest.raises(ValueError, match="expected xyz"):
        bp.process_chunk(xyz, valid, ring)             # no batch axis
    with pytest.raises(ValueError, match="expected xyz"):
        bp.process_chunk(np.stack([xyz] * 3), np.stack([valid] * 3))
    with pytest.raises(ValueError, match="ring channel"):
        bp.process_chunk(np.stack([xyz] * 2), np.stack([valid] * 2))
    assert bp.frame == 0
