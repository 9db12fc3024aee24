"""Pose-graph parity: lego_loam_tpu_torch.models.posegraph against the JAX
package's models/posegraph.py on tests/test_posegraph.py's drifted
circular chains (its CFG, so the JAX side reuses the programs that file
compiles), CPU.

Tolerances:
  * graph_residuals and edge_blocks (r, Ji, Jj), and the assembled
    normal-equation blocks: within 1e-5 of each block's largest entry.
    The port writes the Jacobians in closed form where the JAX package
    runs jax.jacfwd; both are the exact derivative at the zero tangent, so
    they differ by float32 rounding only.
  * tridiag_factor + tridiag_solve and direct_gn_delta against a dense
    numpy.linalg.solve of the same system, built from the port's own
    blocks (port only): the counterpart of
    test_posegraph.py::test_direct_step_matches_dense_normal_equations.
    BCR in float32 keeps a relative residual of a few 1e-3 at this size
    (the JAX package's own test allows 2e-3 of the step's largest entry).
  * solve_pose_graph after distribute_loop_error on
    test_posegraph_loop_correction's circle: keyframe poses within 1 mm /
    0.01 deg of the JAX solve; distribute_loop_error within 1e-6 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.models import posegraph as jpg
from lego_loam_tpu.utils.math3d import Pose as JPose
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models import posegraph as tpg
from lego_loam_tpu_torch.utils.convert import state_from_numpy
from lego_loam_tpu_torch.utils.math3d import Pose

from tests.test_posegraph import CFG as JCFG
from tests.test_posegraph import _chain_state
from tests.test_torch_backend import _rot_err_deg

TCFG = config_for("vlp16", **{
    k: getattr(JCFG, k) for k in (
        "deskew", "max_keyframes", "max_map_corner", "max_map_surf",
        "kf_corner_cap", "kf_surf_cap", "kf_outlier_cap", "max_scan_corner_ds",
        "max_scan_surf_ds", "nn_query_tile", "max_loop_edges", "pg_gn_iters")})


def _with_loops(state, trues, pairs, w):
    """The JAX state with exact loop edges i -> j of information w."""
    li, lj = np.asarray(state.loop_i).copy(), np.asarray(state.loop_j).copy()
    lR, lt = np.asarray(state.loop_R).copy(), np.asarray(state.loop_t).copy()
    lw = np.asarray(state.loop_w).copy()
    for s, (i, j) in enumerate(pairs):
        Ti = JPose(jnp.asarray(trues[i][0], jnp.float32), jnp.asarray(trues[i][1], jnp.float32))
        Tj = JPose(jnp.asarray(trues[j][0], jnp.float32), jnp.asarray(trues[j][1], jnp.float32))
        Z = Ti.inverse().compose(Tj)
        li[s], lj[s] = i, j
        lR[s], lt[s], lw[s] = np.asarray(Z.R), np.asarray(Z.t), w
    return state._replace(loop_i=jnp.asarray(li), loop_j=jnp.asarray(lj),
                          loop_R=jnp.asarray(lR), loop_t=jnp.asarray(lt),
                          loop_w=jnp.asarray(lw), n_loops=jnp.int32(len(pairs)))


@pytest.fixture(scope="module")
def dense_case():
    """test_direct_step_matches_dense_normal_equations' graph: K = 16, 12
    drifted keyframes on a circle, two exact loop edges."""
    cfg = JCFG.replace(max_keyframes=16, max_loop_edges=4)
    n = 12
    state, trues = _chain_state(
        n, drift_per_step=np.array([0.02, -0.01, 0.005]),
        yaw_step=2 * np.pi / (n - 1), yaw_drift_per_step=0.01, cfg=cfg)
    state = _with_loops(state, trues, [(n - 1, 0), (n - 2, 1)], 50.0)
    tcfg = TCFG.replace(max_keyframes=16, max_loop_edges=4)
    return cfg, tcfg, jax.device_get(state), n


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=what)


def test_residuals_and_blocks_match_jax(dense_case):
    cfg, tcfg, st, n = dense_case
    ts = state_from_numpy(st, "cpu")
    R, t = jnp.asarray(st.kf_R), jnp.asarray(st.kf_t)
    jr = jax.jit(jpg.graph_residuals, static_argnames="cfg")(R, t, jax.device_put(st), cfg)
    _close(tpg.graph_residuals(ts.kf_R, ts.kf_t, ts, tcfg), jr, what="residuals")
    # a live loop edge's rows, and a chain edge's
    assert np.abs(np.asarray(jr)[16:18]).max() > 0.1
    assert np.abs(np.asarray(jr)[1:n]).max() > 0.1

    # edge_blocks on the chain edges, the loop edges and the prior
    K = 16
    Rp, tp = np.roll(st.kf_R, 1, 0), np.roll(st.kf_t, 1, 0)
    wr = np.where(np.arange(K) >= 1, 1.0 / cfg.pg_rot_sigma, 0.0).astype(np.float32)
    wt = np.where(np.arange(K) >= 1, 1.0 / cfg.pg_trans_sigma, 0.0).astype(np.float32)
    li, lj = st.loop_i, st.loop_j
    lw = np.sqrt(st.loop_w).astype(np.float32)
    wp = np.full(1, 1.0 / cfg.pg_prior_sigma, np.float32)
    cases = {
        "chain": (Rp, tp, st.kf_R, st.kf_t, st.kf_meas_R, st.kf_meas_t, wr, wt,
                  np.zeros(K, bool)),
        "loop": (st.kf_R[li], st.kf_t[li], st.kf_R[lj], st.kf_t[lj], st.loop_R,
                 st.loop_t, lw, lw, np.zeros(4, bool)),
        "prior": (st.kf_R[:1], st.kf_t[:1], st.kf_R[:1], st.kf_t[:1],
                  np.eye(3, dtype=np.float32)[None], np.zeros((1, 3), np.float32),
                  wp, wp, np.ones(1, bool)),
    }
    jblocks = jax.jit(jpg.edge_blocks)
    for name, args in cases.items():
        want = jax.device_get(jblocks(*map(jnp.asarray, args)))
        got = tpg.edge_blocks(*(torch.as_tensor(np.ascontiguousarray(a)) for a in args))
        for part, g, w in zip(("r", "Ji", "Jj"), got, want):
            _close(g.numpy(), w, what=f"{name} {part}")

    # the assembled normal equations
    jasm = jax.jit(jpg._assemble_blocks, static_argnames="cfg")
    want = jax.device_get(jasm(R, t, jax.device_put(st), cfg))
    got = tpg._assemble_blocks(ts.kf_R, ts.kf_t, ts, tcfg)
    for part, g, w in zip(("D", "U", "b", "A", "B", "r_loop"), got[:6], want[:6]):
        _close(g.numpy(), w, what=part)


def _float64(x):
    """A NamedTuple (nested) of tensors with its float tensors in float64:
    torch.func's forward mode gives some float32 ops (an add of a Python
    float) float64 tangents, which a float32 matmul then refuses."""
    if isinstance(x, tuple):
        return type(x)(*(_float64(v) for v in x))
    return x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x


def test_closed_form_jacobians_match_autodiff(dense_case):
    """edge_blocks' closed-form Ji / Jj equal torch.func.jacfwd of
    _edge_residual_chart, the function the JAX package differentiates."""
    cfg, tcfg, st, n = dense_case
    ts = _float64(state_from_numpy(st, "cpu"))
    i, j = 3, 4
    z = torch.zeros(6, dtype=torch.float64)
    for args in ((ts.kf_R[i], ts.kf_t[i], ts.kf_R[j], ts.kf_t[j], ts.kf_meas_R[j],
                  ts.kf_meas_t[j], torch.tensor(500.0).double(),
                  torch.tensor(100.0).double(), torch.tensor(False)),
                 (ts.kf_R[0], ts.kf_t[0], ts.kf_R[0], ts.kf_t[0], torch.eye(3).double(),
                  torch.zeros(3).double(), torch.tensor(1e4).double(),
                  torch.tensor(1e4).double(), torch.tensor(True))):
        f = lambda xi, xj: tpg._edge_residual_chart(xi, xj, *args)  # noqa: E731
        Ji = torch.func.jacfwd(f, argnums=0)(z, z)
        Jj = torch.func.jacfwd(f, argnums=1)(z, z)
        r, Ji_c, Jj_c = tpg.edge_blocks(*(a[None] for a in args))
        _close(r[0].numpy(), f(z, z).numpy(), what="r")
        _close(Ji_c[0].numpy(), Ji.numpy(), what="Ji")
        _close(Jj_c[0].numpy(), Jj.numpy(), what="Jj")


def _dense(D, U, A, B, li, lj, damping):
    """The dense (6K x 6K) float64 normal matrix tridiag(D, U) + damping +
    U_L^T U_L from the blocks."""
    D, U, A, B = (np.asarray(x, np.float64) for x in (D, U, A, B))
    K = D.shape[0]
    H = np.zeros((6 * K, 6 * K))
    for k in range(K):
        H[6 * k:6 * k + 6, 6 * k:6 * k + 6] = D[k] + damping * np.eye(6)
        if k + 1 < K:
            H[6 * k:6 * k + 6, 6 * k + 6:6 * k + 12] = U[k]
            H[6 * k + 6:6 * k + 12, 6 * k:6 * k + 6] = U[k].T
    for l, (i, j) in enumerate(zip(li, lj)):
        UL = np.zeros((6, 6 * K))
        UL[:, 6 * i:6 * i + 6] += A[l]
        UL[:, 6 * j:6 * j + 6] += B[l]
        H += UL.T @ UL
    return H


def test_direct_step_matches_dense_solve(dense_case):
    cfg, tcfg, st, n = dense_case
    ts = state_from_numpy(st, "cpu")
    D, U, b, A, B, r_l, li, lj = tpg._assemble_blocks(ts.kf_R, ts.kf_t, ts, tcfg)
    K = D.shape[0]

    # BCR alone: M X = rhs for a seeded right-hand side
    M = _dense(D, U, A[:0], B[:0], [], [], 0.0)
    rhs = np.random.default_rng(3).standard_normal((K, 6, 5)).astype(np.float32)
    X = tpg.tridiag_solve(tpg.tridiag_factor(D, U), torch.as_tensor(rhs))
    X_dense = np.linalg.solve(M, rhs.reshape(6 * K, 5)).reshape(K, 6, 5)
    for m in range(5):
        _close(X[..., m].numpy(), X_dense[..., m], rel=2e-3, what=f"BCR column {m}")

    # the Woodbury step against the dense normal equations
    x = tpg.direct_gn_delta(D, U, A, B, li, lj, r_l, b, tcfg.pg_damping)
    H = _dense(D, U, A, B, li.numpy(), lj.numpy(), tcfg.pg_damping)
    g = np.asarray(b, np.float64).reshape(-1)
    for l, (i, j) in enumerate(zip(li.numpy(), lj.numpy())):
        g[6 * i:6 * i + 6] -= np.asarray(A[l], np.float64).T @ np.asarray(r_l[l], np.float64)
        g[6 * j:6 * j + 6] -= np.asarray(B[l], np.float64).T @ np.asarray(r_l[l], np.float64)
    x_dense = np.linalg.solve(H, g).reshape(K, 6)
    _close(x.numpy(), x_dense, rel=2e-3, what="direct step")

    # and the blocks are the Gauss-Newton normal equations of the graph:
    # J^T J (+ the inactive poses' identity) from autodiff of the residuals
    ts64 = _float64(ts)

    def r_of(xv):
        R2, t2 = tpg._apply_delta(ts64.kf_R, ts64.kf_t, xv.reshape(K, 6))
        return tpg.graph_residuals(R2, t2, ts64, tcfg)

    J = torch.func.jacfwd(r_of)(torch.zeros(K * 6, dtype=torch.float64)).reshape(-1, K * 6)
    H_ad = (J.T @ J).numpy() + np.diag(np.repeat(np.arange(K) >= n, 6).astype(float))
    _close(_dense(D, U, A, B, li.numpy(), lj.numpy(), 0.0), H_ad, rel=1e-5,
           what="normal matrix")


@pytest.fixture(scope="module")
def circle():
    """test_posegraph_loop_correction's drifted 32-keyframe circle with one
    exact loop edge, before and after the JAX package's warm start and
    solve."""
    n = 32
    state, trues = _chain_state(
        n, drift_per_step=np.array([0.03, 0.02, 0.0]), yaw_step=2 * np.pi / (n - 1))
    state = _with_loops(state, trues, [(n - 1, 0)], 100.0)
    Z = JPose(state.loop_R[0], state.loop_t[0])
    warm = jpg.distribute_loop_error(state, jnp.int32(n - 1), jnp.int32(0), Z, JCFG)
    solved = jpg.solve_pose_graph(warm, JCFG)
    return jax.device_get((state, warm, solved)), trues, n


def test_distribute_loop_error_matches_jax(circle):
    (st, warm, _), _, n = circle
    ts = state_from_numpy(st, "cpu")
    Z = Pose(ts.loop_R[0], ts.loop_t[0])
    tw = tpg.distribute_loop_error(ts, torch.tensor(n - 1), torch.tensor(0), Z, TCFG)
    np.testing.assert_allclose(tw.kf_t.numpy(), warm.kf_t, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw.aft_mapped.t.numpy(), warm.aft_mapped.t, rtol=0, atol=1e-6)


def test_solve_pose_graph_matches_jax(circle):
    (st, warm, solved), trues, n = circle
    tsol = tpg.solve_pose_graph(state_from_numpy(warm, "cpu"), TCFG)
    np.testing.assert_allclose(tsol.kf_t[:n].numpy(), solved.kf_t[:n], rtol=0, atol=1e-3)
    for k in range(n):
        assert _rot_err_deg(solved.kf_R[k], tsol.kf_R[k].numpy()) < 0.01, k
    np.testing.assert_allclose(tsol.aft_mapped.t.numpy(), solved.aft_mapped.t, atol=1e-3)
    # slots beyond n_kf are kept as they were
    np.testing.assert_array_equal(tsol.kf_t[n:].numpy(), warm.kf_t[n:])
    # and the solve did close the loop (test_posegraph_loop_correction's bound)
    drift_end = np.linalg.norm(st.kf_t[n - 1] - trues[n - 1][1])
    assert np.linalg.norm(tsol.kf_t[n - 1].numpy() - trues[n - 1][1]) < 0.15 * drift_end
