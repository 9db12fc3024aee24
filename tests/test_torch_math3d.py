"""SO(3)/SE(3) helpers and the closed-form 3x3 algebra of the PyTorch port
against lego_loam_tpu.utils.math3d / lego_loam_tpu.ops.lin3, on seeded
random inputs including rotations near pi.

Tolerances: 1e-5 absolute on rotation matrices and axis-angle vectors
(float32 elementwise formulas evaluated in the same order; libm sin/cos/
atan2 may differ by an ulp), 1e-4 relative on the well-conditioned 3x3
solves and eigenvalues.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.ops import lin3 as jlin3
from lego_loam_tpu.utils import math3d as jm
from lego_loam_tpu_torch.ops import lin3 as tlin3
from lego_loam_tpu_torch.utils import math3d as tm


def _t(x):
    return torch.from_numpy(np.array(x))


def _axis_angles(rng, n, near_pi=False):
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = (np.pi - rng.random(n) * 1e-3) if near_pi else rng.random(n) * 3.0
    return (axis * ang[:, None]).astype(np.float32)


@pytest.mark.parametrize("near_pi", [False, True])
def test_so3_exp_log(near_pi):
    w = _axis_angles(np.random.default_rng(int(near_pi)), 200, near_pi)
    Rj = np.asarray(jax.jit(jm.so3_exp)(jnp.asarray(w)))
    Rt = tm.so3_exp(torch.from_numpy(w))
    np.testing.assert_allclose(Rt.numpy(), Rj, atol=1e-5)
    wj = np.asarray(jax.jit(jm.so3_log)(jnp.asarray(Rj)))
    wt = tm.so3_log(_t(Rj)).numpy()
    np.testing.assert_allclose(wt, wj, atol=1e-5)
    # the log inverts the exp (up to the antipodal axis at exactly pi)
    back = tm.so3_exp(torch.from_numpy(wt)).numpy()
    np.testing.assert_allclose(back, Rj, atol=2e-3 if near_pi else 1e-5)


def test_pose_ops_and_interp():
    rng = np.random.default_rng(3)
    R = np.asarray(jax.jit(jm.so3_exp)(jnp.asarray(_axis_angles(rng, 8))))
    t = rng.standard_normal((8, 3)).astype(np.float32)
    pts = rng.standard_normal((8, 5, 3)).astype(np.float32)
    s = rng.random(8).astype(np.float32)
    jp, tp = jm.Pose(jnp.asarray(R), jnp.asarray(t)), tm.Pose(_t(R), _t(t))
    pairs = ((jp.compose(jp.inverse()), tp.compose(tp.inverse())),
             (jax.jit(jm.pose_interp)(jp, jnp.asarray(s)),
              tm.pose_interp(tp, torch.from_numpy(s))))
    for j, u in pairs:
        np.testing.assert_allclose(u.R.numpy(), np.asarray(j.R), atol=1e-5)
        np.testing.assert_allclose(u.t.numpy(), np.asarray(j.t), atol=1e-5)
    np.testing.assert_allclose(tp.apply(torch.from_numpy(pts)).numpy(),
                               np.asarray(jp.apply(jnp.asarray(pts))), atol=1e-5)
    np.testing.assert_allclose(tm.project_so3(torch.from_numpy(R * 1.001)).numpy(),
                               np.asarray(jm.project_so3(jnp.asarray(R * 1.001))),
                               atol=1e-6)
    ident = tm.Pose.identity((2,))
    assert ident.R.shape == (2, 3, 3) and not ident.t.any()


def test_lin3_closed_forms():
    rng = np.random.default_rng(9)
    X = rng.standard_normal((500, 5, 3)).astype(np.float32)
    A = np.einsum("nki,nkj->nij", X, X).astype(np.float32) + np.eye(3, dtype=np.float32)
    b = rng.standard_normal((500, 3)).astype(np.float32)
    np.testing.assert_allclose(tlin3.solve3(torch.from_numpy(A), torch.from_numpy(b)).numpy(),
                               np.asarray(jlin3.solve3(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-4, atol=1e-5)
    lj = np.array(jlin3.eigvalsh3(jnp.asarray(A)))       # a writable copy
    lt = tlin3.eigvalsh3(torch.from_numpy(A))
    np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.linalg.eigvalsh(A.astype(np.float64)),
                               rtol=1e-3, atol=1e-4)
    vj = np.asarray(jlin3.principal_axis3(jnp.asarray(A), jnp.asarray(lj)))
    vt = tlin3.principal_axis3(torch.from_numpy(A), torch.from_numpy(lj)).numpy()
    np.testing.assert_allclose(np.abs(np.sum(vt * vj, axis=1)), 1.0, atol=1e-4)
    # isotropic A: the projector collapses and both return the (1, 0, 0) fallback
    iso = np.broadcast_to(2.0 * np.eye(3, dtype=np.float32), (4, 3, 3)).copy()
    li = np.array(jlin3.eigvalsh3(jnp.asarray(iso)))
    np.testing.assert_array_equal(
        tlin3.principal_axis3(torch.from_numpy(iso), torch.from_numpy(li)).numpy(),
        np.asarray(jlin3.principal_axis3(jnp.asarray(iso), jnp.asarray(li))))
