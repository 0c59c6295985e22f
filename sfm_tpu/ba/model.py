"""Bundle-adjustment residual model and analytic Jacobian blocks.

The 12-parameter camera model (see geometry.projection; reference uses 11
params with averaged f, BundleAdjustment.py:23-39;
packing at SFM.py:143-148): [rvec(3), t(3), fx, fy, k1, k2, px, py].  Residuals
are (projected - observed) per observation (BundleAdjustment.py:42-56).

Where the reference relies on scipy TRF's sparse finite differences over a
hand-built lil_matrix sparsity pattern (BundleAdjustment.py:58-72), this
engine gets exact per-observation Jacobian blocks dr/dcam (2x12) and
dr/dpoint (2x3) from one vmapped ``jax.jacfwd`` — the block structure the
Schur solver consumes directly, no sparse matrix materialized.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sfm_tpu.geometry.projection import project_cam


def _residual_one(cam, point, obs):
    return project_cam(point[None, :], cam[None, :])[0] - obs


def residuals(cams, points, cam_idx, point_idx, obs_2d, mask=None):
    """Per-observation residuals (O, 2); masked rows are zero."""
    r = project_cam(points[point_idx], cams[cam_idx]) - obs_2d
    if mask is not None:
        r = r * mask[:, None].astype(r.dtype)
    return r


def total_cost(cams, points, cam_idx, point_idx, obs_2d, mask=None):
    """0.5 * sum of squared residuals (scipy least_squares convention)."""
    r = residuals(cams, points, cam_idx, point_idx, obs_2d, mask)
    return 0.5 * jnp.sum(r * r)


_jac_cam = jax.vmap(jax.jacfwd(_residual_one, argnums=0))
_jac_point = jax.vmap(jax.jacfwd(_residual_one, argnums=1))


def jacobian_blocks(cams, points, cam_idx, point_idx, obs_2d, mask=None):
    """Exact Jacobian blocks per observation.

    Returns (Jc (O, 2, 12), Jp (O, 2, 3), r (O, 2)), all zeroed on masked
    rows so padded observations contribute nothing to any normal equation.
    """
    c = cams[cam_idx]
    p = points[point_idx]
    r = project_cam(p, c) - obs_2d
    Jc = _jac_cam(c, p, obs_2d)
    Jp = _jac_point(c, p, obs_2d)
    if mask is not None:
        m = mask.astype(r.dtype)
        r = r * m[:, None]
        Jc = Jc * m[:, None, None]
        Jp = Jp * m[:, None, None]
    return Jc, Jp, r
