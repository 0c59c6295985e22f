"""Two-view epipolar geometry: normalized 8-point estimation + residuals.

Replaces ``cv2.findFundamentalMat(FM_RANSAC)`` (reference utils.py:209-212).
The estimator is formulated so a fixed batch of RANSAC hypotheses can be
evaluated with one ``vmap`` (see sfm_tpu.sfm.ransac): it takes a weight vector
over correspondences, so minimal 8-point samples (one-hot weights) and
all-inlier refits share one code path.  Epipolar line computation for debug
visualization (reference cv2.computeCorrespondEpilines, utils.py:220-224) is
:func:`epipolar_lines`.
"""

from __future__ import annotations

import jax.numpy as jnp

from sfm_tpu.geometry.nullvec import smallest_eigvec

_EPS = 1e-12


def _normalize(pts, weights):
    """Hartley normalization: centroid to origin, mean distance sqrt(2).

    Returns (normalized points (..., N, 2), T (..., 3, 3))."""
    wsum = jnp.maximum(jnp.sum(weights, axis=-1, keepdims=True), _EPS)
    centroid = jnp.sum(pts * weights[..., None], axis=-2) / wsum[..., :]
    d = pts - centroid[..., None, :]
    mean_dist = (
        jnp.sum(jnp.linalg.norm(d, axis=-1) * weights, axis=-1) / wsum[..., 0]
    )
    s = jnp.sqrt(2.0) / jnp.maximum(mean_dist, _EPS)
    zeros = jnp.zeros_like(s)
    ones = jnp.ones_like(s)
    T = jnp.stack(
        [
            jnp.stack([s, zeros, -s * centroid[..., 0]], axis=-1),
            jnp.stack([zeros, s, -s * centroid[..., 1]], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )
    return d * s[..., None, None], T


def eight_point(pts1, pts2, weights=None):
    """Weighted normalized 8-point fundamental-matrix estimate.

    Args:
      pts1, pts2: (..., N, 2) correspondences.
      weights: optional (..., N) nonnegative weights (e.g. one-hot minimal
        sample selection or an inlier mask).  Defaults to all-ones.

    Returns (..., 3, 3) rank-2 fundamental matrices with unit Frobenius norm,
    satisfying pts2_h^T F pts1_h ~ 0.
    """
    if weights is None:
        weights = jnp.ones(pts1.shape[:-1], dtype=pts1.dtype)
    n1, T1 = _normalize(pts1, weights)
    n2, T2 = _normalize(pts2, weights)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    ones = jnp.ones_like(x1)
    # Row per correspondence: [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1]
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1
    )
    A = A * weights[..., None]
    AtA = jnp.einsum("...ki,...kj->...ij", A, A)
    # Null vector via batched inverse iteration (geometry.nullvec) — far
    # cheaper than a full jnp.linalg.eigh for tens of thousands of 9x9s.
    f = smallest_eigvec(AtA)
    F = f.reshape(*f.shape[:-1], 3, 3)
    # Rank-2 enforcement: subtract the smallest singular triplet.  With v3
    # the smallest right singular vector (smallest eigenvector of F^T F),
    # F v3 = s3 u3, so F - (F v3) v3^T == U diag(s1, s2, 0) V^T exactly —
    # no SVD needed.
    FtF = jnp.einsum("...ki,...kj->...ij", F, F)
    v3 = smallest_eigvec(FtF)
    F = F - jnp.einsum("...ij,...j->...i", F, v3)[..., :, None] * v3[..., None, :]
    # Denormalize: F = T2^T F_hat T1.
    F = jnp.swapaxes(T2, -1, -2) @ F @ T1
    norm = jnp.linalg.norm(F, axis=(-2, -1), keepdims=True)
    return F / jnp.maximum(norm, _EPS)


def _homog(pts):
    return jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)


def sampson_distance(F, pts1, pts2):
    """First-order geometric (Sampson) distance, (..., N) in px^2 units.

    d = (x2^T F x1)^2 / ((Fx1)_0^2 + (Fx1)_1^2 + (F^T x2)_0^2 + (F^T x2)_1^2)
    """
    x1 = _homog(pts1)
    x2 = _homog(pts2)
    Fx1 = jnp.einsum("...ij,...nj->...ni", F, x1)
    Ftx2 = jnp.einsum("...ji,...nj->...ni", F, x2)
    num = jnp.sum(x2 * Fx1, axis=-1) ** 2
    den = (
        Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    )
    return num / jnp.maximum(den, _EPS)


def epipolar_distance(F, pts1, pts2):
    """Symmetric point-to-epiline distance in pixels, (..., N)."""
    x1 = _homog(pts1)
    x2 = _homog(pts2)
    Fx1 = jnp.einsum("...ij,...nj->...ni", F, x1)
    Ftx2 = jnp.einsum("...ji,...nj->...ni", F, x2)
    dot = jnp.abs(jnp.sum(x2 * Fx1, axis=-1))
    d1 = dot / jnp.maximum(
        jnp.sqrt(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2), _EPS
    )
    d2 = dot / jnp.maximum(
        jnp.sqrt(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2), _EPS
    )
    return 0.5 * (d1 + d2)


def epipolar_lines(F, pts, which: int = 1):
    """Epilines in the other image for debug overlays (utils.py:220-224).

    which=1: lines in image 2 for points of image 1 (l = F x1);
    which=2: lines in image 1 for points of image 2 (l = F^T x2).
    Returns (..., N, 3) line coefficients (a, b, c) normalized to a^2+b^2=1.
    """
    x = _homog(pts)
    if which == 1:
        l = jnp.einsum("...ij,...nj->...ni", F, x)
    else:
        l = jnp.einsum("...ji,...nj->...ni", F, x)
    scale = jnp.sqrt(l[..., 0:1] ** 2 + l[..., 1:2] ** 2)
    return l / jnp.maximum(scale, _EPS)


def essential_from_fundamental(F, K1, K2):
    """E = K2^T F K1 (for calibrated two-view pose if ever needed)."""
    return jnp.swapaxes(K2, -1, -2) @ F @ K1
