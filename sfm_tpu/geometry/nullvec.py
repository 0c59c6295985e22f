"""Smallest-eigenvector extraction for small batched symmetric matrices.

DLT triangulation (4x4) and the weighted 8-point solver (9x9) both need the
eigenvector of the SMALLEST eigenvalue of a PSD normal matrix.
``jnp.linalg.eigh`` on huge batches of tiny matrices runs a general
eigensolver per matrix; these problems only need a few inverse-iteration steps:

    factor  M + eps*I = L L^T        (Cholesky, unrolled over the static k)
    iterate v <- normalize((L L^T)^{-1} v)

Convergence per step is (lambda_min + eps) / (lambda_2 + eps) — for
near-rank-deficient normal matrices (the DLT/8-point case: lambda_min is the
squared residual, orders below lambda_2) a handful of steps reaches f32
round-off.  Everything is unrolled Python loops over the STATIC k, so the
batch dimension stays pure elementwise/vectorized work — no per-matrix
control flow, nothing for XLA to serialize.

Replaces jnp.linalg.eigh in geometry.triangulation (reference
cv2.triangulatePoints / utils.py:238-239) and geometry.epipolar (reference
cv2.findFundamentalMat's internal solver, utils.py:209).
"""

from __future__ import annotations

import jax.numpy as jnp


def cholesky_unrolled(A):
    """Cholesky of (..., k, k) SPD matrices, unrolled over static k.

    Returns the lower factor as a list-of-lists of (...,) entries (row i has
    i+1 columns) — kept unpacked so downstream solves index it statically.
    Pivots are clamped to a tiny positive floor so nearly singular inputs
    (lambda_min ~ 0, the whole point of inverse iteration) stay finite.
    """
    k = A.shape[-1]
    L = [[None] * (i + 1) for i in range(k)]
    for i in range(k):
        for j in range(i + 1):
            s = A[..., i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def cho_solve_unrolled(L, b):
    """Solve (L L^T) x = b with the unpacked factor from cholesky_unrolled.

    b: (..., k).  Returns (..., k).
    """
    k = len(L)
    y = [None] * k
    for i in range(k):
        s = b[..., i]
        for p in range(i):
            s = s - L[i][p] * y[p]
        y[i] = s / L[i][i]
    x = [None] * k
    for i in reversed(range(k)):
        s = y[i]
        for p in range(i + 1, k):
            s = s - L[p][i] * x[p]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def smallest_eigvec(M, iters: int = 4, eps_rel: float = 1e-6):
    """Unit eigenvector for the smallest eigenvalue of PSD (..., k, k) M.

    Inverse iteration on M + eps*I with eps = eps_rel * mean(diag): one
    unrolled Cholesky, ``iters`` triangular solves.  Matches eigh's smallest
    eigenvector up to sign for the well-separated spectra produced by DLT /
    8-point normal equations (tested against eigh in float64).

    PRECONDITION (callers must tolerate violations): convergence per step is
    (lambda_min + eps)/(lambda_2 + eps), so a poorly separated spectrum —
    degenerate RANSAC minimal samples, near-duplicate cameras in DLT — can
    leave the result far from the true eigenvector at the default 4 steps.
    Both call sites are robust by construction: RANSAC *scores* every
    hypothesis by Sampson inliers (a garbage F from a degenerate sample just
    loses the vote, sfm/ransac.py), and DLT triangulation runs a Gauss-Newton
    refine afterwards whose 0.3 px reprojection gate rejects unconverged
    points (geometry/triangulation.py).  Raise ``iters`` for call sites
    without such a downstream filter — each extra step is one pair of cheap
    unrolled triangular solves, fully vectorized over the batch.
    """
    k = M.shape[-1]
    diag = jnp.diagonal(M, axis1=-2, axis2=-1)
    eps = eps_rel * jnp.mean(diag, axis=-1) + 1e-30
    A = M + eps[..., None, None] * jnp.eye(k, dtype=M.dtype)
    L = cholesky_unrolled(A)
    # Deterministic start with weight on every coordinate; near-orthogonality
    # to the solution is measure-zero and one extra iteration absorbs it.
    v = jnp.full(M.shape[:-1], 1.0 / (k ** 0.5), M.dtype)
    for _ in range(iters):
        v = cho_solve_unrolled(L, v)
        v = v / jnp.maximum(
            jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30
        )
    return v
