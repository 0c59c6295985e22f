"""Closed-form batched small-matrix solves.

XLA's generic ``jnp.linalg.solve``/``inv`` on batched tiny matrices lowers
to LU factorisation calls, not vectorized math.  The 3x3 case has a cheap
closed form (adjugate / Cramer) that is pure elementwise work.  Used by triangulation refinement
and the BA point-block (V^-1) path.
"""

from __future__ import annotations

import jax.numpy as jnp


def adjugate3(M):
    """Batched adjugate of (..., 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = jnp.stack(
        [
            jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        -2,
    )
    return A


def det3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3(M, eps: float = 1e-30):
    """Batched closed-form inverse of (..., 3, 3)."""
    det = det3(M)
    safe = jnp.where(jnp.abs(det) < eps, eps, det)
    return adjugate3(M) / safe[..., None, None]


def solve3(M, b, eps: float = 1e-30):
    """Solve (..., 3, 3) @ x = (..., 3) in closed form."""
    det = det3(M)
    safe = jnp.where(jnp.abs(det) < eps, eps, det)
    x = jnp.einsum("...ij,...j->...i", adjugate3(M), b)
    return x / safe[..., None]
