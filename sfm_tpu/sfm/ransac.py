"""Vectorized RANSAC for fundamental-matrix estimation.

Replaces ``cv2.findFundamentalMat(FM_RANSAC)`` (reference utils.py:209-212).
Batched formulation: a *fixed* batch of H hypotheses is generated and scored in
one shot — minimal 8-point samples become one-hot weight vectors, the
weighted normalized 8-point solver is vmapped across hypotheses, and every
hypothesis scores every correspondence with the Sampson distance.  Fixed H
(default 512) is chosen to dominate OpenCV's adaptive termination at typical
inlier ratios (>= 0.5 inliers: 99.999%+ success probability needs ~70 trials;
512 gives margin for ratios down to ~0.35).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sfm_tpu.geometry.epipolar import eight_point, sampson_distance


@functools.partial(jax.jit, static_argnames=("num_hypotheses", "refit"))
def ransac_fundamental(
    pts1,
    pts2,
    valid,
    key,
    num_hypotheses: int = 512,
    threshold_px: float = 2.0,
    refit: bool = True,
):
    """Robustly estimate F from padded correspondences.

    Args:
      pts1, pts2: (M, 2) float correspondence coordinates (padded).
      valid: (M,) bool validity of each correspondence.
      key: PRNG key.
      num_hypotheses: static hypothesis count H.
      threshold_px: inlier threshold on sqrt(Sampson distance), px.
      refit: re-estimate F from all inliers of the best hypothesis.

    Returns:
      F: (3, 3) fundamental matrix;
      inliers: (M,) bool inlier mask (subset of ``valid``);
      num_inliers: () int32.
    """
    m = pts1.shape[0]
    logits = jnp.where(valid, 0.0, -jnp.inf)
    # Sample 8 correspondence indices per hypothesis (with replacement;
    # a degenerate duplicate sample just yields a low-scoring hypothesis).
    idx = jax.random.categorical(
        key, logits[None, :], shape=(num_hypotheses, 8)
    )  # (H, 8)
    weights = jnp.zeros((num_hypotheses, m), pts1.dtype)
    weights = weights.at[
        jnp.arange(num_hypotheses)[:, None], idx
    ].set(1.0)

    F_h = eight_point(
        jnp.broadcast_to(pts1, (num_hypotheses, m, 2)),
        jnp.broadcast_to(pts2, (num_hypotheses, m, 2)),
        weights,
    )  # (H, 3, 3)
    d = sampson_distance(F_h, pts1[None], pts2[None])  # (H, M)
    thr2 = threshold_px * threshold_px
    inl = (d < thr2) & valid[None, :]
    scores = jnp.sum(inl, axis=-1)
    best = jnp.argmax(scores)
    F = F_h[best]
    inliers = inl[best]
    if refit:
        F_refit = eight_point(pts1, pts2, inliers.astype(pts1.dtype))
        d_refit = sampson_distance(F_refit, pts1, pts2)
        inl_refit = (d_refit < thr2) & valid
        # Keep the refit only if it does not lose inliers (guards against a
        # degenerate all-inlier LSQ pulling the model off).
        better = jnp.sum(inl_refit) >= jnp.sum(inliers)
        F = jnp.where(better, F_refit, F)
        inliers = jnp.where(better, inl_refit, inliers)
    return F, inliers, jnp.sum(inliers.astype(jnp.int32))
