"""Descriptor matching as one matmul.

Replaces the reference's FLANN kNN (k=2) + Lowe ratio 0.7 + min-8-matches
gate (utils.py:180-204) and the dormant two-process two-sided NCC matcher
(MatchTwoSided, HarrisFeatures.py:40-65).  Design:

- one (K1, D) x (D, K2) matmul gives every pairwise NCC score;
- the Lowe ratio test runs on equivalent unit-vector L2 distances
  (d^2 = 2 - 2*ncc), so `d1 < r*d2` becomes `(1-s1) < r^2 (1-s2)`;
- the two-sided (mutual-nearest) cross-check is two argmaxes of the same
  score matrix — what the reference forks two processes for;
- results are compacted to a static (M_max, ...) block with a validity mask.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from sfm_tpu.ops.ncc import ncc_scores

_NEG = -2.0  # below any valid NCC score (range [-1, 1])


@jax.tree_util.register_dataclass
@dataclass
class MatchResult:
    """Static-capacity match set between two images.

    idx1/idx2: (M,) int32 indices into each FeatureSet's corner arrays;
    valid: (M,) bool; count: () int32 number of valid matches.
    """

    idx1: jnp.ndarray
    idx2: jnp.ndarray
    valid: jnp.ndarray
    count: jnp.ndarray


@functools.partial(
    jax.jit, static_argnames=("max_matches", "mutual_check")
)
def match_descriptors(
    desc1,
    valid1,
    desc2,
    valid2,
    lowe_ratio: float = 0.8,
    max_matches: int = 2048,
    mutual_check: bool = True,
) -> MatchResult:
    """Match two descriptor sets; returns indices padded to ``max_matches``."""
    s = ncc_scores(desc1, desc2)  # (K1, K2)
    s = jnp.where(valid1[:, None] & valid2[None, :], s, _NEG)

    # Best + second-best via three row reductions instead of top_k(k=2):
    # max/argmax passes over the (K1, K2) score matrix never sort a row.
    best = jnp.max(s, axis=1)
    j_best = jnp.argmax(s, axis=1)
    masked = jnp.where(
        jnp.arange(s.shape[1])[None, :] == j_best[:, None], _NEG, s
    )
    second = jnp.max(masked, axis=1)
    # Lowe ratio on unit-vector L2 distances: d^2 = 2(1 - s).
    r2 = lowe_ratio * lowe_ratio
    d1 = jnp.maximum(1.0 - best, 0.0)
    d2 = jnp.maximum(1.0 - second, 0.0)
    ratio_ok = d1 < r2 * d2

    accept = ratio_ok & valid1 & (best > _NEG + 1.0)
    if mutual_check:
        col_best = jnp.argmax(s, axis=0)  # (K2,)
        accept = accept & (col_best[j_best] == jnp.arange(s.shape[0]))

    score = jnp.where(accept, best, _NEG)
    vals, rows = jax.lax.top_k(score, min(max_matches, score.shape[0]))
    if vals.shape[0] < max_matches:
        pad = max_matches - vals.shape[0]
        vals = jnp.pad(vals, (0, pad), constant_values=_NEG)
        rows = jnp.pad(rows, (0, pad))
    ok = vals > _NEG
    idx1 = rows.astype(jnp.int32)
    idx2 = j_best[rows].astype(jnp.int32)
    return MatchResult(
        idx1=idx1, idx2=idx2, valid=ok, count=jnp.sum(ok.astype(jnp.int32))
    )


def matched_points(corners1, corners2, match: MatchResult):
    """Gather (M, 2) float32 pixel coordinate arrays for a MatchResult."""
    p1 = corners1[match.idx1].astype(jnp.float32)
    p2 = corners2[match.idx2].astype(jnp.float32)
    return p1, p2


def match_pair_gate(match: MatchResult, min_matches: int = 8):
    """The reference skips pairs with < 8 matches (utils.py:193-204)."""
    return match.count >= min_matches
