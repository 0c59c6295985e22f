"""Batched multi-view photo-consistency (NCC) scoring.

The reference's ``photo_consistenecy_test`` (MVS2.py:62-77) scores ONE patch
against all images in interpreted Python — and contains a bug: it projects
the centroid with the *reference* camera for every view (MVS2.py:68), so all
views are sampled at the reference pixel.  Here the whole candidate batch is
scored against all views in one device program, each view projected with its
OWN camera (the code's documented intent, per SURVEY.md §7), patches sampled
bilinearly at fractional centers.

Score convention mirrors ``ctNcc`` (MVS2.py:39-43): Pearson correlation
scaled by n/(n-1), so the reference's 0.4/0.7 thresholds transfer exactly.

Visibility semantics mirror the reference: the reference view itself is NOT
part of the visible set (MVS2.py:66-67), so ``visible_lower_bound`` counts
*other* views.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sfm_tpu.geometry.projection import project_pinhole
from sfm_tpu.ops.ncc import (
    bilinear_sample_patches,
    bilinear_sample_patches_stack,
)
from sfm_tpu.ops.patches import normalize_descriptors


def pack_patch_payload(c, n, score, ref_pix, ref_idx, valid):
    """Fuse the per-patch host-bound outputs into one (M, 11) float32 array.

    Packing [c(3) | n(3) | score | u | v | ref | valid] lets the host loop
    retrieve a whole round's results in a single small device->host
    transfer.
    (u, v) is the patch's projection in its reference view ``ref`` — the
    host samples the patch COLOR there from the original images it already
    holds (the reference samples int pixel colors, MVS2.py:119-120), so the
    RGB stack never has to reach the device.
    """
    return jnp.concatenate(
        [
            c.astype(jnp.float32),
            n.astype(jnp.float32),
            score.astype(jnp.float32)[:, None],
            ref_pix.astype(jnp.float32),
            ref_idx.astype(jnp.float32)[:, None],
            valid.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )


def unpack_patch_payload(ph, images):
    """Host-side decode of ``pack_patch_payload`` rows (numpy).

    Returns (valid mask, c, n, score, colors uint8) with colors sampled
    nearest-pixel from ``images`` at each patch's reference projection.
    """
    import numpy as np

    h, w = images.shape[1], images.shape[2]
    valid = ph[:, 10] > 0.5
    x = np.clip(np.rint(ph[:, 7]).astype(np.int64), 0, w - 1)
    y = np.clip(np.rint(ph[:, 8]).astype(np.int64), 0, h - 1)
    ref = np.clip(ph[:, 9].astype(np.int64), 0, images.shape[0] - 1)
    colors = images[ref, y, x]
    return valid, ph[:, 0:3], ph[:, 3:6], ph[:, 6], colors


def _thr_col(min_ncc):
    """NCC threshold as a broadcastable column: scalar, or per-candidate
    (M,) vector (the post-pass visibility recompute scores seeds and
    expansion patches in one batch with their respective 0.4/0.7
    thresholds — mvs.filter)."""
    thr = jnp.asarray(min_ncc)
    return thr[:, None] if thr.ndim == 1 else thr


@functools.partial(
    jax.jit, static_argnames=("wid", "max_views")
)
def photo_consistency(
    gray,            # (N, H, W) float32 grayscale stack
    K, R, t,         # (N, 3, 3), (N, 3, 3), (N, 3) calibration
    centers,         # (M, 3) candidate patch centroids
    ref_idx,         # (M,) int32 reference image per candidate
    min_ncc: float,
    wid: int = 5,
    max_views: int = 0,
):
    """Score M candidates against all N views.

    ``max_views > 0`` enables the PMVS-style geometric visibility gate
    (Furukawa & Ponce, "Accurate, Dense, and Robust Multi-View Stereopsis",
    §3.2 uses an angle threshold between the patch normal and each viewing
    ray): only the ``max_views - 1`` non-reference views whose viewing
    direction best aligns with the patch normal (and whose projection lands
    in-frame, in front of the camera) are NCC-sampled.  Views outside the
    subset are reported invisible.  With a ring of 48 cameras the oblique
    views fail the 0.7 NCC threshold anyway, so this trades no measurable
    acceptance for a ~N/max_views cut in the gather sweep — the whole MVS
    stage's dominant cost.  ``max_views = 0`` scores every view, the
    reference's exact semantics (MVS2.py:62-77).

    Returns:
      vis: (M, N) bool — view passes NCC threshold (False at the ref view);
      proj: (M, N, 2) float32 — projected pixel of each candidate in each view;
      score_mean: (M,) mean NCC over visible views (0 if none);
      vis_count: (M,) int32 number of visible (non-reference) views.
    """
    n_img = gray.shape[0]
    if 0 < max_views < n_img:
        return _photo_consistency_gated(
            gray, K, R, t, centers, ref_idx, min_ncc, wid, max_views
        )
    m = centers.shape[0]
    side2 = (2 * wid + 1) ** 2
    ncc_scale = side2 / (side2 - 1.0)

    # Project all candidates into all views: (M, N, 2).
    proj = project_pinhole(
        centers[:, None, :], K[None], R[None], t[None]
    )

    # ONE sampling sweep over views: each view's normalized descriptors are
    # stored (bf16 — NCC ranking tolerates it and it halves the HBM
    # footprint), the reference row is then just a take_along_axis, and NCC
    # for all views is a single batched contraction.  This halves the gather
    # work vs. a separate reference-sampling pass.  The stack is sampled in
    # bf16: half the bytes gathered, and its ~half-ULP-of-a-pixel
    # quantization is the same scale as the uint8 grayscale rounding already
    # applied.
    gray_s = gray.astype(jnp.bfloat16)

    def view_scan(_, i):
        patches_i, inb_i = bilinear_sample_patches(gray_s[i], proj[:, i], wid)
        desc_i = normalize_descriptors(patches_i)
        return None, (desc_i.astype(jnp.bfloat16), inb_i)

    _, (desc_t, inb_t) = jax.lax.scan(view_scan, None, jnp.arange(n_img))
    desc = jnp.transpose(desc_t, (1, 0, 2))   # (M, N, D) bf16
    inb = jnp.transpose(inb_t)                # (M, N)

    ref_ix = ref_idx[:, None, None].astype(jnp.int32)
    ref_desc = jnp.take_along_axis(
        desc, jnp.broadcast_to(ref_ix, (m, 1, side2)), axis=1
    )[:, 0]                                    # (M, D) bf16
    ref_inb = jnp.take_along_axis(inb, ref_ix[..., 0], axis=1)[:, 0]

    ncc = (
        jnp.einsum(
            "mnd,md->mn", desc, ref_desc,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.DEFAULT,
        )
        * ncc_scale
    )
    not_ref = (
        jnp.arange(n_img, dtype=jnp.int32)[None, :] != ref_idx[:, None]
    )
    vis = (ncc > _thr_col(min_ncc)) & inb & ref_inb[:, None] & not_ref
    scores = jnp.where(vis, ncc, 0.0)
    vis_count = jnp.sum(vis.astype(jnp.int32), axis=1)
    score_mean = jnp.sum(scores, axis=1) / jnp.maximum(vis_count, 1)
    return vis, proj.astype(jnp.float32), score_mean, vis_count


def _photo_consistency_gated(
    gray, K, R, t, centers, ref_idx, min_ncc, wid: int, max_views: int,
):
    """Top-(max_views-1) geometric view selection + one stacked gather sweep.

    Same contract as ``photo_consistency`` (see its docstring); the subset is
    chosen per candidate by viewing-direction alignment with the patch
    normal, computed from geometry alone (no image access), so the expensive
    patch gather runs over M x max_views samples instead of M x N.
    """
    n_img = gray.shape[0]
    m = centers.shape[0]
    side2 = (2 * wid + 1) ** 2
    ncc_scale = side2 / (side2 - 1.0)
    v_sub = max_views - 1

    proj = project_pinhole(
        centers[:, None, :], K[None], R[None], t[None]
    )                                                     # (M, N, 2)
    depth = (
        jnp.einsum("nij,mj->mni", R, centers) + t[None]
    )[..., 2]                                             # (M, N)

    cam_centers = -jnp.einsum("nji,nj->ni", R, t)         # (N, 3) = -R^T t
    dirs = cam_centers[None] - centers[:, None]           # (M, N, 3)
    dirs = dirs / jnp.maximum(
        jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-12
    )
    normal = jnp.take_along_axis(
        dirs, ref_idx[:, None, None].astype(jnp.int32).repeat(3, -1), axis=1
    )[:, 0]                                               # (M, 3): toward ref cam
    cos_ang = jnp.einsum("mni,mi->mn", dirs, normal)

    h_img, w_img = gray.shape[1], gray.shape[2]
    inframe = (
        (proj[..., 0] >= wid + 1)
        & (proj[..., 0] <= w_img - wid - 2)
        & (proj[..., 1] >= wid + 1)
        & (proj[..., 1] <= h_img - wid - 2)
        & (depth > 0)
    )
    not_ref = (
        jnp.arange(n_img, dtype=jnp.int32)[None, :] != ref_idx[:, None]
    )
    pref = jnp.where(inframe & not_ref, cos_ang, -jnp.inf)
    top_pref, top_idx = jax.lax.top_k(pref, v_sub)        # (M, V-1)
    pick_ok = jnp.isfinite(top_pref)

    vidx = jnp.concatenate(
        [ref_idx[:, None].astype(jnp.int32), top_idx.astype(jnp.int32)],
        axis=1,
    )                                                     # (M, V)
    pix_v = jnp.take_along_axis(
        proj, vidx[..., None].repeat(2, -1), axis=1
    )                                                     # (M, V, 2)
    patches, inb_v = bilinear_sample_patches_stack(
        gray.astype(jnp.bfloat16), vidx, pix_v, wid
    )
    desc = normalize_descriptors(patches).astype(jnp.bfloat16)  # (M, V, D)
    ncc = (
        jnp.einsum(
            "mvd,md->mv", desc, desc[:, 0],
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.DEFAULT,
        )
        * ncc_scale
    )
    vis_v = (
        (ncc[:, 1:] > _thr_col(min_ncc)) & inb_v[:, 1:] & inb_v[:, :1]
        & pick_ok
    )                                                     # (M, V-1)
    scores = jnp.where(vis_v, ncc[:, 1:], 0.0)
    vis_count = jnp.sum(vis_v.astype(jnp.int32), axis=1)
    score_mean = jnp.sum(scores, axis=1) / jnp.maximum(vis_count, 1)

    rows = jnp.broadcast_to(jnp.arange(m)[:, None], top_idx.shape)
    vis = jnp.zeros((m, n_img), bool).at[rows, top_idx].set(vis_v)
    return vis, proj.astype(jnp.float32), score_mean, vis_count
