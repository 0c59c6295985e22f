"""Frontier-round patch expansion.

The reference's dominant hot loop (patch_expansion, MVS2.py:308-404): a FIFO
of patches, each popping up to |V|*4 candidate cells, each candidate costing
N_images NCC tests in interpreted Python, capped at 100k iterations.

Batched re-formulation (SURVEY.md §7): *rounds*.  Each round takes the whole
frontier (patches accepted last round), enumerates every (hit, diagonal
neighbor) candidate cell at once, back-projects cell centers, intersects the
parent patch planes, scores the entire candidate batch with one
photo-consistency program, applies the reference's acceptance rules
(>= bound views, coplanarity < 0.1, radius < 0.05/scale — MVS2.py:369)
vectorized, deduplicates intra-round cell claims by best score, and
scatter-updates occupancy.  Deliberate fixes over the reference, per
SURVEY.md §7 (they contradict the code's own intent): neighbor cells use
(i, j) not the (i, i) typo (MVS2.py:334); each view is projected with its
own camera (MVS2.py:68); an accepted patch also occupies its target cell in
its reference image (the reference only fills non-reference hits, leaving
the target cell forever vacant and re-claimable — unbounded duplicate work
that its 100k-iteration cap hides).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sfm_tpu.config import MvsConfig
from sfm_tpu.geometry.triangulation import (
    backproject_pixel,
    ray_plane_intersection,
)
from sfm_tpu.mvs.cells import (
    cell_center,
    fill_cells,
    is_vacant,
    which_cell,
)
from sfm_tpu.mvs.photoconsistency import (
    pack_patch_payload,
    photo_consistency,
)

_OFFSETS = jnp.asarray([[-1, -1], [-1, 1], [1, -1], [1, 1]], jnp.int32)


def ordered_compact(flags, cap: int, fill):
    """Indices of the first ``cap`` true flags, ascending — bitwise drop-in
    for ``jnp.nonzero(flags, size=cap, fill_value=fill)[0]``.

    Round-5 negative result, kept as the recorded experiment: the
    cumsum+scatter formulation below was hypothesized to beat nonzero's
    scan at the round's 524,288-flag compaction, but measured slower in
    isolation on the accelerator it was first tried on, and neutral end to
    end.  Production code therefore keeps jnp.nonzero; this stays
    equality-tested (tests/test_mvs.py) until the GPU measures the trade
    (ROADMAP D6)."""
    n = flags.shape[0]
    pos = jnp.cumsum(flags.astype(jnp.int32)) - 1
    tgt = jnp.where(flags & (pos < cap), pos, cap)
    out = jnp.full((cap + 1,), fill, jnp.int32)
    out = out.at[tgt].set(jnp.arange(n, dtype=jnp.int32), mode="drop")
    return out[:cap]


@functools.lru_cache(maxsize=16)
def _make_round_program(
    config: MvsConfig,
    visible_lower_bound: int,
    round_capacity: int,
    mesh=None,
    rounds_per_call: int = 1,
):
    """Compiled expansion round, cached per (config, bound, capacity, mesh).

    When ``mesh`` is given (1-D, axis "data"), the compacted candidate batch
    is constrained to shard along the mesh — candidate geometry, the
    photo-consistency sweep (the round's dominant cost) and acceptance all
    partition over devices; XLA inserts the collectives for the global
    scatter-max cell claims and occupancy OR.
    """

    def run(gray, K, R, t, centers_cam, occupancy,
            f_c, f_n, f_vis, f_proj, f_valid, scale):
        if rounds_per_call == 1:
            return _expansion_round_impl(
                gray, K, R, t, centers_cam, occupancy,
                f_c, f_n, f_vis, f_proj, f_valid,
                config, visible_lower_bound, round_capacity, scale, mesh,
            )

        # Chunk several rounds into ONE device program (lax.scan over the
        # frontier/occupancy carry): each host round trip costs a fetch +
        # dispatch, so this amortizes them across rounds.  An empty
        # frontier mid-chunk produces all-invalid rounds downstream —
        # harmless, the host stops at the first empty round it sees in the
        # stacked payload.
        def one(carry, _):
            occ, fc, fn, fvis, fproj, fvalid = carry
            accepted, occ2, packed = _expansion_round_impl(
                gray, K, R, t, centers_cam, occ,
                fc, fn, fvis, fproj, fvalid,
                config, visible_lower_bound, round_capacity, scale, mesh,
            )
            carry2 = (
                occ2, accepted["c"], accepted["n"], accepted["vis"],
                accepted["proj"], accepted["valid"],
            )
            return carry2, packed

        init = (occupancy, f_c, f_n, f_vis, f_proj, f_valid)
        (occ, fc, fn, fvis, fproj, fvalid), packs = jax.lax.scan(
            one, init, None, length=rounds_per_call
        )
        frontier = {
            "c": fc, "n": fn, "vis": fvis, "proj": fproj, "valid": fvalid,
        }
        return frontier, occ, packs  # packs: (rounds_per_call, C+1, 11)

    return jax.jit(run)


def expansion_round(
    gray,
    K, R, t, centers_cam,
    occupancy,
    f_c, f_n, f_vis, f_proj, f_valid,
    config: MvsConfig,
    visible_lower_bound: int,
    round_capacity: int,
    scale: float,
    mesh=None,
    rounds_per_call: int = 1,
):
    """Run ``rounds_per_call`` expansion rounds over the frontier in one
    device program (see _make_round_program).

    Returns (frontier dict after the last round [stays on device], new
    occupancy, packed float32 — rows 0..C-1 per
    ``photoconsistency.pack_patch_payload``, row C carries
    [n_candidates, 0, ...] — so the host loop needs exactly ONE fetch).
    With rounds_per_call == 1 packed is (C+1, 11); otherwise it is
    (rounds_per_call, C+1, 11), one payload slice per round.
    """
    from sfm_tpu.config import mvs_device_knobs

    run = _make_round_program(
        mvs_device_knobs(config), visible_lower_bound, round_capacity,
        mesh, rounds_per_call,
    )
    return run(
        gray, K, R, t, centers_cam, occupancy,
        f_c, f_n, f_vis, f_proj, f_valid, scale,
    )


def _shard_constraint(x, mesh):
    if mesh is None:
        return x
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P("data", *([None] * (x.ndim - 1)))
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def _expansion_round_impl(
    gray,
    K, R, t, centers_cam,
    occupancy,
    f_c, f_n, f_vis, f_proj, f_valid,
    config: MvsConfig,
    visible_lower_bound: int,
    round_capacity: int,
    scale,
    mesh=None,
):
    """One expansion round over the frontier.

    Frontier arrays: f_c (F,3), f_n (F,3), f_vis (F,N), f_proj (F,N,2),
    f_valid (F,).  Returns (accepted dict with capacity ``round_capacity``,
    new occupancy, n_candidates considered).
    """
    n_img = gray.shape[0]
    F = f_c.shape[0]

    # --- Candidate enumeration: extract visible HITS per frontier row, then
    # expand the 4 diagonal offsets.  With the view gate a frontier row has
    # at most max_photo_views - 1 visible entries out of N (the reference
    # view is never in its own visible set), so the hit list is a row-wise
    # ``top_k`` over view-index weights instead of a nonzero compaction over
    # the dense (F*N,) flag space (tools/prof_round3.py; nonzero is
    # O(flags scanned), top_k is O(F*K)).
    # Weights DESCEND with view index so hits emerge view-ascending — the
    # same patch-major/view-ascending order the flat enumeration produced,
    # which the scatter-min dedup tie-breaks on (first-come), so winners are
    # unchanged.  Ungated (max_photo_views = 0) K degenerates to N —
    # identical to dense enumeration.
    from sfm_tpu.config import resolve_photo_views

    photo_views = resolve_photo_views(config.max_photo_views, n_img)
    gated = 0 < photo_views < n_img
    k_hit = (photo_views - 1) if gated else n_img
    w_view = jnp.arange(n_img, 0, -1, dtype=jnp.int32)
    hit_flags = f_valid[:, None] & f_vis
    wv, hit_img2 = jax.lax.top_k(
        jnp.where(hit_flags, w_view[None, :], 0), k_hit
    )                                                          # (F, K)
    hit_cap = F * k_hit
    hit_valid = (wv > 0).reshape(-1)                           # (H,)
    # No silent caps: a frontier built by the same gate carries <= k_hit
    # visible views per row, so this is 0; a future caller violating the
    # bound shows up as a counted metric (mvs_hits_over_k), not dropped
    # work.
    hits_dropped = (
        jnp.sum(hit_flags.astype(jnp.int32))
        - jnp.sum(hit_valid.astype(jnp.int32))
    )
    hit_img = hit_img2.astype(jnp.int32).reshape(-1)           # (H,)
    hit_patch = jnp.repeat(jnp.arange(F, dtype=jnp.int32), k_hit)
    hit_pix = jnp.take_along_axis(
        f_proj, hit_img2[..., None], axis=1
    ).reshape(-1, 2)                                           # (H, 2)
    hit_cell = which_cell(hit_pix, config.cell_size)           # (H, 2)
    cand_cell = hit_cell[:, None, :] + _OFFSETS[None]          # (H, 4, 2)
    img_ids = jnp.broadcast_to(hit_img[:, None], (hit_cap, 4))
    vacant = is_vacant(occupancy, img_ids, cand_cell)
    cand_ok = hit_valid[:, None] & vacant

    # Pre-dedup BEFORE scoring: many frontier hits propose the same target
    # cell; scoring duplicates wastes the round's photo-consistency budget
    # (the dominant cost) only for the post-score claim pass to discard all
    # but one.  Keep exactly one proposer per (img, cell): scatter-min of
    # the flat candidate index into the cell grid (first-come, the parallel
    # analogue of the reference's sequential first-claim).
    n_flat = hit_cap * 4
    cx, cy = occupancy.shape[1], occupancy.shape[2]
    cell_flat = cand_cell.reshape(-1, 2)
    img_flat = jnp.repeat(hit_img, 4)
    lin_all = (
        img_flat * cx + jnp.clip(cell_flat[:, 0], 0, cx - 1)
    ) * cy + jnp.clip(cell_flat[:, 1], 0, cy - 1)
    flat_ok = cand_ok.reshape(-1)
    idx_all = jnp.arange(n_flat, dtype=jnp.int32)
    big = jnp.int32(n_flat)
    first_at_cell = jnp.full((occupancy.size,), big, jnp.int32)
    first_at_cell = first_at_cell.at[lin_all].min(
        jnp.where(flat_ok, idx_all, big)
    )
    flat_ok = flat_ok & (first_at_cell[lin_all] == idx_all)

    (sel,) = jnp.nonzero(
        flat_ok, size=round_capacity, fill_value=flat_ok.shape[0] - 1
    )
    sel = _shard_constraint(sel, mesh)
    sel_valid = flat_ok[sel]
    n_candidates = jnp.sum(flat_ok.astype(jnp.int32))

    parent = hit_patch[sel // 4]
    img = hit_img[sel // 4]
    cell = _shard_constraint(cand_cell.reshape(-1, 2)[sel], mesh)

    # --- Geometry: back-project cell center, intersect parent plane. ---
    center_pix = cell_center(cell, config.cell_size)
    O, ray = backproject_pixel(center_pix, K[img], R[img], t[img])
    c_new, ray_ok = ray_plane_intersection(O, ray, f_c[parent], f_n[parent])
    dvec = centers_cam[img] - c_new
    dist = jnp.linalg.norm(dvec, axis=-1)
    n_new = dvec / jnp.maximum(dist[:, None], 1e-12)

    # --- Photo-consistency for the whole batch (sharded over candidates
    # when a mesh is given: the round's dominant cost). ---
    c_new = _shard_constraint(c_new, mesh)
    vis, proj, score, cnt = photo_consistency(
        gray, K, R, t, c_new, img, config.min_ncc_expand, config.patch_wid,
        photo_views,
    )
    vis = _shard_constraint(vis, mesh)
    proj = _shard_constraint(proj, mesh)

    # --- Acceptance (MVS2.py:369). ---
    d = c_new - f_c[parent]
    coplanar = (
        jnp.abs(
            jnp.sum(d * f_n[parent], axis=-1) + jnp.sum(d * n_new, axis=-1)
        )
        < config.coplanarity_threshold
    )
    near = (
        jnp.linalg.norm(d, axis=-1) < config.neighbor_radius_scaled / scale
    )
    finite = jnp.all(jnp.isfinite(c_new), axis=-1)
    geom_ok = sel_valid & ray_ok & finite & coplanar & near
    accept = geom_ok & (cnt >= visible_lower_bound)

    # --- Intra-round dedup: one winner per target cell (the parallel
    # analogue of the reference's first-come sequential claim). ---
    cx, cy = occupancy.shape[1], occupancy.shape[2]
    lin = (
        img * cx + jnp.clip(cell[:, 0], 0, cx - 1)
    ) * cy + jnp.clip(cell[:, 1], 0, cy - 1)
    idx = jnp.arange(round_capacity)
    claim_key = jnp.where(accept, score - idx * 1e-7, -jnp.inf)
    best = jnp.full((occupancy.size,), -jnp.inf, claim_key.dtype)
    best = best.at[lin].max(claim_key)
    accept_pre_dedup = accept
    accept = accept & (claim_key >= best[lin]) & jnp.isfinite(claim_key)

    # --- Occupancy update: visible hits + own target/ref cells. ---
    # Same top_k extraction as the hit enumeration above: an accepted
    # patch's visible set has at most k_hit entries, so scatter C*K masked
    # cells instead of the dense C*N (a ~12x smaller scatter at V=5/N=48).
    wa, fill_img = jax.lax.top_k(
        jnp.where(vis & accept[:, None], w_view[None, :], 0), k_hit
    )                                                           # (C, K)
    fill_pix = jnp.take_along_axis(proj, fill_img[..., None], axis=1)
    occupancy = fill_cells(
        occupancy, fill_img, which_cell(fill_pix, config.cell_size), wa > 0
    )
    occupancy = fill_cells(occupancy, img, cell, accept)

    accepted = {
        "c": c_new,
        "n": n_new,
        "ref": img,
        "vis": vis,
        "proj": proj,
        "score": score,
        "valid": accept,
    }
    ref_pix = jnp.take_along_axis(
        proj, img[:, None, None].astype(jnp.int32).repeat(2, -1), axis=1
    )[:, 0]
    packed = pack_patch_payload(c_new, n_new, score, ref_pix, img, accept)
    # Tail row: round diagnostics riding the existing single fetch (free —
    # the row exists anyway).  Slots 2..6 are the acceptance-funnel counts
    # that size any pre-gating opportunity (VERDICT r4 item 2): how many
    # candidates were actually scored, how many survive the cheap geometric
    # gates, and how much photo-consistency work went to eventual rejects.
    def _ct(m):
        return jnp.sum(m.astype(jnp.int32)).astype(jnp.float32)

    tail = jnp.zeros((1, packed.shape[1]), jnp.float32)
    tail = tail.at[0, 0].set(n_candidates.astype(jnp.float32))
    tail = tail.at[0, 1].set(hits_dropped.astype(jnp.float32))
    tail = tail.at[0, 2].set(_ct(sel_valid))             # scored candidates
    tail = tail.at[0, 3].set(_ct(sel_valid & ray_ok & finite))
    tail = tail.at[0, 4].set(_ct(geom_ok))               # + coplanar + near
    tail = tail.at[0, 5].set(_ct(accept_pre_dedup))      # + NCC view count
    tail = tail.at[0, 6].set(_ct(accept))                # post cell dedup
    packed = jnp.concatenate([packed, tail], axis=0)
    return accepted, occupancy, packed
