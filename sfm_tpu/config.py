"""Typed configuration for the whole pipeline.

The reference scatters its knobs between argparse defaults and hard-coded
constants (reference main.py:33-42 plus constants catalogued in SURVEY.md §5:
Lowe ratio 0.7 at utils.py:190, reprojection gate 0.3 px at main.py:22,
track-merge threshold 0.01 at main.py:27, MVS NCC thresholds 0.4/0.7 at
MVS2.py:255/362, visibility bound 3 at MVS2.py:200-203, coplanarity 0.1 and
radius 0.05/scale at MVS2.py:369, 100000-iteration cap at MVS2.py:321,
BA ftol 1e-4 at SFM.py:176).  Here every one of those is a named, documented
field on a single frozen dataclass tree.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class FeatureConfig:
    """Corner detection + patch description + matching."""

    # Harris detector (batched frontend; reference HarrisFeatures.py:135-161 uses
    # block=2, ksize=3, k=0.04 and a 1%-of-max threshold).
    harris_k: float = 0.04
    harris_window: int = 3          # structure-tensor box window half-extent*2+1
    # The reference's Harris frontend keeps responses > 1% of the per-image
    # max (HarrisFeatures.py:158); that leaves only a few dozen corners on
    # dark-background Middlebury images (response scales as gradient^4).  We
    # default far more permissive — the ratio test + RANSAC downstream do the
    # actual quality gating, and top-K capacity bounds the cost.
    harris_rel_threshold: float = 1e-6
    nms_radius: int = 4             # non-max-suppression radius in pixels
    # Static top-K corners per image (mask-padded).  Swept on dinoRing-48
    # (tools/ corner sweep): 4096/2048 -> 3105 tracks; 2048/1024 -> 3109;
    # 1024/512 -> 3075 tracks, rms 0.302 px, dense 103,504 points —
    # quality is flat because the ratio test + RANSAC + 0.3 px gate
    # saturate first, while cost grows with K.  Raise for
    # feature-richer imagery than 640x480 Middlebury rings.
    max_corners: int = 1024

    # Patch descriptors (reference getDescFeatures HarrisFeatures.py:116-133:
    # grayscale square patch of side 2*wid+1, wid=5 -> 11x11).
    desc_wid: int = 5

    # Matching (reference uses FLANN kNN + Lowe ratio 0.7, utils.py:180-191;
    # we do dense correlation as one matmul with a mutual-nearest + ratio
    # test).
    # The default deliberately DIFFERS from the reference's 0.7: our matcher
    # is exact (no FLANN approximation) and adds a mutual-nearest check the
    # reference lacks, so the ratio test needs less slack.  Measured on
    # dinoRing-48 (tools/sweep_lowe.py, 2026-08-18):
    #   0.7 -> 2633 tracks, post-BA rms 0.294 px, 102,865 dense points
    #   0.8 -> 3075 tracks, post-BA rms 0.302 px, 103,504 dense points
    # 0.8 gives 17% more tracks at equal quality (both far under the 0.3 px
    # insertion gate; mean NCC 0.935 vs 0.934).
    lowe_ratio: float = 0.8
    min_matches: int = 8            # reference utils.py:193-204 requires >= 8
    max_matches: int = 512          # static match capacity per pair (mask-padded)
    mutual_check: bool = True


@dataclass(frozen=True)
class RansacConfig:
    """Fundamental-matrix RANSAC (replaces cv2.findFundamentalMat FM_RANSAC,
    reference utils.py:209-212) with vmapped 8-point hypotheses."""

    num_hypotheses: int = 512       # fixed for static shapes
    inlier_threshold_px: float = 2.0  # Sampson distance threshold
    refit_on_inliers: bool = True   # final least-squares 8-point refit on inliers


@dataclass(frozen=True)
class SfmConfig:
    """Sparse reconstruction loop (reference SFM.py:47-88)."""

    # Accept a triangulated point only if reprojection error in BOTH views is
    # below this (reference main.py:22 passes 0.3 px; gate at SFM.py:78-79).
    max_reprojection_error_px: float = 0.3
    # Track-merge 3-D distance threshold (reference GlobalSet threshold=0.01,
    # main.py:27, check at GlobalSet.py:73-79).
    track_merge_threshold: float = 0.01
    # Pair scheduling: "sequence" = (i-1, i) chaining (utils.py:99-112);
    # "combination" = all C(n,2) pairs (utils.py:82-95 — unimplemented in the
    # reference, SFM.py:49-50; implemented here).
    pair_mode: str = "sequence"
    # Pairs vmapped per lax.map step in the all-pairs program.  DEFAULT 1
    # (serial pairs) — a measured round-4 negative result: the hypothesis
    # was that 47 sequential small sub-programs were dispatch overhead, but
    # block=4 ran the warm dino48 pair stage slower than serial on the
    # accelerator it was first measured on (tools/prof_pipeline.py
    # --pairs_per_step) — the per-pair step is already internally batched
    # (K x K correlation, 512 vmapped RANSAC hypotheses), so blocking pairs
    # only grows working sets.  Not yet measured on the GPU.  The mechanism
    # is kept and CPU-equality-tested (tests/test_sfm.py).
    pairs_per_step: int = 1


@dataclass(frozen=True)
class BaConfig:
    """Bundle adjustment (reference BundleAdjustment.py + SFM.py:91-210).

    Camera model: 12 parameters generalizing the reference's 11:
    [rvec(3), t(3), fx, fy, k1, k2, px, py] (cf. SFM.py:143-148, BundleAdjustment.py:23-39),
    solved by Levenberg-Marquardt with a Schur-complement reduced camera system
    instead of scipy.optimize.least_squares(method='trf').
    """

    max_iterations: int = 50
    ftol: float = 1e-4              # relative cost-decrease stop (SFM.py:176)
    gtol: float = 1e-8
    init_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    # The reference only keeps refined POINTS and discards refined cameras
    # (SFM.py:181-183). We reproduce that default but expose the flag.
    refine_cameras: bool = False
    # float32 on the GPU; float64 only on the CPU, for parity checks
    # (utils.platform.resolve_ba_dtype is the one policy).
    dtype: str = "float32"
    # Joint-mode reduced camera system: assemble S = U − W V⁻¹ Wᵀ DENSELY
    # (scatter + one matmul, ba.solver._dense_schur_dc) and
    # Cholesky-solve it when the camera count stays under this cap
    # (S is (12·Nc)²); otherwise matrix-free PCG.  The dense path removes
    # the 2-psums-per-CG-iteration sequential collectives of sharded joint
    # BA, and is faster single-device at rig scale.
    dense_schur_max_cams: int = 256
    # Second dense-path gate: the scatter grids are (T, Nc, 12, 3) f32 —
    # O(T·Nc·144 B) each, ~4 live at peak (two grids + their transposed
    # matmul operands) — so large point clouds with many cameras would
    # exhaust device memory even under the camera cap (e.g. 200k pts ×
    # 256 cams ≈ 7.4 GB per grid).  Past this budget the solver falls back to
    # matrix-free PCG, which materializes nothing bigger than the
    # observation buffers.
    dense_schur_max_bytes: int = 2 << 30
    # DEPRECATED, unused: the round-4 dense-Schur assembly is one scatter +
    # matmul whose program size is independent of track span, so this no
    # longer gates anything (ba/run.py warns if changed from the default).
    dense_schur_max_span: int = 64


@dataclass(frozen=True)
class MvsConfig:
    """Patch-based dense reconstruction (reference MVS2.py)."""

    cell_size: int = 2              # beta, pixels per occupancy cell (main.py:40)
    patch_wid: int = 5              # photo-consistency patch half-width -> 11x11
    min_ncc_seed: float = 0.4       # seeding threshold (MVS2.py:255)
    min_ncc_expand: float = 0.7     # expansion threshold (MVS2.py:362)
    visible_lower_bound: int = 3    # >=3 views (2 when only 2 images), MVS2.py:200-203
    coplanarity_threshold: float = 0.1   # |d.n1 + d.n2| bound (MVS2.py:369)
    neighbor_radius_scaled: float = 0.05  # ||c1-c2|| < this / scale (MVS2.py:369)
    # Work budget, the analogue of the reference's 100000-iteration BFS cap
    # (MVS2.py:321): total accepted-patch budget across expansion rounds.
    max_patches: int = 100_000
    max_rounds: int = 64
    # Per-round candidate batch capacity (static shape), swept on
    # dinoRing-48 with tools/sweep_capacity.py.  Larger batches mean fewer
    # rounds and fewer fixed per-round costs (occupancy-sized dedup
    # scatters, compaction, dispatch+fetch); too large loses to padding
    # waste (seed round and final round score mostly empty slots).  Not
    # yet re-swept on the GPU.
    round_capacity: int = 32_768
    # Expansion rounds fused into one device program call: each call pays
    # one D2H payload fetch, so chunking amortizes it; too large a chunk
    # wastes whole rounds after the frontier goes dry (the host only sees
    # acceptance counts per chunk).  With the software-pipelined host loop
    # (mvs/pipeline.py) the fetch already overlaps device compute, and at
    # round_capacity 32768 dinoRing finishes in ~4 rounds, so chunking
    # past 1 only enlarges the wasted prefetched tail.  Not yet measured on
    # the GPU.  Forced to 1 when enable_outlier_filter needs per-round
    # vis/proj.
    rounds_per_call: int = 1
    # PMVS-style geometric view gate: NCC-sample only the (max_photo_views-1)
    # non-reference views best aligned with the patch normal (0 = score all
    # views, the reference's exact semantics; -1 = auto, see
    # resolve_photo_views).  Oblique views fail the NCC threshold anyway;
    # this cuts the dominant gather sweep ~N/max_photo_views.
    # Measured on dinoRing-48 (tools/prof_v8.py): V=16 -> 102,716 points;
    # V=8 -> 104,570; V=5 -> 103,329 with HIGHER mean NCC (0.934 vs 0.912
    # — the gate keeps only the best-aligned views) at a fraction of the
    # sweep's work.  The
    # V=5 sweet spot was tuned on a dense 48-view ring; on rigs with sparse
    # or irregular angular coverage the gate could push vis_count below
    # visible_lower_bound and silently drop valid patches, so auto falls
    # back to 0 (reference-exact) below 16 images.
    max_photo_views: int = -1
    # PMVS visibility-consistency outlier filter (reference implements but
    # disables it at MVS2.py:280-281; here it is a cheap vectorized post-pass).
    enable_outlier_filter: bool = False
    # Scheduling-only (bitwise-identical output either way): dispatch the
    # first expansion round BEFORE reading the seed payload so the fetch
    # rides under device compute.  Kept as a knob until the GPU shows
    # whether the overlap buys anything (ROADMAP D2).
    overlap_seed_fetch: bool = True
    # Round data-dependent shapes (image count, seed-candidate/track
    # counts) up to a standard ladder so a new dataset reuses compiled
    # programs (utils/buckets.py; VERDICT r4 item 4 — temple onboarding
    # paid a full set of compiles for a new shape family).  Padding is
    # inert/masked; outputs are identical either way (equality-tested).
    shape_buckets: bool = True


def mvs_device_knobs(config: "MvsConfig") -> "MvsConfig":
    """Canonicalize an MvsConfig to the fields the compiled DEVICE programs
    actually read (thresholds, patch/cell geometry, view gate).

    Host-loop knobs — budgets (max_patches/max_rounds), chunking
    (rounds_per_call), capacity (passed to the program makers separately),
    the filter/overlap/bucketing toggles — do not appear in any traced
    program, so keying the jit caches on them forced a full re-trace and
    recompile of identical MVS programs for e.g. a budget sweep
    (the same bug class the round-4 pair-program key fix closed for SfM,
    sfm.pipeline._pair_cache_key)."""
    import dataclasses as _dc

    return _dc.replace(
        MvsConfig(),
        cell_size=config.cell_size,
        patch_wid=config.patch_wid,
        min_ncc_seed=config.min_ncc_seed,
        min_ncc_expand=config.min_ncc_expand,
        visible_lower_bound=config.visible_lower_bound,
        coplanarity_threshold=config.coplanarity_threshold,
        neighbor_radius_scaled=config.neighbor_radius_scaled,
        max_photo_views=config.max_photo_views,
    )


def resolve_photo_views(max_photo_views: int, n_images: int) -> int:
    """Resolve MvsConfig.max_photo_views against the actual rig size.

    -1 (auto) -> 5 on dense multi-view rigs (>= 16 images, where the
    geometric view gate was tuned and measured to *raise* mean NCC), else 0
    (score all views — the reference's exact semantics, MVS2.py:62-77).
    Explicit values pass through (0 = all views).  1 is rejected: it would
    mean "reference view only" — zero views to NCC-score against (and a
    degenerate k=0 top_k in the expansion hit compaction).
    """
    if max_photo_views == 1:
        raise ValueError(
            "max_photo_views=1 leaves no non-reference view to score; "
            "use 0 (all views) or >= 2"
        )
    if max_photo_views < 0:
        return 5 if n_images >= 16 else 0
    return max_photo_views


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution environment knobs."""

    # Devices along the single "data" mesh axis used by sharded BA / MVS.
    mesh_shape: Optional[int] = None   # None = all visible devices
    # Shape bucketing for the SfM stage (images/pairs padded to the
    # utils/buckets.py ladder; MVS has its own knob on MvsConfig since
    # dense_reconstruction doesn't see RuntimeConfig).  See MvsConfig.
    shape_buckets: bool = True
    checkpoint_dir: Optional[str] = None  # stage checkpoints (tracks/BA) for resume
    profile_dir: Optional[str] = None     # jax.profiler trace output
    seed: int = 0


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level configuration mirroring the reference CLI (main.py:33-42)."""

    image_path: str = ""
    par_path: str = ""
    image_type: str = "ppm"         # reference '-t', default ppm (main.py:36)
    scale: float = 1.0              # viz/radius scale multiplier (main.py:37)
    debug: bool = False
    max_images: Optional[int] = None  # subset support for benchmarks/tests

    features: FeatureConfig = field(default_factory=FeatureConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    sfm: SfmConfig = field(default_factory=SfmConfig)
    ba: BaConfig = field(default_factory=BaConfig)
    mvs: MvsConfig = field(default_factory=MvsConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
