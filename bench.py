#!/usr/bin/env python3
"""Benchmark harness: full dinoRing pipeline (SfM + BA + dense MVS).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N}

Baseline (vs_baseline denominator): the UNMODIFIED reference running on this
container's CPU, measured by /tmp-style harness (see BASELINE.md "Measured"
table for the recorded numbers and method): SfM+BA wall time plus its MVS
BFS extrapolated to the 100k-iteration cap it ships with (MVS2.py:321) from
observed iterations/s.  Our run uses an equivalent work budget
(max_patches=100k) on the same dataset.

Usage: python bench.py [--frames N] [--skip-mvs] [--warm N]
"""

import argparse
import json
import os
import time

# Reference-CPU baseline, measured on this container (see BASELINE.md):
#   SfM+BA seconds + 100k-iteration MVS extrapolation, dinoRing 48 frames.
BASELINE_SFM_BA_S = None   # filled from BASELINE.md measurement
BASELINE_MVS_100K_S = None
_BASELINE_FILE = os.path.join(os.path.dirname(__file__), "BASELINE_MEASURED.json")
if os.path.exists(_BASELINE_FILE):
    with open(_BASELINE_FILE) as f:
        _b = json.load(f)
    BASELINE_SFM_BA_S = _b.get("ref_sfm_ba_s")
    BASELINE_MVS_100K_S = _b.get("ref_mvs_100k_s")


def run_pipeline(images, calib, config, mvs: bool, scale: float,
                 defer_fetch: bool = True):
    from sfm_tpu.sfm import structure_from_motion
    from sfm_tpu.ba.run import bundle_adjust

    t0 = time.perf_counter()
    recon = structure_from_motion(images, calib, config)
    # Defer BA's solution fetch when MVS follows: the dense stage never
    # consumes the refined points (seeds re-triangulate from observations),
    # so the fetch rides under MVS device compute (ba.run.bundle_adjust).
    recon, info = bundle_adjust(recon, config.ba, defer_fetch=mvs and defer_fetch)
    t_sfm_ba = time.perf_counter() - t0
    t_mvs = 0.0
    dense_points = 0
    if mvs:
        from sfm_tpu.mvs import dense_reconstruction

        t1 = time.perf_counter()
        dense = dense_reconstruction(images, calib, recon, config.mvs, scale)
        if mvs and defer_fetch:
            info["finalize"]()
        t_mvs = time.perf_counter() - t1
        dense_points = dense.num_points
    return recon, t_sfm_ba, t_mvs, dense_points


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--skip-mvs", action="store_true")
    ap.add_argument("--warm", type=int, default=8,
                    help="timed runs after the cold (compile) run; the "
                         "headline is the fastest, and the JSON also "
                         "reports the median, mean and every sample")
    ap.add_argument("--no-defer-fetch", action="store_true",
                    help="A/B: eager BA solution fetch (disable the round-4 "
                         "defer-under-MVS overlap, 100fa9a)")
    ap.add_argument("--no-seed-overlap", action="store_true",
                    help="A/B: read the MVS seed payload before dispatching "
                         "round 1 (disable the round-4 overlap, 225fb0a)")
    ap.add_argument("--data", default="/root/reference/dinoRing")
    ap.add_argument("--no-roofline", action="store_true",
                    help="skip the MFU/bandwidth kernel accounting")
    ap.add_argument("--refine_cameras", action="store_true",
                    help="run the joint Schur+PCG camera path instead of "
                         "the reference-equivalent frozen-camera solve")
    args = ap.parse_args()

    import jax

    from sfm_tpu.config import PipelineConfig, BaConfig, MvsConfig
    from sfm_tpu.io import read_pars, load_images
    from sfm_tpu.utils.platform import resolve_ba_dtype

    backend = jax.default_backend()

    # --- Cold-start attribution (VERDICT r2 item 7) -------------------------
    #   compile_s      — actual XLA backend compile seconds (cache misses);
    #   cache hits/misses + compile_time_saved_s — persistent-cache health.
    _attr = {"hits": 0, "misses": 0, "compile_s": 0.0, "saved_s": 0.0}
    try:
        from jax._src import monitoring as _mon

        def _on_event(event, **kw):
            if event == "/jax/compilation_cache/cache_hits":
                _attr["hits"] += 1
            elif event == "/jax/compilation_cache/compile_requests_use_cache":
                _attr["misses"] += 1  # corrected by hits below

        def _on_duration(event, duration, **kw):
            if "backend_compile" in event:
                _attr["compile_s"] += duration
            elif event == "/jax/compilation_cache/compile_time_saved_sec":
                _attr["saved_s"] += duration

        _mon.register_event_listener(_on_event)
        _mon.register_event_duration_secs_listener(_on_duration)
    except Exception:
        _mon = None

    calib = read_pars(os.path.join(args.data, "dinoR_par.txt"))
    images, _ = load_images(args.data, "png", max_images=args.frames)
    calib = calib.subset(range(images.shape[0]))
    n = images.shape[0]
    scale = 10.0  # reference run.sh invocation

    config = PipelineConfig(
        ba=BaConfig(
            dtype=resolve_ba_dtype(None, backend),
            refine_cameras=args.refine_cameras,
        ),
        mvs=MvsConfig(overlap_seed_fetch=not args.no_seed_overlap),
    )
    defer = not args.no_defer_fetch

    # Cold run (includes compilation).
    t0 = time.perf_counter()
    recon, t_sfm_ba, t_mvs, dense_points = run_pipeline(
        images, calib, config, not args.skip_mvs, scale, defer
    )
    cold_s = time.perf_counter() - t0

    # Warm runs (steady state), with the number of blocking device->host
    # fetches each made (sfm_tpu.utils.fetch).
    from sfm_tpu.utils import fetch as fetch_acct

    warm_total = []
    fetch_counts = []
    for _ in range(max(args.warm, 0)):
        n0 = fetch_acct.count()
        t0 = time.perf_counter()
        recon, t_sfm_ba, t_mvs, dense_points = run_pipeline(
            images, calib, config, not args.skip_mvs, scale, defer
        )
        warm_total.append(time.perf_counter() - t0)
        fetch_counts.append(fetch_acct.count() - n0)
    wall = min(warm_total) if warm_total else cold_s

    def _median(xs):
        if not xs:
            return None
        s = sorted(xs)
        return s[len(s) // 2]

    frames_per_s = n / wall
    vs = None
    if BASELINE_SFM_BA_S:
        base_wall = BASELINE_SFM_BA_S + (
            0.0 if args.skip_mvs else (BASELINE_MVS_100K_S or 0.0)
        )
        base_fps = n / base_wall if base_wall else None
        vs = frames_per_s / base_fps if base_fps else None

    result = {
        "metric": (
            f"dinoRing {n}-frame SfM+BA"
            + ("" if args.skip_mvs else "+MVS(100k budget)")
            + f" on {backend}"
        ),
        "value": round(frames_per_s, 3),
        "unit": "frames/s",
        "vs_baseline": round(vs, 2) if vs else None,
        "wall_s": round(wall, 2),
        "wall_median_s": round(_median(warm_total) or cold_s, 3),
        "wall_mean_s": round(
            sum(warm_total) / len(warm_total) if warm_total else cold_s, 2
        ),
        "wall_samples_s": [round(w, 3) for w in warm_total],
        "d2h_fetches_per_run": fetch_counts,
        "cold_s": round(cold_s, 2),
        "cold_attribution": {
            "compile_s": round(_attr["compile_s"], 2),
            "cache_hits": _attr["hits"],
            "cache_misses": max(_attr["misses"] - _attr["hits"], 0),
            "compile_time_saved_s": round(_attr["saved_s"], 2),
            "residual_s": round(
                max(cold_s - _attr["compile_s"], 0.0), 2
            ),
        },
        "sfm_ba_s": round(t_sfm_ba, 2),
        "mvs_s": round(t_mvs, 2),
        "tracks": recon.num_tracks,
        "rms_reproj_px": round(recon.rms_reprojection_error(), 4),
        "dense_points": dense_points,
        "refine_cameras": args.refine_cameras,
        "overlap": {
            "ba_defer_fetch": defer,
            "seed_fetch": not args.no_seed_overlap,
        },
    }
    if not args.no_roofline:
        from sfm_tpu.utils.roofline import full_report

        rep = full_report(iters=5)
        # Compact rounding for the one-line JSON contract.
        def _r(x):
            if isinstance(x, dict):
                return {k: _r(v) for k, v in x.items()}
            if isinstance(x, float):
                return round(x, 6 if abs(x) < 1 else 3)
            return x
        result["roofline"] = _r(rep)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
