"""Scale stress beyond dinoRing (VERDICT r1 item 10): synthetic 96-frame
ring at 1280x960 (2x resolution, 2x frames, 4x pixels/frame vs dinoRing).

Scene: a textured sphere (closed-form ray intersection; random-Fourier
3-D texture so there are no uv seams and patch-scale NCC structure exists
everywhere).  Cameras on a ring looking at the origin, exact calibration —
the same contract as Middlebury rings.  Validates that the static-capacity
knobs scale (corner/match/round capacities) and records perf at this scale.

Run: python tools/stress_scale.py [--frames 96] [--width 1280] [--height 960]
Writes one JSON line per config plus a final RESULT line.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np


def make_scene(n_frames=96, w=1280, h=960, seed=0):
    """Textured-sphere ring via the shared generator (sfm_tpu.utils.synth).

    texture_freq_scale is PINNED to 1.0 (the pre-round-4 field) so the
    stress workload stays bit-identical to the recorded round-2/3 numbers;
    render_scene's default now scales frequency with width (round 4), which
    would change acceptance rates at 1280 px."""
    from sfm_tpu.utils.synth import render_scene, ring_rig

    images, calib = render_scene(
        ring_rig(n_frames), w=w, h=h, seed=seed, texture_freq_scale=1.0
    )
    return images, calib.K, calib.R, calib.t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--max_corners", type=int, default=4096)
    ap.add_argument("--max_matches", type=int, default=2048)
    ap.add_argument("--round_capacity", type=int, default=32768)
    ap.add_argument("--max_patches", type=int, default=300_000)
    ap.add_argument("--out", default=None,
                    help="write a machine-readable JSON artifact: warm "
                         "walls, point count, sphere-distance envelope, and "
                         "a pass/fail gate on the scene's geometry")
    args = ap.parse_args()

    from sfm_tpu.config import (
        PipelineConfig, FeatureConfig, BaConfig, MvsConfig,
    )
    from sfm_tpu.io.calib import Calibration
    from sfm_tpu.sfm import structure_from_motion
    from sfm_tpu.ba.run import bundle_adjust
    from sfm_tpu.mvs import dense_reconstruction

    t0 = time.time()
    cache = f"/tmp/stress_scene_{args.frames}_{args.width}x{args.height}.npz"
    if os.path.exists(cache):
        z = np.load(cache)
        images, K, R, t = z["images"], z["K"], z["R"], z["t"]
    else:
        images, K, R, t = make_scene(args.frames, args.width, args.height)
        np.savez(cache, images=images, K=K, R=R, t=t)
    calib = Calibration(
        K=K, R=R, t=t, names=tuple(f"s{i:04d}" for i in range(args.frames))
    )
    print(json.dumps({"scene_gen_s": round(time.time() - t0, 1),
                      "shape": list(images.shape)}), flush=True)

    cfg = PipelineConfig(
        features=FeatureConfig(
            max_corners=args.max_corners, max_matches=args.max_matches
        ),
        ba=BaConfig(),
        mvs=MvsConfig(
            round_capacity=args.round_capacity,
            max_patches=args.max_patches,
            max_rounds=96,
        ),
    )
    t0 = time.perf_counter()
    recon = structure_from_motion(images, calib, cfg)
    t_sfm = time.perf_counter() - t0
    print(json.dumps({
        "stage": "sfm", "wall_s": round(t_sfm, 2),
        "tracks": recon.num_tracks, "obs": int(recon.num_observations),
        "mean_pair_reproj": recon.metrics.values[
            "mean_pair_reprojection_error_px"],
    }), flush=True)

    t0 = time.perf_counter()
    recon, info = bundle_adjust(recon, cfg.ba)
    t_ba = time.perf_counter() - t0
    rms = recon.rms_reprojection_error()
    print(json.dumps({"stage": "ba", "wall_s": round(t_ba, 2),
                      "rms_px": rms, "iters": info["iterations"]}),
          flush=True)

    t0 = time.perf_counter()
    dense = dense_reconstruction(images, calib, recon, cfg.mvs, scale=10.0)
    t_mvs = time.perf_counter() - t0
    # Geometric ground truth: every dense point must sit on the sphere.
    r_err = np.abs(np.linalg.norm(dense.points, axis=1) - 1.0)
    result = {
        "frames": args.frames, "res": f"{args.width}x{args.height}",
        "sfm_s": round(t_sfm, 2), "ba_s": round(t_ba, 2),
        "mvs_s": round(t_mvs, 2),
        "wall_s": round(t_sfm + t_ba + t_mvs, 2),
        "frames_per_s": round(args.frames / (t_sfm + t_ba + t_mvs), 2),
        "tracks": recon.num_tracks,
        "rms_px": round(rms, 4),
        "seeds": dense.num_seeds,
        "dense_points": dense.num_points,
        "rounds": dense.metrics.values["mvs_rounds"],
        "sphere_dist_median": float(np.median(r_err)),
        "sphere_dist_p95": float(np.percentile(r_err, 95)),
        "candidates_over_capacity": dense.metrics.values[
            "mvs_candidates_over_capacity"],
        "backlog_remaining": dense.metrics.values.get(
            "mvs_backlog_remaining", 0),
    }
    print("RESULT " + json.dumps(result), flush=True)

    # Warm (steady-state) timing: re-run the full pipeline with compiled
    # programs in place.
    t0 = time.perf_counter()
    recon2 = structure_from_motion(images, calib, cfg)
    t_sfm2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    recon2, _ = bundle_adjust(recon2, cfg.ba)
    t_ba2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense2 = dense_reconstruction(images, calib, recon2, cfg.mvs, scale=10.0)
    t_mvs2 = time.perf_counter() - t0
    wall2 = t_sfm2 + t_ba2 + t_mvs2
    print("WARM " + json.dumps({
        "sfm_s": round(t_sfm2, 2), "ba_s": round(t_ba2, 2),
        "mvs_s": round(t_mvs2, 2), "wall_s": round(wall2, 2),
        "frames_per_s": round(args.frames / wall2, 2),
        "dense_points": dense2.num_points,
    }), flush=True)

    # Roofline at THIS scale (VERDICT r2 item 6): matcher, gather ceiling,
    # photo-consistency and Harris rates at 4x pixels — measured, not
    # inferred from dinoRing shapes.
    from sfm_tpu.utils.roofline import full_report

    rep = full_report(
        iters=5, n_img=args.frames, h=args.height, w=args.width,
        n_pairs=args.frames - 1, corners=args.max_corners,
        mvs_m=args.round_capacity // 2,
    )
    print("ROOFLINE " + json.dumps(rep), flush=True)

    if args.out:
        # Machine-readable stress artifact + geometry gate (VERDICT r4
        # item 6).  Envelope from the round-4 run of this scene: 302,081
        # points, sphere-distance median 0.0113 / p95 0.0379, backlog 0.
        gates = {
            "dense_points_min": 290_000,
            "sphere_dist_median_max": 0.013,
            "sphere_dist_p95_max": 0.045,
            "backlog_remaining_max": 0,
        }
        checks = {
            "dense_points": dense2.num_points >= gates["dense_points_min"],
            "sphere_dist_median": result["sphere_dist_median"]
            <= gates["sphere_dist_median_max"],
            "sphere_dist_p95": result["sphere_dist_p95"]
            <= gates["sphere_dist_p95_max"],
            "backlog_remaining": result["backlog_remaining"]
            <= gates["backlog_remaining_max"],
        }
        artifact = {
            "config": {
                "frames": args.frames,
                "res": f"{args.width}x{args.height}",
                "max_corners": args.max_corners,
                "max_matches": args.max_matches,
                "round_capacity": args.round_capacity,
                "max_patches": args.max_patches,
            },
            "cold": result,
            "warm": {
                "sfm_s": round(t_sfm2, 2), "ba_s": round(t_ba2, 2),
                "mvs_s": round(t_mvs2, 2), "wall_s": round(wall2, 2),
                "frames_per_s": round(args.frames / wall2, 2),
                "dense_points": dense2.num_points,
            },
            "gates": gates,
            "checks": checks,
            "pass": all(checks.values()),
        }
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.out} (pass={artifact['pass']})", flush=True)
        if not artifact["pass"]:
            sys.exit(1)


if __name__ == "__main__":
    main()
