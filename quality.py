#!/usr/bin/env python3
"""Head-to-head quality parity vs the reference (VERDICT r1 item 1).

Reference-side numbers were measured by running the UNMODIFIED reference to
completion/caps on this container (tools/refquality/, recorded in
quality_data/reference_measured.json + subsampled clouds + its exact BA
problem in quality_data/ref/).  This script runs sfm_tpu on the SAME
datasets/configs, computes comparison metrics, and writes QUALITY.json with
a pass/fail per acceptance criterion; the human summary lives in QUALITY.md.

Criteria (rationale in QUALITY.md):

  1. reproj_vs_calibration — post-BA rms of the final world points against
     the CALIBRATED cameras (what MVS consumes).  The reference discards its
     refined cameras (SFM.py:181-183), leaving its points off-calibration
     (4.70 px); ours must be <= 1.05x its value.
  2. ba_solver_parity — our LM/Schur solver run on the reference's EXACT
     captured BA problem (same x0, same observations, 11-param cameras
     embedded in our 12-param model): final internal rms <= 1.05x the
     reference's scipy-TRF result.  This isolates solver quality from
     frontend differences (our exact matcher keeps 2.6x more observations,
     so internal rms on our own tracks is not comparable).
  3. dense on-surface accuracy — median distance of each dense cloud to the
     SAME anchor (our BA-refined sparse cloud, every point 0.3 px-gated in
     two views): ours <= 1.05x the reference cloud's.  The reference cloud
     cannot serve as ground truth: its photo-consistency projects every view
     at the reference camera's pixel (MVS2.py:68), so its acceptance barely
     constrains depth and its clouds carry depth noise (measured here).
  4. dense completeness — median distance from the reference cloud to ours
     <= 1.5% of the reference cloud's bbox diagonal: we find the surface
     regions the reference found (the reverse direction is NOT a criterion:
     our stronger frontend seeds far more surface, e.g. 596 vs 33 seeds on
     dino-8, so ours->ref distances measure extra coverage, not error).
  5. seed envelope — at least as many seeds as the reference.

Usage: python quality.py [--out QUALITY.json]   (runs on JAX's default backend)
"""
import argparse
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA48 = "/root/reference/dinoRing"


def _load_ref():
    with open(os.path.join(ROOT, "quality_data", "reference_measured.json")) as f:
        return json.load(f)


def _ref_cloud(tag):
    z = np.load(os.path.join(ROOT, "quality_data", "ref", tag + ".npz"))
    return z["points"], int(z["full_count"])


def _save_ours(tag, points, colors=None):
    out_dir = os.path.join(ROOT, "quality_data", "ours")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    n = points.shape[0]
    sel = rng.choice(n, 50000, replace=False) if n > 50000 else np.arange(n)
    np.savez_compressed(
        os.path.join(out_dir, tag + ".npz"),
        points=points[sel].astype(np.float32),
        full_count=np.int64(n),
        **({"colors": colors[sel]} if colors is not None else {}),
    )


def nn_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance from each point of a to its nearest neighbor in b."""
    from scipy.spatial import cKDTree

    return cKDTree(b).query(a, k=1, workers=-1)[0]


def _stats(d: np.ndarray) -> dict:
    return {
        "mean": float(d.mean()),
        "p10": float(np.percentile(d, 10)),
        "p25": float(np.percentile(d, 25)),
        "median": float(np.median(d)),
        "p75": float(np.percentile(d, 75)),
        "p90": float(np.percentile(d, 90)),
    }


def photo_pass_stats(points, images, calib, min_ncc=0.7, bound=3,
                     max_eval=50000) -> dict:
    """Fraction of cloud points passing a TRUE multi-view photo-consistency
    test (NCC >= min_ncc against the nearest camera's patch, in >= bound
    other views, each view sampled at its OWN projection).

    This is PMVS's own acceptance rule applied identically to both clouds —
    coverage-independent, so it is fair when the clouds span different
    amounts of surface.  The reference's builder projected every view at the
    reference camera's pixel (MVS2.py:68), which barely constrains depth;
    this measures how much geometric noise that admitted.
    """
    import jax.numpy as jnp

    from sfm_tpu.io.images import device_gray
    from sfm_tpu.mvs.photoconsistency import photo_consistency

    rng = np.random.default_rng(0)
    if points.shape[0] > max_eval:
        points = points[rng.choice(points.shape[0], max_eval, replace=False)]
    centers = calib.centers  # (N, 3)
    d = np.linalg.norm(
        points[:, None, :] - centers[None, :, :], axis=-1
    )
    ref_img = np.argmin(d, axis=1).astype(np.int32)
    gray = device_gray(images)
    vis, proj, score, cnt = photo_consistency(
        gray,
        jnp.asarray(calib.K.astype(np.float32)),
        jnp.asarray(calib.R.astype(np.float32)),
        jnp.asarray(calib.t.astype(np.float32)),
        jnp.asarray(points.astype(np.float32)),
        jnp.asarray(ref_img), min_ncc, 5, 0,
    )
    cnt = np.asarray(cnt)
    score = np.asarray(score)
    return {
        "pass_rate": float((cnt >= bound).mean()),
        "mean_visible_views": float(cnt.mean()),
        "mean_ncc_of_passing": float(score[cnt >= bound].mean())
        if (cnt >= bound).any() else 0.0,
        "evaluated": int(points.shape[0]),
    }


def _dino(n_frames=None):
    from sfm_tpu.io import read_pars, load_images

    calib = read_pars(os.path.join(DATA48, "dinoR_par.txt"))
    images, _ = load_images(DATA48, "png", max_images=n_frames)
    return images, calib.subset(range(images.shape[0]))


def load_ba_problem(dtype=None):
    """The reference's exact captured dino48 BA problem, in our 12-param
    camera model: (BAProblem at the reference's start point, reference
    solution cams, reference solution points)."""
    import jax.numpy as jnp

    from sfm_tpu.ba.problem import BAProblem

    z = np.load(os.path.join(ROOT, "quality_data", "ref",
                             "dino48_ba_problem.npz"))
    n_cams, n_pts = int(z["n_cams"]), int(z["n_pts"])
    x0, xf = z["x0"], z["x_final"]

    def unpack(x):
        """Reference 11-param [rvec3,t3,f,k1,k2,px,py] (SFM.py:143-148) ->
        our 12-param [rvec3,t3,fx,fy,k1,k2,px,py] with fx=fy=f."""
        c11 = x[: n_cams * 11].reshape(n_cams, 11)
        cams = np.concatenate(
            [c11[:, 0:6], c11[:, 6:7], c11[:, 6:7], c11[:, 7:11]], axis=1
        )
        return cams, x[n_cams * 11:].reshape(n_pts, 3)

    cams0, pts0 = unpack(x0)
    camsf, ptsf = unpack(xf)
    dt = dtype or jnp.float32
    prob = BAProblem(
        cams=jnp.asarray(cams0, dt), points=jnp.asarray(pts0, dt),
        cam_idx=jnp.asarray(z["cam_idx"], jnp.int32),
        point_idx=jnp.asarray(z["pt_idx"], jnp.int32),
        obs_2d=jnp.asarray(z["pts2d"], dt),
        mask=jnp.ones(z["cam_idx"].shape[0], bool),
    )
    return prob, jnp.asarray(camsf, dt), jnp.asarray(ptsf, dt)


def _ba_solver_parity(ref_rms: float, pair_span: int = 0) -> dict:
    """Run our LM/Schur solver on the reference's exact captured BA problem.

    ``pair_span`` picks the joint camera solver: 0 = matrix-free PCG,
    1 = dense reduced camera system + Cholesky (ba.solver)."""
    from sfm_tpu.ba.solver import solve_lm
    from sfm_tpu.ba.model import total_cost

    prob, camsf, ptsf = load_ba_problem()
    n_obs = prob.num_observations

    def rms_of(cost):
        return float(np.sqrt(2.0 * float(cost) / n_obs))

    # Model-parity self-check: our residual model evaluated at the
    # reference's SOLUTION must reproduce its final rms (proves the 12-param
    # model embeds the reference's 11-param one exactly).
    cost_at_ref = total_cost(
        camsf, ptsf, prob.cam_idx, prob.point_idx, prob.obs_2d, prob.mask,
    )
    model_check_rms = rms_of(cost_at_ref)

    cams, pts, cost, iters = solve_lm(
        prob, max_iterations=100, ftol=1e-6, optimize_cameras=True,
        pair_span=pair_span,
    )
    ours_rms = rms_of(cost)
    return {
        "camera_solver": "dense_schur" if pair_span else "pcg",
        "model_check_rms_at_ref_solution": model_check_rms,
        "reference_rms": ref_rms,
        "ours_rms": ours_rms,
        "iterations": int(iters),
        "n_obs": n_obs,
        "ratio": ours_rms / ref_rms,
        "threshold": 1.05,
        "pass": ours_rms <= 1.05 * ref_rms
        and abs(model_check_rms - ref_rms) < 0.02,
    }


def dino8_evaluation(save_cloud: bool = True):
    """Full dino-8 pipeline + the two dino8 criteria (photo-consistency,
    completeness) against the CACHED reference cloud.

    This is the cheap our-side half of the quality parity suite — the
    reference side (quality_data/ref/*.npz, reference_measured.json) was
    captured once by tools/refquality and never re-run.  Runs on CPU in
    ~2 min, so tests/test_quality_gate.py executes it as a per-round
    regression gate (VERDICT r2 item 3); quality.py's main() reuses it for
    the QUALITY.json artifact.

    Returns (details dict, criteria dict).
    """
    from sfm_tpu.config import PipelineConfig, BaConfig, MvsConfig
    from sfm_tpu.sfm import structure_from_motion
    from sfm_tpu.ba.run import bundle_adjust
    from sfm_tpu.mvs import dense_reconstruction

    images8, calib8 = _dino(8)
    t0 = time.perf_counter()
    recon8 = structure_from_motion(images8, calib8, PipelineConfig())
    recon8, _ = bundle_adjust(recon8, BaConfig())
    dense8 = dense_reconstruction(
        images8, calib8, recon8,
        MvsConfig(max_rounds=512, max_patches=1_000_000), scale=10.0,
    )
    wall8 = time.perf_counter() - t0
    if save_cloud:
        _save_ours("dino8_full_all_patches", dense8.points, dense8.colors)
    ref8_pts, ref8_count = _ref_cloud("dino8_full_all_patches")
    anchor8 = recon8.world.astype(np.float32)
    diag8 = float(np.linalg.norm(ref8_pts.max(0) - ref8_pts.min(0)))
    surf8_ours = _stats(nn_dist(dense8.points, anchor8))
    surf8_ref = _stats(nn_dist(ref8_pts, anchor8))
    compl8 = _stats(nn_dist(ref8_pts, dense8.points))
    extra8 = _stats(nn_dist(dense8.points, ref8_pts))
    details = {
        "n_tracks": recon8.num_tracks,
        "seeds": dense8.num_seeds,
        "dense_points": dense8.num_points,
        "reference_dense_points": ref8_count,
        "rounds": dense8.metrics.values["mvs_rounds"],
        "wall_s": round(wall8, 2),
        "dist_to_sparse_anchor_ours": surf8_ours,
        "dist_to_sparse_anchor_ref": surf8_ref,
        "ref_to_ours": compl8,
        "ours_to_ref (coverage, not a criterion)": extra8,
        "ref_bbox_diag": diag8,
    }
    # On-surface accuracy via the PMVS acceptance rule itself (the sparse
    # anchor is only 600 points on 8 frames, so dist-to-anchor saturates at
    # anchor spacing and penalizes our 6x larger surface coverage — reported
    # above, not a criterion here).
    pc8_ours = photo_pass_stats(dense8.points, images8, calib8)
    pc8_ref = photo_pass_stats(ref8_pts, images8, calib8)
    details["photo_consistency_ours"] = pc8_ours
    details["photo_consistency_ref"] = pc8_ref
    criteria = {
        "dino8_photo_consistency": {
            "ours_pass_rate": pc8_ours["pass_rate"],
            "reference_pass_rate": pc8_ref["pass_rate"],
            "pass": pc8_ours["pass_rate"] >= pc8_ref["pass_rate"],
        },
        "dino8_completeness": {
            "ref_to_ours_median": compl8["median"],
            "threshold": 0.015 * diag8,
            "pass": compl8["median"] <= 0.015 * diag8,
        },
    }
    return details, criteria


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "QUALITY.json"))
    args = ap.parse_args()

    import jax

    from sfm_tpu.config import PipelineConfig, BaConfig, MvsConfig
    from sfm_tpu.sfm import structure_from_motion
    from sfm_tpu.ba.run import bundle_adjust
    from sfm_tpu.mvs import dense_reconstruction

    ref = _load_ref()
    import subprocess

    try:
        rev = subprocess.run(
            ["git", "-C", ROOT, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
    except Exception:
        rev = "unknown"
    result = {"backend": jax.default_backend(),
              "generated": time.strftime("%Y-%m-%d %H:%M:%S UTC",
                                         time.gmtime()),
              "git_rev": rev,
              "reference": ref,
              "ours": {}, "criteria": {}}
    ra = ref["dino48_sparse"]

    # ---- 1. dinoRing-48 sparse: reprojection vs calibration ----------------
    images, calib = _dino()
    t0 = time.perf_counter()
    recon = structure_from_motion(images, calib, PipelineConfig())
    frozen, _ = bundle_adjust(recon, BaConfig(refine_cameras=False))
    rms_vs_calib = float(frozen.rms_reprojection_error())
    joint, joint_info = bundle_adjust(recon, BaConfig(refine_cameras=True))
    result["ours"]["dino48_sparse"] = {
        "n_tracks": frozen.num_tracks,
        "n_obs": int(frozen.num_observations),
        "post_ba_rms_vs_calibration_px": rms_vs_calib,
        "post_ba_rms_internal_px": joint_info["rms_reproj_refined_px"],
        "note": "internal rms is over OUR tracks (2.6x more observations "
                "than the reference kept) — solver parity on identical "
                "problems is the ba_solver_parity criterion",
        "wall_s": round(time.perf_counter() - t0, 2),
    }
    result["criteria"]["reproj_vs_calibration"] = {
        "ours_px": rms_vs_calib,
        "reference_px": ra["post_ba_rms_px"],
        "ratio": rms_vs_calib / ra["post_ba_rms_px"],
        "threshold": 1.05,
        "pass": rms_vs_calib <= 1.05 * ra["post_ba_rms_px"],
    }

    # ---- 2. solver parity on the reference's exact BA problem --------------
    result["criteria"]["ba_solver_parity"] = _ba_solver_parity(
        ra["internal_rms_px"]
    )

    # ---- 3. dinoRing-8 full pipeline vs reference @100k iterations ---------
    details8, criteria8 = dino8_evaluation()
    result["ours"]["dino8_full"] = details8
    result["criteria"].update(criteria8)

    # ---- 4. dinoRing-48 at matched output size (ref 5k iterations) ---------
    refc_pts, refc_count = _ref_cloud("dino48_mvs5k_all_patches")
    t0 = time.perf_counter()
    densec = dense_reconstruction(
        images, calib, frozen, MvsConfig(max_patches=refc_count), scale=10.0,
    )
    wallc = time.perf_counter() - t0
    _save_ours("dino48_matched_all_patches", densec.points, densec.colors)
    anchorc = frozen.world.astype(np.float32)
    diagc = float(np.linalg.norm(refc_pts.max(0) - refc_pts.min(0)))
    surfc_ours = _stats(nn_dist(densec.points, anchorc))
    surfc_ref = _stats(nn_dist(refc_pts, anchorc))
    complc = _stats(nn_dist(refc_pts, densec.points))
    extrac = _stats(nn_dist(densec.points, refc_pts))
    result["ours"]["dino48_matched_budget"] = {
        "dense_points": densec.num_points,
        "target_points": refc_count,
        "seeds": densec.num_seeds,
        "wall_s": round(wallc, 2),
        "dist_to_sparse_anchor_ours": surfc_ours,
        "dist_to_sparse_anchor_ref": surfc_ref,
        "ref_to_ours": complc,
        "ours_to_ref (coverage, not a criterion)": extrac,
        "ref_bbox_diag": diagc,
    }
    result["criteria"]["dino48_on_surface_accuracy"] = {
        "ours_median": surfc_ours["median"],
        "reference_median": surfc_ref["median"],
        "ratio": surfc_ours["median"] / surfc_ref["median"],
        "threshold": 1.05,
        "pass": surfc_ours["median"] <= 1.05 * surfc_ref["median"],
    }
    pcc_ours = photo_pass_stats(densec.points, images, calib)
    pcc_ref = photo_pass_stats(refc_pts, images, calib)
    result["ours"]["dino48_matched_budget"]["photo_consistency_ours"] = pcc_ours
    result["ours"]["dino48_matched_budget"]["photo_consistency_ref"] = pcc_ref
    result["criteria"]["dino48_photo_consistency"] = {
        "ours_pass_rate": pcc_ours["pass_rate"],
        "reference_pass_rate": pcc_ref["pass_rate"],
        "pass": pcc_ours["pass_rate"] >= pcc_ref["pass_rate"],
    }
    result["criteria"]["dino48_completeness"] = {
        "ref_to_ours_median": complc["median"],
        "threshold": 0.015 * diagc,
        "pass": complc["median"] <= 0.015 * diagc,
    }
    result["criteria"]["dino48_seed_envelope"] = {
        "ours": densec.num_seeds,
        "reference": ref["dino48_mvs_5k_iters"]["seeds"],
        "pass": densec.num_seeds >= ref["dino48_mvs_5k_iters"]["seeds"],
    }

    result["all_pass"] = all(c["pass"] for c in result["criteria"].values())
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    for name, c in result["criteria"].items():
        print(f"{'PASS' if c['pass'] else 'FAIL'}  {name}: "
              + json.dumps({k: v for k, v in c.items() if k != 'pass'}))
    print(json.dumps({"all_pass": result["all_pass"], "out": args.out}))


if __name__ == "__main__":
    main()
