"""Bundle adjustment at a scale the reference could never touch
(VERDICT r4 item 7).

The reference's scipy-TRF BA tops out at dino48's 8,063 observations
(SFM.py:150-151, 172-177; its MVS would need 23.6 h to even produce a
bigger problem).  This harness synthesizes a rig of ~256 cameras /
100k points / 1M observations — SURVEY.md §5's "long dimension" — and runs
the LM solver's camera paths on the accelerator:

  - frozen-camera solve (production default) at 1M obs;
  - joint camera+point solve via matrix-free PCG at 1M obs (the dense
    Schur path is correctly gated OFF here by dense_schur_max_bytes:
    its (T, Nc, 12, 3) scatter grids would need ~15 GB);
  - joint dense-Schur on a 256-cam / 8k-point slice (under the memory
    gate) for cross-solver agreement at many-camera scale;
  - sharded-vs-single equality on the simulated 8-device CPU mesh at the
    full 1M-obs scale (run with --cpu-equality; slow, minutes).

Run (on the GPU):
    python tools/ba_scale.py
Record stdout as BA_SCALE_r05.txt.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np


def synth_problem(n_cams, n_pts, n_obs, dtype, seed=0, noise_px=0.5,
                  point_jitter=0.02):
    """Ring of cameras around a textured ball of points; every observation
    is a real projection + noise, so the problem is well-posed and the
    optimum is near the ground truth."""
    import jax.numpy as jnp

    from sfm_tpu.ba.problem import BAProblem
    from sfm_tpu.geometry.projection import project_cam

    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n_cams, endpoint=False)
    # 12-param cams [rvec(3), t(3), fx, fy, k1, k2, px, py]: ring at r=3
    # looking inward (rvec about y); modest calibration spread.
    rvec = np.stack([np.zeros(n_cams), ang, np.zeros(n_cams)], 1)
    # t = -R C with C on the ring; for rotation about y by ang, looking at
    # origin, use t = (0, 0, 3) per camera in its own frame.
    t = np.tile(np.asarray([0.0, 0.0, 3.0]), (n_cams, 1))
    cams = np.concatenate(
        [
            rvec, t,
            np.full((n_cams, 2), 800.0) + rng.normal(size=(n_cams, 2)) * 5,
            np.zeros((n_cams, 2)),
            np.full((n_cams, 2), 320.0),
        ],
        axis=1,
    )
    pts = rng.normal(size=(n_pts, 3)) * 0.4
    cam_idx = rng.integers(0, n_cams, n_obs)
    point_idx = rng.integers(0, n_pts, n_obs)
    obs = np.asarray(
        project_cam(jnp.asarray(pts[point_idx]), jnp.asarray(cams[cam_idx]))
    ) + rng.normal(size=(n_obs, 2)) * noise_px
    pts_init = pts + rng.normal(size=pts.shape) * point_jitter
    return BAProblem(
        cams=jnp.asarray(cams, dtype),
        points=jnp.asarray(pts_init, dtype),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        point_idx=jnp.asarray(point_idx, jnp.int32),
        obs_2d=jnp.asarray(obs, dtype),
        mask=jnp.ones(n_obs, bool),
    )


def timed_solve(problem, label, reps=3, **kw):
    from sfm_tpu.ba.solver import solve_lm

    t0 = time.perf_counter()
    cams, pts, cost, iters = solve_lm(problem, **kw)
    np.asarray(cost)
    cold = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        cams, pts, cost, iters = solve_lm(problem, **kw)
        np.asarray(cost)
        walls.append(time.perf_counter() - t0)
    it = int(iters)
    n_obs = int(problem.mask.shape[0])
    wall = sorted(walls)[len(walls) // 2]
    rms = float(np.sqrt(2.0 * float(cost) / max(n_obs, 1)))
    rec = {
        "label": label,
        "cold_s": round(cold, 2),
        "wall_s": round(wall, 3),
        "walls": [round(w, 3) for w in walls],
        "iterations": it,
        "s_per_iter": round(wall / max(it, 1), 4),
        "obs_per_s": round(n_obs * it / wall, 0),
        "final_cost": float(cost),
        "rms_px": round(rms, 4),
    }
    print(json.dumps(rec), flush=True)
    return rec


import jax.numpy as jnp  # noqa: E402  (after sys.path insert)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=256)
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--obs", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu-equality", action="store_true",
                    help="also equality-test sharded-vs-single on the "
                         "8-device simulated CPU mesh at full scale "
                         "(forces the CPU backend; run separately)")
    args = ap.parse_args()

    import jax

    if args.cpu_equality:
        jax.config.update("jax_platforms", "cpu")

    print(f"backend={jax.default_backend()}")
    np.asarray(jnp.arange(8))

    prob = synth_problem(args.cams, args.points, args.obs, jnp.float32)
    print(json.dumps({
        "problem": {
            "cams": args.cams, "points": args.points, "obs": args.obs,
            "params": 12 * args.cams + 3 * args.points,
            "residuals": 2 * args.obs,
            "vs_reference_max": round(args.obs / 8063.0, 1),
        }
    }), flush=True)

    if args.cpu_equality:
        from sfm_tpu.ba.sharded import shard_problem, solve_lm_sharded
        from sfm_tpu.ba.solver import solve_lm
        from sfm_tpu.parallel.mesh import data_mesh

        mesh = data_mesh()
        print(f"mesh devices: {mesh.size}")
        t0 = time.perf_counter()
        c1, p1, cost1, it1 = solve_lm(
            prob, max_iterations=args.iters, optimize_cameras=True
        )
        np.asarray(cost1)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        c2, p2, cost2, it2 = solve_lm_sharded(
            prob, mesh, max_iterations=args.iters, optimize_cameras=True
        )
        np.asarray(cost2)
        t2 = time.perf_counter() - t0
        dc = float(np.max(np.abs(np.asarray(c1) - np.asarray(c2))))
        dp = float(np.max(np.abs(np.asarray(p1) - np.asarray(p2))))
        rel = abs(float(cost1) - float(cost2)) / max(float(cost1), 1e-30)
        print(json.dumps({
            "cpu_equality": {
                "single_s": round(t1, 1), "sharded8_s": round(t2, 1),
                "iters": [int(it1), int(it2)],
                "max_abs_dcams": dc, "max_abs_dpoints": dp,
                "rel_dcost": rel,
                "pass": bool(rel < 1e-4 and int(it1) == int(it2)),
            }
        }), flush=True)
        return

    # Frozen cameras (production default path).
    timed_solve(prob, "frozen_1M", max_iterations=args.iters,
                optimize_cameras=False)
    # Joint via matrix-free PCG (dense Schur is memory-gated off at this
    # T*Nc: grids would be ~15 GB — exactly what dense_schur_max_bytes
    # protects against; ba/run.py would select PCG for this problem).
    timed_solve(prob, "joint_pcg_1M", max_iterations=args.iters,
                optimize_cameras=True, pair_span=0)
    # Dense Schur at many-camera scale under the memory gate:
    # 256 cams x 8k points -> grids ~1.2 GB.
    small = synth_problem(args.cams, 8_192, 200_000, jnp.float32, seed=1)
    r_pcg = timed_solve(small, "joint_pcg_256c_200k", max_iterations=args.iters,
                        optimize_cameras=True, pair_span=0)
    r_ds = timed_solve(small, "joint_dense_256c_200k",
                       max_iterations=args.iters,
                       optimize_cameras=True, pair_span=1)
    agree = abs(r_pcg["final_cost"] - r_ds["final_cost"]) / max(
        r_pcg["final_cost"], 1e-30
    )
    print(json.dumps({"dense_vs_pcg_rel_dcost": agree,
                      "agree": bool(agree < 5e-3)}), flush=True)


if __name__ == "__main__":
    main()
