"""High-level bundle-adjustment entry point.

The analogue of the reference's DrawPointClouds BA section (SFM.py:91-210)
minus the plotting: assemble the problem from tracks, solve, write refined
world points back into the reconstruction.

Deliberate deviation from the reference: the reference solves cameras and
points *jointly*, then discards the refined cameras (SFM.py:181-183) — which
leaves the kept points consistent with cameras that no longer exist; under
gauge freedom the discarded camera drift shows up directly as reprojection
error against the real calibration.  Here ``refine_cameras=False`` (the
default, matching the reference's effective output contract "cameras stay at
calibration") freezes cameras in the solve itself, which is both cheaper
(no reduced camera system) and strictly better on the reference's own
reprojection-error metric.  ``refine_cameras=True`` runs the joint solve and
applies both.
"""

from __future__ import annotations


import jax.numpy as jnp
import numpy as np

import jax

from sfm_tpu.ba.problem import build_problem
from sfm_tpu.ba.solver import solve_lm
from sfm_tpu.config import BaConfig
from sfm_tpu.sfm.pipeline import SparseReconstruction
from sfm_tpu.utils.metrics import StageTimer


@jax.jit
def _pack_solution(cams, points, cost, iters):
    """Fuse the solver outputs into ONE flat array so the host pays a single
    device->host fetch instead of four (cams, points, float(cost),
    int(iters) would each be a separate blocking transfer)."""
    dt = points.dtype
    return jnp.concatenate(
        [
            cams.reshape(-1).astype(dt),
            points.reshape(-1).astype(dt),
            jnp.stack([cost.astype(dt), iters.astype(dt)]),
        ]
    )


def bundle_adjust(
    recon: SparseReconstruction,
    config: BaConfig = BaConfig(),
    track_store=None,
    mesh=None,
    defer_fetch: bool = False,
):
    """Refine a SparseReconstruction in place; returns (recon, info dict).

    If ``mesh`` is given (a jax.sharding.Mesh with a 'data' axis), the
    solve runs sharded over observations/points (ba.sharded).

    ``defer_fetch=True`` dispatches the solve but NOT the blocking
    device->host solution fetch: ``info["finalize"]()`` must be called
    before reading ``recon.world`` / the info result fields.  Nothing
    downstream of BA *on the device* needs the solution — MVS re-
    triangulates seeds from observations (reference MVS2.py:238-244), so a
    pipeline driver can run the whole dense stage between the dispatch and
    the finalize and pay the fetch entirely under device compute (round 4;
    bench.py does this; the CLI keeps the eager default because its BA
    artifacts/checkpoint must hit disk before MVS starts for
    crash-consistent resume).
    """
    timers = StageTimer()
    dtype = jnp.float64 if config.dtype == "float64" else jnp.float32
    with timers.stage("assemble"):
        problem = build_problem(
            recon.calib, recon.world, recon.track_offsets, recon.track_obs,
            dtype=dtype,
        )
    # Dense-Schur eligibility (joint mode only): S is (12*Nc)^2, so gate on
    # the camera count AND on the scatter-grid memory footprint (the grids
    # are (T, Nc, 12, 3) f32, ~4 live at peak — dense_schur_max_bytes in
    # config.py); track length no longer matters (the round-4 assembly is
    # one scatter + matmul, program size independent of span).  pair_span
    # is now just the on/off flag — pass 1 so the compiled program is shared
    # across datasets with different longest tracks.
    import warnings

    if config.dense_schur_max_span != type(config)().dense_schur_max_span:
        warnings.warn(
            "BaConfig.dense_schur_max_span is deprecated and has no effect "
            "(the dense-Schur assembly is span-independent since round 4); "
            "use dense_schur_max_cams / dense_schur_max_bytes to steer the "
            "solver choice",
            DeprecationWarning,
            stacklevel=2,
        )
    pair_span = 0
    dense_grid_bytes = 4 * recon.num_tracks * recon.calib.num_views * 144
    if (
        config.refine_cameras
        and recon.num_tracks
        and recon.calib.num_views <= config.dense_schur_max_cams
        and dense_grid_bytes <= config.dense_schur_max_bytes
    ):
        pair_span = 1
    with timers.stage("solve"):
        if mesh is not None:
            from sfm_tpu.ba.sharded import solve_lm_sharded

            cams, points, cost, iters = solve_lm_sharded(
                problem,
                mesh,
                max_iterations=config.max_iterations,
                ftol=config.ftol,
                init_lambda=config.init_lambda,
                lambda_up=config.lambda_up,
                lambda_down=config.lambda_down,
                optimize_cameras=config.refine_cameras,
                pair_span=pair_span,
            )
        else:
            cams, points, cost, iters = solve_lm(
                problem,
                max_iterations=config.max_iterations,
                ftol=config.ftol,
                init_lambda=config.init_lambda,
                lambda_up=config.lambda_up,
                lambda_down=config.lambda_down,
                optimize_cameras=config.refine_cameras,
                pair_span=pair_span,
            )
        packed_dev = _pack_solution(cams, points, cost, iters)

    info = {
        "num_observations": problem.num_observations,
        "num_points": recon.num_tracks,
        "num_cameras": recon.calib.num_views,
        "refined_cameras": bool(config.refine_cameras),
        "camera_solver": (
            "dense_schur" if pair_span
            else ("pcg" if config.refine_cameras else "frozen")
        ),
        "timers": timers.times,
    }

    def finalize():
        """Pay the single packed device->host fetch and publish the
        solution into recon/info (idempotent)."""
        if "final_cost" in info:
            return recon, info
        with timers.stage("fetch"):
            from sfm_tpu.utils.fetch import fetch as _fetch

            packed = _fetch(packed_dev)
        nc = 12 * problem.cams.shape[0]
        npts = 3 * problem.points.shape[0]
        cams = packed[:nc].reshape(-1, 12)
        points = packed[nc : nc + npts].reshape(-1, 3)
        cost, iters = packed[nc + npts], packed[nc + npts + 1]
        recon.world = points[: recon.num_tracks].astype(np.float64)
        if track_store is not None:
            track_store.update_world(recon.world)
        info["final_cost"] = float(cost)
        info["iterations"] = int(iters)
        # Internal optimum rms: per-observation error against the REFINED
        # parameter set (cost = 0.5 * sum r^2 over 2*n_obs components).
        # With refine_cameras this is the apples-to-apples reading against
        # the reference's own scipy-TRF residual (its refined cameras are
        # discarded at SFM.py:181-183, so its against-calibration error is
        # far worse — see QUALITY.md).
        info["rms_reproj_refined_px"] = float(
            np.sqrt(
                2.0 * info["final_cost"] / max(problem.num_observations, 1)
            )
        )
        if config.refine_cameras:
            # Slice off shape-bucketing's padded camera rows (ba.problem).
            info["cams11"] = cams[: recon.calib.num_views]
        recon.metrics.record("ba_final_cost", info["final_cost"])
        recon.metrics.record("ba_iterations", info["iterations"])
        # With frozen cameras the refined-parameter rms IS the rms against
        # the stored calibration (same cameras), so reuse the solver's own
        # cost instead of paying a fresh device program + fetch; the joint
        # path's cameras differ from calibration, so compute it for real
        # there.
        recon.metrics.record(
            "ba_rms_reproj_after_px",
            info["rms_reproj_refined_px"]
            if not config.refine_cameras
            else recon.rms_reprojection_error(),
        )
        return recon, info

    info["finalize"] = finalize
    if not defer_fetch:
        finalize()
    return recon, info
