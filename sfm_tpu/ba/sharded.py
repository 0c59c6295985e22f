"""Multi-device bundle adjustment via shard_map over a data mesh.

Distribution design (SURVEY.md §5/§7, BASELINE north-star): observations —
the only O(problem-size) axis — are sharded across the mesh's "data" axis;
cameras and points are replicated.  Every reduction the LM loop needs
(normal-equation blocks U/V/b, the Schur RHS, each CG matvec's two segment
sums, the cost) becomes segment_sum-then-psum, so partial sums ride the
interconnect and no device ever materializes more than its observation
shard.  The entire LM
while_loop runs *inside* shard_map: one compiled SPMD program, zero host
round-trips during the solve.

This replaces nothing in the reference — it has no distributed code at all
(SURVEY.md §2 "Parallelism") — and is the part the reference's scipy TRF
design fundamentally could not express.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from sfm_tpu.ba.problem import BAProblem
from sfm_tpu.ba.solver import _lm_impl
from sfm_tpu.parallel.mesh import DATA_AXIS


def shard_problem(
    problem: BAProblem, num_shards: int, track_aligned: bool = False
) -> BAProblem:
    """Pad the observation axis so it splits evenly across shards.

    Padded rows get mask=False / index 0, exactly like build_problem padding,
    so they are algebraically inert.

    ``track_aligned=True`` additionally cuts ONLY at track boundaries (all
    observations of a point land on one shard) — required by the dense
    Schur path, whose same-point pair enumeration is shard-local
    (solver._dense_schur_dc).  Observations arrive grouped by point
    (problem.build_problem uses np.repeat over track lengths), so this is a
    host-side greedy re-chunking with per-shard padding.
    """
    o = problem.obs_2d.shape[0]
    if track_aligned:
        # Sort observations by point (stable; usually already grouped —
        # build_problem emits tracks contiguously) so each point's
        # observations are contiguous, then cut only at point boundaries.
        po_all = np.asarray(problem.point_idx)
        grouped = np.argsort(po_all, kind="stable")
        po = po_all[grouped]
        mask = np.asarray(problem.mask)[grouped]
        cuts = np.flatnonzero(np.diff(po) != 0) + 1
        bounds = np.concatenate([[0], cuts, [o]])
        target = -(-o // num_shards)
        starts = [0]
        for s in range(1, num_shards):
            pos = bounds[np.searchsorted(bounds, s * target)]
            starts.append(max(int(pos), starts[-1]))
        starts.append(o)
        lens = np.diff(starts)
        per = int(lens.max())
        idx = np.zeros((num_shards, per), np.int64)
        ok = np.zeros((num_shards, per), bool)
        for s in range(num_shards):
            n = lens[s]
            idx[s, :n] = np.arange(starts[s], starts[s] + n)
            ok[s, :n] = True
        idx = grouped[idx.reshape(-1)]
        ok = ok.reshape(-1)
        return BAProblem(
            cams=problem.cams,
            points=problem.points,
            cam_idx=jnp.asarray(np.asarray(problem.cam_idx)[idx] * ok),
            point_idx=jnp.asarray(np.asarray(problem.point_idx)[idx] * ok),
            obs_2d=jnp.asarray(
                np.asarray(problem.obs_2d)[idx] * ok[:, None]
            ),
            mask=jnp.asarray(np.asarray(problem.mask)[idx] & ok),
        )
    per = -(-o // num_shards)
    pad = per * num_shards - o
    if pad == 0:
        return problem
    return BAProblem(
        cams=problem.cams,
        points=problem.points,
        cam_idx=jnp.concatenate(
            [problem.cam_idx, jnp.zeros(pad, problem.cam_idx.dtype)]
        ),
        point_idx=jnp.concatenate(
            [problem.point_idx, jnp.zeros(pad, problem.point_idx.dtype)]
        ),
        obs_2d=jnp.concatenate(
            [problem.obs_2d, jnp.zeros((pad, 2), problem.obs_2d.dtype)]
        ),
        mask=jnp.concatenate([problem.mask, jnp.zeros(pad, bool)]),
    )


def solve_lm_sharded(
    problem: BAProblem,
    mesh,
    max_iterations: int = 50,
    ftol: float = 1e-4,
    init_lambda: float = 1e-3,
    lambda_up: float = 4.0,
    lambda_down: float = 0.5,
    optimize_cameras: bool = True,
    cg_iters: int = 100,
    cg_tol: float = 1e-6,
    pair_span: int = 0,
):
    """Distributed LM over ``mesh`` (1-D, axis "data").

    ``pair_span > 0`` selects the dense reduced-camera-system path (one
    psum of S per LM iteration instead of 2 psums per CG iteration, whose
    latency bounds the PCG path across devices); shards
    are then cut at track boundaries so pair enumeration stays local.

    Returns (cams, points, final_cost, iterations), all replicated.
    """
    num_shards = mesh.shape[DATA_AXIS]
    problem = shard_problem(
        problem, num_shards,
        track_aligned=optimize_cameras and pair_span > 0,
    )

    obs_spec = P(DATA_AXIS)
    rep = P()
    in_specs = BAProblem(
        cams=rep, points=rep,
        cam_idx=obs_spec, point_idx=obs_spec, obs_2d=obs_spec, mask=obs_spec,
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(in_specs,),
        out_specs=(rep, rep, rep, rep),
        check_vma=False,
    )
    def run(local_problem: BAProblem):
        return _lm_impl(
            local_problem,
            max_iterations=max_iterations,
            ftol=ftol,
            init_lambda=init_lambda,
            lambda_up=lambda_up,
            lambda_down=lambda_down,
            optimize_cameras=optimize_cameras,
            cg_iters=cg_iters,
            cg_tol=cg_tol,
            axis_name=DATA_AXIS,
            pair_span=pair_span,
        )

    with mesh:
        return jax.jit(run)(problem)
