"""Command-line driver (reference main.py:7-46 equivalent).

Mirrors the reference CLI flags (-img_p, -par_p, -t, -scale, --debug,
--nonSequence, -cell_size, -desc_wid; main.py:33-42) and adds the knobs the
reference hard-codes, plus checkpoint/resume and stage selection.  Outputs
sparse_points.ply / initial_patches.ply / all_patches.ply (the reference
writes the latter two, MVS2.py:274,295).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Batched structure-from-motion + multi-view stereo in JAX"
    )
    # Reference flags (main.py:33-42).
    p.add_argument("-img_p", "--image_path", required=True,
                   help="directory of input images")
    p.add_argument("-par_p", "--par_path", required=True,
                   help="Middlebury *_par.txt calibration file")
    p.add_argument("-t", "--type", default="ppm", dest="image_type",
                   help="image extension (default ppm, like the reference)")
    p.add_argument("-scale", type=float, default=1.0,
                   help="viz / MVS-radius scale multiplier")
    p.add_argument("--debug", action="store_true",
                   help="write epipolar/match debug overlays")
    p.add_argument("--nonSequence", action="store_true",
                   help="match all C(n,2) pairs instead of the sequential "
                        "chain (unimplemented in the reference; works here)")
    p.add_argument("-cell_size", type=int, default=2)
    p.add_argument("-desc_wid", type=int, default=5)
    # Engine knobs (hard-coded constants in the reference, SURVEY.md §5).
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--max_reproj_err", type=float, default=0.3)
    p.add_argument("--track_threshold", type=float, default=0.01)
    p.add_argument("--max_corners", type=int, default=1024)
    p.add_argument("--max_matches", type=int, default=512)
    p.add_argument("--lowe_ratio", type=float, default=0.8)
    p.add_argument("--min_ncc_seed", type=float, default=0.4)
    p.add_argument("--min_ncc_expand", type=float, default=0.7)
    p.add_argument("--mvs_rounds", type=int, default=64)
    p.add_argument("--mvs_round_capacity", type=int, default=32768)
    p.add_argument("--mvs_max_patches", type=int, default=100_000)
    p.add_argument("--mvs_max_views", type=int, default=-1,
                   help="PMVS-style geometric view gate: NCC-test only this "
                        "many best-aligned views per patch (0 = all views, "
                        "the reference's exact semantics; -1 = auto: 5 on "
                        "rigs with >= 16 images, else 0)")
    p.add_argument("--refine_cameras", action="store_true")
    p.add_argument("--enable_outlier_filter", action="store_true",
                   help="PMVS visibility-consistency outlier post-pass "
                        "(the reference implements but disables it as 'very "
                        "very slow', MVS2.py:280-281; here it is a cheap "
                        "vectorized exact-pairwise pass, off by default to "
                        "match reference output)")
    p.add_argument("--no_shape_buckets", action="store_true",
                   help="disable shape bucketing (images/pairs/tracks "
                        "padded to a standard ladder so new datasets reuse "
                        "compiled programs; outputs identical either way)")
    p.add_argument("--ba_dtype", default=None,
                   help="float32|float64 (default: float32 on the GPU, "
                        "float64 on the CPU; float64 is CPU-only)")
    # Orchestration.
    p.add_argument("--stages", default="sfm,ba,mvs",
                   help="comma list from {sfm,ba,mvs}")
    p.add_argument("--out_dir", default=".")
    p.add_argument("--checkpoint_dir", default=None,
                   help="save/resume stage outputs here (also enables "
                        "mid-MVS round-boundary checkpointing)")
    p.add_argument("--mvs_checkpoint_every", type=int, default=16,
                   help="persist mid-expansion MVS state every this many "
                        "rounds (needs --checkpoint_dir)")
    p.add_argument("--mesh_devices", type=int, default=None,
                   help="shard BA over this many devices (default: 1)")
    p.add_argument("--plot", action="store_true",
                   help="save 3-D scatter PNGs of the clouds")
    p.add_argument("--profile_dir", default=None,
                   help="write a jax.profiler trace of the run here")
    return p


def config_from_args(args):
    from sfm_tpu.config import (
        PipelineConfig, FeatureConfig, SfmConfig, BaConfig, MvsConfig,
        RuntimeConfig,
    )
    from sfm_tpu.utils.platform import resolve_ba_dtype

    ba_dtype = resolve_ba_dtype(args.ba_dtype)
    return PipelineConfig(
        image_path=args.image_path,
        par_path=args.par_path,
        image_type=args.image_type,
        scale=args.scale,
        debug=args.debug,
        max_images=args.max_images,
        features=FeatureConfig(
            max_corners=args.max_corners,
            max_matches=args.max_matches,
            lowe_ratio=args.lowe_ratio,
            desc_wid=args.desc_wid,
        ),
        sfm=SfmConfig(
            max_reprojection_error_px=args.max_reproj_err,
            track_merge_threshold=args.track_threshold,
            pair_mode="combination" if args.nonSequence else "sequence",
        ),
        ba=BaConfig(refine_cameras=args.refine_cameras, dtype=ba_dtype),
        mvs=MvsConfig(
            cell_size=args.cell_size,
            patch_wid=args.desc_wid,
            min_ncc_seed=args.min_ncc_seed,
            min_ncc_expand=args.min_ncc_expand,
            max_rounds=args.mvs_rounds,
            round_capacity=args.mvs_round_capacity,
            max_patches=args.mvs_max_patches,
            max_photo_views=args.mvs_max_views,
            enable_outlier_filter=args.enable_outlier_filter,
            shape_buckets=not args.no_shape_buckets,
        ),
        runtime=RuntimeConfig(
            mesh_shape=args.mesh_devices,
            checkpoint_dir=args.checkpoint_dir,
            shape_buckets=not args.no_shape_buckets,
        ),
    )


def main(argv=None) -> int:
    """CLI entry point.

    Like the reference driver, a RuntimeError from the pipeline is caught
    and reported instead of crashing with a traceback (main.py:43-46) —
    but exits nonzero so scripts can detect the failure.  Bad-input errors
    (missing images, malformed par.txt) get the same clean reporting; the
    library-level APIs still raise.
    """
    try:
        return _main(argv)
    except (RuntimeError, FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    os.makedirs(args.out_dir, exist_ok=True)

    from sfm_tpu.io import read_pars, load_images
    from sfm_tpu.utils.metrics import StageTimer
    from sfm_tpu.utils import checkpoint as ckpt

    timers = StageTimer()
    if args.profile_dir:
        import jax

        jax.profiler.start_trace(args.profile_dir)
    calib = read_pars(config.par_path)
    images, paths = load_images(
        config.image_path, config.image_type, config.max_images
    )
    if calib.num_views > images.shape[0]:
        calib = calib.subset(range(images.shape[0]))
    print(f"loaded {images.shape[0]} images {images.shape[1]}x{images.shape[2]}")

    recon = None
    summary = {}

    if "sfm" in stages:
        resumed = ckpt.try_resume(args.checkpoint_dir, "sfm")
        if resumed is not None:
            print("resumed sparse reconstruction from checkpoint")
            recon = resumed
        else:
            from sfm_tpu.sfm import structure_from_motion

            sfm_mesh = None
            if args.mesh_devices and args.mesh_devices > 1:
                from sfm_tpu.parallel.mesh import data_mesh

                sfm_mesh = data_mesh(num_devices=args.mesh_devices)
            with timers.stage("sfm"):
                recon = structure_from_motion(
                    images, calib, config, mesh=sfm_mesh
                )
            if args.checkpoint_dir:
                ckpt.save_sparse(ckpt.stage_path(args.checkpoint_dir, "sfm"),
                                 recon)
        mean_reproj = recon.mean_reprojection_error()
        print(f"sparse: {recon.num_tracks} tracks, "
              f"{recon.num_observations} observations, "
              f"mean reproj {mean_reproj:.3f}px")
        recon.export_ply(os.path.join(args.out_dir, "sparse_points.ply"))
        summary["sparse_tracks"] = recon.num_tracks
        summary["sparse_mean_reproj_px"] = mean_reproj
        for key in ("mean_pair_reprojection_error_px", "track_store_backend"):
            if key in recon.metrics.values:
                summary[key] = recon.metrics.values[key]
        if args.debug and recon.debug_pairs is not None:
            from sfm_tpu.utils.viz import draw_epipolar_debug

            dp = recon.debug_pairs
            for pi in range(min(3, len(dp["pairs"]))):
                a, b = dp["pairs"][pi]
                sel = dp["inlier"][pi]
                draw_epipolar_debug(
                    images[a], images[b],
                    dp["p1"][pi][sel], dp["p2"][pi][sel], dp["F"][pi],
                    path=os.path.join(
                        args.out_dir, f"debug_epipolar_{a}_{b}.png"
                    ),
                )
        if args.plot:
            from sfm_tpu.utils.viz import scatter3d

            scatter3d(recon.world, scale=args.scale,
                      title="without bundle adjustment",
                      path=os.path.join(args.out_dir, "sparse_before_ba.png"))

    if "ba" in stages:
        if recon is None:
            recon = ckpt.try_resume(args.checkpoint_dir, "sfm")
            if recon is None:
                print("error: BA requested but no sparse reconstruction",
                      file=sys.stderr)
                return 2
        from sfm_tpu.ba.run import bundle_adjust

        mesh = None
        if args.mesh_devices and args.mesh_devices > 1:
            from sfm_tpu.parallel.mesh import data_mesh

            mesh = data_mesh(num_devices=args.mesh_devices)
        with timers.stage("ba"):
            recon, info = bundle_adjust(recon, config.ba, mesh=mesh)
        ba_rms = recon.rms_reprojection_error()
        print(f"ba: cost {info['final_cost']:.4g} after {info['iterations']} "
              f"iterations; rms reproj {ba_rms:.3f}px")
        if args.checkpoint_dir:
            ckpt.save_sparse(ckpt.stage_path(args.checkpoint_dir, "ba"), recon)
        recon.export_ply(os.path.join(args.out_dir, "sparse_points_ba.ply"))
        summary["ba_final_cost"] = info["final_cost"]
        summary["ba_rms_reproj_px"] = ba_rms
        if args.plot:
            from sfm_tpu.utils.viz import scatter3d

            scatter3d(recon.world, scale=args.scale,
                      title="with bundle adjustment",
                      path=os.path.join(args.out_dir, "sparse_after_ba.png"))

    if "mvs" in stages:
        if recon is None:
            recon = (ckpt.try_resume(args.checkpoint_dir, "ba")
                     or ckpt.try_resume(args.checkpoint_dir, "sfm"))
            if recon is None:
                print("error: MVS requested but no reconstruction",
                      file=sys.stderr)
                return 2
        from sfm_tpu.mvs import dense_reconstruction
        from sfm_tpu.io.ply import export_ply

        mvs_mesh = None
        if args.mesh_devices and args.mesh_devices > 1:
            from sfm_tpu.parallel.mesh import data_mesh

            mvs_mesh = data_mesh(num_devices=args.mesh_devices)
        with timers.stage("mvs"):
            dense = dense_reconstruction(
                images, recon.calib, recon, config.mvs, scale=args.scale,
                mesh=mvs_mesh,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.mvs_checkpoint_every,
            )
        if dense.metrics.values.get("mvs_resumed_at_round"):
            print(
                "resumed MVS expansion from round "
                f"{dense.metrics.values['mvs_resumed_at_round']}"
            )
        print(f"mvs: {dense.num_seeds} seeds -> {dense.num_points} points "
              f"in {dense.metrics.values['mvs_rounds']} rounds")
        export_ply(
            os.path.join(args.out_dir, "initial_patches.ply"),
            dense.points[: dense.num_seeds], dense.colors[: dense.num_seeds],
        )
        dense.export_ply(os.path.join(args.out_dir, "all_patches.ply"))
        summary["mvs_seeds"] = dense.num_seeds
        summary["mvs_points"] = dense.num_points
        if args.plot:
            from sfm_tpu.utils.viz import scatter3d

            scatter3d(dense.points, dense.colors, scale=args.scale,
                      title="reconstruct_results",
                      path=os.path.join(args.out_dir, "dense.png"))

    if args.profile_dir:
        import jax

        jax.profiler.stop_trace()
        print(f"profiler trace written to {args.profile_dir}")
    summary["timers_s"] = {k: round(v, 3) for k, v in timers.times.items()}
    print(json.dumps(summary))
    print("stage timers:")
    print(timers.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
