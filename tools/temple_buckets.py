"""Demonstrate warm-from-cache onboarding of a NEW dataset via shape
bucketing (VERDICT r4 item 4).

Round 4's temple-style run paid a full set of compiles because
16 images x 2048 corners was a brand-new shape family.  With shape
bucketing (utils/buckets.py) the compiled-program shapes depend only on the
BUCKETS, so a second temple-style dataset with a *different* image count
(13 vs 14 -> both bucket to 16 images / 15 pairs; track/obs counts land in
the same 1024/2048 ladder rungs) runs entirely from the persistent compile
cache: `compile_s ~ 0`.

Usage: python tools/temple_buckets.py
Runs dataset A (13 views) and dataset B (12 views) in FRESH subprocesses,
one after the other, printing each run's cold wall + XLA compile
attribution.

Single-run mode (used internally): tools/temple_buckets.py --run DIR PREFIX
"""

import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def run_one(data_dir: str, prefix: str):
    """Fresh-process pipeline run with XLA compile attribution."""
    attr = {"hits": 0, "misses": 0, "compile_s": 0.0}
    try:
        from jax._src import monitoring as mon

        def on_event(event, **kw):
            if event == "/jax/compilation_cache/cache_hits":
                attr["hits"] += 1
            elif event == "/jax/compilation_cache/compile_requests_use_cache":
                attr["misses"] += 1

        def on_duration(event, duration, **kw):
            if "backend_compile" in event:
                attr["compile_s"] += duration

        mon.register_event_listener(on_event)
        mon.register_event_duration_secs_listener(on_duration)
    except Exception:
        pass

    import jax.numpy as jnp
    import numpy as np

    from sfm_tpu.ba.run import bundle_adjust
    from sfm_tpu.config import (
        BaConfig, FeatureConfig, MvsConfig, PipelineConfig,
    )
    from sfm_tpu.io import load_images, read_pars
    from sfm_tpu.mvs import dense_reconstruction
    from sfm_tpu.sfm import structure_from_motion

    np.asarray(jnp.arange(8))  # backend init outside the timed region
    calib = read_pars(os.path.join(data_dir, f"{prefix}_par.txt"))
    images, _ = load_images(data_dir, "ppm")
    cfg = PipelineConfig(
        features=FeatureConfig(max_corners=2048, max_matches=1024),
        ba=BaConfig(dtype="float32"),
        mvs=MvsConfig(round_capacity=8192, max_rounds=16),
    )
    t0 = time.perf_counter()
    recon = structure_from_motion(images, calib, cfg)
    recon, info = bundle_adjust(recon, cfg.ba)
    dense = dense_reconstruction(images, calib, recon, cfg.mvs, 1.0)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "dataset": data_dir,
        "n_images": int(images.shape[0]),
        "wall_s": round(wall, 2),
        "compile_s": round(attr["compile_s"], 2),
        "cache_hits": attr["hits"],
        "cache_misses": max(attr["misses"] - attr["hits"], 0),
        "tracks": recon.num_tracks,
        "rms_px": round(recon.rms_reprojection_error(), 4),
        "dense_points": dense.num_points,
    }))


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--run":
        run_one(sys.argv[2], sys.argv[3])
        return

    from sfm_tpu.utils import synth

    # 13 and 12 views land in the same rung of EVERY ladder (images 16,
    # pairs 15, tracks 1024, observations 1024, seed candidates 2048); a
    # 14-view A measured one legitimate rung crossing (its ~1.3k
    # observations bucket to 2048 vs 13/12-view ~0.9k -> 1024), which
    # recompiles the BA solver — bucketing bounds compiles per RUNG, it
    # doesn't erase them.
    sets = []
    for name, n in (("A", 13), ("B", 12)):
        d = f"/tmp/temple_bucket_{name}"
        if not os.path.exists(os.path.join(d, "templeSR_par.txt")):
            synth.write_middlebury_dataset(
                d, centers=synth.ring_rig(n)
            )
        sets.append(d)
        print(f"dataset {name}: {d} ({n} views)")

    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [_ROOT, env.get("PYTHONPATH")])
    )
    # Dedicated persistent-cache dir: run A populates it from scratch, so
    # run B's compile_s ~ 0 is attributable to bucket sharing alone (the
    # default cache may already hold these shapes from other runs).
    env["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(prefix="temple_cache")
    for d in sets:
        print(f"--- fresh-process run on {d} ---", flush=True)
        subprocess.run(
            [sys.executable, __file__, "--run", d, "templeSR"],
            env=env, check=True,
        )


if __name__ == "__main__":
    main()
