#!/usr/bin/env python3
"""Dev harness: per-stage timing breakdown of the full pipeline.

Not part of the library; used to find the next bottleneck."""
import json
import os
import sys
import time

import numpy as np


def main():
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    import jax
    from sfm_tpu.config import PipelineConfig, BaConfig, MvsConfig
    from sfm_tpu.io import read_pars, load_images
    from sfm_tpu.sfm import structure_from_motion
    from sfm_tpu.ba.run import bundle_adjust
    from sfm_tpu.mvs import dense_reconstruction
    from sfm_tpu.utils.platform import resolve_ba_dtype

    data = "/root/reference/dinoRing"
    calib = read_pars(os.path.join(data, "dinoR_par.txt"))
    images, _ = load_images(data, "png", max_images=frames)
    calib = calib.subset(range(images.shape[0]))
    backend = jax.default_backend()
    config = PipelineConfig(
        ba=BaConfig(dtype=resolve_ba_dtype(None, backend)),
        mvs=MvsConfig(),
    )

    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        recon = structure_from_motion(images, calib, config)
        t_sfm = time.perf_counter() - t0
        t0 = time.perf_counter()
        recon, info = bundle_adjust(recon, config.ba)
        t_ba = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = dense_reconstruction(images, calib, recon, config.mvs, 10.0)
        t_mvs = time.perf_counter() - t0
        print(f"== {run} ==  sfm {t_sfm:.2f}s  ba {t_ba:.2f}s  mvs {t_mvs:.2f}s"
              f"  dense_points {dense.num_points}")
        print("sfm timers:", recon.timers.summary() if recon.timers else "-")
        print("ba timers:", info.get("timers"), "iters:", info.get("iterations"))
        print("mvs timers:", dense.timers.summary() if dense.timers else "-")
        print("mvs metrics:", dense.metrics.summary())
        sys.stdout.flush()


if __name__ == "__main__":
    main()
