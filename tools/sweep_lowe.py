"""Measure Lowe-ratio sensitivity on dinoRing-48 (VERDICT r1 item 4).

The reference uses 0.7 (utils.py:190) with FLANN's *approximate* kNN; our
matcher is exact matmul correlation with a mutual-nearest check, so the optimal
ratio need not transfer.  This records tracks/obs/rms/dense at both settings
so the shipped default is a measured choice, not drift.

Run on the GPU:
  python tools/sweep_lowe.py
"""
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np

from sfm_tpu.config import PipelineConfig, BaConfig, FeatureConfig, MvsConfig
from sfm_tpu.io import read_pars, load_images
from sfm_tpu.sfm import structure_from_motion
from sfm_tpu.ba.run import bundle_adjust
from sfm_tpu.mvs import dense_reconstruction

DATA = "/root/reference/dinoRing"


def main():
    calib = read_pars(os.path.join(DATA, "dinoR_par.txt"))
    images, _ = load_images(DATA, "png")
    calib = calib.subset(range(images.shape[0]))

    out = []
    for ratio in (0.7, 0.8):
        cfg = PipelineConfig(
            features=FeatureConfig(lowe_ratio=ratio),
            ba=BaConfig(),
            mvs=MvsConfig(),
        )
        t0 = time.perf_counter()
        recon = structure_from_motion(images, calib, cfg)
        recon, info = bundle_adjust(recon, cfg.ba)
        dense = dense_reconstruction(images, calib, recon, cfg.mvs, scale=10.0)
        wall = time.perf_counter() - t0
        row = {
            "lowe_ratio": ratio,
            "tracks": recon.num_tracks,
            "obs": int(recon.num_observations),
            "post_ba_rms_px": float(recon.rms_reprojection_error()),
            "seeds": dense.num_seeds,
            "dense_points": dense.num_points,
            "mean_ncc": float(dense.scores.mean()),
            "wall_s": round(wall, 2),
        }
        print(json.dumps(row), flush=True)
        out.append(row)
    print("RESULT " + json.dumps(out))


if __name__ == "__main__":
    main()
