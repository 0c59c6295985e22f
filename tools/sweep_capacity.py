"""Sweep MVS round_capacity x rounds_per_call on dinoRing-48.

Total photo-consistency gather work is ~fixed (candidates deferred past the
cap re-enter later rounds), but each round also pays fixed costs: occupancy-
sized dedup scatters, frontier compaction, dispatch, and a payload fetch.
Larger capacity = fewer rounds = less fixed overhead — until the last
round's padding waste (cap - live candidates) dominates.

Run: python tools/sweep_capacity.py
"""
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")

from sfm_tpu.config import PipelineConfig, BaConfig, MvsConfig
from sfm_tpu.io import read_pars, load_images
from sfm_tpu.sfm import structure_from_motion
from sfm_tpu.ba.run import bundle_adjust
from sfm_tpu.mvs import dense_reconstruction

DATA = "/root/reference/dinoRing"


def main():
    calib = read_pars(os.path.join(DATA, "dinoR_par.txt"))
    images, _ = load_images(DATA, "png")
    calib = calib.subset(range(images.shape[0]))
    recon = structure_from_motion(images, calib, PipelineConfig())
    recon, _ = bundle_adjust(recon, BaConfig())

    for cap, chunk in [
        (16384, 2), (16384, 4),
        (32768, 1), (32768, 2),
        (49152, 1), (49152, 2),
        (65536, 1),
    ]:
        cfg = MvsConfig(round_capacity=cap, rounds_per_call=chunk)
        dense = dense_reconstruction(images, calib, recon, cfg, 10.0)  # compile
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            dense = dense_reconstruction(images, calib, recon, cfg, 10.0)
            best = min(best, time.perf_counter() - t0)
        print(json.dumps({
            "cap": cap,
            "chunk": chunk,
            "mvs_s": round(best, 3),
            "points": dense.num_points,
            "rounds": dense.metrics.values["mvs_rounds"],
            "over_cap": dense.metrics.values["mvs_candidates_over_capacity"],
        }), flush=True)


if __name__ == "__main__":
    main()
