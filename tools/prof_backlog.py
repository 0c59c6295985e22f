#!/usr/bin/env python3
"""Sustained-backlog regime measurement (VERDICT r2 item 8).

When seed count exceeds ``round_capacity`` the MVS loop defers the overflow
to a host-side backlog and, while it persists, pulls the WHOLE frontier to
host every round and disables the prefetch pipeline
(mvs/pipeline.py:_merge_backlog).  On dinoRing the backlog drains in one
round; this tool creates a sustained regime (capacity << seeds) and records
the per-round cost from the pipeline's own metrics
(mvs_backlog_merge_s / mvs_backlog_rounds, added this round).

Run: python tools/prof_backlog.py
Findings: BASELINE.md "Sustained backlog" section.
"""
import json
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np


def main():
    from sfm_tpu.config import PipelineConfig, BaConfig, MvsConfig
    from sfm_tpu.io import read_pars, load_images
    from sfm_tpu.sfm import structure_from_motion
    from sfm_tpu.ba.run import bundle_adjust
    from sfm_tpu.mvs import dense_reconstruction

    data = "/root/reference/dinoRing"
    calib = read_pars(data + "/dinoR_par.txt")
    images, _ = load_images(data, "png")
    calib = calib.subset(range(images.shape[0]))
    recon = structure_from_motion(images, calib, PipelineConfig())
    recon, _ = bundle_adjust(recon, BaConfig(dtype="float32"))
    print(json.dumps({"tracks": recon.num_tracks}), flush=True)

    # capacity >> seeds (steady state), then capacity << seeds (sustained
    # backlog: every accepted-over-capacity patch re-enters via the host).
    for cap in (32768, 2048, 1024):
        cfg = MvsConfig(round_capacity=cap, max_rounds=256)
        for it in range(2):  # second run = warm (compiled) numbers
            t0 = time.perf_counter()
            d = dense_reconstruction(images, calib, recon, cfg, scale=10.0)
            wall = time.perf_counter() - t0
        m = d.metrics.values
        rounds = m["mvs_rounds"]
        bl_rounds = m.get("mvs_backlog_rounds", 0)
        bl_s = m.get("mvs_backlog_merge_s", 0.0)
        print(json.dumps({
            "round_capacity": cap,
            "warm_wall_s": round(wall, 3),
            "rounds": rounds,
            "points": d.num_points,
            "seeds": d.num_seeds,
            "backlog_rounds": bl_rounds,
            "backlog_merge_s_total": bl_s,
            "backlog_merge_s_per_round": round(bl_s / bl_rounds, 4)
            if bl_rounds else None,
            "per_round_wall_s": round(wall / max(rounds, 1), 4),
        }), flush=True)


if __name__ == "__main__":
    main()
