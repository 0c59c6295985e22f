#!/usr/bin/env python3
"""Per-phase wall attribution of the warm dinoRing-48 pipeline (round 4).

VERDICT r3 task #6: the 0.65 s warm wall splits roughly SfM 0.14 / BA 0.10
/ MVS 0.44 — publish where each goes at production shapes and either cut
it or record the measured floor.  This runs the REAL pipeline (not shaped
micro-benchmarks) twice — cold then warm — and prints the stage timers the
pipeline already collects, plus an MVS round/fetch decomposition.

python tools/prof_pipeline.py
"""
import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds_per_call", type=int, default=None)
    ap.add_argument("--round_capacity", type=int, default=None)
    ap.add_argument("--pairs_per_step", type=int, default=None)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()

    from sfm_tpu.ba.run import bundle_adjust
    from sfm_tpu.config import (
        BaConfig, MvsConfig, PipelineConfig, SfmConfig,
    )
    from sfm_tpu.io import load_images, read_pars
    from sfm_tpu.mvs import dense_reconstruction
    from sfm_tpu.sfm import structure_from_motion

    images, _ = load_images("/root/reference/dinoRing", "png")
    calib = read_pars("/root/reference/dinoRing/dinoR_par.txt")
    mvs_kw = {}
    if args.rounds_per_call is not None:
        mvs_kw["rounds_per_call"] = args.rounds_per_call
    if args.round_capacity is not None:
        mvs_kw["round_capacity"] = args.round_capacity
    sfm_kw = {}
    if args.pairs_per_step is not None:
        sfm_kw["pairs_per_step"] = args.pairs_per_step
    cfg = PipelineConfig(mvs=MvsConfig(**mvs_kw), sfm=SfmConfig(**sfm_kw))

    for run in range(1 + args.runs):
        t0 = time.perf_counter()
        recon = structure_from_motion(images, calib, cfg)
        t_sfm = time.perf_counter() - t0
        t1 = time.perf_counter()
        recon, ba_info = bundle_adjust(recon, cfg.ba)
        t_ba = time.perf_counter() - t1
        t2 = time.perf_counter()
        dense = dense_reconstruction(images, calib, recon, cfg.mvs, 10.0)
        t_mvs = time.perf_counter() - t2
        tag = "cold" if run == 0 else f"warm{run}"
        print(f"== {tag}: total {t_sfm + t_ba + t_mvs:.3f} s "
              f"(sfm {t_sfm:.3f} ba {t_ba:.3f} mvs {t_mvs:.3f})")
        if run == 0:
            continue
        print("   sfm stages:", {
            k: round(v, 4) for k, v in (recon.timers.times or {}).items()
        })
        print("   ba stages:", {
            k: round(v, 4) for k, v in ba_info["timers"].items()
        })
        mt = dense.timers.times if dense.timers else {}
        print("   mvs stages:", {k: round(v, 4) for k, v in mt.items()})
        mv = dense.metrics.values
        rounds = mv.get("mvs_rounds", 0)
        print(f"   mvs rounds={rounds} points={dense.num_points} "
              f"seeds={dense.num_seeds}")
        if rounds:
            print(f"   mvs expand/round = "
                  f"{mt.get('expand', 0) / rounds * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
