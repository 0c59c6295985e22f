#!/usr/bin/env python3
"""GPU smoke test: the main path once on the card, checked, in one process.

    python chip_smoke.py              # phases 0-4 on one GPU
    python chip_smoke.py --chips 4    # only the sharded path, on four GPUs

Phase 0 checks for a GPU and prints the setup.  Phase 1 renders a 48-view
640x480 ring of one textured sphere from --seed, writes it in Middlebury
layout (PPM + _par.txt), runs ``sfm_tpu.cli.main`` on it twice (cold, then
warm) with the default knobs and stages sfm,ba,mvs, and checks the clouds
against thresholds taken from a CPU run of the same scene (PERF.md).
Phase 2 runs BA solver parity on the captured dinoRing problem through
both camera solvers.  Phase 3 compares the remaining device kernels with
the float64 numpy references at real widths.  Phase 4 runs the
non-default device paths: the outlier filter on a two-sphere scene, and a
mid-MVS checkpoint -> resume cycle.

Any failed check raises, so the process exits non-zero and prints no
result.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# One textured unit sphere at the origin: the dinoRing-shaped scene.
SPHERE = (((0.0, 0.0, 0.0), 1.0),)
RING_VIEWS, RING_W, RING_H = 48, 640, 480
# The MVS radius scale tools/stress_scale.py uses for the same sphere scene.
RING_SCALE = 10.0
CLI_KNOBS = [
    "--max_corners", "1024", "--max_matches", "512",
    "--mvs_max_patches", "100000", "--mvs_round_capacity", "32768",
    "--mvs_max_views", "-1",
]

# Phase-1 thresholds, set from a CPU run of the same scene and seed 0:
# 7,033 tracks, mean pair reprojection 0.1293 px, BA rms 0.19335 px
# (float64), 8,499 dense points, median surface distance 0.0024246
# (PERF.md, "Phase-1 thresholds").  Counts may move by a few percent with
# float32 rounding at the gates; accuracy may not get worse by more than
# the quality criteria's 5 % (25 % for the median distance, a noisier
# statistic of fewer points).
MIN_TRACKS, MAX_TRACKS = 6822, 7244            # CPU +- 3 %
MAX_PAIR_REPROJ_PX = 0.3                       # the insertion gate
MAX_BA_RMS_PX = 0.2030                         # CPU x 1.05
MIN_DENSE_POINTS, MAX_DENSE_POINTS = 8074, 8924  # CPU +- 5 %
MAX_MEDIAN_SURFACE_DIST = 0.00303              # CPU x 1.25
# Phase 4 (16-view 640x480 two-sphere ring, outlier filter on).
FILTER_MIN_TRACKS = 500


def log(msg=""):
    print(msg, flush=True)


class Check(AssertionError):
    pass


def check(ok, what):
    log(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        raise Check(what)


# --------------------------------------------------------------------------
# Phase 0: device
# --------------------------------------------------------------------------


def phase0_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform!r}",
              file=sys.stderr)
        raise SystemExit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"
    from sfm_tpu.utils.platform import compile_cache_dir

    log("== phase 0: device")
    log(card)
    log(f"jax {jax.__version__}; devices: {len(jax.devices())} x "
        f"{dev.device_kind}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"JAX_PLATFORMS={os.environ.get('JAX_PLATFORMS', '')!r}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir or 'off'} "
        f"(policy dir {compile_cache_dir()})")
    log(f"jax_default_matmul_precision="
        f"{jax.config.jax_default_matmul_precision}")
    return dev, card


# --------------------------------------------------------------------------
# Compile-cache accounting
# --------------------------------------------------------------------------

_CACHE = {"hits": 0, "misses": 0, "compile_s": 0.0}


def _install_cache_listeners():
    from jax._src import monitoring

    def on_event(event, **kw):
        if event == "/jax/compilation_cache/cache_hits":
            _CACHE["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            _CACHE["misses"] += 1

    def on_duration(event, duration, **kw):
        if "backend_compile" in event:
            _CACHE["compile_s"] += duration

    monitoring.register_event_listener(on_event)
    monitoring.register_event_duration_secs_listener(on_duration)


def _cache_snapshot():
    return dict(_CACHE)


def _cache_delta(before):
    return {
        "persistent_cache_hits": _CACHE["hits"] - before["hits"],
        "persistent_cache_misses": _CACHE["misses"] - before["misses"],
        "backend_compile_s": round(_CACHE["compile_s"] - before["compile_s"], 3),
    }


# --------------------------------------------------------------------------
# Phase 1: main path through the CLI
# --------------------------------------------------------------------------


def write_ring(out_dir, seed, n_views=None, spheres=SPHERE):
    from sfm_tpu.utils import synth

    _, par, _ = synth.write_middlebury_dataset(
        out_dir, centers=synth.ring_rig(n_views or RING_VIEWS),
        w=RING_W, h=RING_H,
        prefix="ringSR", image_type="ppm", spheres=spheres, seed=seed,
    )
    return par


def run_cli(argv):
    """sfm_tpu.cli.main in this process; returns (rc, summary dict, wall)."""
    from sfm_tpu import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"    | {line}")
    summary = {}
    for line in out.splitlines():
        if line.startswith("{"):
            summary = json.loads(line)
    return rc, summary, wall


def ring_metrics(data_dir, out_dir, extra=()):
    """Run the CLI on a written ring and read its results back."""
    from sfm_tpu.io.ply import read_ply
    from sfm_tpu.utils import synth

    argv = [
        "-img_p", data_dir, "-par_p", os.path.join(data_dir, "ringSR_par.txt"),
        "-t", "ppm", "-scale", str(RING_SCALE), "--stages", "sfm,ba,mvs",
        "--out_dir", out_dir, *CLI_KNOBS, *extra,
    ]
    before = _cache_snapshot()
    rc, summary, wall = run_cli(argv)
    clouds = {
        name: read_ply(os.path.join(out_dir, name + ".ply"))
        for name in ("sparse_points", "sparse_points_ba", "initial_patches",
                     "all_patches")
    }
    dense = clouds["all_patches"][0]
    surf = synth.surface_distance(dense, SPHERE) if len(dense) else np.inf
    return {
        "rc": rc,
        "wall_s": round(wall, 3),
        "tracks": summary.get("sparse_tracks"),
        "mean_pair_reprojection_error_px": summary.get(
            "mean_pair_reprojection_error_px"),
        "ba_rms_px": summary.get("ba_rms_reproj_px"),
        "ba_final_cost": summary.get("ba_final_cost"),
        "dense_points": summary.get("mvs_points"),
        "median_surface_distance": float(np.median(surf)),
        "track_store_backend": summary.get("track_store_backend"),
        "timers_s": summary.get("timers_s"),
        "ply_counts": {k: int(v[0].shape[0]) for k, v in clouds.items()},
        **_cache_delta(before),
    }


def phase1_main_path(work, seed):
    log("== phase 1: main path (cli.main, 48 x 640x480 ring, sfm,ba,mvs)")
    data = os.path.join(work, "ring48")
    t0 = time.perf_counter()
    write_ring(data, seed)
    log(f"  rendered {RING_VIEWS} views in {time.perf_counter() - t0:.1f} s")
    runs = {}
    for run in ("cold", "warm"):
        m = ring_metrics(data, os.path.join(work, f"out_{run}"))
        runs[run] = m
        log(f"  {run}: " + json.dumps(m))
    for run, m in runs.items():
        check(m["rc"] == 0, f"{run} cli.main rc 0 (got {m['rc']})")
        check(m["ply_counts"]["all_patches"] == m["dense_points"],
              f"{run} all_patches.ply holds the {m['dense_points']} points")
        check(MIN_TRACKS <= m["tracks"] <= MAX_TRACKS,
              f"{run} tracks {m['tracks']} in [{MIN_TRACKS}, {MAX_TRACKS}]")
        check(m["mean_pair_reprojection_error_px"] < MAX_PAIR_REPROJ_PX,
              f"{run} mean pair reprojection "
              f"{m['mean_pair_reprojection_error_px']:.4f} px "
              f"< {MAX_PAIR_REPROJ_PX}")
        check(m["ba_rms_px"] < MAX_BA_RMS_PX,
              f"{run} BA rms {m['ba_rms_px']:.4f} px < {MAX_BA_RMS_PX}")
        check(MIN_DENSE_POINTS <= m["dense_points"] <= MAX_DENSE_POINTS,
              f"{run} dense points {m['dense_points']} in "
              f"[{MIN_DENSE_POINTS}, {MAX_DENSE_POINTS}]")
        check(m["median_surface_distance"] <= MAX_MEDIAN_SURFACE_DIST,
              f"{run} median surface distance "
              f"{m['median_surface_distance']:.5f} <= "
              f"{MAX_MEDIAN_SURFACE_DIST}")
        check(m["track_store_backend"] == "native",
              f"{run} track store backend {m['track_store_backend']!r}")
    cold, warm = runs["cold"], runs["warm"]
    check(cold["tracks"] == warm["tracks"],
          "warm run reproduces the cold run's track count")
    check(abs(cold["dense_points"] - warm["dense_points"])
          <= 0.01 * cold["dense_points"],
          "warm run's dense count within 1 % of the cold run's")
    return runs


# --------------------------------------------------------------------------
# Phase 2: BA solver parity on the captured dinoRing problem
# --------------------------------------------------------------------------


def _reference_ba_rms():
    with open(os.path.join(ROOT, "quality_data",
                           "reference_measured.json")) as f:
        return json.load(f)["dino48_sparse"]["internal_rms_px"]


def phase2_ba_parity():
    import quality

    log("== phase 2: BA solver parity on dino48_ba_problem.npz (float32)")
    ref_rms = _reference_ba_rms()
    res = {}
    for span in (1, 0):  # dense Schur, then PCG
        t0 = time.perf_counter()
        r = quality._ba_solver_parity(ref_rms, pair_span=span)
        r["wall_s"] = round(time.perf_counter() - t0, 3)
        log("  " + json.dumps(r))
        res[r["camera_solver"]] = r
        check(r["ratio"] <= 1.05,
              f"{r['camera_solver']} ratio {r['ratio']:.4f} <= 1.05")
        check(abs(r["model_check_rms_at_ref_solution"] - ref_rms) < 0.02,
              f"{r['camera_solver']} model check within 0.02 px")
    a, b = res["dense_schur"]["ours_rms"], res["pcg"]["ours_rms"]
    check(abs(a - b) <= 0.02 * max(a, b),
          f"dense-Schur rms {a:.5f} and PCG rms {b:.5f} within 2%")
    return res


# --------------------------------------------------------------------------
# Phase 3: kernels against plain references at real widths
# --------------------------------------------------------------------------


def _smooth_stack(rng, n, h, w):
    """Band-limited random texture in [0, 255] (patch-scale structure)."""
    g = rng.random((n, h, w)).astype(np.float32)
    for axis in (1, 2):
        g = (np.roll(g, 1, axis) + g + np.roll(g, -1, axis)) / 3.0
    g -= g.min(axis=(1, 2), keepdims=True)
    return g / g.max(axis=(1, 2), keepdims=True) * 255.0


def phase3_references(ring_gray):
    import jax
    import jax.numpy as jnp

    from sfm_tpu.ops import reference
    from sfm_tpu.ops.harris import harris_response
    from sfm_tpu.ops.ncc import bilinear_sample_patches_stack, ncc_scores
    from sfm_tpu.ops.patches import normalize_descriptors

    log("== phase 3: kernels vs float64 numpy references")
    rng = np.random.default_rng(0)
    out = {}

    # Harris: float32 on the device, library precision 'highest'.
    for name, gray in (
        ("48x480x640", ring_gray),
        ("4x1200x1600", _smooth_stack(rng, 4, 1200, 1600)),
    ):
        got = np.asarray(harris_response(jnp.asarray(gray)), np.float64)
        want = reference.harris_response(gray)
        scale = np.abs(want).max(axis=(1, 2))
        err = np.abs(got - want).max(axis=(1, 2)) / scale
        out[f"harris_{name}"] = float(err.max())
        check(err.max() <= 1e-4,
              f"harris {name} (float32): max abs err / per-image max "
              f"response = {err.max():.3e} <= 1e-4")

    # Matcher correlation at Precision.DEFAULT (TF32 for f32 operands).
    p, k, d = 47, 1024, 121
    d1 = rng.standard_normal((p, k, d))
    d2 = d1[:, rng.permutation(k)] + 0.6 * rng.standard_normal((p, k, d))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    got = np.asarray(
        jax.vmap(ncc_scores)(jnp.asarray(d1, jnp.float32),
                             jnp.asarray(d2, jnp.float32)), np.float64)
    want = np.einsum("pid,pjd->pij", d1, d2)
    err = float(np.abs(got - want).max())
    mn_got, mn_want = reference.mutual_nearest(got), reference.mutual_nearest(want)
    agree = float((mn_got == mn_want).mean())
    out["ncc_scores_max_abs_err"] = err
    out["ncc_mutual_nearest_agreement"] = agree
    check(err <= 5e-3, f"ncc_scores 47x1024x121 (DEFAULT = TF32): max abs "
                       f"err {err:.3e} <= 5e-3")
    check(agree >= 0.99, f"mutual-nearest agreement {agree:.4f} >= 0.99")

    # Photo-consistency sampler: bilinear 11x11 patches from the bf16 stack
    # the MVS sweep samples, normalized and stored as bf16, NCC against the
    # first view of each candidate at Precision.DEFAULT.  The reference
    # samples the same bf16-quantized stack in float64, so the limits
    # measure the sampler's arithmetic and its bf16 output.  Compared where
    # the patch has texture (std >= 1 grey level): a flat patch normalizes
    # float rounding noise, and its descriptor carries no information.
    m, v = 32768, 5
    for name, gray in (
        ("w640", ring_gray),
        ("w1600", _smooth_stack(rng, 48, 1200, 1600)),
    ):
        gray = np.asarray(jnp.asarray(gray, jnp.bfloat16), np.float32)
        n, h, w = gray.shape
        img = rng.integers(0, n, (m, v)).astype(np.int32)
        ctr = np.stack([rng.uniform(0, w, (m, v)), rng.uniform(0, h, (m, v))],
                       -1).astype(np.float32)
        patches, inb = bilinear_sample_patches_stack(
            jnp.asarray(gray, jnp.bfloat16), jnp.asarray(img),
            jnp.asarray(ctr), 5)
        desc = normalize_descriptors(patches).astype(jnp.bfloat16)
        ncc = jnp.einsum("mvd,md->mv", desc, desc[:, 0],
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.DEFAULT)
        desc = np.asarray(desc.astype(jnp.float32), np.float64)
        want_p, want_inb = reference.bilinear_patches(gray, img, ctr, 5)
        want_d = reference.normalize(want_p).reshape(m, v, -1)
        want_inb = want_inb.reshape(m, v)
        check(np.array_equal(np.asarray(inb), want_inb),
              f"sampler {name}: in-bounds masks equal")
        tex = want_inb & (want_p.std(-1).reshape(m, v) >= 1.0)
        ok = tex & tex[:, :1]
        out[f"sampler_{name}_compared"] = [int(tex.sum()), int(ok.sum())]
        check(ok.sum() > m // 4, f"sampler {name}: {int(tex.sum())} "
                                 f"textured samples, {int(ok.sum())} pairs")
        derr = float(np.abs(desc - want_d)[tex].max())
        want_ncc = np.einsum("mvd,md->mv", want_d, want_d[:, 0])
        nerr = float(np.abs(np.asarray(ncc, np.float64) - want_ncc)[ok].max())
        out[f"sampler_{name}_desc_err"] = derr
        out[f"sampler_{name}_ncc_err"] = nerr
        check(derr <= 1e-2, f"sampler {name} ({m}x{v} samples, bf16 stack): "
                            f"descriptor max abs err {derr:.3e} <= 1e-2")
        check(nerr <= 2e-2, f"sampler {name}: NCC max abs err "
                            f"{nerr:.3e} <= 2e-2")
    return out


# --------------------------------------------------------------------------
# Phase 4: non-default device paths
# --------------------------------------------------------------------------


def phase4_nondefault(work, seed):
    import copy

    import sfm_tpu.mvs.pipeline as mp
    from sfm_tpu.ba import bundle_adjust
    from sfm_tpu.config import (
        BaConfig, FeatureConfig, MvsConfig, PipelineConfig,
    )
    from sfm_tpu.io import load_images, read_pars
    from sfm_tpu.io.ply import read_ply
    from sfm_tpu.mvs import dense_reconstruction
    from sfm_tpu.sfm import structure_from_motion
    from sfm_tpu.utils import synth

    log("== phase 4: outlier filter on a two-sphere scene; checkpoint/resume")
    two = (((0.0, 0.0, 0.0), 1.0), ((1.0, 0.1, 0.9), 0.55))
    data = os.path.join(work, "two16")
    write_ring(data, seed, n_views=16, spheres=two)
    out = os.path.join(work, "out_two16")
    rc, summary, wall = run_cli([
        "-img_p", data, "-par_p", os.path.join(data, "ringSR_par.txt"),
        "-t", "ppm", "-scale", "1", "--stages", "sfm,ba,mvs",
        "--out_dir", out, "--max_corners", "2048", "--max_matches", "1024",
        "--mvs_round_capacity", "4096", "--mvs_rounds", "8",
        "--enable_outlier_filter",
    ])
    check(rc == 0, f"filter-on cli.main rc 0 (got {rc})")
    pts, _ = read_ply(os.path.join(out, "all_patches.ply"))
    p95 = float(np.percentile(synth.surface_distance(pts, two), 95))
    res = {"filter_tracks": summary.get("sparse_tracks"),
           "filter_dense_points": summary.get("mvs_points"),
           "filter_surface_p95": p95, "filter_wall_s": round(wall, 3)}
    log("  " + json.dumps(res))
    check(res["filter_tracks"] > FILTER_MIN_TRACKS,
          f"tracks {res['filter_tracks']} > {FILTER_MIN_TRACKS}")
    check(res["filter_dense_points"] > 5 * res["filter_tracks"],
          "dense points > 5x tracks")
    check(p95 < 0.05, f"surface distance p95 {p95:.4f} < 0.05")

    images, _ = load_images(data, "ppm")
    calib = read_pars(os.path.join(data, "ringSR_par.txt"))
    cfg = PipelineConfig(
        features=FeatureConfig(max_corners=2048, max_matches=1024))
    recon = structure_from_motion(images, calib, cfg)
    recon, _ = bundle_adjust(copy.deepcopy(recon), BaConfig())
    mvs_cfg = MvsConfig(round_capacity=2048, max_rounds=6)
    full = dense_reconstruction(images, calib, recon, mvs_cfg, scale=1.0)
    ckpt_dir = os.path.join(work, "ckpt")
    real_round = mp.expansion_round
    calls = {"n": 0}

    def killing_round(*a, **k):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("simulated crash")
        return real_round(*a, **k)

    mp.expansion_round = killing_round
    try:
        dense_reconstruction(images, calib, recon, mvs_cfg, scale=1.0,
                             checkpoint_dir=ckpt_dir, checkpoint_every=1)
        raise Check("the simulated crash did not fire")
    except RuntimeError:
        pass
    finally:
        mp.expansion_round = real_round
    resumed = dense_reconstruction(images, calib, recon, mvs_cfg, scale=1.0,
                                   checkpoint_dir=ckpt_dir, checkpoint_every=1)
    bitwise = (resumed.num_points == full.num_points
               and np.array_equal(resumed.points, full.points)
               and np.array_equal(resumed.colors, full.colors))
    res.update(resume_points=resumed.num_points, full_points=full.num_points,
               resume_bitwise_identical=bool(bitwise),
               resumed_at_round=resumed.metrics.values.get(
                   "mvs_resumed_at_round"))
    log("  " + json.dumps({k: res[k] for k in (
        "resume_points", "full_points", "resume_bitwise_identical",
        "resumed_at_round")}))
    check(res["resumed_at_round"], "the second run resumed from a checkpoint")
    # Bit-for-bit equality is reported, not required: a GPU scatter with
    # duplicate indices may pick another winner from run to run, so the
    # resumed cloud is held to the uninterrupted one's size and geometry.
    rel = abs(resumed.num_points - full.num_points) / max(full.num_points, 1)
    check(rel <= 0.01, f"resumed cloud {resumed.num_points} points vs "
                       f"{full.num_points} uninterrupted (within 1 %)")
    p95r = float(np.percentile(synth.surface_distance(resumed.points, two), 95))
    check(p95r < 0.05, f"resumed cloud surface distance p95 {p95r:.4f} < 0.05")
    return res


# --------------------------------------------------------------------------
# --chips 4: the sharded path against one device
# --------------------------------------------------------------------------


def phase_mesh(work, seed, n_dev):
    import jax

    import quality
    from sfm_tpu.ba.sharded import solve_lm_sharded
    from sfm_tpu.ba.solver import solve_lm
    from sfm_tpu.parallel.mesh import data_mesh

    check(len(jax.devices()) >= n_dev,
          f"{n_dev} GPUs visible (found {len(jax.devices())})")
    log(f"== mesh phase: cli.main --mesh_devices {n_dev} vs 1; "
        "solve_lm_sharded vs solve_lm")
    data = os.path.join(work, "ring48")
    write_ring(data, seed)
    runs = {}
    for nd in (n_dev, 1):
        runs[nd] = ring_metrics(data, os.path.join(work, f"out_mesh{nd}"),
                                extra=["--mesh_devices", str(nd)])
        log(f"  mesh_devices={nd}: " + json.dumps(runs[nd]))
        check(runs[nd]["rc"] == 0, f"mesh_devices={nd} rc 0")
    stats = [d.memory_stats() for d in jax.devices()[:n_dev]]
    if all(stats):  # the CPU backend keeps no memory statistics
        peaks = [st.get("peak_bytes_in_use", 0) for st in stats]
        log(f"  peak bytes in use per device: {peaks}")
        check(min(peaks) > 0, "every mesh device held arrays")
    a, b = runs[n_dev], runs[1]
    check(a["tracks"] == b["tracks"], f"tracks equal ({a['tracks']})")
    for key in ("ba_rms_px", "ba_final_cost"):
        rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
        check(rel <= 1e-4, f"{key} within 1e-4 relative ({rel:.2e})")
    rel = abs(a["dense_points"] - b["dense_points"]) / b["dense_points"]
    check(rel <= 0.01, f"dense points {a['dense_points']} vs "
                       f"{b['dense_points']} within 1% ({rel:.4f})")

    mesh = data_mesh(num_devices=n_dev)
    prob, _, _ = quality.load_ba_problem()
    span = int(np.bincount(np.asarray(prob.point_idx)).max())
    out = {"cli": runs}
    # A fixed number of LM steps (ftol 0): with a stopping rule, float32
    # round-off from the psum order moves the step at which LM stops, and
    # the costs then differ by more than the order of summation explains.
    for name, ps in (("dense_schur", span), ("pcg", 0)):
        kw = dict(max_iterations=20, ftol=0.0, optimize_cameras=True)
        _, _, c1, i1 = solve_lm(prob, pair_span=1 if ps else 0, **kw)
        _, _, cs, is_ = solve_lm_sharded(prob, mesh, pair_span=ps, **kw)
        c1, cs = float(c1), float(cs)
        rel = abs(cs - c1) / c1
        out[name] = {"cost_single": c1, "cost_sharded": cs,
                     "iters_single": int(i1), "iters_sharded": int(is_)}
        log(f"  {name}: " + json.dumps(out[name]))
        check(int(i1) == int(is_), f"sharded {name} took as many LM steps")
        check(rel <= 1e-4, f"sharded {name} cost within 1e-4 relative "
                           f"({rel:.2e})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="1: phases 0-4; 4: only the sharded path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work", default=None,
                    help="scratch directory (default: a temporary one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import jax

    dev, _ = phase0_device()
    import sfm_tpu  # noqa: F401  (sets precision and the compile cache)

    _install_cache_listeners()
    with contextlib.ExitStack() as stack:
        work = args.work or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="chip_smoke_"))
        t0 = time.perf_counter()
        if args.chips > 1:
            phase_mesh(work, args.seed, args.chips)
        else:
            phase1_main_path(work, args.seed)
            phase2_ba_parity()
            from sfm_tpu.io import load_images, to_gray

            imgs, _ = load_images(os.path.join(work, "ring48"), "ppm")
            phase3_references(np.rint(to_gray(imgs)).astype(np.float32))
            phase4_nondefault(work, args.seed)
        log(f"all phases passed in {time.perf_counter() - t0:.1f} s; "
            f"process cache totals: {json.dumps(_cache_delta({'hits': 0, 'misses': 0, 'compile_s': 0.0}))}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


def cpu_reference(work, seed=0):
    """Phase 1 on the CPU (JAX_PLATFORMS=cpu): the figures the thresholds
    above are set from.  Prints them; checks nothing."""
    sys.path.insert(0, ROOT)
    import sfm_tpu  # noqa: F401

    _install_cache_listeners()
    data = os.path.join(work, "ring48")
    write_ring(data, seed)
    m = ring_metrics(data, os.path.join(work, "out_cpu"))
    print("CPU_REFERENCE " + json.dumps(m), flush=True)
    return m


if __name__ == "__main__":
    raise SystemExit(main())
