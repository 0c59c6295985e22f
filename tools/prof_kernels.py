"""GPU kernel measurements: a bf16 matmul and a copy for calibration,
Harris, large-k top_k, the photo-consistency sampler, its share of one
expansion round, and the MVS stage on the chip_smoke ring.

Run on the GPU from the repo root:
    python tools/prof_kernels.py [--out DIR] [--skip-mvs]

Prints one JSON line per measurement and a final SUMMARY line.  Times are
host-clock walls around back-to-back calls ended by block_until_ready
(roofline._timeit).  With --out, a profiler trace of one warm MVS stage is
written there.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def emit(rec):
    print(json.dumps(rec), flush=True)
    return rec


def calibration(timeit):
    import jax
    import jax.numpy as jnp

    a = jnp.ones((8192, 8192), jnp.bfloat16)
    mm = jax.jit(lambda x: x @ x)
    t = timeit(lambda: mm(a), 20)
    x = jnp.ones((256 << 20,), jnp.float32)  # 1 GiB
    cp = jax.jit(lambda v: v * 2.0)
    tc = timeit(lambda: cp(x), 20)
    return emit({"what": "calibration",
                 "bf16_matmul_8192_tflops": 2 * 8192 ** 3 / t / 1e12,
                 "copy_1GiB_read_write_gbps": 2 * x.nbytes / tc / 1e9})


def harris_and_topk(timeit):
    import jax
    import jax.numpy as jnp

    from sfm_tpu.utils.roofline import harris_roofline

    rng = np.random.default_rng(0)
    out = []
    for n, h, w in ((48, 480, 640), (4, 1200, 1600)):
        rec = harris_roofline(n_img=n, h=h, w=w, iters=50)
        rec["hbm_bound_us"] = 2 * n * h * w * 4 / 3.35e12 * 1e6
        out.append(emit({"what": "harris_response", **rec}))
        flat = jnp.asarray(rng.random((n, h * w)), jnp.float32)
        tk = jax.jit(lambda x: jax.lax.top_k(x, 1024))
        t = timeit(lambda: tk(flat), 50)
        out.append(emit({"what": "top_k_1024", "shape": [n, h * w],
                         "time_us": t * 1e6,
                         "read_bound_us": n * h * w * 4 / 3.35e12 * 1e6}))
    return out


def sampler(timeit):
    import jax
    import jax.numpy as jnp

    from sfm_tpu.ops import reference
    from sfm_tpu.ops.ncc import bilinear_sample_patches_stack
    from sfm_tpu.ops.patches import normalize_descriptors

    def xla_ncc(stack, img, ctr):
        patches, inb = bilinear_sample_patches_stack(stack, img, ctr, 5)
        d = normalize_descriptors(patches).astype(jnp.bfloat16)
        ncc = jnp.einsum("mvd,md->mv", d, d[:, 0],
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.DEFAULT)
        return ncc, inb

    xla_ncc = jax.jit(xla_ncc)
    rng = np.random.default_rng(1)
    m, v = 32768, 5
    out = []
    for n, h, w in ((48, 480, 640), (48, 1200, 1600)):
        g = rng.random((n, h, w)).astype(np.float32)
        for axis in (1, 2):
            g = (np.roll(g, 1, axis) + g + np.roll(g, -1, axis)) / 3
        g = (g - g.min()) / (g.max() - g.min()) * 255
        stack = jnp.asarray(g, jnp.bfloat16)
        gq = np.asarray(stack, np.float32)
        img = rng.integers(0, n, (m, v)).astype(np.int32)
        ctr = np.stack([rng.uniform(0, w, (m, v)), rng.uniform(0, h, (m, v))],
                       -1).astype(np.float32)
        img_d, ctr_d = jnp.asarray(img), jnp.asarray(ctr)
        p, wi = reference.bilinear_patches(gq, img, ctr, 5)
        d = reference.normalize(p).reshape(m, v, -1)
        want = np.einsum("mvd,md->mv", d, d[:, 0])
        tex = wi.reshape(m, v) & (p.std(-1).reshape(m, v) >= 1.0)
        ok = tex & tex[:, :1]
        t_x = timeit(lambda: xla_ncc(stack, img_d, ctr_d), 50)
        e_x = float(np.abs(np.asarray(xla_ncc(stack, img_d, ctr_d)[0])
                           - want)[ok].max())
        out.append(emit({"what": "sampler", "width": w, "m": m, "v": v,
                         "xla_us": t_x * 1e6, "xla_ncc_err": e_x,
                         "desc_bytes": m * v * 121 * 2}))
    return out


def ring_recon(work):
    import chip_smoke as cs
    from sfm_tpu.ba import bundle_adjust
    from sfm_tpu.config import FeatureConfig, PipelineConfig
    from sfm_tpu.io import load_images, read_pars
    from sfm_tpu.sfm import structure_from_motion

    data = os.path.join(work, "ring48")
    cs.write_ring(data, 0)
    images, _ = load_images(data, "ppm")
    calib = read_pars(os.path.join(data, "ringSR_par.txt"))
    recon = structure_from_motion(
        images, calib,
        PipelineConfig(features=FeatureConfig(max_corners=1024,
                                              max_matches=512)))
    recon, _ = bundle_adjust(recon)
    return images, calib, recon


def round_share(timeit, images, calib, recon):
    """photo_consistency alone vs a whole expansion round, production
    shapes (48 views, capacity 32768, gated V=5), same device inputs."""
    import jax.numpy as jnp

    from sfm_tpu.config import MvsConfig
    from sfm_tpu.io.images import device_gray
    from sfm_tpu.mvs.cells import make_occupancy
    from sfm_tpu.mvs.expand import expansion_round
    from sfm_tpu.mvs.photoconsistency import photo_consistency

    rng = np.random.default_rng(2)
    gray = device_gray(images)
    n, h, w = gray.shape
    K = jnp.asarray(calib.K, jnp.float32)
    R = jnp.asarray(calib.R, jnp.float32)
    t = jnp.asarray(calib.t, jnp.float32)
    cap = 32768
    pts = recon.world[rng.integers(0, recon.num_tracks, cap)]
    c = jnp.asarray(pts + rng.normal(size=pts.shape) * 1e-3, jnp.float32)
    ref = jnp.asarray(rng.integers(0, n, cap), jnp.int32)
    t_pc = timeit(lambda: photo_consistency(gray, K, R, t, c, ref, 0.7, 5, 5),
                  30)
    cfg = MvsConfig()
    occ = make_occupancy(n, h, w, cfg.cell_size)
    vis, proj, _, _ = photo_consistency(gray, K, R, t, c, ref, 0.4, 5, 5)
    nrm = -c / jnp.linalg.norm(c, axis=-1, keepdims=True)
    cams = jnp.asarray(calib.centers, jnp.float32)
    valid = jnp.ones((cap,), bool)
    t_round = timeit(lambda: expansion_round(
        gray, K, R, t, cams, occ, c, nrm, vis, proj, valid,
        cfg, 3, cap, 10.0)[2], 30)
    return {"photo_consistency_us": t_pc * 1e6, "round_us": t_round * 1e6,
            "share": t_pc / t_round}


def mvs_stage(images, calib, recon, reps=3):
    from sfm_tpu.config import MvsConfig
    from sfm_tpu.mvs import dense_reconstruction

    cfg = MvsConfig()
    dense_reconstruction(images, calib, recon, cfg, scale=10.0)  # compile
    walls, pts = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        d = dense_reconstruction(images, calib, recon, cfg, scale=10.0)
        walls.append(time.perf_counter() - t0)
        pts = d.num_points
    return walls, pts, d.metrics.values.get("mvs_rounds")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-mvs", action="store_true")
    args = ap.parse_args()

    import jax

    import sfm_tpu  # noqa: F401
    from sfm_tpu.utils.roofline import _timeit as timeit

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("no GPU")
    emit({"device": dev.device_kind})
    summary = {"calibration": calibration(timeit)}
    summary["harris_topk"] = harris_and_topk(timeit)
    summary["sampler"] = sampler(timeit)
    if not args.skip_mvs:
        with tempfile.TemporaryDirectory() as work:
            images, calib, recon = ring_recon(work)
            summary["round_share"] = emit(
                {"what": "round_share",
                 **round_share(timeit, images, calib, recon)})
            walls, pts, rounds = mvs_stage(images, calib, recon)
            summary["mvs_stage"] = emit(
                {"what": "mvs_stage", "walls_s": walls, "points": pts,
                 "rounds": rounds})
            if args.out:
                from sfm_tpu.config import MvsConfig
                from sfm_tpu.mvs import dense_reconstruction

                os.makedirs(args.out, exist_ok=True)
                with jax.profiler.trace(args.out):
                    dense_reconstruction(images, calib, recon, MvsConfig(),
                                         scale=10.0)
    print("SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
