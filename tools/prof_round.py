#!/usr/bin/env python3
"""Dev micro-bench: attribute expansion-round cost."""
import time
import numpy as np
import jax
import jax.numpy as jnp

from sfm_tpu.config import MvsConfig
from sfm_tpu.mvs.cells import make_occupancy
from sfm_tpu.mvs.expand import expansion_round
from sfm_tpu.mvs.photoconsistency import photo_consistency


def sync(x):
    np.asarray(jax.tree_util.tree_leaves(x)[0].ravel()[:1])


def timeit(f, n=5):
    f()  # compile
    sync(f())
    t0 = time.perf_counter()
    for _ in range(n):
        r = f()
    sync(r)
    return (time.perf_counter() - t0) / n


rng = np.random.default_rng(0)
N, H, W = 48, 480, 640
CAP = 16384
gray = jnp.asarray(rng.random((N, H, W)).astype(np.float32) * 255)
K = jnp.asarray(np.tile(np.asarray([[1500.0, 0, 320], [0, 1500.0, 240], [0, 0, 1]], np.float32), (N, 1, 1)))
R = jnp.asarray(np.tile(np.eye(3, dtype=np.float32), (N, 1, 1)))
t = jnp.asarray(np.tile(np.asarray([0, 0, 0.6], np.float32), (N, 1)))
centers_cam = jnp.zeros((N, 3), jnp.float32)

rgb = jnp.asarray(rng.integers(0, 255, (N, H, W, 3)).astype(np.uint8))
centers = jnp.asarray((rng.random((CAP, 3)) * 0.1 - 0.05).astype(np.float32))
ref = jnp.asarray(rng.integers(0, N, CAP).astype(np.int32))

t_pc = timeit(lambda: photo_consistency(gray, K, R, t, centers, ref, 0.7, 5, 0))
print(f"photo_consistency full  M={CAP} N={N}: {t_pc*1e3:.1f} ms")
t_pc16 = timeit(lambda: photo_consistency(gray, K, R, t, centers, ref, 0.7, 5, 16))
print(f"photo_consistency V=16  M={CAP} N={N}: {t_pc16*1e3:.1f} ms")

cfg = MvsConfig(round_capacity=CAP)
occ = make_occupancy(N, H, W, cfg.cell_size)
f_c = centers
f_n = jnp.asarray((rng.random((CAP, 3)) - 0.5).astype(np.float32))
f_n = f_n / jnp.linalg.norm(f_n, axis=-1, keepdims=True)
f_vis = jnp.asarray(rng.random((CAP, N)) < 0.2)
f_proj = jnp.asarray((rng.random((CAP, N, 2)) * [W - 40, H - 40] + 20).astype(np.float32))
f_valid = jnp.ones((CAP,), bool)


def round_fn():
    return expansion_round(gray, K, R, t, centers_cam, occ, f_c, f_n,
                           f_vis, f_proj, f_valid, cfg, 3, CAP, 10.0)


t_rd = timeit(round_fn)
print(f"expansion_round  F={CAP}: {t_rd*1e3:.1f} ms")

# D2H cost of a round's packed payload (what the pipeline now fetches)
acc, occ2, packed = round_fn()
t0 = time.perf_counter()
np.asarray(packed)
t_d2h = time.perf_counter() - t0
print(f"packed D2H: {t_d2h*1e3:.1f} ms")
