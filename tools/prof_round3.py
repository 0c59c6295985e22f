#!/usr/bin/env python3
"""Round-3 expansion-round ablation at production shapes (CAP=32768, V=5).

After the slab-gather kernel cut the photo-consistency sweep 3.7x, MVS wall
is 0.64 s over ~4 rounds — what is the rest?  Suspect: the round's OWN row
gathers (hit compaction, candidate selection, parent lookups) at XLA's
~1 us/index rate, plus dedup scatters over the occupancy grid.

python tools/prof_round3.py
"""
import time
import numpy as np
import jax
import jax.numpy as jnp

from sfm_tpu.config import MvsConfig
from sfm_tpu.mvs.cells import make_occupancy
from sfm_tpu.mvs.expand import expansion_round
from sfm_tpu.mvs.photoconsistency import photo_consistency
from sfm_tpu.utils.roofline import _timeit


rng = np.random.default_rng(0)
N, H, W = 48, 480, 640
CAP = 32768
V = 5
gray = jnp.asarray(rng.random((N, H, W)).astype(np.float32) * 255)
K = jnp.asarray(np.tile(np.asarray(
    [[1500.0, 0, 320], [0, 1500.0, 240], [0, 0, 1]], np.float32), (N, 1, 1)))
R = jnp.asarray(np.tile(np.eye(3, dtype=np.float32), (N, 1, 1)))
t = jnp.asarray(np.tile(np.asarray([0, 0, 0.6], np.float32), (N, 1)))
centers_cam = jnp.zeros((N, 3), jnp.float32)
centers = jnp.asarray((rng.random((CAP, 3)) * 0.1 - 0.05).astype(np.float32))
ref = jnp.asarray(rng.integers(0, N, CAP).astype(np.int32))

# Production-shaped photo-consistency (gated V=5).
t_pc = _timeit(lambda: photo_consistency(
    gray, K, R, t, centers, ref, 0.7, 5, V)[3].sum(), 10)
print(f"photo_consistency gated V={V} M={CAP}: {t_pc*1e3:.1f} ms")

# Full expansion round at production shapes.
cfg = MvsConfig(round_capacity=CAP)
occ = make_occupancy(N, H, W, cfg.cell_size)
f_n = jnp.asarray((rng.random((CAP, 3)) - 0.5).astype(np.float32))
f_n = f_n / jnp.linalg.norm(f_n, axis=-1, keepdims=True)
vis_mask = rng.random((CAP, N)) < (V - 1) / N
f_vis = jnp.asarray(vis_mask)
f_proj = jnp.asarray(
    (rng.random((CAP, N, 2)) * [W - 40, H - 40] + 20).astype(np.float32))
f_valid = jnp.ones((CAP,), bool)


def round_fn():
    acc, occ2, packed = expansion_round(
        gray, K, R, t, centers_cam, occ, centers, f_n,
        f_vis, f_proj, f_valid, cfg, 3, CAP, 10.0)
    return packed.sum()


t_rd = _timeit(round_fn, 10)
print(f"expansion_round F={CAP}: {t_rd*1e3:.1f} ms "
      f"(non-photoconsistency: {(t_rd - t_pc)*1e3:.1f} ms)")

# Raw XLA row-gather rate: M indices into rows of various widths.
for rows, width in ((CAP * V, 2), (CAP * V, 96), (CAP, 151)):
    src = jnp.asarray(rng.random((CAP * 8, width)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, CAP * 8, rows).astype(np.int32))
    f = jax.jit(lambda s, i: s[i].sum())
    tg = _timeit(lambda: f(src, idx), 10)
    print(f"xla row-gather {rows}x({width},): {tg*1e3:.2f} ms "
          f"({tg/rows*1e9:.0f} ns/row)")

# nonzero-compaction cost (the round does 2 of these).
flags = jnp.asarray(rng.random(CAP * 4) < 0.3)
f_nz = jax.jit(
    lambda fl: jnp.nonzero(fl, size=CAP, fill_value=fl.shape[0] - 1)[0].sum()
)
t_nz = _timeit(lambda: f_nz(flags), 10)
print(f"nonzero(size={CAP}) over {CAP*4}: {t_nz*1e3:.2f} ms")

# Occupancy-grid scatter (dedup pre-pass + claims).
lin = jnp.asarray(rng.integers(0, N * 320 * 240, CAP * 4).astype(np.int32))
vals = jnp.asarray(rng.random(CAP * 4).astype(np.float32))
f_sc = jax.jit(
    lambda l, v: jnp.full((N * 320 * 240,), -jnp.inf).at[l].max(v).sum()
)
t_sc = _timeit(lambda: f_sc(lin, vals), 10)
print(f"scatter-max {CAP*4} -> {N*320*240} cells: {t_sc*1e3:.2f} ms")
