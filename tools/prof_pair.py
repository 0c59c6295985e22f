#!/usr/bin/env python3
"""Dev micro-bench: SfM pair-geometry component costs."""
import time
import numpy as np
import jax
import jax.numpy as jnp

from sfm_tpu.config import PipelineConfig, RansacConfig
from sfm_tpu.sfm.pipeline import _make_pair_program
from sfm_tpu.features.matching import match_descriptors
from sfm_tpu.geometry.triangulation import triangulate_dlt, refine_triangulation
from sfm_tpu.sfm.ransac import ransac_fundamental


def sync(r):
    np.asarray(jax.tree_util.tree_leaves(r)[0].ravel()[:1])


def timeit(f, n=3):
    sync(f())
    t0 = time.perf_counter()
    for _ in range(n):
        r = f()
    sync(r)
    return (time.perf_counter() - t0) / n


rng = np.random.default_rng(0)
NP_, K_, D_, M_ = 47, 4096, 121, 2048
desc = rng.normal(size=(48, K_, D_)).astype(np.float32)
desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
desc = jnp.asarray(desc)
val = jnp.ones((48, K_), bool)
cor = jnp.asarray(rng.integers(10, 470, (48, K_, 2)).astype(np.int32))
Km = jnp.asarray(np.tile(np.asarray([[1500., 0, 320], [0, 1500., 240], [0, 0, 1]], np.float32), (48, 1, 1)))
Rm = jnp.asarray(np.tile(np.eye(3, dtype=np.float32), (48, 1, 1)))
tm = jnp.asarray(np.tile(np.asarray([0, 0, .6], np.float32), (48, 1)))
P = jnp.einsum("nij,njk->nik", Km, jnp.concatenate([Rm, tm[..., None]], -1))
keys = jax.random.split(jax.random.PRNGKey(0), NP_)
ia = np.arange(NP_)
ib = ia + 1

ia_d = jnp.asarray(ia, jnp.int32)
ib_d = jnp.asarray(ib, jnp.int32)
for hyp in (512, 128):
    cfg = PipelineConfig(ransac=RansacConfig(num_hypotheses=hyp))
    prog = _make_pair_program(cfg, M_)
    print(f"pair program hyp={hyp}: "
          f"{timeit(lambda: prog(desc, val, cor, P, Km, Rm, tm, ia_d, ib_d, keys))*1e3:.0f} ms")

# matcher alone over 47 pairs (lax.map)
@jax.jit
def match_all(da, va, db, vb):
    def step(args):
        a, vva, b, vvb = args
        m = match_descriptors(a, vva, b, vvb, 0.8, M_, True)
        return m.count
    return jax.lax.map(step, (da, va, db, vb))


print(f"match only          : {timeit(lambda: match_all(desc[ia], val[ia], desc[ib], val[ib]))*1e3:.0f} ms")

# triangulation alone: 47*2048 two-view DLT + refine
pix = jnp.asarray(rng.uniform(0, 480, (NP_ * M_, 2, 2)).astype(np.float32))
Pb = jnp.broadcast_to(P[0], (NP_ * M_, 2, 3, 4))


@jax.jit
def tri(Pb, pix):
    X, w = triangulate_dlt(Pb, pix)
    return refine_triangulation(Pb, pix, X)


@jax.jit
def tri_only(Pb, pix):
    return triangulate_dlt(Pb, pix)[0]


print(f"DLT+refine 96k pts  : {timeit(lambda: tri(Pb, pix))*1e3:.0f} ms")
print(f"DLT only   96k pts  : {timeit(lambda: tri_only(Pb, pix))*1e3:.0f} ms")

# ransac alone over 47 pairs
p1 = jnp.asarray(rng.uniform(0, 480, (NP_, M_, 2)).astype(np.float32))
p2 = p1 + 1.0


@jax.jit
def ransac_all(p1, p2, keys):
    def step(args):
        a, b, k = args
        F, inl, n = ransac_fundamental(a, b, jnp.ones(M_, bool), k, 512, 2.0, True)
        return n
    return jax.lax.map(step, (p1, p2, keys))


print(f"ransac512 only      : {timeit(lambda: ransac_all(p1, p2, keys))*1e3:.0f} ms")
