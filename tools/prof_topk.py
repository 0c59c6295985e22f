#!/usr/bin/env python3
"""Micro-bench: per-row small-k selection strategies at MVS round shapes.

After the round-3 top_k rewrite, each expansion round runs three (M, N)
row-wise selections (hit enumeration, PMVS view gate, occupancy fill) at
M=32768, N=48, k=4-5.  XLA's lax.top_k lowers to a full row sort; candidates
that may beat it: lax.approx_max_k (an accelerator-optimized partial reduction, exact
at recall_target ~1.0) and an unrolled k-step argmax+mask.

python tools/prof_topk.py
"""
import numpy as np
import jax
import jax.numpy as jnp

from sfm_tpu.utils.roofline import _timeit

M, N, K = 32768, 48, 4
rng = np.random.default_rng(0)
vals_f = jnp.asarray(rng.random((M, N)).astype(np.float32))
vals_i = jnp.asarray(rng.integers(0, N + 1, (M, N)).astype(np.int32))


@jax.jit
def t_topk_f(v):
    w, i = jax.lax.top_k(v, K)
    return w.sum() + i.sum()


@jax.jit
def t_topk_i(v):
    w, i = jax.lax.top_k(v, K)
    return w.sum() + i.sum()


@jax.jit
def t_approx(v):
    w, i = jax.lax.approx_max_k(v, K, recall_target=0.99,
                                aggregate_to_topk=True)
    return w.sum() + i.sum()


@jax.jit
def t_argmax_iter(v):
    out_w = []
    out_i = []
    cur = v
    for _ in range(K):
        i = jnp.argmax(cur, axis=1)
        w = jnp.take_along_axis(cur, i[:, None], axis=1)[:, 0]
        out_w.append(w)
        out_i.append(i)
        cur = cur.at[jnp.arange(v.shape[0]), i].set(-jnp.inf)
    return sum(w.sum() for w in out_w) + sum(i.sum() for i in out_i)


for name, fn, v in (
    ("top_k f32", t_topk_f, vals_f),
    ("top_k int32", t_topk_i, vals_i),
    ("approx_max_k f32", t_approx, vals_f),
    ("argmax-iter f32", t_argmax_iter, vals_f),
):
    t = _timeit(lambda: fn(v), 20)
    print(f"{name:20s} ({M}x{N}, k={K}): {t*1e3:.2f} ms")
