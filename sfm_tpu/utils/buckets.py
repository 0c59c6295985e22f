"""Shape bucketing: round data-dependent array sizes up to a small ladder.

Every compiled program is keyed on its operand shapes; a brand-new dataset
(new image count, new track/observation counts) used to cost a full set
of XLA compiles even with the persistent cache hot, because 16 images x
2048 corners was a new shape family (VERDICT r4).  Rounding the data-dependent dimensions up
to standard sizes (pad + mask — the codebase's existing currency) makes any
dataset whose buckets were compiled before warm-from-cache.

Padding is INERT by construction at every site:
  - pad images are zeros with cameras placed at z = -1e9, so every
    projection lands out of frame / behind the camera and no corner,
    match, NCC hit, or cell fill can reference them;
  - pad pairs carry an explicit invalid mask into the pair program;
  - pad seed candidates carry an explicit invalid mask into seeding;
  - pad BA observations/points/cameras are masked / observation-free (the
    LM trajectory of the real parameters is bitwise unchanged — appended
    decoupled rows don't alter the leading Cholesky block or add nonzero
    terms to any reduction).

Equality bucketed-vs-unbucketed is tested in tests/test_pipeline_scenes.py.
"""

from __future__ import annotations

import numpy as np


def bucket_images(n: int) -> int:
    """Image-count bucket: exact up to 8 (tiny rigs compile fast and tests
    stay exact), then the next multiple of 8 (12->16, 48->48, 50->56)."""
    if n <= 8:
        return n
    return -(-n // 8) * 8


def bucket_pairs(n_images_bucket: int, mode: str) -> int:
    """Pair-count bucket implied by the image bucket and schedule mode."""
    if mode == "sequence":
        return max(n_images_bucket - 1, 0)
    if mode == "combination":
        return n_images_bucket * (n_images_bucket - 1) // 2
    raise ValueError(f"unknown pair mode: {mode}")


def bucket_multiple(n: int, multiple: int) -> int:
    """Round ``n`` up to a multiple (tracks: 1024, seed candidates: 2048)."""
    return -(-max(n, 1) // multiple) * multiple


def pad_calibration(calib, n_bucket: int):
    """Extend a Calibration with inert cameras up to ``n_bucket`` views.

    Pad cameras: K=I, R=I, t=(0,0,-1e9) — depth of any finite world point
    is hugely negative, so projections fail every in-frame/in-front gate
    and the cameras can never contribute observations or visible hits."""
    from sfm_tpu.io.calib import Calibration

    n = calib.num_views
    if n_bucket <= n:
        return calib
    pad = n_bucket - n
    K = np.concatenate([calib.K, np.tile(np.eye(3), (pad, 1, 1))])
    R = np.concatenate([calib.R, np.tile(np.eye(3), (pad, 1, 1))])
    t_pad = np.tile(np.array([0.0, 0.0, -1e9]), (pad, 1))
    t = np.concatenate([calib.t, t_pad])
    names = tuple(calib.names) + tuple(
        f"__pad{i}" for i in range(pad)
    )
    return Calibration(K=K, R=R, t=t, names=names)
