"""Plain float64 numpy references for the device kernels.

Independent of the JAX code they check: written from the formulas, with
Python-level loops only where numpy has no vectorized form.  Used by the
tests at small shapes and by ``chip_smoke.py`` at real widths on the GPU.
"""

from __future__ import annotations

import numpy as np


def harris_response(gray: np.ndarray, k: float = 0.04) -> np.ndarray:
    """(N, H, W) -> Harris response with zero padding: Sobel gradients, 3x3
    box-summed structure tensor, det - k * trace^2 (ops/harris.py)."""
    g = np.asarray(gray, np.float64)
    h, w = g.shape[-2:]
    p = np.pad(g, ((0, 0), (1, 1), (1, 1)))

    def at(a, dy, dx):
        return a[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    ix = (at(p, -1, 1) + 2 * at(p, 0, 1) + at(p, 1, 1)) - (
        at(p, -1, -1) + 2 * at(p, 0, -1) + at(p, 1, -1)
    )
    iy = (at(p, 1, -1) + 2 * at(p, 1, 0) + at(p, 1, 1)) - (
        at(p, -1, -1) + 2 * at(p, -1, 0) + at(p, -1, 1)
    )

    def box(a):
        q = np.pad(a, ((0, 0), (1, 1), (1, 1)))
        return sum(at(q, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

    sxx, syy, sxy = box(ix * ix), box(iy * iy), box(ix * iy)
    return sxx * syy - sxy * sxy - k * (sxx + syy) ** 2


def bilinear_patches(stack, img_idx, centers, wid: int = 5):
    """Bilinear (2*wid+1)^2 patches at fractional (x, y) centers from an
    (N, H, W) stack, with ops/ncc.py's window conventions: the window's
    top-left is clipped into the image, and ``inbounds`` says whether the
    whole patch and its interpolation support lie inside.

    Returns (patches (M, side*side) float64, inbounds (M,) bool)."""
    stack = np.asarray(stack, np.float64)
    img_idx = np.asarray(img_idx).reshape(-1)
    centers = np.asarray(centers, np.float64).reshape(-1, 2)
    _, h, w = stack.shape
    side = 2 * wid + 1
    win = side + 1
    x, y = centers[:, 0], centers[:, 1]
    inb = (x >= wid + 1) & (x <= w - wid - 2) & (y >= wid + 1) & (y <= h - wid - 2)
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0
    bx = np.clip(x0.astype(np.int64) - wid, 0, w - win)
    by = np.clip(y0.astype(np.int64) - wid, 0, h - win)
    rows = by[:, None] + np.arange(win)[None]                  # (M, win)
    cols = bx[:, None] + np.arange(win)[None]
    blk = stack[img_idx[:, None, None], rows[:, :, None], cols[:, None, :]]
    fx, fy = fx[:, None, None], fy[:, None, None]
    val = (
        blk[:, :side, :side] * (1 - fy) * (1 - fx)
        + blk[:, :side, 1:] * (1 - fy) * fx
        + blk[:, 1:, :side] * fy * (1 - fx)
        + blk[:, 1:, 1:] * fy * fx
    )
    return val.reshape(len(x), side * side), inb


def normalize(patches: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Zero-mean, unit-L2 rows (ops/patches.normalize_descriptors)."""
    c = patches - patches.mean(axis=-1, keepdims=True)
    n = np.linalg.norm(c, axis=-1, keepdims=True)
    return c / np.maximum(n, eps)


def mutual_nearest(scores: np.ndarray) -> np.ndarray:
    """(..., K1, K2) scores -> (..., K1) index of the mutual best match in
    the second set, -1 where the best match is not mutual."""
    j = scores.argmax(-1)                                      # (..., K1)
    i_back = scores.argmax(-2)                                 # (..., K2)
    back = np.take_along_axis(i_back, j, axis=-1)
    return np.where(back == np.arange(scores.shape[-2]), j, -1)
