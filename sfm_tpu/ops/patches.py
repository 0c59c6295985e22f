"""Patch extraction + descriptor normalization.

The reference's descriptor is a flattened grayscale square patch of side
2*wid+1 around a corner (getDescFeatures, HarrisFeatures.py:116-133), matched
by zero-mean NCC (Match, HarrisFeatures.py:16-37).  Here the gather is batched
over all corners of all images at once, and descriptors are normalized to
zero-mean unit-norm so that NCC between two descriptors is a plain dot
product — which turns all-pairs matching into one matmul.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_EPS = 1e-8


@functools.partial(jax.jit, static_argnames=("wid",))
def extract_patches(gray, corners, wid: int = 5):
    """Gather square patches around integer corner coordinates.

    Args:
      gray: (N, H, W) grayscale stack.
      corners: (N, K, 2) int (x, y) positions.
      wid: half-width; patch side = 2*wid+1.

    Returns:
      patches: (N, K, (2*wid+1)**2) float32, row-major flattened;
      inbounds: (N, K) bool — corners whose full patch fits in the image.
    """
    n, h, w = gray.shape
    k = corners.shape[1]
    side = 2 * wid + 1
    x = corners[..., 0]
    y = corners[..., 1]
    inb = (x >= wid) & (x < w - wid) & (y >= wid) & (y < h - wid)
    # Fold (image, row) into one axis and vmap a 2-D dynamic_slice per
    # corner: one (side, side) block slice per corner instead of a
    # side*side-element advanced-index gather.
    # An out-of-border corner's slice may cross an image boundary in the
    # folded layout (defined values, wrong content) — exactly those corners
    # are flagged ``inb=False`` and masked by the caller; dynamic_slice
    # clamps starts so the gather itself always stays in bounds.
    flat = gray.reshape(n * h, w)
    img = jnp.repeat(jnp.arange(n, dtype=jnp.int32), k)
    row = img * h + y.reshape(-1) - wid
    col = x.reshape(-1) - wid

    def one(r, c):
        return jax.lax.dynamic_slice(flat, (r, c), (side, side))

    patches = jax.vmap(one)(row, col)
    return patches.reshape(n, k, side * side).astype(jnp.float32), inb


@jax.jit
def normalize_descriptors(patches):
    """Zero-mean, unit-L2 normalize flattened patches -> NCC-ready descriptors.

    After this, dot(d1, d2) equals the Pearson/NCC correlation of the raw
    patches (the reference's ctNcc up to its 1/(n-1) convention, MVS2.py:39-43).
    """
    mean = jnp.mean(patches, axis=-1, keepdims=True)
    c = patches - mean
    norm = jnp.linalg.norm(c, axis=-1, keepdims=True)
    return c / jnp.maximum(norm, _EPS)
