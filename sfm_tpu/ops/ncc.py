"""NCC scoring and bilinear patch sampling.

``ncc_scores`` is the matcher's hot op: all-pairs correlation of two
normalized descriptor sets as one matmul (replaces the reference's FLANN
k-d forest at utils.py:180-185 and the O(N*M) Python NCC loop at
HarrisFeatures.py:16-37 — at a few thousand corners per 640x480 image, a
dense matmul on the tensor cores beats tree search by orders of magnitude).

``bilinear_sample_patches`` is MVS's photo-consistency gather: sample square
patches at *fractional* pixel centers (projected 3-D points) with bilinear
interpolation, batched over candidates x views.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def ncc_scores(desc1, desc2):
    """(…, K1, D) x (…, K2, D) -> (…, K1, K2) correlation matrix.

    Runs at DEFAULT precision deliberately (TF32 on a Hopper GPU for f32
    operands, ~3 decimal digits): correlation ranking only needs ~2 and
    this is the matcher's FLOPs hot spot — the library's global 'highest'
    default (see sfm_tpu/__init__.py) is for the geometry path, not here.
    """
    return jnp.einsum(
        "...id,...jd->...ij",
        desc1,
        desc2,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )


@functools.partial(jax.jit, static_argnames=("wid",))
def bilinear_sample_patches(gray, centers, wid: int = 5):
    """Sample (2*wid+1)^2 patches at fractional centers with bilinear interp.

    Gather strategy (the MVS hot path): ONE (side+1)x(side+1) block
    ``dynamic_slice`` per candidate — XLA lowers the vmap to a single
    slice-gather instead of 4 element gathers per pixel — then all bilinear
    taps are static shifts of the block with per-candidate scalar weights
    (the fractional offset is constant across a patch).

    Args:
      gray: (H, W) single grayscale image.
      centers: (M, 2) float (x, y) patch centers.
      wid: half-width.

    Returns:
      patches: (M, (2*wid+1)**2) float32;
      inbounds: (M,) bool — True where the whole patch (incl. interp support)
        lies inside the image.
    """
    h, w = gray.shape
    side = 2 * wid + 1
    win = side + 1
    x = centers[..., 0]
    y = centers[..., 1]
    inb = (
        (x >= wid + 1) & (x <= w - wid - 2) & (y >= wid + 1) & (y <= h - wid - 2)
    )
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0).astype(jnp.float32)[:, None, None]
    fy = (y - y0).astype(jnp.float32)[:, None, None]
    base_x = jnp.clip(x0.astype(jnp.int32) - wid, 0, w - win)
    base_y = jnp.clip(y0.astype(jnp.int32) - wid, 0, h - win)

    def block(by, bx):
        return jax.lax.dynamic_slice(gray, (by, bx), (win, win))

    window = jax.vmap(block)(base_y, base_x)  # (M, win, win)
    p00 = window[:, :side, :side]
    p01 = window[:, :side, 1:]
    p10 = window[:, 1:, :side]
    p11 = window[:, 1:, 1:]
    val = (
        p00 * (1 - fy) * (1 - fx)
        + p01 * (1 - fy) * fx
        + p10 * fy * (1 - fx)
        + p11 * fy * fx
    )
    m = val.shape[0]
    return val.reshape(m, -1).astype(jnp.float32), inb


@functools.partial(jax.jit, static_argnames=("wid",))
def bilinear_sample_patches_stack(stack, img_idx, centers, wid: int = 5):
    """Like ``bilinear_sample_patches`` but with a per-sample image index
    into a stacked (N, H, W) grayscale array.

    The stack is viewed as one tall (N*H, W) image and the slice row is
    ``img*H + y0``: folding the image index into the row index makes every
    window a 2-D slice of one operand.  ``y0`` is clipped inside the image,
    so a window never crosses an image boundary.

    Args:
      stack: (N, H, W); img_idx: (...,) int32; centers: (..., 2) float (x, y).

    Returns (patches (..., (2*wid+1)**2) float32, inbounds (...,) bool).
    """
    batch_shape = img_idx.shape
    img_flat = img_idx.reshape(-1).astype(jnp.int32)
    ctr = centers.reshape(-1, 2)
    n, h, w = stack.shape
    flat = stack.reshape(n * h, w)
    side = 2 * wid + 1
    win = side + 1
    x = ctr[:, 0]
    y = ctr[:, 1]
    inb = (
        (x >= wid + 1) & (x <= w - wid - 2) & (y >= wid + 1) & (y <= h - wid - 2)
    )
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0).astype(jnp.float32)[:, None, None]
    fy = (y - y0).astype(jnp.float32)[:, None, None]
    base_x = jnp.clip(x0.astype(jnp.int32) - wid, 0, w - win)
    base_y = (
        jnp.clip(y0.astype(jnp.int32) - wid, 0, h - win) + img_flat * h
    )

    def block(by, bx):
        return jax.lax.dynamic_slice(flat, (by, bx), (win, win))

    window = jax.vmap(block)(base_y, base_x)  # (M, win, win)
    p00 = window[:, :side, :side]
    p01 = window[:, :side, 1:]
    p10 = window[:, 1:, :side]
    p11 = window[:, 1:, 1:]
    val = (
        p00 * (1 - fy) * (1 - fx)
        + p01 * (1 - fy) * fx
        + p10 * fy * (1 - fx)
        + p11 * fy * fx
    )
    return (
        val.reshape(*batch_shape, side * side).astype(jnp.float32),
        inb.reshape(batch_shape),
    )
