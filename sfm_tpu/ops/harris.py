"""Harris corner response + detection, batched over images.

Batched replacement for the reference's ``cv2.cornerHarris(block=2,
ksize=3, k=0.04)`` + dilate + 1%-of-max threshold frontend
(HarrisFeatures.py:135-161).  Differences by design:

- fully batched over the image stack, float32, static shapes;
- non-max suppression + top-K corner selection instead of a boolean corner
  image, yielding fixed-capacity (K, 2) corner arrays with validity masks —
  the static-shape currency of the whole batched pipeline;
- the response is a chain of shifted adds (Sobel gradients, structure
  tensor, box window) that XLA fuses into one pass over the stack.

Scale normalization of the Sobel taps is irrelevant for detection: the Harris
response scales as s^4 in both det(M) and trace(M)^2, so k and the relative
threshold are unaffected.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _shift(img, dy, dx):
    """Shift a 2-D (or batched ...HW) image by (dy, dx), zero-filled."""
    pad = [(0, 0)] * (img.ndim - 2) + [(1, 1), (1, 1)]
    p = jnp.pad(img, pad)
    h, w = img.shape[-2], img.shape[-1]
    return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def _sobel(gray):
    """Sobel gradients via 9 shifted adds (fuses into one elementwise chain)."""
    tl = _shift(gray, -1, -1)
    tc = _shift(gray, -1, 0)
    tr = _shift(gray, -1, 1)
    ml = _shift(gray, 0, -1)
    mr = _shift(gray, 0, 1)
    bl = _shift(gray, 1, -1)
    bc = _shift(gray, 1, 0)
    br = _shift(gray, 1, 1)
    ix = (tr + 2.0 * mr + br) - (tl + 2.0 * ml + bl)
    iy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    return ix, iy


def _box3(img):
    """3x3 box filter via shifted adds."""
    s = (
        _shift(img, -1, -1) + _shift(img, -1, 0) + _shift(img, -1, 1)
        + _shift(img, 0, -1) + img + _shift(img, 0, 1)
        + _shift(img, 1, -1) + _shift(img, 1, 0) + _shift(img, 1, 1)
    )
    return s


def _harris_math(gray, k):
    ix, iy = _sobel(gray)
    sxx = _box3(ix * ix)
    syy = _box3(iy * iy)
    sxy = _box3(ix * iy)
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace * trace


@functools.partial(jax.jit, static_argnames=("k",))
def harris_response(gray, k: float = 0.04):
    """Harris corner response for a stack of grayscale images (N, H, W)."""
    return _harris_math(gray.astype(jnp.float32), k)


@functools.partial(
    jax.jit, static_argnames=("max_corners", "nms_radius", "border", "k")
)
def detect_corners(
    gray,
    max_corners: int = 4096,
    nms_radius: int = 4,
    rel_threshold: float = 0.01,
    border: int = 0,
    k: float = 0.04,
):
    """Detect top-K Harris corners per image.

    Args:
      gray: (N, H, W) float grayscale stack.
      max_corners: static corner capacity K per image.
      nms_radius: non-max-suppression radius (pixels).
      rel_threshold: keep responses > rel_threshold * per-image max (the
        reference uses 0.01 * max, HarrisFeatures.py:158).
      border: reject corners within this many pixels of the edge (so patch
        descriptors never read out of bounds; reference getDescFeatures
        rejects border corners at HarrisFeatures.py:121-127).

    Returns:
      corners: (N, K, 2) int32 (x, y) pixel coordinates, sorted by response.
      valid: (N, K) bool validity mask.
      response: (N, H, W) float32 Harris response (for diagnostics).
    """
    resp = harris_response(gray, k=k)
    n, h, w = resp.shape
    win = 2 * nms_radius + 1
    # NMS on per-pixel-unique keys instead of raw responses: equal responses
    # (symmetric textures, saturated regions) would all satisfy
    # ``resp >= max_pool(resp)`` and defeat suppression.  The key packs the
    # response into the high bits and a pixel id into the low bits:
    # non-negative float32 bitcast to int32 is order-preserving, and
    # replacing the bottom mantissa bits perturbs only tiny relative
    # response differences — ties (and only near-ties) break by pixel id.
    # The id field is sized so ids are unique within any NMS window (max id
    # spread = (win-1)*(w+1)), making "exactly one peak per window" exact.
    # One elementwise pass instead of an argsort-rank formulation (a full
    # sort of N*H*W).
    # id_bits grows with image width: 13 bits at w=640 (~0.06% worst-case
    # relative response perturbation), 15 at w~3200 (~0.4%).  Keep >=5
    # mantissa bits of response (<=18 id bits, ~3% perturbation, widths to
    # ~29k px) — near the 23-bit f32 mantissa the ordering would break
    # entirely, so fail loudly long before that.
    id_bits = max(((win - 1) * (w + 1) + 1).bit_length(), 1)
    assert id_bits <= 18, (
        f"NMS tie-break id field needs {id_bits} bits for width {w} "
        f"(nms_radius={nms_radius}); >18 bits would corrupt the bitcast "
        "response ordering — tile the image or shrink the NMS window"
    )
    id_mask = jnp.int32((1 << id_bits) - 1)
    pos = jnp.maximum(resp, 0.0) + jnp.float32(1e-30)
    bits = jax.lax.bitcast_convert_type(pos, jnp.int32)
    pix_id = (
        jax.lax.broadcasted_iota(jnp.int32, (n, h, w), 1) * w
        + jax.lax.broadcasted_iota(jnp.int32, (n, h, w), 2)
    )
    key = (bits & ~id_mask) | (pix_id & id_mask)
    pooled = jax.lax.reduce_window(
        key,
        jnp.int32(jnp.iinfo(jnp.int32).min),
        jax.lax.max,
        (1, win, win),
        (1, 1, 1),
        "SAME",
    )
    peak = key == pooled
    maxval = jnp.max(resp, axis=(1, 2), keepdims=True)
    strong = resp > rel_threshold * maxval
    mask = peak & strong
    if border > 0:
        ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        inb = (
            (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
        )
        mask = mask & inb[None]
    scored = jnp.where(mask, resp, -jnp.inf)
    flat = scored.reshape(n, h * w)
    vals, idx = jax.lax.top_k(flat, max_corners)
    xs = (idx % w).astype(jnp.int32)
    ys = (idx // w).astype(jnp.int32)
    corners = jnp.stack([xs, ys], axis=-1)
    valid = jnp.isfinite(vals)
    return corners, valid, resp
