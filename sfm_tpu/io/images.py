"""Image loading.

The reference globs ``{img_path}/*.{type}``, sorts, and loads BGR->RGB via
OpenCV (reference main.py:7-20).  Binary PNM (P5 gray / P6 color: ``.pgm``,
``.ppm``, ``.pnm``) is read and written here with numpy alone; other formats
(PNG, JPEG, ...) go through PIL, imported only for them.  Returns a single
stacked uint8 array — all views share one static (H, W) shape, which is
what the batched device pipeline requires.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

PNM_TYPES = ("ppm", "pgm", "pnm")


def _pnm_tokens(data: bytes, count: int) -> Tuple[List[int], int]:
    """First ``count`` whitespace-separated header fields (``#`` comments
    skipped) and the offset just past the single whitespace byte that ends
    the header."""
    fields: List[int] = []
    i = 2  # past the magic number
    while len(fields) < count:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] not in (b"\n", b"\r"):
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        if j == i:
            raise ValueError("truncated PNM header")
        fields.append(int(data[i:j]))
        i = j
    return fields, i + 1


def read_pnm(path: str) -> np.ndarray:
    """Binary PGM (P5) -> (H, W) or PPM (P6) -> (H, W, 3), uint8.

    Samples with a maxval other than 255 (16-bit included) are rescaled
    to [0, 255]."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PGM/PPM (magic {magic!r})")
    (w, h, maxval), off = _pnm_tokens(data, 3)
    if not 0 < maxval < 65536:
        raise ValueError(f"{path}: bad PNM maxval {maxval}")
    channels = 3 if magic == b"P6" else 1
    dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    n = w * h * channels
    if len(data) - off < n * dtype.itemsize:
        raise ValueError(f"{path}: PNM pixel data truncated")
    img = np.frombuffer(data, dtype, count=n, offset=off)
    if maxval != 255:
        img = np.rint(img.astype(np.float64) * (255.0 / maxval))
    img = img.astype(np.uint8)
    return img.reshape((h, w, 3) if channels == 3 else (h, w))


def write_pnm(path: str, img: np.ndarray) -> None:
    """(H, W) uint8 -> binary PGM (P5); (H, W, 3) uint8 -> binary PPM (P6)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        magic = b"P5"
    elif img.ndim == 3 and img.shape[2] == 3:
        magic = b"P6"
    else:
        raise ValueError(f"PNM needs (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def _read_rgb(path: str, image_type: str) -> np.ndarray:
    if image_type.lower() in PNM_TYPES:
        img = read_pnm(path)
        return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading .{image_type} images needs Pillow, which is not "
            f"installed; binary {'/'.join(PNM_TYPES)} images are read "
            "without it"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_images(
    image_dir: str,
    image_type: str = "png",
    max_images: Optional[int] = None,
) -> Tuple[np.ndarray, List[str]]:
    """Load ``image_dir/*.{image_type}`` sorted by name.

    Returns (images uint8 (N, H, W, 3), list of file paths).
    """
    paths = sorted(glob.glob(os.path.join(image_dir, f"*.{image_type}")))
    if max_images is not None:
        paths = paths[:max_images]
    if not paths:
        raise FileNotFoundError(f"no *.{image_type} images in {image_dir}")
    imgs = [_read_rgb(p, image_type) for p in paths]
    shapes = {a.shape for a in imgs}
    if len(shapes) != 1:
        raise ValueError(f"images have differing shapes: {shapes}")
    return np.stack(imgs), paths


_DEVICE_CACHE: dict = {}


def _cache_key(images: np.ndarray):
    """Content-aware cache key: identity alone is unsafe (id reuse after GC,
    in-place mutation), so include shape/dtype/data-pointer plus a CRC over a
    ~64k-element stride sample — cheap (<1 ms on the 44 MB dinoRing stack)
    and catches any realistic in-place edit."""
    import zlib

    a = np.asarray(images)
    flat = a.reshape(-1) if a.flags.c_contiguous else np.ascontiguousarray(a).reshape(-1)
    sample = flat[:: max(1, flat.size // 65536)]
    return (
        id(images), a.shape, a.dtype.str, a.ctypes.data,
        zlib.crc32(np.ascontiguousarray(sample).tobytes()),
    )


def device_gray(images: np.ndarray, pad_to: int = 0):
    """Upload the grayscale image stack once per process, shared by stages.

    ``pad_to > N`` appends zero images BEFORE upload (host-side), so the
    conversion program and every consumer is keyed on the shape BUCKET, not
    the raw image count — a new dataset in a seen bucket compiles nothing
    (utils/buckets.py).

    SfM and MVS both consume the same stack, so grayscale is computed on
    the HOST, quantized to uint8 (exactly what the reference's cv2.cvtColor
    produces, utils.py:169-170), and shipped as (N, H, W) uint8 — 3x less traffic than
    the RGB stack, which never needs to reach the device (patch colors are
    sampled host-side from the original images).  Cached by identity PLUS a
    content fingerprint (see _cache_key), so in-place mutation or id reuse
    can never alias to stale device data; entries are evicted when the host
    array is garbage-collected.

    Returns gray_dev float32 (N, H, W) in [0, 255].
    """
    import weakref

    import jax.numpy as jnp

    key = _cache_key(images) + (pad_to,)
    hit = _DEVICE_CACHE.get(key)
    if hit is not None:
        return hit
    gray_u8 = np.rint(to_gray(images)).astype(np.uint8)
    if pad_to > gray_u8.shape[0]:
        n, h, w = gray_u8.shape
        gray_u8 = np.concatenate(
            [gray_u8, np.zeros((pad_to - n, h, w), np.uint8)]
        )
    gray = jnp.asarray(gray_u8).astype(jnp.float32)
    _DEVICE_CACHE[key] = gray
    try:
        weakref.finalize(images, _DEVICE_CACHE.pop, key, None)
    except TypeError:
        pass  # non-weakref-able input: fingerprint key still prevents aliasing
    return gray


def to_gray(images: np.ndarray) -> np.ndarray:
    """uint8 RGB (..., H, W, 3) -> float32 grayscale (..., H, W) in [0, 255].

    Uses the ITU-R BT.601 weights (what cv2.cvtColor COLOR_RGB2GRAY uses, the
    reference's grayscale path at utils.py:169-170 / HarrisFeatures.py:138).
    """
    img = images.astype(np.float32)
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
