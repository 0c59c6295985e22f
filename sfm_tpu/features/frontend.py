"""Feature frontend: Harris corners + NCC patch descriptors for all images.

One batched device computation replaces the reference's per-image OpenCV
calls (getORBFeatures utils.py:160-232 detect path; Harris frontend
HarrisFeatures.py:135-161).  Output is a static-shape :class:`FeatureSet`
for the whole image stack.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from sfm_tpu.config import FeatureConfig
from sfm_tpu.ops.harris import detect_corners
from sfm_tpu.ops.patches import extract_patches, normalize_descriptors


@jax.tree_util.register_dataclass
@dataclass
class FeatureSet:
    """Corners + descriptors for N images (all device arrays).

    corners: (N, K, 2) int32 (x, y); valid: (N, K) bool;
    descriptors: (N, K, D) float32 zero-mean unit-norm.
    """

    corners: jnp.ndarray
    valid: jnp.ndarray
    descriptors: jnp.ndarray

    @property
    def num_images(self) -> int:
        return self.corners.shape[0]

    @property
    def capacity(self) -> int:
        return self.corners.shape[1]


def detect_and_describe(
    gray, config: FeatureConfig = FeatureConfig()
) -> FeatureSet:
    """(N, H, W) grayscale -> FeatureSet with top-K corners per image."""
    # border = wid + 1 (not wid): every surviving corner's patch window,
    # bilinear support included, lies strictly inside the image, so the
    # descriptor read never needs clipping.
    corners, valid, _ = detect_corners(
        gray,
        max_corners=config.max_corners,
        nms_radius=config.nms_radius,
        rel_threshold=config.harris_rel_threshold,
        border=config.desc_wid + 1,
        k=config.harris_k,
    )
    patches, inb = extract_patches(gray, corners, wid=config.desc_wid)
    desc = normalize_descriptors(patches)
    valid = valid & inb
    # Zero out invalid descriptors so they can never win a correlation.
    desc = jnp.where(valid[..., None], desc, 0.0)
    return FeatureSet(corners=corners, valid=valid, descriptors=desc)
