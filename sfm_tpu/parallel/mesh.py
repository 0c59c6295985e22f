"""Device-mesh helpers.

The engine's distribution model (SURVEY.md §5, §7): one logical mesh axis
"data" over which bulk per-observation / per-candidate work is sharded —
BA observations (ba.sharded), MVS candidate batches — with small replicated
state (cameras, reduced systems) assembled via psum.  A flat 1-D axis suits
cards joined all to all (NVLink), where every pair talks at one rate.  The reference
has no distributed backend at all (its ceiling is 2 forked processes and a
Manager dict, HarrisFeatures.py:40-65); this module is designed fresh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


DATA_AXIS = "data"


def data_mesh(
    num_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over the data axis (defaults to all visible devices)."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def shard_batch(n: int, num_shards: int) -> int:
    """Per-shard padded length so ``n`` items split evenly over shards."""
    return -(-n // num_shards)


def pad_to_shards(arr: np.ndarray, num_shards: int, fill=0):
    """Pad axis 0 so it divides evenly into ``num_shards`` equal shards.

    Returns (padded array, validity mask over axis 0)."""
    n = arr.shape[0]
    per = shard_batch(n, num_shards)
    total = per * num_shards
    pad = total - n
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    if pad == 0:
        return arr, mask
    pad_block = np.full((pad, *arr.shape[1:]), fill, dtype=arr.dtype)
    return np.concatenate([arr, pad_block], axis=0), mask
