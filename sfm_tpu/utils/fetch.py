"""Device->host fetch accounting.

Every *pipeline* fetch site (SfM pair payload, BA solution, MVS seed payload,
MVS per-chunk payload, reprojection-error metric, outlier-filter vis/proj)
funnels through :func:`fetch`, so a harness can count how many blocking
device->host transfers a run made.  Each one is a point where the host
waits for the device.
"""

from __future__ import annotations

import numpy as np

_counts = {"n": 0}


def fetch(x) -> np.ndarray:
    """np.asarray(x), counted as one device->host round trip."""
    _counts["n"] += 1
    return np.asarray(x)


def count() -> int:
    """Total pipeline fetches since process start (monotonic)."""
    return _counts["n"]
