"""Feature-track store: merging two-view matches into multi-view tracks.

The one inherently sequential, hash-based stage of the pipeline (SURVEY.md §7
"hard parts").  Bulk geometry stays on device; this host-side store consumes
whole per-pair match batches.  Two interchangeable backends with identical
semantics (mirroring the reference GlobalSet, GlobalSet.py:22-172 — see
native/trackstore.cpp for the case analysis):

- a C++ union-find hash store (native/libtrackstore.so, compiled from
  native/trackstore.cpp on first use and whenever the source is newer),
- a pure-Python fallback used, with a logged warning, when the store cannot
  be built or loaded.
"""

from __future__ import annotations

import ctypes
import logging
import math
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libtrackstore.so"))
_SRC_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "trackstore.cpp"))
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_log = logging.getLogger("sfm_tpu")


def _build_native() -> None:
    """Compile the store when the library is missing or older than its
    source.  Portable flags (no -march=native), so a library built on one
    host also loads on another.  Built under a temporary name and renamed,
    so concurrent processes never load a half-written file."""
    if os.path.exists(_LIB_PATH) and (
        os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC_PATH)
    ):
        return
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-shared",
        "-std=c++17", "-o", tmp, _SRC_PATH,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed: {proc.stderr.strip()}"
            )
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_native() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        _build_native()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.ts_create.restype = ctypes.c_void_p
        lib.ts_create.argtypes = [ctypes.c_double]
        lib.ts_destroy.argtypes = [ctypes.c_void_p]
        lib.ts_add_pairs.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.ts_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ts_export.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ts_update_world.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        _LIB = lib
    except Exception as e:  # no compiler, build error, unloadable library
        _log.warning(
            "native track store unavailable, using the Python store: %s", e
        )
        _LIB = None
    return _LIB


class _PyTrack:
    __slots__ = ("p", "obs", "valid", "alive")

    def __init__(self, p, obs):
        self.p = p
        self.obs = list(obs)
        self.valid = True
        self.alive = True


class _PyBackend:
    """Pure-Python mirror of native/trackstore.cpp."""

    def __init__(self, threshold: float):
        self.threshold = threshold
        self.index = {}
        self.tracks = []

    def _check(self, tid, p):
        a = self.tracks[tid].p
        return (
            math.sqrt(
                (a[0] - p[0]) ** 2 + (a[1] - p[1]) ** 2 + (a[2] - p[2]) ** 2
            )
            < self.threshold
        )

    def _attach(self, tid, key):
        obs = self.tracks[tid].obs
        if key not in obs:
            obs.append(key)

    def add_pairs(self, obs_a, obs_b, pts):
        for ka, kb, p in zip(
            map(tuple, obs_a), map(tuple, obs_b), pts
        ):
            i1 = self.index.get(ka, -1)
            i2 = self.index.get(kb, -1)
            tr = self.tracks
            if i1 < 0 and i2 < 0:
                tid = len(tr)
                tr.append(_PyTrack(tuple(p), [ka, kb]))
                self.index[ka] = tid
                self.index[kb] = tid
            elif i1 < 0:
                if tr[i2].valid and self._check(i2, p):
                    self.index[ka] = i2
                    self._attach(i2, ka)
                    self._attach(i2, kb)
                else:
                    tr[i2].valid = False
            elif i2 < 0:
                if tr[i1].valid and self._check(i1, p):
                    self.index[kb] = i1
                    self._attach(i1, ka)
                    self._attach(i1, kb)
                else:
                    tr[i1].valid = False
            elif i1 == i2:
                if tr[i1].valid and self._check(i1, p):
                    self._attach(i1, ka)
                    self._attach(i1, kb)
                else:
                    tr[i1].valid = False
            else:
                if tr[i1].valid and tr[i2].valid and self._check(i1, p):
                    for k in tr[i2].obs:
                        self.index[k] = i1
                        self._attach(i1, k)
                    tr[i2].alive = False
                    tr[i2].obs = []
                else:
                    tr[i1].valid = False
                    tr[i2].valid = False

    def info(self):
        nt = no = 0
        for t in self.tracks:
            if t.alive and t.valid:
                nt += 1
                no += len(t.obs)
        return nt, no

    def export(self):
        world, offsets, obs = [], [0], []
        for t in self.tracks:
            if not (t.alive and t.valid):
                continue
            world.append(t.p)
            obs.extend(t.obs)
            offsets.append(len(obs))
        return (
            np.asarray(world, np.float64).reshape(-1, 3),
            np.asarray(offsets, np.int64),
            np.asarray(obs, np.int32).reshape(-1, 3),
        )

    def update_world(self, pts):
        i = 0
        for t in self.tracks:
            if not (t.alive and t.valid):
                continue
            if i >= len(pts):
                break
            t.p = tuple(pts[i])
            i += 1


class TrackStore:
    """Batched host-side track store (GlobalSet-equivalent).

    Observations are (image_index, x, y) int triples; world points float64.
    """

    def __init__(self, threshold: float = 0.01, native: Optional[bool] = None):
        lib = _load_native() if native in (None, True) else None
        if native is True and lib is None:
            raise RuntimeError("native trackstore requested but unavailable")
        self._lib = lib
        if lib is not None:
            self._h = ctypes.c_void_p(lib.ts_create(ctypes.c_double(threshold)))
            self._py = None
        else:
            self._h = None
            self._py = _PyBackend(threshold)
        self.threshold = threshold

    @property
    def backend(self) -> str:
        return "native" if self._lib is not None else "python"

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.ts_destroy(h)
            self._h = None

    def add_pairs(self, obs_a, obs_b, points) -> None:
        """Insert a batch of matched observation pairs with 3-D points.

        obs_a, obs_b: (M, 3) int32 rows (image_index, x, y);
        points: (M, 3) float world points.
        """
        obs_a = np.ascontiguousarray(obs_a, np.int32)
        obs_b = np.ascontiguousarray(obs_b, np.int32)
        pts = np.ascontiguousarray(points, np.float64)
        m = obs_a.shape[0]
        if m == 0:
            return
        if self._lib is not None:
            self._lib.ts_add_pairs(
                self._h,
                ctypes.c_int64(m),
                obs_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                obs_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
        else:
            self._py.add_pairs(obs_a, obs_b, pts)

    def info(self):
        """(num_valid_tracks, num_observations)."""
        if self._lib is not None:
            nt = ctypes.c_int64()
            no = ctypes.c_int64()
            self._lib.ts_info(self._h, ctypes.byref(nt), ctypes.byref(no))
            return nt.value, no.value
        return self._py.info()

    def export(self):
        """Valid tracks in creation order.

        Returns (world (T, 3) f64, offsets (T+1,) i64, obs (O, 3) i32) where
        track t's observations are obs[offsets[t]:offsets[t+1]].
        """
        if self._lib is None:
            return self._py.export()
        nt, no = self.info()
        world = np.empty((nt, 3), np.float64)
        offsets = np.empty(nt + 1, np.int64)
        obs = np.empty((no, 3), np.int32)
        self._lib.ts_export(
            self._h,
            world.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            obs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return world, offsets, obs

    def update_world(self, points) -> None:
        """Write refined world points back (BA output), creation order."""
        pts = np.ascontiguousarray(points, np.float64)
        if self._lib is not None:
            self._lib.ts_update_world(
                self._h,
                pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.c_int64(pts.shape[0]),
            )
        else:
            self._py.update_world(pts)
