"""sfm_tpu — a batched Structure-from-Motion + Multi-View-Stereo engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``MarvinChung/simple-implementation-of-structure-from-motion-and-multi-view-stereo-by-python``
(see /root/reference): calibrated incremental SfM on Middlebury-style datasets,
Levenberg-Marquardt bundle adjustment with a Schur-complement solver, and
PMVS-style patch-based dense reconstruction — all formulated as batched,
statically-shaped device computations instead of per-point Python loops.

Layering (bottom-up), mirroring the capability map in SURVEY.md:

- ``sfm_tpu.config``    — every tunable the reference hard-codes, as one dataclass
- ``sfm_tpu.io``        — Middlebury ``*_par.txt`` calibration, images, PLY export
- ``sfm_tpu.geometry``  — rotations, projection, triangulation, epipolar geometry
- ``sfm_tpu.ops``       — device kernels (Harris response, NCC scoring, patch sampling)
- ``sfm_tpu.features``  — corner detection, patch descriptors, matmul matcher
- ``sfm_tpu.sfm``       — RANSAC two-view geometry, track store, sparse pipeline
- ``sfm_tpu.ba``        — Schur-complement Levenberg-Marquardt bundle adjustment
- ``sfm_tpu.mvs``       — patch-based dense reconstruction (seed + frontier expansion)
- ``sfm_tpu.parallel``  — device-mesh / sharding helpers (pjit/shard_map)
- ``sfm_tpu.utils``     — metrics, timing, platform policy, visualization
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry and solver math (projection matrices ~3e3 entries, DLT/eigh,
# Gauss-Newton) needs true f32 matmuls or pixel-level accuracy collapses
# (~1 px triangulation error vs the 0.3 px acceptance gate).  On a Hopper
# GPU, f32 matmuls at DEFAULT precision run in TF32 (~3 decimal digits), so
# the library default is 'highest'.  Bandwidth-bound throughput kernels
# that tolerate TF32/bf16 opt back in explicitly (descriptor correlation,
# ops/ncc.py; photo-consistency NCC, mvs/photoconsistency.py).
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache (policy in utils/platform.py): a fresh
# process otherwise re-pays every XLA compile of this many-program pipeline.
from sfm_tpu.utils.platform import configure_compile_cache as _cc  # noqa: E402

_cc()

from sfm_tpu.config import PipelineConfig  # noqa: F401, E402
