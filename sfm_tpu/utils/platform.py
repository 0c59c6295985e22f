"""Backend, precision and compile-cache policy, each kept in this one module.

- :func:`resolve_ba_dtype`: bundle adjustment runs in float32 on the GPU, the
  dtype the accuracy records (QUALITY.md) were taken in.  float64 is for
  parity checks on the CPU only; asking for it there turns on
  ``jax_enable_x64``, without which JAX would silently compute in float32.
- :func:`compile_cache_dir` / :func:`configure_compile_cache`: JAX's
  persistent compilation cache lives where ``JAX_COMPILATION_CACHE_DIR``
  says (JAX reads that variable itself, so no other directory is set in
  code), and otherwise at ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import jax

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
BA_DTYPES = ("float32", "float64")


def default_backend() -> str:
    return jax.default_backend()


def resolve_ba_dtype(
    requested: Optional[str] = None, backend: Optional[str] = None
) -> str:
    """The BA dtype for ``backend`` (default: JAX's default backend).

    None picks float32 on an accelerator and float64 on the CPU.  float64
    on an accelerator is refused; float64 on the CPU enables x64.
    """
    backend = backend or default_backend()
    dtype = requested or ("float64" if backend == "cpu" else "float32")
    if dtype not in BA_DTYPES:
        raise ValueError(f"unknown BA dtype {dtype!r}; use one of {BA_DTYPES}")
    if dtype == "float64":
        if backend != "cpu":
            raise ValueError(
                f"float64 bundle adjustment runs on the CPU only; the "
                f"{backend} path runs float32"
            )
        jax.config.update("jax_enable_x64", True)
    return dtype


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """Where the persistent compilation cache lives."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def _pinned_to_cpu(environ: Mapping[str, str]) -> bool:
    """True when the CPU is JAX's first platform choice ("cpu", not a
    fallback as in "cuda,cpu")."""
    platforms = environ.get("JAX_PLATFORMS", "") or (
        getattr(jax.config, "jax_platforms", None) or ""
    )
    return platforms.split(",")[0].strip() == "cpu"


def configure_compile_cache(
    environ: Mapping[str, str] = os.environ,
) -> Optional[str]:
    """Turn the persistent cache on for every program; returns its directory.

    Skipped (returns None) when the process pins JAX to the CPU (tests,
    rehearsals): CPU compiles are fast, and XLA:CPU cache entries bake in
    host CPU features that can mismatch across processes.  Thresholds 0:
    this pipeline is many small programs, not one big one.
    """
    if _pinned_to_cpu(environ):
        return None
    path = compile_cache_dir(environ)
    try:
        if not environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except OSError:  # read-only checkout: run without a persistent cache
        return None
    return path
