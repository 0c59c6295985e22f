"""Test configuration: run everything on a simulated 8-device CPU mesh.

Must set the env vars before jax is imported anywhere: the multi-device
logic is validated here with XLA's host-platform device simulation, and on
real GPUs by ``python chip_smoke.py --chips 4``.  No test needs a GPU:
what only the card can show, ``chip_smoke.py`` checks there.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Pin the CPU platform programmatically as well, in case the environment
# registers another default backend.
jax.config.update("jax_platforms", "cpu")

# Math-parity unit tests validate formulas in float64; device-facing
# pipeline tests pass explicit float32 inputs where f32 behavior matters.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


REFERENCE_DATA = "/root/reference/dinoRing"


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def dino_calib():
    from sfm_tpu.io import read_pars

    par = os.path.join(REFERENCE_DATA, "dinoR_par.txt")
    if not os.path.exists(par):
        pytest.skip("dinoRing dataset not available")
    return read_pars(par)


@pytest.fixture(scope="class")
def dino_calib_cls(dino_calib):
    return dino_calib


@pytest.fixture(scope="class")
def dino_images_cls(dino_images):
    return dino_images


@pytest.fixture(scope="session")
def dino_images():
    from sfm_tpu.io import load_images

    if not os.path.isdir(REFERENCE_DATA):
        pytest.skip("dinoRing dataset not available")
    imgs, paths = load_images(REFERENCE_DATA, "png", max_images=8)
    return imgs, paths
