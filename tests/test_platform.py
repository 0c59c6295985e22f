"""Platform policy (utils/platform.py), the native track store's build, and
chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys

import pytest

from sfm_tpu.utils import platform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_compile_cache_dir(env_dir):
    env = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": env_dir}
    want = env_dir or os.path.join(ROOT, ".jax_cache")
    assert platform.compile_cache_dir(env) == want


@pytest.mark.parametrize(
    "platforms,pinned", [("cpu", True), ("cpu,cuda", True), ("cuda,cpu", False)]
)
def test_cpu_pinning_reads_the_first_platform(platforms, pinned):
    assert platform._pinned_to_cpu({"JAX_PLATFORMS": platforms}) is pinned


def test_compile_cache_skipped_on_cpu():
    assert platform.configure_compile_cache({"JAX_PLATFORMS": "cpu"}) is None


@pytest.mark.parametrize(
    "requested,backend,want",
    [
        (None, "gpu", "float32"),
        (None, "cpu", "float64"),
        ("float32", "cpu", "float32"),
        ("float64", "gpu", ValueError),
        ("float16", "cpu", ValueError),
    ],
)
def test_ba_dtype_policy(requested, backend, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            platform.resolve_ba_dtype(requested, backend)
    else:
        assert platform.resolve_ba_dtype(requested, backend) == want


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert "no GPU" in proc.stdout + proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_native_store_rebuilds_when_source_is_newer(tmp_path, monkeypatch):
    import shutil

    from sfm_tpu.sfm import tracks

    src = tmp_path / "trackstore.cpp"
    lib = tmp_path / "libtrackstore.so"
    shutil.copy(tracks._SRC_PATH, src)
    monkeypatch.setattr(tracks, "_SRC_PATH", str(src))
    monkeypatch.setattr(tracks, "_LIB_PATH", str(lib))
    tracks._build_native()
    assert lib.exists()
    built = lib.stat().st_mtime
    os.utime(src, (built + 10, built + 10))
    tracks._build_native()
    assert lib.stat().st_mtime > built
    assert not list(tmp_path.glob("*.tmp"))


def test_native_store_failure_is_logged(tmp_path, monkeypatch, caplog):
    import shutil

    from sfm_tpu.sfm import tracks

    src = tmp_path / "trackstore.cpp"
    shutil.copy(tracks._SRC_PATH, src)
    monkeypatch.setattr(tracks, "_SRC_PATH", str(src))
    monkeypatch.setattr(tracks, "_LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(tracks, "_LIB", None)
    monkeypatch.setattr(tracks, "_LIB_TRIED", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with caplog.at_level("WARNING", logger="sfm_tpu"):
        assert tracks._load_native() is None
    assert "native track store unavailable" in caplog.text
    assert tracks.TrackStore(0.01).backend == "python"
