import numpy as np
import pytest

from sfm_tpu.io import read_pars, load_images, to_gray, export_ply
from sfm_tpu.io.ply import read_ply


def test_read_pars_dino(dino_calib):
    c = dino_calib
    assert c.num_views == 48
    assert c.K.shape == (48, 3, 3)
    assert c.R.shape == (48, 3, 3)
    assert c.t.shape == (48, 3)
    # Middlebury dino intrinsics from the file's first row.
    assert np.isclose(c.K[0, 0, 0], 3310.4)
    assert np.isclose(c.K[0, 1, 1], 3325.5)
    # Rotations are orthonormal with det +1.
    RtR = np.einsum("nij,nik->njk", c.R, c.R)
    assert np.allclose(RtR, np.eye(3)[None], atol=1e-6)
    assert np.allclose(np.linalg.det(c.R), 1.0, atol=1e-6)
    # P = K[R|t] shape.
    assert c.P.shape == (48, 3, 4)
    # Camera centers project to ~origin direction: at least finite.
    assert np.all(np.isfinite(c.centers))


def test_calib_subset(dino_calib):
    sub = dino_calib.subset([0, 2, 4])
    assert sub.num_views == 3
    assert np.allclose(sub.K[1], dino_calib.K[2])
    assert sub.names[2] == dino_calib.names[4]


def test_load_images(dino_images):
    imgs, paths = dino_images
    assert imgs.shape == (8, 480, 640, 3)
    assert imgs.dtype == np.uint8
    assert paths == sorted(paths)
    g = to_gray(imgs)
    assert g.shape == (8, 480, 640)
    assert g.dtype == np.float32
    assert 0 <= g.min() and g.max() <= 255.0


@pytest.mark.parametrize("binary", [True, False])
def test_ply_roundtrip(tmp_path, binary, rng):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    cols = rng.integers(0, 256, size=(100, 3)).astype(np.uint8)
    p = str(tmp_path / "cloud.ply")
    export_ply(p, pts, cols, binary=binary)
    rpts, rcols = read_ply(p)
    assert np.allclose(rpts, pts, atol=1e-5)
    assert np.array_equal(rcols, cols)


def test_ply_no_color(tmp_path, rng):
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    p = str(tmp_path / "cloud.ply")
    export_ply(p, pts)
    rpts, rcols = read_ply(p)
    assert np.allclose(rpts, pts)
    assert rcols is None


def test_write_pars_roundtrip_exact(tmp_path):
    """write_pars -> read_pars must reproduce K/R/t bit-exactly (%.17g
    covers float64), so synthetic datasets materialized on disk carry
    calibration with zero drift (round 4: temple-style CLI dataset)."""
    import numpy as np

    from sfm_tpu.io.calib import Calibration, read_pars, write_pars

    rng = np.random.default_rng(3)
    n = 5
    cal = Calibration(
        K=rng.standard_normal((n, 3, 3)) * 100,
        R=rng.standard_normal((n, 3, 3)),
        t=rng.standard_normal((n, 3)),
        names=tuple(f"img{i:04d}.ppm" for i in range(n)),
    )
    path = str(tmp_path / "x_par.txt")
    write_pars(path, cal)
    back = read_pars(path)
    assert back.names == cal.names
    np.testing.assert_array_equal(back.K, cal.K)
    np.testing.assert_array_equal(back.R, cal.R)
    np.testing.assert_array_equal(back.t, cal.t)


@pytest.mark.parametrize("shape,magic", [((7, 5), b"P5"), ((7, 5, 3), b"P6")])
def test_pnm_round_trip(tmp_path, rng, shape, magic):
    from sfm_tpu.io import read_pnm, write_pnm

    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.pnm")
    write_pnm(path, img)
    with open(path, "rb") as f:
        assert f.read(2) == magic
    back = read_pnm(path)
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, img)
    # load_images reads PNM without PIL and returns RGB for both kinds.
    imgs, _ = load_images(str(tmp_path), "pnm")
    rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=-1)
    np.testing.assert_array_equal(imgs[0], rgb)


def test_pnm_header_comments_and_16bit(tmp_path):
    from sfm_tpu.io import read_pnm

    vals = np.array([[0, 65535, 32768]], ">u2")
    path = str(tmp_path / "b.pgm")
    with open(path, "wb") as f:
        f.write(b"P5\n# a comment\n3 1\n65535\n" + vals.tobytes())
    np.testing.assert_array_equal(read_pnm(path), [[0, 255, 128]])
    with open(path, "wb") as f:
        f.write(b"P2\n3 1\n255\n0 1 2\n")
    with pytest.raises(ValueError, match="binary"):
        read_pnm(path)


def test_non_pnm_without_pillow_names_format(tmp_path, monkeypatch):
    import sys

    (tmp_path / "x.png").write_bytes(b"\x89PNG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"\.png"):
        load_images(str(tmp_path), "png")
