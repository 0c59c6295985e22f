import numpy as np
import jax.numpy as jnp
import pytest

from sfm_tpu.config import FeatureConfig
from sfm_tpu.ops.harris import harris_response, detect_corners
from sfm_tpu.ops.patches import extract_patches, normalize_descriptors
from sfm_tpu.ops.ncc import ncc_scores, bilinear_sample_patches
from sfm_tpu.features import detect_and_describe, match_descriptors
from sfm_tpu.features.matching import matched_points


def checkerboard(h=64, w=64, sq=16):
    ys, xs = np.mgrid[0:h, 0:w]
    return (((ys // sq) + (xs // sq)) % 2 * 255.0).astype(np.float32)


class TestHarris:
    def test_response_peaks_at_corners(self):
        img = checkerboard()
        resp = np.asarray(harris_response(jnp.asarray(img[None])))[0]
        # Interior checkerboard crossings are strong positive corners; edge
        # midpoints respond negative; flat square centers ~0.
        assert resp[16, 16] > 0
        assert resp[8, 16] < 0  # vertical edge midpoint
        assert abs(resp[8, 8]) < 1e-3 * resp[16, 16]  # flat region

    def test_detect_corners_on_checkerboard(self):
        img = checkerboard()
        corners, valid, _ = detect_corners(
            jnp.asarray(img[None]), max_corners=64, nms_radius=3,
            border=5,
        )
        c = np.asarray(corners[0])[np.asarray(valid[0])]
        assert len(c) >= 9  # 3x3 interior crossings at 16px grid
        # Every detected corner sits near a multiple-of-16 crossing.
        offs = np.minimum(c % 16, 16 - (c % 16))
        assert np.all(offs <= 3)

    def test_nms_spacing(self):
        img = checkerboard()
        corners, valid, _ = detect_corners(
            jnp.asarray(img[None]), max_corners=128, nms_radius=4,
        )
        c = np.asarray(corners[0])[np.asarray(valid[0])]
        d = np.abs(c[:, None, :] - c[None, :, :]).max(-1)
        np.fill_diagonal(d, 99)
        assert d.min() > 4


class TestPatches:
    def test_extract_centered(self, rng):
        img = rng.normal(size=(1, 32, 32)).astype(np.float32)
        corners = jnp.asarray([[[10, 20], [3, 3], [1, 1]]])  # (x, y)
        patches, inb = extract_patches(jnp.asarray(img), corners, wid=2)
        assert patches.shape == (1, 3, 25)
        assert bool(inb[0, 0]) and bool(inb[0, 1]) and not bool(inb[0, 2])
        # Center pixel of first patch = img[y=20, x=10].
        assert np.isclose(patches[0, 0, 12], img[0, 20, 10])

    def test_normalize(self, rng):
        p = rng.normal(size=(4, 7, 25)).astype(np.float32) * 50 + 100
        d = np.asarray(normalize_descriptors(jnp.asarray(p)))
        assert np.allclose(d.sum(-1), 0.0, atol=1e-3)
        assert np.allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)

    def test_ncc_is_correlation(self, rng):
        a = rng.normal(size=(1, 25)).astype(np.float32)
        b = 3.0 * a + 7.0  # affine -> perfect correlation
        da = normalize_descriptors(jnp.asarray(a))
        db = normalize_descriptors(jnp.asarray(b))
        s = ncc_scores(da, db)
        assert np.isclose(float(s[0, 0]), 1.0, atol=1e-4)

    def test_bilinear_integer_centers_match_extract(self, rng):
        img = rng.normal(size=(32, 32)).astype(np.float32)
        centers = jnp.asarray([[10.0, 20.0], [15.0, 8.0]])
        p, inb = bilinear_sample_patches(jnp.asarray(img), centers, wid=2)
        pe, _ = extract_patches(
            jnp.asarray(img[None]), jnp.asarray([[[10, 20], [15, 8]]]), wid=2
        )
        assert np.allclose(p, pe[0], atol=1e-4)
        assert np.all(np.asarray(inb))

    def test_bilinear_halfpixel(self):
        img = np.zeros((16, 16), np.float32)
        img[8, 8] = 4.0
        p, _ = bilinear_sample_patches(
            jnp.asarray(img), jnp.asarray([[7.5, 8.0]]), wid=1
        )
        # Center value interpolates halfway between img[8,7]=0 and img[8,8]=4.
        assert np.isclose(p[0, 4], 2.0, atol=1e-5)


class TestMatching:
    def test_self_match_identity(self, rng):
        d = normalize_descriptors(jnp.asarray(rng.normal(size=(64, 25))))
        v = jnp.ones(64, bool)
        m = match_descriptors(d, v, d, v, max_matches=64)
        assert int(m.count) == 64
        got = np.asarray(m.idx2)[np.asarray(m.valid)]
        want = np.asarray(m.idx1)[np.asarray(m.valid)]
        assert np.array_equal(np.sort(got), np.sort(want))
        # Each i matches itself.
        assert np.array_equal(
            np.asarray(m.idx2)[np.asarray(m.valid)],
            np.asarray(m.idx1)[np.asarray(m.valid)],
        )

    def test_shuffled_match(self, rng):
        d1 = normalize_descriptors(jnp.asarray(rng.normal(size=(50, 25))))
        perm = rng.permutation(50)
        d2 = d1[jnp.asarray(perm)]
        v = jnp.ones(50, bool)
        m = match_descriptors(d1, v, d2, v, max_matches=64)
        ok = np.asarray(m.valid)
        assert int(m.count) == 50
        # d2[j] = d1[perm[j]], so a correct match satisfies perm[idx2] == idx1.
        assert np.array_equal(
            perm[np.asarray(m.idx2)[ok]], np.asarray(m.idx1)[ok]
        )

    def test_ratio_rejects_ambiguous(self, rng):
        base = rng.normal(size=(1, 25))
        d1 = normalize_descriptors(jnp.asarray(base))
        # Two nearly identical candidates -> ambiguous -> rejected.
        d2 = normalize_descriptors(
            jnp.asarray(np.concatenate([base + 1e-4, base - 1e-4]))
        )
        v1 = jnp.ones(1, bool)
        v2 = jnp.ones(2, bool)
        m = match_descriptors(d1, v1, d2, v2, lowe_ratio=0.8, max_matches=8)
        assert int(m.count) == 0

    def test_invalid_never_matched(self, rng):
        d1 = normalize_descriptors(jnp.asarray(rng.normal(size=(10, 25))))
        d2 = d1
        v1 = jnp.ones(10, bool)
        v2 = jnp.zeros(10, bool)
        m = match_descriptors(d1, v1, d2, v2, max_matches=16)
        assert int(m.count) == 0


class TestEndToEndFeatures:
    def test_dino_pair_matching(self, dino_images):
        from sfm_tpu.io import to_gray

        imgs, _ = dino_images
        gray = jnp.asarray(to_gray(imgs[:2]))
        cfg = FeatureConfig(max_corners=1024, max_matches=512)
        fs = detect_and_describe(gray, cfg)
        assert fs.num_images == 2
        n_valid = np.asarray(fs.valid).sum(1)
        assert np.all(n_valid > 100), n_valid
        m = match_descriptors(
            fs.descriptors[0], fs.valid[0], fs.descriptors[1], fs.valid[1],
            lowe_ratio=cfg.lowe_ratio, max_matches=cfg.max_matches,
        )
        assert int(m.count) > 30
        p1, p2 = matched_points(fs.corners[0], fs.corners[1], m)
        ok = np.asarray(m.valid)
        # Adjacent dino views: matched points should move only a little.
        disp = np.linalg.norm(np.asarray(p1)[ok] - np.asarray(p2)[ok], axis=-1)
        assert np.median(disp) < 60.0


def test_lowe_ratio_default_matches_documentation():
    """VERDICT r1: code, PARITY.md, and a test must agree on the Lowe ratio.

    The shipped default is 0.8 — a measured deviation from the reference's
    0.7 (tools/sweep_lowe.py: +17% tracks at equal rms/NCC) — and PARITY.md
    must document it as such.
    """
    import os
    from sfm_tpu.config import FeatureConfig

    assert FeatureConfig().lowe_ratio == 0.8
    parity = open(
        os.path.join(os.path.dirname(__file__), "..", "PARITY.md")
    ).read()
    assert "default ratio 0.8" in parity
    assert "sweep_lowe" in parity


class TestPlainReferences:
    """Device kernels against the float64 numpy references of
    sfm_tpu.ops.reference (chip_smoke.py repeats these at real widths)."""

    @pytest.mark.parametrize(
        "h,w", [(480, 640), (482, 640), (64, 1280), (30, 200)]
    )
    def test_harris_matches_numpy_stencil(self, h, w):
        from sfm_tpu.ops import reference

        rng = np.random.default_rng(h * w)
        gray = (rng.random((2, h, w)) * 255).astype(np.float32)
        got = np.asarray(harris_response(jnp.asarray(gray)), np.float64)
        want = reference.harris_response(gray)
        assert got.shape == want.shape == (2, h, w)
        scale = np.abs(want).max(axis=(1, 2), keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-4 * scale)

    @pytest.mark.parametrize("w", [200, 320, 640, 1000, 4096])
    def test_sampler_matches_numpy_bilinear(self, w):
        """The photo-consistency sampler (bf16 stack, as the MVS sweep
        uses it) against bilinear sampling of the same quantized stack."""
        from sfm_tpu.ops import reference
        from sfm_tpu.ops.ncc import bilinear_sample_patches_stack

        rng = np.random.default_rng(w)
        n_img, h, m = 3, 48, 256
        stack = jnp.asarray(rng.random((n_img, h, w)) * 255, jnp.bfloat16)
        img = rng.integers(0, n_img, m).astype(np.int32)
        ctr = np.stack(  # includes out-of-bounds centers
            [rng.uniform(-4, w + 4, m), rng.uniform(-4, h + 4, m)], 1
        ).astype(np.float32)
        patches, inb = bilinear_sample_patches_stack(
            stack, jnp.asarray(img), jnp.asarray(ctr), 5
        )
        desc = np.asarray(normalize_descriptors(patches), np.float64)
        want_p, want_inb = reference.bilinear_patches(
            np.asarray(stack.astype(jnp.float32)), img, ctr, 5
        )
        np.testing.assert_array_equal(np.asarray(inb), want_inb)
        assert want_inb.any() and not want_inb.all()
        np.testing.assert_allclose(
            np.asarray(patches, np.float64), want_p, atol=1e-3
        )
        err = np.abs(desc - reference.normalize(want_p))[want_inb]
        assert err.max() < 1e-4
