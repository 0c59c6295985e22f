import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sfm_tpu.config import PipelineConfig, FeatureConfig
from sfm_tpu.sfm.ransac import ransac_fundamental
from sfm_tpu.sfm.tracks import TrackStore, _load_native
from sfm_tpu.sfm.pipeline import pair_schedule, structure_from_motion
from sfm_tpu.geometry.epipolar import epipolar_distance


def make_scene(rng, n=200, outlier_frac=0.3):
    import scipy.spatial.transform as st

    pts = rng.normal(size=(n, 3)) * 0.3 + np.array([0, 0, 3.0])
    K = np.array([[700.0, 0, 320], [0, 700.0, 240], [0, 0, 1]])
    R = st.Rotation.from_euler("yx", [0.25, 0.08]).as_matrix()
    t = np.array([0.4, 0.05, 0.1])
    P1 = K @ np.eye(3, 4)
    P2 = K @ np.concatenate([R, t[:, None]], 1)
    h1 = (P1 @ np.concatenate([pts, np.ones((n, 1))], 1).T).T
    h2 = (P2 @ np.concatenate([pts, np.ones((n, 1))], 1).T).T
    p1 = h1[:, :2] / h1[:, 2:]
    p2 = h2[:, :2] / h2[:, 2:]
    n_out = int(n * outlier_frac)
    p2[:n_out] += rng.uniform(20, 80, size=(n_out, 2))
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F = np.linalg.inv(K).T @ (tx @ R) @ np.linalg.inv(K)
    return p1, p2, F / np.linalg.norm(F), n_out


class TestRansac:
    def test_recovers_inliers(self):
        # Fresh seeded rng: the shared fixture's state depends on test order.
        p1, p2, F_true, n_out = make_scene(np.random.default_rng(7))
        key = jax.random.PRNGKey(0)
        valid = jnp.ones(len(p1), bool)
        F, inl, n_inl = ransac_fundamental(
            jnp.asarray(p1), jnp.asarray(p2), valid, key
        )
        inl = np.asarray(inl)
        # A random 2-D shift can still land near an epipolar *line*, so a
        # few accidental-inlier outliers are geometrically legitimate.
        assert inl[:n_out].mean() < 0.05   # outliers rejected
        assert inl[n_out:].mean() > 0.98   # inliers kept
        d = epipolar_distance(F, jnp.asarray(p1[n_out:]), jnp.asarray(p2[n_out:]))
        assert float(jnp.median(d)) < 0.5

    def test_respects_validity_mask(self, rng):
        p1, p2, _, n_out = make_scene(rng, outlier_frac=0.0)
        valid = np.ones(len(p1), bool)
        valid[50:] = False
        F, inl, n_inl = ransac_fundamental(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
            jax.random.PRNGKey(1),
        )
        assert not np.asarray(inl)[50:].any()
        assert int(n_inl) > 40


@pytest.mark.parametrize("native", [False, None])
class TestTrackStore:
    def _store(self, native):
        if native is None and _load_native() is None:
            pytest.skip("native trackstore unavailable")
        return TrackStore(0.01, native=native)

    def test_new_pairs_create_tracks(self, native):
        ts = self._store(native)
        obs_a = np.array([[0, 10, 20], [0, 11, 21]], np.int32)
        obs_b = np.array([[1, 30, 40], [1, 31, 41]], np.int32)
        pts = np.array([[0, 0, 1.0], [0, 0, 2.0]])
        ts.add_pairs(obs_a, obs_b, pts)
        nt, no = ts.info()
        assert (nt, no) == (2, 4)
        world, offsets, obs = ts.export()
        assert world.shape == (2, 3)
        assert np.allclose(world, pts)
        assert offsets.tolist() == [0, 2, 4]

    def test_chain_merges_into_track(self, native):
        # (0,a)-(1,b) then (1,b)-(2,c) with consistent 3-D -> one 3-obs track.
        ts = self._store(native)
        ts.add_pairs(
            np.array([[0, 1, 2]], np.int32),
            np.array([[1, 3, 4]], np.int32),
            np.array([[0, 0, 1.0]]),
        )
        ts.add_pairs(
            np.array([[1, 3, 4]], np.int32),
            np.array([[2, 5, 6]], np.int32),
            np.array([[0, 0, 1.005]]),
        )
        nt, no = ts.info()
        assert (nt, no) == (1, 3)
        world, offsets, obs = ts.export()
        # Track keeps its ORIGINAL world point (reference union semantics).
        assert np.allclose(world[0], [0, 0, 1.0])
        assert set(map(tuple, obs.tolist())) == {
            (0, 1, 2), (1, 3, 4), (2, 5, 6)
        }

    def test_threshold_violation_invalidates(self, native):
        ts = self._store(native)
        ts.add_pairs(
            np.array([[0, 1, 2]], np.int32),
            np.array([[1, 3, 4]], np.int32),
            np.array([[0, 0, 1.0]]),
        )
        # Same obs (1,3,4) but a far-away 3-D point -> track invalidated.
        ts.add_pairs(
            np.array([[1, 3, 4]], np.int32),
            np.array([[2, 5, 6]], np.int32),
            np.array([[0, 0, 5.0]]),
        )
        assert ts.info() == (0, 0)

    def test_union_of_two_tracks(self, native):
        ts = self._store(native)
        ts.add_pairs(
            np.array([[0, 1, 1], [2, 2, 2]], np.int32),
            np.array([[1, 1, 1], [3, 2, 2]], np.int32),
            np.array([[0, 0, 1.0], [0, 0, 1.001]]),
        )
        assert ts.info() == (2, 4)
        # Bridge the two tracks with a consistent point -> merged 4-obs track.
        ts.add_pairs(
            np.array([[1, 1, 1]], np.int32),
            np.array([[2, 2, 2]], np.int32),
            np.array([[0, 0, 1.002]]),
        )
        nt, no = ts.info()
        assert (nt, no) == (1, 4)

    def test_update_world(self, native):
        ts = self._store(native)
        ts.add_pairs(
            np.array([[0, 1, 1], [0, 2, 2]], np.int32),
            np.array([[1, 1, 1], [1, 2, 2]], np.int32),
            np.array([[0, 0, 1.0], [0, 0, 2.0]]),
        )
        ts.update_world(np.array([[1, 1, 1.0], [2, 2, 2.0]]))
        world, _, _ = ts.export()
        assert np.allclose(world, [[1, 1, 1.0], [2, 2, 2.0]])


def test_native_python_equivalence(rng):
    if _load_native() is None:
        pytest.skip("native trackstore unavailable")
    ts_n = TrackStore(0.05, native=True)
    ts_p = TrackStore(0.05, native=False)
    # Random stream of pairs over a small coordinate universe to force all
    # four add2pts cases (new/extend/same/merge) and invalidations.
    for _ in range(20):
        m = 50
        obs_a = np.stack(
            [
                rng.integers(0, 3, m),
                rng.integers(0, 6, m),
                rng.integers(0, 6, m),
            ],
            axis=1,
        ).astype(np.int32)
        obs_b = np.stack(
            [
                rng.integers(3, 6, m),
                rng.integers(0, 6, m),
                rng.integers(0, 6, m),
            ],
            axis=1,
        ).astype(np.int32)
        pts = rng.normal(size=(m, 3)) * 0.03
        ts_n.add_pairs(obs_a, obs_b, pts)
        ts_p.add_pairs(obs_a, obs_b, pts)
    assert ts_n.info() == ts_p.info()
    wn, on_, obn = ts_n.export()
    wp, op_, obp = ts_p.export()
    assert np.allclose(wn, wp)
    assert np.array_equal(on_, op_)
    assert np.array_equal(obn, obp)


class TestPairSchedule:
    def test_sequence(self):
        assert pair_schedule(4) == [(0, 1), (1, 2), (2, 3)]

    def test_combination(self):
        assert pair_schedule(4, "combination") == [
            (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)
        ]

    def test_unknown(self):
        with pytest.raises(ValueError):
            pair_schedule(4, "bogus")


class TestSparsePipeline:
    @pytest.fixture(scope="class")
    def recon(self, dino_images_cls, dino_calib_cls):
        imgs, _ = dino_images_cls
        cfg = PipelineConfig(
            features=FeatureConfig(max_corners=2048, max_matches=1024),
        )
        return structure_from_motion(imgs, dino_calib_cls.subset(range(8)), cfg)

    def test_produces_tracks(self, recon):
        assert recon.num_tracks > 300
        assert recon.num_observations >= 2 * recon.num_tracks
        assert recon.track_lengths().min() >= 2

    def test_reprojection_quality(self, recon):
        # Every accepted observation passed the 0.3 px two-view gate; the
        # track-level mean (after merging) must stay sub-pixel.
        assert recon.mean_reprojection_error() < 1.0

    def test_points_in_front_of_cameras(self, recon):
        cal = recon.calib
        X = recon.world
        depths = (
            np.einsum("nij,mj->nmi", cal.R, X) + cal.t[:, None, :]
        )[..., 2]
        assert (depths > 0).mean() > 0.95

    def test_export_ply(self, recon, tmp_path):
        from sfm_tpu.io.ply import read_ply

        p = str(tmp_path / "sparse.ply")
        recon.export_ply(p)
        pts, _ = read_ply(p)
        assert pts.shape == (recon.num_tracks, 3)


def test_pairs_per_step_blocks_match_serial(dino_images, dino_calib):
    """The vmapped-block pair map (SfmConfig.pairs_per_step > 1) must
    reproduce the serial lax.map results exactly, including the recycled-
    row padding when the pair count is not a block multiple (round 4; the
    default stays 1 — see the config docstring's negative result)."""
    import numpy as np

    from sfm_tpu.config import FeatureConfig, PipelineConfig, SfmConfig
    from sfm_tpu.sfm import structure_from_motion

    imgs, _ = dino_images
    cal = dino_calib.subset(range(8))
    fc = FeatureConfig(max_corners=1024, max_matches=512)
    runs = {}
    for b in (1, 3, 8):  # 7 pairs: 3 forces padding, 8 exceeds the count
        r = structure_from_motion(
            imgs[:8], cal, PipelineConfig(
                features=fc, sfm=SfmConfig(pairs_per_step=b)
            )
        )
        runs[b] = r
    assert runs[1].num_tracks == runs[3].num_tracks == runs[8].num_tracks
    np.testing.assert_allclose(runs[1].world, runs[3].world, atol=1e-9)
    np.testing.assert_allclose(runs[1].world, runs[8].world, atol=1e-9)
