"""Edge cases and robustness probes across the kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment as scipy_lsa

from datmo_using_optical_flow.ops.dbscan import dbscan
from datmo_using_optical_flow.ops.hungarian import solve_square
from datmo_using_optical_flow.ops.icp import registration_icp
from datmo_using_optical_flow.ops.ransac import segment_plane


def test_hungarian_large_matches_scipy():
    for seed in range(3):
        cost = np.random.default_rng(seed).uniform(0, 100, size=(64, 64)).astype(np.float32)
        col4row = np.asarray(solve_square(jnp.asarray(cost)))
        ri, ci = scipy_lsa(cost)
        assert abs(cost[np.arange(64), col4row].sum() - cost[ri, ci].sum()) < 1e-2
        assert len(set(col4row.tolist())) == 64


def test_hungarian_with_equal_costs():
    cost = jnp.ones((8, 8), jnp.float32)
    col4row = np.asarray(solve_square(cost))
    assert len(set(col4row.tolist())) == 8  # any permutation is optimal


def test_icp_no_correspondences_returns_identity():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(512, 3)).astype(np.float32)
    dst = src + 100.0  # far beyond any threshold
    m = np.ones(512, bool)
    res = registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                           jnp.asarray(m), threshold=0.01, max_iterations=10)
    np.testing.assert_allclose(np.asarray(res.transformation), np.eye(4), atol=1e-6)
    assert float(res.fitness) == 0.0


def test_icp_identical_clouds():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(512, 3)).astype(np.float32)
    m = np.ones(512, bool)
    res = registration_icp(jnp.asarray(pts), jnp.asarray(m), jnp.asarray(pts),
                           jnp.asarray(m), threshold=0.5)
    np.testing.assert_allclose(np.asarray(res.transformation), np.eye(4), atol=1e-4)
    assert float(res.fitness) > 0.999


def test_ransac_few_points():
    """Plane through a handful of points — must not crash, must fit."""
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0.5, 0.5, 0.01],
                    [2, 2, 5.0]], np.float32)  # 5 planar + 1 outlier
    pad = np.full((512, 3), 1e9, np.float32)
    pad[:6] = pts
    m = np.zeros(512, bool)
    m[:6] = True
    plane, inl = segment_plane(jnp.asarray(pad), jnp.asarray(m),
                               jax.random.PRNGKey(0), 0.05, 3, 500)
    plane = np.asarray(plane)
    assert abs(plane[2]) > 0.99
    got = np.asarray(inl)[:6]
    assert got[:5].all() and not got[5]


def test_dbscan_single_point():
    feats = np.full((512, 3), 3e18, np.float32)
    feats[0] = [0, 0, 0]
    valid = np.zeros(512, bool)
    valid[0] = True
    labels, core = dbscan(jnp.asarray(feats), jnp.asarray(valid), 1.0, 1)
    assert int(labels[0]) == 0 and bool(core[0])  # min_samples=1: self-core
    labels2, core2 = dbscan(jnp.asarray(feats), jnp.asarray(valid), 1.0, 2)
    assert int(labels2[0]) == -1 and not bool(core2[0])


def test_compat_process_multiple_frames(tmp_path):
    from datmo_using_optical_flow import compat
    from datmo_using_optical_flow.config import CapacityConfig, PipelineAConfig
    from datmo_using_optical_flow.sim.synthetic import (SyntheticScene,
                                                            write_synthetic_sequence)

    paths = write_synthetic_sequence(SyntheticScene(seed=2), str(tmp_path / "s"), 3)
    cfg = PipelineAConfig(capacities=CapacityConfig(max_raw_points=8192,
                                                    max_roi_points=1024,
                                                    max_cells=512, max_clusters=4,
                                                    max_tracks=8))
    tracks = compat.process_multiple_frames(paths, cfg, output_dir=str(tmp_path / "o"))
    assert isinstance(tracks, dict)
    import os

    assert os.path.exists(tmp_path / "o" / "bev_frame_0.npy")


def test_gmfa_plot_dir(tmp_path):
    import os

    from datmo_using_optical_flow.config import (CapacityConfig, DbscanConfig,
                                                     GMFAConfig, IcpConfig)
    from datmo_using_optical_flow.models.gmfa import GMFAPipeline
    from datmo_using_optical_flow.sim.synthetic import (BoxTarget, SyntheticScene,
                                                            write_synthetic_sequence)

    cfg = GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=30),
                     icp=IcpConfig(threshold=0.1),
                     capacities=CapacityConfig(max_raw_points=8192, max_roi_points=1024,
                                               max_cells=512, max_clusters=8,
                                               max_tracks=16))
    scene = SyntheticScene(seed=21, targets=(BoxTarget(center0=(5.0, -3.0, 0.75),
                                                       velocity=(2.0, 1.0)),))
    paths = write_synthetic_sequence(scene, str(tmp_path / "s"), 3)
    pipe = GMFAPipeline(cfg, max_moving_points=4096)
    pipe.process_files(paths, plot_dir=str(tmp_path / "plots"))
    names = os.listdir(tmp_path / "plots")
    assert any(n.startswith("som_frame_") for n in names)
    assert any(n.startswith("moving_static_frame_") for n in names)
