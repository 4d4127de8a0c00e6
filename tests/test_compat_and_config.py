"""Reference-schema config loading + compat-layer API parity tests."""

import numpy as np
import pytest
import yaml

from datmo_using_optical_flow.config import (GMFAConfig, PipelineAConfig,
                                                 gmfa_config_from_dict, load_config,
                                                 pipeline_a_config_from_dict)

# a reference-shaped config dict (schema of Optical_flow/config.yaml /
# GMFA/config.yaml, constructed here rather than copied)
REFERENCE_STYLE = {
    "input_folder": "/data/pcds",
    "output_folder": "/data/out",
    "grid_resolution": [0.2, 0.2],
    "x_range": [-20, 20],
    "y_range": [-20, 20],
    "z_max": 2.0,
    "roi_bounds": [-10, 10, -10, 10, -3, 1],
    "ransac": {"distance_threshold": 0.3, "ransac_n": 3, "num_iterations": 5000},
    "farneback_params": {"pyr_scale": 0.7, "levels": 3, "winsize": 15,
                         "iterations": 3, "poly_n": 5, "poly_sigma": 1.2, "flags": 0},
    "masks": {"alpha_p": [0.8], "alpha_cont": [0.2]},
    "dt": 1.0,
    "dbscan_params": {"eps": 5.0, "min_samples": 3},
    "pcd_files": ["/data/pcds/lidar_frame_930.pcd", "/data/pcds/lidar_frame_960.pcd"],
}


def test_pipeline_a_config_from_reference_dict():
    cfg = pipeline_a_config_from_dict(REFERENCE_STYLE)
    assert cfg.grid_shape == (200, 200)
    # unlike the reference, the ransac/farneback blocks are honored
    assert cfg.ransac.distance_threshold == 0.3 and cfg.ransac.ransac_n == 3
    assert cfg.farneback.pyr_scale == 0.7 and cfg.farneback.levels == 3
    assert cfg.masks.alpha_p == 0.8 and cfg.masks.alpha_cont == 0.2
    assert cfg.dbscan.eps == 5.0 and cfg.dbscan.min_samples == 3
    assert len(cfg.pcd_files) == 2


def test_default_config_matches_executed_reference_values():
    """Defaults = what the reference actually executes (hard-coded), not its
    dead YAML blocks (SURVEY.md §2.4 #3)."""
    cfg = PipelineAConfig()
    assert (cfg.ransac.distance_threshold, cfg.ransac.ransac_n,
            cfg.ransac.num_iterations) == (0.5, 5, 5000)
    fb = cfg.farneback
    assert (fb.pyr_scale, fb.levels, fb.winsize, fb.iterations, fb.poly_n,
            fb.poly_sigma) == (0.3, 5, 15, 5, 5, 5.0)
    g = GMFAConfig()
    assert g.dbscan.min_samples == 1000  # GMFA.py:480 hard-codes 1000
    assert g.static_threshold == 0.2 and g.moving_threshold == 0.6


def test_gmfa_config_from_reference_dict():
    cfg = gmfa_config_from_dict({"roi_bounds": [-20, 20, -20, 20, -3, 3],
                                 "dbscan_params": {"eps": 5.0, "min_samples": 3}})
    # explicit min_samples is honored (config is authoritative here)
    assert cfg.dbscan.min_samples == 3


def test_load_config_yaml_roundtrip(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(REFERENCE_STYLE))
    cfg = load_config(str(path), pipeline="a")
    assert isinstance(cfg, PipelineAConfig) and cfg.z_max == 2.0


def test_config_validation_rejects_bad_values():
    with pytest.raises(ValueError, match="pyr_scale"):
        pipeline_a_config_from_dict({"farneback_params": {"pyr_scale": 1.5}})
    with pytest.raises(ValueError, match="unknown keys"):
        pipeline_a_config_from_dict({"dbscan_params": {"epsilon": 1.0}})


# ------------------------------------------------------------------ compat layer

def test_compat_functions_match_oracle():
    from datmo_using_optical_flow import compat
    from datmo_using_optical_flow.oracle import reference_a as ref

    rng = np.random.default_rng(0)
    pts = rng.uniform(-15, 15, size=(2000, 3))
    roi = (-10, 10, -10, 10, -3, 1)
    got = compat.filter_points_in_roi(pts, roi)
    np.testing.assert_array_equal(got, ref.filter_points_in_roi(pts, roi))

    bev = compat.compute_bev_grid(pts, (0.2, 0.2), (-20, 20), (-20, 20), h_max=2.0)
    expect = ref.compute_bev_grid(pts, (0.2, 0.2), (-20, 20), (-20, 20), h_max=2.0)
    assert (np.abs(bev.astype(int) - expect.astype(int)) <= 1).all()

    vx = rng.normal(scale=0.3, size=(40, 40)).astype(np.float32)
    vy = rng.normal(scale=0.3, size=(40, 40)).astype(np.float32)
    np.testing.assert_array_equal(compat.continuity_mask(vx, vy, 0.2),
                                  ref.continuity_mask(vx, vy, 0.2))


def test_compat_flow_and_clustering():
    import cv2

    from datmo_using_optical_flow import compat

    rng = np.random.default_rng(1)
    bev1 = cv2.GaussianBlur(rng.uniform(0, 255, (48, 48)).astype(np.float32), (0, 0), 2)
    bev2 = cv2.warpAffine(bev1, np.float32([[1, 0, 1], [0, 1, 0]]), (48, 48))
    vx, vy, av = compat.compute_velocity_vectors(bev1, bev2, (-20, 20), (-20, 20))
    flow = cv2.calcOpticalFlowFarneback(bev1, bev2, None, 0.3, 5, 15, 5, 5, 5, 0)
    np.testing.assert_allclose(vx, flow[..., 0] * (40 / 48), atol=1e-3)

    mag = np.hypot(vx, vy)
    labels, idx = compat.dbscan_clustering(vx, vy, mag > 0.1, eps=5.0, min_samples=3)
    assert len(labels) == len(idx) == int((mag > 0.1).sum())


def test_compat_tracking_api():
    from datmo_using_optical_flow import compat

    tracks = {}
    clusters = {0: {"centroid": np.array([1.0, 2.0]),
                    "measurement": [1.0, 2.0, 0.1, 0.2],
                    "eigenvalues": np.array([0.01, 0.02])}}
    tracks = compat.track_clusters(tracks, clusters, 1.0, np.eye(4) * 0.1,
                                   np.eye(4) * 0.05, gamma=0.5)
    assert list(tracks) == [1]
    lifetimes = {1: 4}
    confirmed = set()
    compat.manage_tracks(tracks, lifetimes, confirmed, 1, 4, 10, 15)
    assert 1 in confirmed


def test_cli_synth_and_run(tmp_path, capsys):
    from datmo_using_optical_flow.__main__ import main

    out_dir = str(tmp_path / "seq")
    assert main(["synth", out_dir, "-n", "3"]) == 0
    import os

    assert len([f for f in os.listdir(out_dir) if f.endswith(".pcd")]) == 3
