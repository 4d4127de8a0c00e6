"""Reference-API compatibility layer.

Function-for-function equivalents of the reference's public surface
(``Optical_flow/main.py`` and ``GMFA/GMFA.py``), with the same names, argument
conventions, and numpy-in/numpy-out behavior — implemented on the device ops.  A
user of the reference can switch imports and keep their driver code:

    from datmo_using_optical_flow.compat import (
        load_config, preprocess_pcd, compute_velocity_vectors,
        continuity_mask, dbscan_clustering, extract_cluster_data,
        track_clusters, manage_tracks, process_multiple_frames, EKF)

Differences from the reference (all defects from SURVEY.md §2.4): randomness is
seeded (pass ``seed=``), the first-frame acceleration crash is fixed, config is
authoritative, and plots save to files instead of blocking.
"""

from __future__ import annotations

import numpy as np


def load_config(yaml_file: str) -> dict:
    """Raw-dict YAML load (``Optical_flow/main.py:25-28``)."""
    import yaml

    with open(yaml_file, "r") as f:
        return yaml.safe_load(f)


def filter_points_in_roi(points: np.ndarray, roi_bounds) -> np.ndarray:
    """Box filter (``main.py:30-36``)."""
    import jax.numpy as jnp

    from datmo_using_optical_flow.ops.points import roi_mask

    keep = np.asarray(roi_mask(jnp.asarray(np.asarray(points)), roi_bounds))
    return np.asarray(points)[keep]


def increase_point_density(points: np.ndarray, expansion_factor: int = 2,
                           noise_std: float = 0.01, seed: int = 0) -> np.ndarray:
    """Replication + jitter (``main.py:38-57``), seeded."""
    rng = np.random.default_rng(seed)
    rep = np.repeat(np.asarray(points), expansion_factor, axis=0)
    return rep + rng.normal(scale=noise_std, size=rep.shape)


def compute_bev_grid(points: np.ndarray, grid_resolution, x_range, y_range,
                     a: float = 0.5, b: float = 0.5, h_max: float = 5.0) -> np.ndarray:
    """uint8 BEV grid (``main.py:98-126``) on device."""
    import jax.numpy as jnp

    from datmo_using_optical_flow.io.frames import pad_points
    from datmo_using_optical_flow.ops.bev import compute_bev_grid as dev_bev

    pts = np.asarray(points, np.float32)
    cap = max(1, int(np.ceil(pts.shape[0] / 256)) * 256)
    padded, mask = pad_points(pts, cap)
    nx = len(np.arange(x_range[0], x_range[1], grid_resolution[0]))
    ny = len(np.arange(y_range[0], y_range[1], grid_resolution[1]))
    return np.asarray(dev_bev(jnp.asarray(padded), jnp.asarray(mask), (nx, ny),
                              tuple(x_range), tuple(y_range), tuple(grid_resolution),
                              a, b, h_max))


def preprocess_pcd(pcd_file: str, grid_resolution, x_range, y_range, z_max,
                   roi_bounds, seed: int = 0) -> np.ndarray | None:
    """Read -> flip -> RANSAC ground removal -> ROI -> densify -> BEV
    (``main.py:59-95``); returns None when the ROI is empty, like the reference."""
    import jax
    import jax.numpy as jnp

    from datmo_using_optical_flow.config import PipelineAConfig
    from datmo_using_optical_flow.io.frames import pad_points
    from datmo_using_optical_flow.io.pcd import read_pcd
    from datmo_using_optical_flow.models.optical_flow_datmo import _preprocess_impl

    pts = read_pcd(pcd_file, dtype=np.float32)
    cfg = PipelineAConfig(grid_resolution=tuple(grid_resolution),
                          x_range=tuple(x_range), y_range=tuple(y_range),
                          z_max=float(z_max), roi_bounds=tuple(roi_bounds))
    padded, mask = pad_points(pts, cfg.capacities.max_raw_points)
    bev = np.asarray(_preprocess_impl(jnp.asarray(padded), jnp.asarray(mask),
                                      jax.random.PRNGKey(seed), cfg))
    if not bev.any():
        print(f"No ROI points for {pcd_file}. Adjust ROI bounds.")
        return None
    return bev


def compute_velocity_vectors(bev1: np.ndarray, bev2: np.ndarray, x_range, y_range,
                             dt: float = 1.0, farneback_params: dict | None = None):
    """Dense flow -> (velocity_x, velocity_y, angular_velocity)
    (``main.py:131-164``); Farnebäck runs on device."""
    import jax.numpy as jnp

    from datmo_using_optical_flow.config import FarnebackConfig
    from datmo_using_optical_flow.ops.farneback import farneback_flow
    from datmo_using_optical_flow.ops.masks import velocity_from_flow

    fb = FarnebackConfig(**(farneback_params or {}))
    flow = farneback_flow(jnp.asarray(bev1, jnp.float32),
                          jnp.asarray(bev2, jnp.float32), fb)
    vx, vy, av = velocity_from_flow(flow, tuple(x_range), tuple(y_range))
    return np.asarray(vx), np.asarray(vy), np.asarray(av)


def continuity_mask(vx: np.ndarray, vy: np.ndarray, alpha_cont: float) -> np.ndarray:
    """``main.py:224-228`` on device."""
    import jax.numpy as jnp

    from datmo_using_optical_flow.ops import masks

    return np.asarray(masks.continuity_mask(jnp.asarray(vx, jnp.float32),
                                            jnp.asarray(vy, jnp.float32), alpha_cont))


def propagation_mask(vx, vy, dt, grid_resolution, alpha_p) -> np.ndarray:
    """``main.py:167-183`` on device."""
    import jax.numpy as jnp

    from datmo_using_optical_flow.ops import masks

    return np.asarray(masks.propagation_mask(jnp.asarray(vx, jnp.float32),
                                             jnp.asarray(vy, jnp.float32), dt,
                                             tuple(grid_resolution), alpha_p))


def propagation_mask_with_acceleration(vx, vy, ax, ay, dt, grid_resolution,
                                       alpha_p) -> np.ndarray:
    """``main.py:185-221`` on device."""
    import jax.numpy as jnp

    from datmo_using_optical_flow.ops import masks

    return np.asarray(masks.propagation_mask_with_acceleration(
        jnp.asarray(vx, jnp.float32), jnp.asarray(vy, jnp.float32),
        jnp.asarray(ax, jnp.float32), jnp.asarray(ay, jnp.float32), dt,
        tuple(grid_resolution), alpha_p))


def dbscan_clustering(vx_filtered: np.ndarray, vy_filtered: np.ndarray,
                      valid_mask: np.ndarray, eps: float = 1.0,
                      min_samples: int = 5):
    """(labels, valid_indices) like ``main.py:231-259``, via the device DBSCAN."""
    import jax.numpy as jnp

    from datmo_using_optical_flow.ops.dbscan import dbscan_velocity_grid

    h, w = np.asarray(vx_filtered).shape
    n_valid = int(np.asarray(valid_mask, bool).sum())
    cap = max(256, int(np.ceil(n_valid / 256)) * 256)
    labels, rows, cols, cmask, count = dbscan_velocity_grid(
        jnp.asarray(vx_filtered, jnp.float32), jnp.asarray(vy_filtered, jnp.float32),
        jnp.asarray(np.asarray(valid_mask, bool)), eps, min_samples, (h, w), cap)
    n = int(count)
    idx = np.stack([np.asarray(rows)[:n], np.asarray(cols)[:n]], axis=1)
    return np.asarray(labels)[:n], idx


def calculate_dbscan_cluster_velocities(labels, valid_indices, vx_filtered,
                                        vy_filtered) -> dict:
    """``main.py:261-294``."""
    out = {}
    for cid in np.unique(labels):
        if cid == -1:
            continue
        pts = valid_indices[labels == cid]
        v = np.hypot(vx_filtered[pts[:, 0], pts[:, 1]],
                     vy_filtered[pts[:, 0], pts[:, 1]])
        out[int(cid)] = float(v.mean())
    return out


def extract_cluster_data(labels, indices, vx, vy) -> dict:
    """``main.py:402-434`` (oracle implementation; small host-side dicts)."""
    from datmo_using_optical_flow.oracle.reference_a import extract_cluster_data as f

    return f(np.asarray(labels), np.asarray(indices), np.asarray(vx), np.asarray(vy))


def filter_clusters_by_roi(db_labels, valid_indices, velocity_grid, valid_mask,
                           road_polygon):
    """``main.py:297-334``; ``road_polygon`` is an (V, 2) array of (col, row)
    vertices (no shapely dependency)."""
    import jax.numpy as jnp

    from datmo_using_optical_flow.ops.clusters import filter_clusters_by_polygon

    rows = jnp.asarray(valid_indices[:, 0])
    cols = jnp.asarray(valid_indices[:, 1])
    out_labels, _, _, w, u, keep = filter_clusters_by_polygon(
        jnp.asarray(db_labels), rows, cols,
        jnp.asarray(velocity_grid[0], jnp.float32),
        jnp.asarray(velocity_grid[1], jnp.float32),
        jnp.asarray(np.asarray(road_polygon, np.float32)))
    keep = np.asarray(keep)
    return (np.asarray(db_labels)[keep], np.asarray(valid_indices)[keep],
            np.asarray(w)[keep], np.asarray(u)[keep])


# tracking surface: the oracle classes ARE the reference behaviors
from datmo_using_optical_flow.oracle.reference_a import (  # noqa: E402,F401
    RefEKF as EKF,
    manage_tracks,
    track_clusters,
)
from datmo_using_optical_flow.io.viz import visualize_tracks  # noqa: E402,F401


def process_multiple_frames(pcd_files, config, output_dir: str | None = None,
                            seed: int = 0) -> dict:
    """The reference's main entry point (``main.py:541-641``), running the full
    device pipeline with artifact outputs.  ``config`` may be the reference's raw
    YAML dict or a :class:`~datmo_using_optical_flow.config.PipelineAConfig`.
    """
    from datmo_using_optical_flow.config import (PipelineAConfig,
                                                     pipeline_a_config_from_dict)
    from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA

    if isinstance(config, dict):
        cfg = pipeline_a_config_from_dict(config)
    else:
        cfg = config or PipelineAConfig()
    pipe = PipelineA(cfg)
    summary = pipe.process_files(list(pcd_files), output_dir=output_dir, seed=seed)
    return summary["tracks"]
