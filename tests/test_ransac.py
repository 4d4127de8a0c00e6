"""RANSAC ground-segmentation tests (reference: Open3D ``segment_plane`` at
``Optical_flow/main.py:73``; statistical-equivalence oracle since Open3D's RNG
is not reproducible here — the plane itself is the ground truth)."""

import jax
import jax.numpy as jnp
import numpy as np

from datmo_using_optical_flow.io.frames import pad_points
from datmo_using_optical_flow.ops.ransac import remove_ground, segment_plane
from datmo_using_optical_flow.sim.synthetic import SyntheticScene, synthetic_frame


def test_segment_plane_recovers_ground():
    scene = SyntheticScene(seed=1)
    pts = synthetic_frame(scene, 0)
    padded, valid = pad_points(pts, 8192)
    plane, inliers = segment_plane(jnp.asarray(padded), jnp.asarray(valid),
                                   jax.random.PRNGKey(0), 0.5, 5, 5000)
    plane = np.asarray(plane)
    # ground is z=0: normal ≈ (0,0,1), d ≈ 0
    assert abs(plane[2]) > 0.99, plane
    assert abs(plane[3]) < 0.3, plane
    # every true ground point (z < 0.1) must be an inlier at threshold 0.5
    ground_truth = np.abs(pts[:, 2]) < 0.1
    got = np.asarray(inliers)[: len(pts)]
    assert (got[ground_truth]).mean() > 0.999


def test_remove_ground_keeps_targets():
    scene = SyntheticScene(seed=2)
    pts = synthetic_frame(scene, 0)
    padded, valid = pad_points(pts, 8192)
    _, non_ground = remove_ground(jnp.asarray(padded), jnp.asarray(valid),
                                  jax.random.PRNGKey(1))
    ng = np.asarray(non_ground)[: len(pts)]
    # target-box points above the 0.5 m inlier band must survive
    tall = pts[:, 2] > 0.6
    assert ng[tall].mean() > 0.99
    # ground plane points must be removed
    flat = np.abs(pts[:, 2]) < 0.1
    assert ng[flat].mean() < 0.01


def test_segment_plane_tilted():
    """Recovers a non-axis-aligned plane (oblique ground)."""
    rng = np.random.default_rng(5)
    n_true = np.array([0.1, -0.2, 1.0])
    n_true = n_true / np.linalg.norm(n_true)
    xy = rng.uniform(-20, 20, size=(4000, 2))
    z = -(n_true[0] * xy[:, 0] + n_true[1] * xy[:, 1] - 1.0) / n_true[2]
    ground = np.column_stack([xy, z]) + rng.normal(scale=0.02, size=(4000, 3))
    clutter = rng.uniform(-20, 20, size=(400, 3)) + np.array([0, 0, 8.0])
    pts = np.concatenate([ground, clutter]).astype(np.float32)
    padded, valid = pad_points(pts, 8192)
    plane, _ = segment_plane(jnp.asarray(padded), jnp.asarray(valid),
                             jax.random.PRNGKey(3), 0.2, 5, 3000)
    plane = np.asarray(plane)
    assert abs(np.dot(plane[:3], n_true)) > 0.999, plane
