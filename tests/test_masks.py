"""Mask/velocity-grid parity tests vs the CPU oracle (reference behaviors at
``Optical_flow/main.py:131-228`` and the dead-code propagation masks :167-221)."""

import jax.numpy as jnp
import numpy as np
import pytest

from datmo_using_optical_flow.ops import masks as mops
from datmo_using_optical_flow.oracle import reference_a as ref


@pytest.fixture
def vgrids():
    rng = np.random.default_rng(11)
    vx = rng.normal(scale=0.4, size=(60, 70)).astype(np.float32)
    vy = rng.normal(scale=0.4, size=(60, 70)).astype(np.float32)
    return vx, vy


def test_gradient_matches_numpy(vgrids):
    vx, _ = vgrids
    for axis in (0, 1):
        ours = np.asarray(mops.gradient(jnp.asarray(vx), axis))
        np.testing.assert_allclose(ours, np.gradient(vx, axis=axis), rtol=1e-6, atol=1e-6)


def test_velocity_from_flow_matches_oracle(vgrids):
    vx, vy = vgrids
    flow = np.stack([vx * 3, vy * 3], axis=-1)
    evx, evy, eav = ref.velocity_from_flow(flow, (-20, 20), (-20, 20))
    gvx, gvy, gav = mops.velocity_from_flow(jnp.asarray(flow), (-20, 20), (-20, 20))
    np.testing.assert_allclose(np.asarray(gvx), evx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gvy), evy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gav), eav, rtol=1e-4, atol=1e-6)


def test_continuity_mask_matches_oracle(vgrids):
    vx, vy = vgrids
    expect = ref.continuity_mask(vx, vy, 0.2)
    got = np.asarray(mops.continuity_mask(jnp.asarray(vx), jnp.asarray(vy), 0.2))
    np.testing.assert_array_equal(got, expect)


def test_propagation_mask_matches_oracle(vgrids):
    vx, vy = vgrids
    # larger velocities so cells actually move across the grid
    vx, vy = vx * 4, vy * 4
    expect = ref.propagation_mask(vx, vy, 1.0, (0.2, 0.2), 0.8)
    got = np.asarray(mops.propagation_mask(jnp.asarray(vx), jnp.asarray(vy), 1.0,
                                           (0.2, 0.2), 0.8))
    np.testing.assert_array_equal(got, expect)


def test_propagation_mask_with_acceleration_matches_oracle(vgrids):
    vx, vy = vgrids
    rng = np.random.default_rng(12)
    ax = rng.normal(scale=1.0, size=vx.shape).astype(np.float32)
    ay = rng.normal(scale=1.0, size=vy.shape).astype(np.float32)
    expect = ref.propagation_mask_with_acceleration(vx * 4, vy * 4, ax, ay, 1.0,
                                                    (0.2, 0.2), 0.8)
    got = np.asarray(mops.propagation_mask_with_acceleration(
        jnp.asarray(vx * 4), jnp.asarray(vy * 4), jnp.asarray(ax), jnp.asarray(ay),
        1.0, (0.2, 0.2), 0.8))
    np.testing.assert_array_equal(got, expect)


def test_points_in_polygon():
    # unit square; interior, exterior, and a concave polygon
    square = jnp.asarray([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    pts = jnp.asarray([[0.5, 0.5], [1.5, 0.5], [-0.1, 0.2], [0.99, 0.99]])
    got = np.asarray(mops.points_in_polygon(pts, square))
    np.testing.assert_array_equal(got, [True, False, False, True])

    concave = jnp.asarray([[0.0, 0.0], [4.0, 0.0], [4.0, 4.0], [2.0, 2.0], [0.0, 4.0]])
    pts = jnp.asarray([[2.0, 3.0], [2.0, 1.0], [0.5, 3.0]])
    got = np.asarray(mops.points_in_polygon(pts, concave))
    np.testing.assert_array_equal(got, [False, True, True])
