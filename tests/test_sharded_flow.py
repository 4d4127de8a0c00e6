"""Row-sharded Farnebäck level vs the unsharded level on the 8-device CPU mesh
(spatial parallelism, SURVEY.md §2.5)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from datmo_using_optical_flow.ops import farneback as fb
from datmo_using_optical_flow.parallel.sharded_flow import (sharded_farneback_level,
                                                                sharded_poly_exp)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device CPU mesh")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    img1 = cv2.GaussianBlur(rng.uniform(0, 255, (64, 80)).astype(np.float32), (0, 0), 3)
    # small displacement so the warp stays within the halo bound
    img2 = cv2.warpAffine(img1, np.float32([[1, 0, 0.9], [0, 1, -1.2]]), (80, 64))
    return img1, img2


def test_sharded_poly_exp_matches_unsharded(pair):
    img1, _ = pair
    expect = np.asarray(fb.poly_exp(jnp.asarray(img1), 5, 5.0))
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("space",))
    fn = shard_map(lambda b: sharded_poly_exp(b, 5, 5.0, "space"), mesh=mesh,
                   in_specs=P("space"), out_specs=P(None, "space"),
                   check_vma=False)
    got = np.asarray(jax.jit(fn)(jnp.asarray(img1)))
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


def test_sharded_level_matches_unsharded(pair):
    img1, img2 = pair
    h = img1.shape[0]
    R0 = fb.poly_exp(jnp.asarray(img1), 5, 5.0)
    R1 = fb.poly_exp(jnp.asarray(img2), 5, 5.0)
    zero = jnp.zeros(img1.shape, jnp.float32)
    dx_e, dy_e = fb.farneback_level(R0, R1, zero, zero, 15, 3)

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("space",))
    fn = shard_map(
        lambda r0, r1, a, b: sharded_farneback_level(r0, r1, a, b, 15, 3, "space",
                                                     h_global=h, warp_halo=8),
        mesh=mesh,
        in_specs=(P(None, "space"), P(None, "space"), P("space"), P("space")),
        out_specs=(P("space"), P("space")), check_vma=False)
    dx_s, dy_s = jax.jit(fn)(R0, R1, zero, zero)
    np.testing.assert_allclose(np.asarray(dx_s), np.asarray(dx_e), atol=1e-4)
    np.testing.assert_allclose(np.asarray(dy_s), np.asarray(dy_e), atol=1e-4)


def test_sharded_full_flow_matches_unsharded():
    """Full pyramid: coarse levels replicated, level 0 row-sharded — matches the
    unsharded flow (small displacement within the warp halo)."""
    from datmo_using_optical_flow.parallel.sharded_flow import sharded_farneback_flow
    from datmo_using_optical_flow.config import FarnebackConfig

    rng = np.random.default_rng(3)
    img1 = cv2.GaussianBlur(rng.uniform(0, 255, (64, 80)).astype(np.float32), (0, 0), 3)
    img2 = cv2.warpAffine(img1, np.float32([[1, 0, 1.1], [0, 1, -0.7]]), (80, 64))
    cfg = FarnebackConfig(pyr_scale=0.5, levels=2, iterations=3)
    expect = np.asarray(fb.farneback_flow(jnp.asarray(img1), jnp.asarray(img2), cfg))

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("space",))
    fn = shard_map(
        lambda a, b: sharded_farneback_flow(a, b, "space", pyr_scale=0.5, levels=2,
                                            iterations=3, warp_halo=8),
        mesh=mesh, in_specs=(P("space"), P("space")),
        out_specs=P("space"), check_vma=False)
    got = np.asarray(jax.jit(fn)(jnp.asarray(img1), jnp.asarray(img2)))
    epe = np.linalg.norm(got - expect, axis=-1)
    assert epe.max() < 1e-3, epe.max()

    # and against cv2 directly
    theirs = cv2.calcOpticalFlowFarneback(img1, img2, None, 0.5, 2, 15, 3, 5, 5.0, 0)
    assert np.linalg.norm(got - theirs, axis=-1).max() < 1e-3
