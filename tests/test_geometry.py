"""Geometry-core parity tests: ROI / flip / densify / compaction / BEV vs the CPU oracle
(reference behaviors at ``Optical_flow/main.py:30-126``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from datmo_using_optical_flow.io.frames import pad_points
from datmo_using_optical_flow.ops import bev as bev_ops
from datmo_using_optical_flow.ops import points as point_ops
from datmo_using_optical_flow.oracle import reference_a as ref
from datmo_using_optical_flow.utils.padding import compact_masked


@pytest.fixture
def cloud():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-25, 25, size=(3000, 3))
    pts[:, 2] = rng.uniform(-4, 4, size=3000)
    return pts.astype(np.float32)


def test_flip_x(cloud):
    out = np.asarray(point_ops.flip_x(jnp.asarray(cloud)))
    np.testing.assert_array_equal(out, ref.flip_x(cloud))


def test_roi_mask_matches_oracle(cloud):
    roi = (-10.0, 10.0, -10.0, 10.0, -3.0, 1.0)
    padded, valid = pad_points(cloud, 4096)
    mask = np.asarray(point_ops.roi_mask(jnp.asarray(padded), roi)) & valid
    expect = ref.filter_points_in_roi(cloud, roi)
    got = padded[mask]
    assert got.shape == expect.shape
    np.testing.assert_array_equal(np.sort(got, axis=0), np.sort(expect, axis=0))


def test_compact_masked_preserves_order(cloud):
    padded, valid = pad_points(cloud, 4096)
    roi = (-10.0, 10.0, -10.0, 10.0, -3.0, 1.0)
    m = np.asarray(point_ops.roi_mask(jnp.asarray(padded), roi)) & valid
    out, out_mask, count = compact_masked(jnp.asarray(padded), jnp.asarray(m), 2048)
    expect = padded[m]
    n = int(count)
    assert n == expect.shape[0] == int(out_mask.sum())
    np.testing.assert_array_equal(np.asarray(out)[:n], expect)  # stable order
    assert (np.asarray(out)[n:] > 1e8).all()


def test_compact_masked_overflow():
    x = jnp.arange(10, dtype=jnp.float32)[:, None]
    mask = jnp.ones(10, dtype=bool)
    out, out_mask, count = compact_masked(x, mask, 4)
    assert int(count) == 4
    np.testing.assert_array_equal(np.asarray(out)[:, 0], [0, 1, 2, 3])


def test_compact_masked_topk_path_matches_scatter():
    """Above _SCATTER_MAX rows compaction switches to top_k+gather (the 1080p
    velocity grid's 2M cells); both paths must
    produce bit-identical rows, order, mask, and count — including underflow,
    overflow, and empty masks."""
    from datmo_using_optical_flow.utils import padding

    rng = np.random.default_rng(0)
    # +37: not a multiple of the bitpacked rank search's 256-bit block; the
    # two sizes force the top_k branch and the bitpacked branch respectively
    for n in (padding._SCATTER_MAX * 2 + 37, padding._BITPACK_MIN + 37):
        _check_compact_paths(rng, n)


def _check_compact_paths(rng, n):
    x = rng.normal(size=(n, 4)).astype(np.float32)
    for frac, cap in ((0.0, 256), (0.001, 1024), (0.02, 512), (1.0, 777)):
        mask = rng.uniform(size=n) < frac
        got, gmask, gcount = compact_masked(jnp.asarray(x), jnp.asarray(mask),
                                            cap, fill_value=3e18)
        expect = x[mask][:cap]
        k = expect.shape[0]
        assert int(gcount) == min(int(mask.sum()), cap) == k or frac == 1.0
        np.testing.assert_array_equal(np.asarray(got)[:k], expect)
        np.testing.assert_array_equal(np.asarray(gmask),
                                      np.arange(cap) < int(gcount))
        assert (np.asarray(got)[k:] == 3e18).all()


def test_densify_matches_oracle_with_shared_noise(cloud):
    roi_pts = ref.filter_points_in_roi(cloud.astype(np.float64), (-10, 10, -10, 10, -3, 1))
    n = roi_pts.shape[0]
    k = 10
    noise = np.random.default_rng(3).normal(scale=0.01, size=(n * k, 3))
    expect = ref.increase_point_density(roi_pts, k, noise=noise)

    padded, valid = pad_points(roi_pts, n, dtype=np.float64)
    out, out_mask = point_ops.densify(jnp.asarray(padded), jnp.asarray(valid),
                                      jax.random.PRNGKey(0), k, noise=jnp.asarray(noise))
    # device path is f32 (JAX default); oracle is f64
    np.testing.assert_allclose(np.asarray(out), expect, rtol=0, atol=1e-5)
    assert bool(out_mask.all())


def test_bev_grid_shape_matches_arange():
    from datmo_using_optical_flow.config import PipelineAConfig

    cfg = PipelineAConfig()
    nx = len(np.arange(cfg.x_range[0], cfg.x_range[1], cfg.grid_resolution[0]))
    ny = len(np.arange(cfg.y_range[0], cfg.y_range[1], cfg.grid_resolution[1]))
    assert cfg.grid_shape == (nx, ny) == (200, 200)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bev_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-21, 21, size=(20000, 3))
    pts[:, 2] = rng.uniform(-1, 3, size=20000)
    x_range, y_range, res = (-20.0, 20.0), (-20.0, 20.0), (0.2, 0.2)
    expect = ref.compute_bev_grid(pts, res, x_range, y_range, h_max=2.0)

    padded, valid = pad_points(pts, 32768, dtype=np.float64)
    got = np.asarray(bev_ops.compute_bev_grid(
        jnp.asarray(padded), jnp.asarray(valid), (200, 200), x_range, y_range, res,
        h_max=2.0))
    # f64 oracle vs f32 device path: allow off-by-one quantization on rare cells
    diff = np.abs(got.astype(int) - expect.astype(int))
    assert (diff <= 1).all(), f"max diff {diff.max()}"
    assert (diff == 0).mean() > 0.995, f"exact-match fraction {(diff == 0).mean()}"


def test_bev_trunc_toward_zero_binning():
    """Points in (lo - step, lo) land in bin 0 — int() truncation quirk (main.py:106)."""
    pts = np.array([[-20.1, -20.1, 1.0], [-20.3, 0.0, 1.0]])
    expect = ref.compute_bev_grid(pts, (0.2, 0.2), (-20, 20), (-20, 20), h_max=2.0)
    assert expect[0, 0] > 0  # first point binned at (0, 0)
    padded, valid = pad_points(pts, 8, dtype=np.float64)
    got = np.asarray(bev_ops.compute_bev_grid(
        jnp.asarray(padded), jnp.asarray(valid), (200, 200), (-20.0, 20.0),
        (-20.0, 20.0), (0.2, 0.2), h_max=2.0))
    np.testing.assert_array_equal(got, expect)


def test_bev_empty_grid_is_zero():
    padded, valid = pad_points(np.zeros((0, 3)), 16)
    got = np.asarray(bev_ops.compute_bev_grid(
        jnp.asarray(padded), jnp.asarray(valid), (200, 200), (-20.0, 20.0),
        (-20.0, 20.0), (0.2, 0.2), h_max=2.0))
    assert (got == 0).all()
