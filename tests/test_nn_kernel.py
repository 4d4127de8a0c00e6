"""The pruned NN kernel (Pallas, Triton route; interpret mode on the CPU) and
the plain XLA sweep against f64 cKDTree, plus the wrapper's padding,
geometry and backend choice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial import cKDTree

from datmo_using_optical_flow.ops import nn_pallas
from datmo_using_optical_flow.ops.nn import nearest_neighbors_scan, sort_order


def _cloud(rng, n, extent=20.0):
    return rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)


def _query(src, tgt, mask, **kw):
    """Kernel on a Morton-sorted source, results back in source order."""
    order = np.asarray(sort_order(jnp.asarray(src), jnp.ones(len(src), bool)))
    index = nn_pallas.build_target_index(jnp.asarray(tgt), jnp.asarray(mask))
    out = nn_pallas.nearest_neighbors_pallas(jnp.asarray(src[order]), index, **kw)
    inv = np.argsort(order)
    return [np.asarray(x)[inv] for x in out]


def _truth(src, tgt, mask, k=2):
    valid = np.nonzero(mask)[0]
    dist, kidx = cKDTree(tgt[valid].astype(np.float64)).query(
        src.astype(np.float64), k=k)
    return dist ** 2, valid[kidx]


@pytest.mark.parametrize("n,m", [(1000, 3000), (37, 129), (300, 64), (513, 1000),
                                 (64, 5)])
def test_kernel_matches_kdtree(n, m):
    """Unaligned N and M, a single tile, fewer targets than a tile."""
    rng = np.random.default_rng(n + m)
    src, tgt = _cloud(rng, n), _cloud(rng, m)
    mask = np.ones(m, bool)
    mask[-(m // 10):] = m < 10  # invalid tail rows when there are enough
    idx, d2, lo, d2nd, crd = _query(src, tgt, mask)
    true2, kidx = _truth(src, tgt, mask)
    np.testing.assert_array_equal(idx, kidx[:, 0])
    np.testing.assert_allclose(d2, true2[:, 0], rtol=2e-6, atol=1e-9)
    np.testing.assert_array_equal(crd, tgt[idx])
    assert (lo <= true2[:, 0]).all()
    assert (d2nd <= true2[:, 1]).all()


def test_kernel_sentinel_rows_and_padding():
    """1e9-sentinel source rows and invalid targets inside the cloud leave
    every valid row's answer unchanged."""
    rng = np.random.default_rng(1)
    src, tgt = _cloud(rng, 700), _cloud(rng, 900)
    mask = rng.uniform(size=900) < 0.8
    src_pad = np.concatenate([src, np.full((90, 3), 1e9, np.float32)])
    idx, d2, lo, _, _ = _query(src_pad, tgt, mask)
    true2, kidx = _truth(src, tgt, mask)
    np.testing.assert_array_equal(idx[:700], kidx[:, 0])
    assert (lo[:700] <= true2[:, 0]).all()


def test_kernel_empty_target():
    rng = np.random.default_rng(2)
    idx, d2, lo, d2nd, crd = _query(_cloud(rng, 100), _cloud(rng, 200),
                                    np.zeros(200, bool))
    assert (idx == 0).all() and np.isinf(d2).all() and np.isinf(lo).all()
    assert (crd == 0).all()


def test_kernel_forced_ties_lowest_index():
    """Integer grids make exact distance ties across tiles: the kernel, the
    XLA sweep and a numpy brute force all pick the lowest original index."""
    rng = np.random.default_rng(3)
    src = rng.integers(-4, 5, size=(300, 3)).astype(np.float32) + 0.5
    tgt = rng.integers(-4, 5, size=(1100, 3)).astype(np.float32)
    mask = np.ones(1100, bool)
    idx = _query(src, tgt, mask)[0]
    sidx, _ = nearest_neighbors_scan(jnp.asarray(src), jnp.asarray(tgt),
                                     jnp.asarray(mask))
    brute = np.argmin(((src[:, None, :] - tgt[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(idx, brute)
    np.testing.assert_array_equal(np.asarray(sidx), brute)


@pytest.mark.parametrize("cap", [0.3, 1.0, 4.0])
def test_kernel_cap_dichotomy(cap):
    """Rows whose true NN is inside the cap are exact; the others report
    d2 >= cap^2; every bound stays sound and the lower bound <= cap^2."""
    rng = np.random.default_rng(4)
    src, tgt = _cloud(rng, 800), _cloud(rng, 2000)
    mask = np.ones(2000, bool)
    cap2 = np.float32(cap * cap)
    idx, d2, lo, d2nd, _ = _query(src, tgt, mask, cap2=jnp.float32(cap2))
    true2, kidx = _truth(src, tgt, mask)
    below = true2[:, 0] < cap2 * (1 - 1e-4)
    assert below.any() and (~below).any()
    np.testing.assert_array_equal(idx[below], kidx[below, 0])
    assert (d2[~below] >= cap2 * (1 - 1e-4)).all()
    assert (lo <= true2[:, 0]).all() and (lo <= cap2).all()
    assert (d2nd <= true2[:, 1]).all()


@pytest.mark.parametrize("n,m", [(500, 1500), (33, 2049)])
def test_scan_matches_kdtree(n, m):
    rng = np.random.default_rng(5 + n)
    src, tgt = _cloud(rng, n), _cloud(rng, m)
    mask = rng.uniform(size=m) < 0.9
    idx, d2 = nearest_neighbors_scan(jnp.asarray(src), jnp.asarray(tgt),
                                     jnp.asarray(mask))
    true2, kidx = _truth(src, tgt, mask, k=1)
    np.testing.assert_array_equal(np.asarray(idx), kidx)
    np.testing.assert_allclose(np.asarray(d2), true2, rtol=2e-6, atol=1e-9)


@pytest.mark.parametrize("block,warps", [(32, 4), (128, 8)])
def test_kernel_block_geometry(monkeypatch, block, warps):
    """Other block sizes give the same winners and distances."""
    rng = np.random.default_rng(6)
    src, tgt = _cloud(rng, 600), _cloud(rng, 1500)
    mask = np.ones(1500, bool)
    ref = _query(src, tgt, mask)
    monkeypatch.setattr(nn_pallas, "_SRC_BLOCK", block)
    monkeypatch.setattr(nn_pallas, "_NUM_WARPS", warps)
    got = _query(src, tgt, mask)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_kernel_vmapped_matches_per_cloud():
    """Batched (stream-parallel GMFA vmaps the step) == one call per cloud."""
    rng = np.random.default_rng(7)
    srcs = np.stack([_cloud(rng, 200) for _ in range(2)])
    tgts = np.stack([_cloud(rng, 500) for _ in range(2)])
    mask = jnp.ones(500, bool)

    def one(s, t):
        return nn_pallas.nearest_neighbors_pallas(
            s, nn_pallas.build_target_index(t, mask))[:2]

    bi, bd = jax.vmap(one)(jnp.asarray(srcs), jnp.asarray(tgts))
    for k in range(2):
        i, d = one(jnp.asarray(srcs[k]), jnp.asarray(tgts[k]))
        np.testing.assert_array_equal(np.asarray(bi[k]), np.asarray(i))
        np.testing.assert_array_equal(np.asarray(bd[k]), np.asarray(d))


@pytest.mark.parametrize("backend,expect", [("cpu", True), ("gpu", False),
                                            ("rocm", None)])
def test_kernel_backend_choice(monkeypatch, backend, expect):
    """Interpreted on the CPU, compiled on the GPU, an error elsewhere —
    never a quiet fallback."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expect is None:
        with pytest.raises(RuntimeError, match="gpu"):
            nn_pallas._interpret()
    else:
        assert nn_pallas._interpret() is expect
