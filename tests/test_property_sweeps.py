"""Randomized parity sweeps: many seeds against the scipy/sklearn oracles for the
exactness-critical kernels (cheap insurance beyond the targeted tests)."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment as scipy_lsa
from sklearn.cluster import DBSCAN

from datmo_using_optical_flow.ops.dbscan import dbscan
from datmo_using_optical_flow.ops.hungarian import linear_sum_assignment


@pytest.mark.parametrize("seed", range(20))
def test_hungarian_random_rectangular(seed):
    rng = np.random.default_rng(seed)
    r, c = int(rng.integers(1, 24)), int(rng.integers(1, 24))
    cost = rng.uniform(0, 50, size=(r, c)).astype(np.float32)
    col4row, valid = linear_sum_assignment(jnp.asarray(cost))
    ri, ci = scipy_lsa(cost)
    got = sum(cost[i, int(col4row[i])] for i in range(r) if valid[i])
    assert int(np.asarray(valid).sum()) == min(r, c)
    assert abs(got - cost[ri, ci].sum()) < 1e-3, (seed, r, c)
    # assigned columns are distinct
    cols = [int(col4row[i]) for i in range(r) if valid[i]]
    assert len(set(cols)) == len(cols)


@pytest.mark.parametrize("seed", range(8))
def test_dbscan_random_clouds(seed):
    rng = np.random.default_rng(100 + seed)
    n_clusters = int(rng.integers(1, 5))
    centers = rng.uniform(-20, 20, size=(n_clusters, 2))
    parts = [c + rng.normal(scale=rng.uniform(0.1, 0.5), size=(int(rng.integers(20, 80)), 2))
             for c in centers]
    parts.append(rng.uniform(-25, 25, size=(int(rng.integers(5, 30)), 2)))
    pts = np.concatenate(parts).astype(np.float32)
    order = rng.permutation(len(pts))
    pts = pts[order]
    eps = float(rng.uniform(0.4, 1.5))
    ms = int(rng.integers(2, 8))

    sk = DBSCAN(eps=eps, min_samples=ms).fit(pts).labels_

    cap = int(np.ceil(len(pts) / 512) * 512)
    feats = np.full((cap, 2), 3e18, np.float32)
    feats[:len(pts)] = pts
    valid = np.zeros(cap, bool)
    valid[:len(pts)] = True
    ours, core = dbscan(jnp.asarray(feats), jnp.asarray(valid), eps, ms)
    ours = np.asarray(ours)[:len(pts)]

    # identical noise sets; identical partitions on core points (border points
    # adjacent to two clusters may legally differ — exclude them)
    np.testing.assert_array_equal(ours == -1, sk == -1)
    core = np.asarray(core)[:len(pts)]
    mapping = {}
    for a, b in zip(ours[core], sk[core]):
        assert mapping.setdefault(int(a), int(b)) == int(b), seed
    assert len(set(mapping.values())) == len(mapping)
