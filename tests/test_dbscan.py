"""On-device DBSCAN parity vs sklearn (reference call sites
``Optical_flow/main.py:257`` and ``GMFA/GMFA.py:62``)."""

import jax.numpy as jnp
import numpy as np
import pytest
from sklearn.cluster import DBSCAN

from datmo_using_optical_flow.ops.dbscan import dbscan, dbscan_velocity_grid
from datmo_using_optical_flow.oracle import reference_a as ref


def _partition_equal(a, b):
    """Same clustering partition (ids may be permuted), same noise set."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a == -1, b == -1)
    mapping = {}
    for x, y in zip(a, b):
        if x == -1:
            continue
        assert mapping.setdefault(x, y) == y, f"cluster {x} maps to {mapping[x]} and {y}"
    assert len(set(mapping.values())) == len(mapping)


def _run(features, eps, min_samples, capacity=None):
    n = features.shape[0]
    cap = capacity or int(np.ceil(n / 512) * 512)
    feats = np.full((cap, features.shape[1]), 3e18, np.float32)
    feats[:n] = features
    valid = np.zeros(cap, bool)
    valid[:n] = True
    labels, core = dbscan(jnp.asarray(feats), jnp.asarray(valid), eps, min_samples)
    return np.asarray(labels)[:n], np.asarray(core)[:n]


@pytest.mark.parametrize("seed,eps,min_samples", [(0, 0.5, 5), (1, 0.3, 3), (2, 1.0, 10)])
def test_dbscan_matches_sklearn_blobs(seed, eps, min_samples):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(4, 3))
    pts = np.concatenate([c + rng.normal(scale=0.2, size=(80, 3)) for c in centers]
                         + [rng.uniform(-12, 12, size=(40, 3))]).astype(np.float32)
    sk = DBSCAN(eps=eps, min_samples=min_samples).fit(pts)
    ours, core = _run(pts, eps, min_samples)
    _partition_equal(ours, sk.labels_)
    # core mask parity
    sk_core = np.zeros(len(pts), bool)
    sk_core[sk.core_sample_indices_] = True
    np.testing.assert_array_equal(core, sk_core)


def test_dbscan_label_ids_match_sklearn_order():
    """Cluster ids ordered by first core index == sklearn's id assignment."""
    rng = np.random.default_rng(3)
    pts = np.concatenate([
        np.array([[0.0, 0.0]]) + rng.normal(scale=0.05, size=(30, 2)),
        np.array([[5.0, 5.0]]) + rng.normal(scale=0.05, size=(30, 2)),
        np.array([[-5.0, 3.0]]) + rng.normal(scale=0.05, size=(30, 2)),
    ]).astype(np.float32)
    order = rng.permutation(len(pts))
    pts = pts[order]
    sk = DBSCAN(eps=0.3, min_samples=4).fit(pts)
    ours, _ = _run(pts, 0.3, 4)
    np.testing.assert_array_equal(ours, sk.labels_)


def test_dbscan_all_noise():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-100, 100, size=(50, 3)).astype(np.float32)
    ours, core = _run(pts, 0.01, 3)
    assert (ours == -1).all() and not core.any()


def test_dbscan_chain_cluster():
    """A long chain (worst case for naive propagation; pointer doubling handles it)."""
    n = 400
    pts = np.stack([np.arange(n) * 0.5, np.zeros(n)], axis=1).astype(np.float32)
    sk = DBSCAN(eps=0.6, min_samples=2).fit(pts)
    ours, _ = _run(pts, 0.6, 2)
    _partition_equal(ours, sk.labels_)
    assert (ours == 0).all()


def test_dbscan_tiled_path_matches_sklearn():
    """Padded size above _FULL_MATRIX_MAX exercises the tiled-scan path."""
    rng = np.random.default_rng(11)
    centers = rng.uniform(-10, 10, size=(3, 3))
    pts = np.concatenate([c + rng.normal(scale=0.2, size=(60, 3)) for c in centers]
                         + [rng.uniform(-12, 12, size=(30, 3))]).astype(np.float32)
    sk = DBSCAN(eps=0.5, min_samples=5).fit(pts)
    ours, core = _run(pts, 0.5, 5, capacity=8704)  # > _FULL_MATRIX_MAX
    _partition_equal(ours, sk.labels_)
    sk_core = np.zeros(len(pts), bool)
    sk_core[sk.core_sample_indices_] = True
    np.testing.assert_array_equal(core, sk_core)


def test_dbscan_shared_border_point():
    """Adversarial case: a border point reachable from the cores of TWO clusters.

    eps=1.0, min_samples=4.  Cluster A spans x in [0, 1], cluster B spans
    x in [3, 4]; P at x=2.0 is within eps of exactly one core of each (neighbor
    count 3 < 4, so P is border, and it bridges nothing).  sklearn expands
    clusters fully in ascending id order, so P always lands in the lower-id
    cluster — which is exactly our min-root attachment rule.  Assert *exact*
    label equality (not just partition) under several point orderings,
    including ones where B's or P's indices come first.
    """
    A = [0.0, 0.33, 0.66, 1.0]
    B = [3.0, 3.33, 3.66, 4.0]
    base = np.array(A + B + [2.0], np.float32)[:, None]
    orders = [
        np.arange(9),                                # A first
        np.array([4, 5, 6, 7, 0, 1, 2, 3, 8]),       # B first
        np.array([8, 0, 1, 2, 3, 4, 5, 6, 7]),       # P first
        np.array([3, 7, 8, 0, 4, 1, 5, 2, 6]),       # interleaved
    ]
    for order in orders:
        pts = base[order]
        sk = DBSCAN(eps=1.0, min_samples=4).fit(pts)
        ours, core = _run(pts, 1.0, 4)
        p_pos = list(order).index(8)
        assert not core[p_pos], "P must be a border point, not core"
        np.testing.assert_array_equal(ours, sk.labels_)
        # the partition checker must reject the opposite assignment of P
        flipped = ours.copy()
        flipped[p_pos] = 1 - flipped[p_pos]
        with pytest.raises(AssertionError):
            _partition_equal(flipped, sk.labels_)


def test_dbscan_velocity_grid_matches_reference_path():
    """Pipeline-A form: features [row, col, vx, vy] on masked cells (main.py:231-259)."""
    rng = np.random.default_rng(5)
    h, w = 40, 40
    vx = np.zeros((h, w), np.float32)
    vy = np.zeros((h, w), np.float32)
    # two moving blobs
    vx[5:10, 5:10] = 1.0 + rng.normal(scale=0.01, size=(5, 5))
    vy[5:10, 5:10] = 0.5
    vx[25:30, 28:33] = -0.8
    vy[25:30, 28:33] = 0.3
    mag = np.sqrt(vx**2 + vy**2)
    valid = mag > 0.1
    exp_labels, exp_idx = ref.dbscan_clustering(vx, vy, valid, eps=5.0, min_samples=3)

    labels, rows, cols, cmask, count = dbscan_velocity_grid(
        jnp.asarray(vx), jnp.asarray(vy), jnp.asarray(valid), 5.0, 3, (h, w), 512)
    n = int(count)
    assert n == exp_idx.shape[0]
    np.testing.assert_array_equal(np.asarray(rows)[:n], exp_idx[:, 0])
    np.testing.assert_array_equal(np.asarray(cols)[:n], exp_idx[:, 1])
    np.testing.assert_array_equal(np.asarray(labels)[:n], exp_labels)
