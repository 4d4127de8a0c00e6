"""Unit tests for the GMFA compute kernels: 1-NN, ICP, Hungarian, SOM
(reference native call sites: FLANN loops GMFA.py:84-91/109-119, Open3D ICP :305,
scipy Hungarian :204, SOM loop :134-142)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment as scipy_lsa
from scipy.spatial import cKDTree

from datmo_using_optical_flow.ops.hungarian import linear_sum_assignment, solve_square
from datmo_using_optical_flow.ops.icp import registration_icp, transform_points
from datmo_using_optical_flow.ops.nn import nearest_neighbors
from datmo_using_optical_flow.ops.som import update_som
from datmo_using_optical_flow.oracle import reference_b as refb


# ------------------------------------------------------------------ 1-NN

def test_nearest_neighbors_matches_kdtree():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(700, 3)).astype(np.float32)
    tgt = rng.normal(size=(900, 3)).astype(np.float32)
    tgt_pad = np.full((1024, 3), 1e9, np.float32)
    tgt_pad[:900] = tgt
    mask = np.zeros(1024, bool)
    mask[:900] = True
    idx, d2 = nearest_neighbors(jnp.asarray(src), jnp.asarray(tgt_pad), jnp.asarray(mask))
    dist, kidx = cKDTree(tgt).query(src, k=1)
    np.testing.assert_array_equal(np.asarray(idx), kidx)
    np.testing.assert_allclose(np.sqrt(np.asarray(d2)), dist, rtol=1e-4, atol=1e-5)


def test_nearest_neighbors_empty_target():
    src = jnp.zeros((8, 3))
    tgt = jnp.full((512, 3), 1e9)
    idx, d2 = nearest_neighbors(src, tgt, jnp.zeros(512, bool))
    assert np.isinf(np.asarray(d2)).all()


def test_nearest_neighbors_scan_path_matches_pallas():
    """The large-target XLA fallback == the Pallas kernel (incl. tie order)."""
    from datmo_using_optical_flow.ops.nn import nearest_neighbors_scan

    rng = np.random.default_rng(3)
    src = rng.normal(size=(300, 3)).astype(np.float32)
    # quantized coords force exact distance ties across tiles
    tgt = (rng.integers(-3, 4, size=(1100, 3))).astype(np.float32)
    tgt_pad = np.full((1536, 3), 1e9, np.float32)
    tgt_pad[:1100] = tgt
    mask = np.zeros(1536, bool)
    mask[:1100] = True
    i1, d1 = nearest_neighbors(jnp.asarray(src), jnp.asarray(tgt_pad), jnp.asarray(mask))
    i2, d2 = nearest_neighbors_scan(jnp.asarray(src), jnp.asarray(tgt_pad),
                                    jnp.asarray(mask))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-4)


def test_nearest_neighbors_active_matches_full():
    """Active-subset 1-NN (the cached-ICP hot path) == the full query on active
    rows, idx=0/+inf on inactive ones — including compaction round-trip."""
    from datmo_using_optical_flow.ops.nn import nearest_neighbors_active

    rng = np.random.default_rng(7)
    src = rng.normal(size=(500, 3)).astype(np.float32)
    tgt = rng.normal(size=(4096, 3)).astype(np.float32)  # >= pallas threshold
    mask = np.ones(4096, bool)
    mask[4000:] = False
    # second-nearest oracle among the VALID targets (certificate soundness)
    d2nd_true, _ = cKDTree(tgt[:4000]).query(src, k=2)
    d2nd_true = (d2nd_true[:, 1] ** 2).astype(np.float32)
    for frac in (0.0, 0.3, 1.0):
        active = rng.uniform(size=500) < frac
        ia, da, la, b2a, ca = map(np.asarray, nearest_neighbors_active(
            jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
            jnp.asarray(active)))
        i0, d0 = nearest_neighbors(jnp.asarray(src), jnp.asarray(tgt),
                                   jnp.asarray(mask))
        i0, d0 = map(np.asarray, (i0, d0))
        np.testing.assert_array_equal(ia[active], i0[active])
        # winner coords are the indexed target rows, exactly
        np.testing.assert_array_equal(ca[active], tgt[ia[active]])
        # interpret mode re-fuses the kernel body into each surrounding
        # graph, which can reassociate f32 math by ~1 ulp
        np.testing.assert_allclose(da[active], d0[active], rtol=3e-5, atol=1e-7)
        assert (la[active] <= da[active] + 1e-7).all()  # bound is sound
        # second-nearest bound: sound vs f64 KDTree truth, zero when inactive
        ok = b2a[active] <= d2nd_true[active] + 1e-5 * (1.0 + d2nd_true[active])
        assert ok.all()
        assert (b2a[~active] == 0.0).all()
        assert (ia[~active] == 0).all() and np.isinf(da[~active]).all()


def test_nearest_neighbors_active_cap_matches_uncapped():
    """active_cap (capped-prefix kernel + lax.cond fallback) is bit-identical
    to the uncapped call on active rows — both when the active count fits the
    cap (small branch) and when it overflows (full-width fallback)."""
    from datmo_using_optical_flow.ops.nn import nearest_neighbors_active

    rng = np.random.default_rng(11)
    src = rng.normal(size=(500, 3)).astype(np.float32)
    tgt = rng.normal(size=(4096, 3)).astype(np.float32)
    mask = np.ones(4096, bool)
    for frac in (0.2, 0.9):  # ~100 actives (<= 256 cap) / ~450 (> cap)
        active = rng.uniform(size=500) < frac
        ref = [np.asarray(x) for x in nearest_neighbors_active(
            jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
            jnp.asarray(active))]
        cap = [np.asarray(x) for x in nearest_neighbors_active(
            jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
            jnp.asarray(active), active_cap=256)]
        for r, c in zip(ref, cap):
            np.testing.assert_array_equal(r[active], c[active])


# ------------------------------------------------------------------ ICP

def _rigid(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    m[:3, 3] = t
    return m


def test_icp_recovers_rigid_transform():
    rng = np.random.default_rng(1)
    cloud = rng.uniform(-5, 5, size=(2000, 3)).astype(np.float32)
    true = _rigid(0.05, [0.2, -0.1, 0.05])
    target = cloud @ true[:3, :3].T + true[:3, 3]
    pad = 2048
    src = np.full((pad, 3), 1e9, np.float32)
    src[:2000] = cloud
    dst = np.full((pad, 3), 1e9, np.float32)
    dst[:2000] = target
    m = np.zeros(pad, bool)
    m[:2000] = True
    res = registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                           jnp.asarray(m), threshold=1.0, max_iterations=50)
    np.testing.assert_allclose(np.asarray(res.transformation), true, atol=2e-3)
    assert float(res.fitness) > 0.99


def test_icp_matches_numpy_oracle():
    rng = np.random.default_rng(2)
    cloud = rng.uniform(-5, 5, size=(1500, 3)).astype(np.float32)
    moved = cloud @ _rigid(0.02, [0.05, 0.02, 0.0])[:3, :3].T + [0.05, 0.02, 0.0]
    moved = (moved + rng.normal(scale=0.005, size=moved.shape)).astype(np.float32)
    oracle_t = refb.icp_point_to_point(cloud.astype(np.float64),
                                       moved.astype(np.float64), threshold=0.5)
    pad = 1536
    src = np.full((pad, 3), 1e9, np.float32)
    src[:1500] = cloud
    dst = np.full((pad, 3), 1e9, np.float32)
    dst[:1500] = moved
    m = np.zeros(pad, bool)
    m[:1500] = True
    res = registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                           jnp.asarray(m), threshold=0.5)
    np.testing.assert_allclose(np.asarray(res.transformation), oracle_t, atol=5e-3)


def test_icp_coarse_matches_full():
    """The coarse-to-fine schedule (stride-subsampled first phase, then the
    full-resolution loop) reaches the same fixed point as the single-phase
    full-resolution loop — only the iterate path differs."""
    rng = np.random.default_rng(5)
    for seed, yaw, t in ((0, 0.02, [0.1, -0.05, 0.02]),
                         (1, -0.04, [-0.2, 0.1, 0.0])):
        rng = np.random.default_rng(seed)
        cloud = rng.uniform(-15, 15, size=(4096, 3)).astype(np.float32)
        true = _rigid(yaw, t)
        target = (cloud @ true[:3, :3].T + true[:3, 3]
                  + rng.normal(scale=0.02, size=cloud.shape)).astype(np.float32)
        m = np.ones(4096, bool)
        ref = registration_icp(jnp.asarray(cloud), jnp.asarray(m),
                               jnp.asarray(target), jnp.asarray(m),
                               threshold=0.5, coarse_stride=1)
        got = registration_icp(jnp.asarray(cloud), jnp.asarray(m),
                               jnp.asarray(target), jnp.asarray(m),
                               threshold=0.5, coarse_stride=4)
        np.testing.assert_allclose(np.asarray(got.transformation),
                                   np.asarray(ref.transformation), atol=2e-4)
        np.testing.assert_allclose(np.asarray(got.fitness),
                                   np.asarray(ref.fitness), atol=1e-3)
        np.testing.assert_allclose(np.asarray(got.inlier_rmse),
                                   np.asarray(ref.inlier_rmse), atol=1e-3)


def test_icp_cached_matches_uncached():
    """Incremental correspondence search (cached=True) is bit-identical to the
    full re-query path — the Lipschitz exclusion bound never drops a point that
    the full path would gate in (GMFA.py:297-309 semantics preserved)."""
    rng = np.random.default_rng(11)
    # dense cloud + tight threshold: most points sit far outside the
    # correspondence shell (the case the cache accelerates), others cross the
    # shell as the transform converges
    cloud = rng.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
    true = _rigid(0.01, [0.05, -0.03, 0.01])
    target = (cloud @ true[:3, :3].T + true[:3, 3]
              + rng.normal(scale=0.01, size=cloud.shape)).astype(np.float32)
    pad = 4096  # >= pallas-eligibility floor so the active kernel runs
    src = np.full((pad, 3), 1e9, np.float32)
    src[:3000] = cloud
    dst = np.full((pad, 3), 1e9, np.float32)
    dst[:3000] = target
    m = np.zeros(pad, bool)
    m[:3000] = True
    for thr in (0.05, 0.5):
        ref = registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                               jnp.asarray(m), threshold=thr, cached=False)
        for sweep in ("compact", "inplace"):
            got = registration_icp(jnp.asarray(src), jnp.asarray(m),
                                   jnp.asarray(dst), jnp.asarray(m),
                                   threshold=thr, cached=True, sweep=sweep)
            # the exclusion bound is conservative, so the trajectories agree;
            # the cached and uncached paths are different programs (kernel vs
            # XLA sweep), so compare at tight float tolerance
            np.testing.assert_allclose(np.asarray(ref.transformation),
                                       np.asarray(got.transformation),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(np.asarray(ref.fitness),
                                       np.asarray(got.fitness), rtol=1e-6)
            np.testing.assert_allclose(np.asarray(ref.inlier_rmse),
                                       np.asarray(got.inlier_rmse), rtol=1e-4)


def test_icp_active_cap_matches_uncapped():
    """The capped-prefix active sweep (active_cap + lax.cond fallback) yields
    the same ICP trajectory as the uncapped compact sweep: early iterations
    overflow a 256-row cap (full-width branch), converged iterations fit it
    (prefix branch) — both must agree with active_cap=None."""
    rng = np.random.default_rng(23)
    cloud = rng.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
    true = _rigid(0.012, [0.06, -0.05, 0.015])
    target = (cloud @ true[:3, :3].T + true[:3, 3]
              + rng.normal(scale=0.01, size=cloud.shape)).astype(np.float32)
    pad = 4096
    src = np.full((pad, 3), 1e9, np.float32)
    src[:3000] = cloud
    dst = np.full((pad, 3), 1e9, np.float32)
    dst[:3000] = target
    m = np.zeros(pad, bool)
    m[:3000] = True
    for thr in (0.05, 0.3):
        ref = registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                               jnp.asarray(m), threshold=thr, cached=True,
                               active_cap=None)
        got = registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                               jnp.asarray(m), threshold=thr, cached=True,
                               active_cap=256)
        assert int(ref.iterations) == int(got.iterations)
        np.testing.assert_allclose(np.asarray(ref.transformation),
                                   np.asarray(got.transformation),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.asarray(ref.fitness),
                                   np.asarray(got.fitness), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(ref.inlier_rmse),
                                   np.asarray(got.inlier_rmse), rtol=1e-4)


def test_icp_early_exit_criteria_fire():
    """VERDICT r2 item 7: the convergence-criteria path, not just GMFA's quirk
    regime.  At a realistic threshold (0.5 m) on a well-posed registration the
    relative-fitness/rmse criteria fire well before max_iterations; the
    while_loop must stop early with the oracle's transform, and its iteration
    count must track ``oracle/reference_b.icp_point_to_point``'s evaluation
    count (the loop phasings differ by at most one evaluation: the oracle
    checks before applying the update, ours applies it in the same body)."""
    for seed, yaw, t, noise in ((3, 0.03, [0.15, -0.1, 0.05], 0.0),
                                (4, -0.02, [0.05, 0.2, 0.0], 0.005)):
        rng = np.random.default_rng(seed)
        cloud = rng.uniform(-8, 8, size=(2000, 3)).astype(np.float32)
        true = _rigid(yaw, t)
        target = (cloud @ true[:3, :3].T + true[:3, 3]
                  + rng.normal(scale=noise, size=cloud.shape)).astype(np.float32)
        oracle_t, oracle_iters = refb.icp_point_to_point(
            cloud.astype(np.float64), target.astype(np.float64), threshold=0.5,
            max_iterations=30, return_iterations=True)
        pad = 2048
        src = np.full((pad, 3), 1e9, np.float32)
        src[:2000] = cloud
        dst = np.full((pad, 3), 1e9, np.float32)
        dst[:2000] = target
        m = np.zeros(pad, bool)
        m[:2000] = True
        res = registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                               jnp.asarray(m), threshold=0.5, max_iterations=30)
        it = int(res.iterations)
        assert oracle_iters < 30, oracle_iters       # the regime actually fires
        assert it < 30, it                           # ours early-exits too
        assert abs(it - oracle_iters) <= 1, (it, oracle_iters)
        np.testing.assert_allclose(np.asarray(res.transformation), oracle_t,
                                   atol=5e-3)
        assert float(res.fitness) > 0.99


def test_transform_points():
    t = _rigid(0.3, [1, 2, 3])
    pts = np.random.default_rng(3).normal(size=(10, 3))
    got = np.asarray(transform_points(jnp.asarray(pts), jnp.asarray(t)))
    np.testing.assert_allclose(got, pts @ t[:3, :3].T + t[:3, 3], rtol=1e-5, atol=1e-5)


def test_nearest_neighbors_active_inplace_matches_full():
    """The no-compaction subset query (per-block skipping in Morton order)
    matches the full sweep on active rows, idx=0/+inf on inactive ones, and
    tolerates invalid 1e9-coord rows inside mixed blocks."""
    from datmo_using_optical_flow.ops import nn_pallas
    from datmo_using_optical_flow.ops.nn import nearest_neighbors_active_inplace

    rng = np.random.default_rng(29)
    n = 1024
    src = rng.uniform(-15, 15, size=(n, 3)).astype(np.float32)
    src[990:] = 1e9  # invalid padding rows (sort last in Morton order)
    tgt = rng.uniform(-15, 15, size=(4096, 3)).astype(np.float32)
    mask = np.ones(4096, bool)
    index = nn_pallas.build_target_index(jnp.asarray(tgt), jnp.asarray(mask))
    order = np.asarray(jnp.argsort(nn_pallas._morton_keys(jnp.asarray(src)),
                                   stable=True))
    src_s = src[order]
    valid_s = (np.abs(src_s) < 1e8).all(axis=1)
    i0, _, _, _, _ = map(np.asarray,
                         nn_pallas.nearest_neighbors_pallas(jnp.asarray(src_s),
                                                            index))
    # the wrapper recomputes d2 by direct subtraction at the winner
    d0 = ((src_s - tgt[i0]) ** 2).sum(axis=1)
    # second-nearest bound oracle: distance to the true 2nd neighbor
    d2nd_true, _ = cKDTree(tgt).query(src_s, k=2)
    d2nd_true = (d2nd_true[:, 1] ** 2).astype(np.float32)
    for frac in (0.0, 0.4, 1.0):
        active = valid_s & (rng.uniform(size=n) < frac)
        ia, da, la, b2a, ca = map(np.asarray, nearest_neighbors_active_inplace(
            jnp.asarray(src_s), jnp.asarray(tgt), jnp.asarray(mask),
            jnp.asarray(active), index))
        # winner coords match the indexed target rows exactly
        np.testing.assert_array_equal(ca[active], tgt[ia[active]])
        np.testing.assert_array_equal(ia[active], i0[active])
        np.testing.assert_allclose(da[active], d0[active], rtol=3e-5, atol=1e-7)
        assert (la[active] <= da[active] + 1e-7).all()
        assert (ia[~active] == 0).all() and np.isinf(da[~active]).all()
        # the second-nearest bound is sound (vs f64 KDTree truth) and never
        # certifies on inactive rows
        ok = b2a[active] <= d2nd_true[active] + 1e-5 * (1.0 + d2nd_true[active])
        assert ok.all()
        assert (b2a[~active] == 0.0).all()


def test_block_first_fill_first_active_representative():
    """The block fill's representative must be a KEPT row: a sentinel/garbage
    representative would inflate the block's bounding box and defeat the
    tile pruning."""
    from datmo_using_optical_flow.ops import nn_pallas

    b = nn_pallas._SRC_BLOCK
    rng = np.random.default_rng(7)
    src = rng.uniform(-10, 10, size=(2 * b, 3)).astype(np.float32)
    keep = np.ones(2 * b, bool)
    # block 0: rows 0..4 are invalid garbage (e.g. mid-cloud sentinel coords)
    keep[:5] = False
    src[:5] = 0.0
    # block 1: fully inactive — representative irrelevant (sweep skipped)
    keep[b:] = False
    filled = np.asarray(nn_pallas.block_first_fill(
        jnp.asarray(src), jnp.asarray(keep)))
    # inactive rows of a mixed block take the first ACTIVE row's coords
    np.testing.assert_array_equal(filled[:5], np.broadcast_to(src[5], (5, 3)))
    # active rows are untouched
    np.testing.assert_array_equal(filled[5:b], src[5:b])


def test_icp_cached_midcloud_padding_matches_uncached():
    """Invalid rows with mid-range coords (zeros inside the cloud's bounding
    box) would sort MID-CLOUD under an unmasked Morton key and land as block
    representatives; registration_icp's internal order must mask them to the
    end.  The cached path must still match the exact
    full-requery path at GMFA's tight gate."""
    rng = np.random.default_rng(17)
    cloud = rng.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
    true = _rigid(0.01, [0.04, -0.02, 0.01])
    target = (cloud @ true[:3, :3].T + true[:3, 3]
              + rng.normal(scale=0.005, size=cloud.shape)).astype(np.float32)
    pad = 4096
    src = np.zeros((pad, 3), np.float32)      # padding at the ORIGIN, not 1e9
    src[:3000] = cloud
    dst = np.zeros((pad, 3), np.float32)
    dst[:3000] = target
    m = np.zeros(pad, bool)
    m[:3000] = True
    for thr in (0.02, 0.3):
        ref = registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                               jnp.asarray(m), threshold=thr, cached=False)
        got = registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                               jnp.asarray(m), threshold=thr, cached=True)
        np.testing.assert_allclose(np.asarray(ref.transformation),
                                   np.asarray(got.transformation),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(ref.fitness), np.asarray(got.fitness),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(ref.inlier_rmse),
                                   np.asarray(got.inlier_rmse), rtol=1e-4)


def test_capped_sweep_dichotomy():
    """Capped-search contract of the NN kernel (VERDICT r2 item 3): every row
    either matches the uncapped sweep exactly (when its true NN d2 < cap2) or
    certifies d2 >= cap2; the lower bound stays sound and <= the returned d2."""
    from datmo_using_optical_flow.ops import nn_pallas

    rng = np.random.default_rng(13)
    src = rng.uniform(-20, 20, size=(2000, 3)).astype(np.float32)
    tgt = rng.uniform(-20, 20, size=(4096, 3)).astype(np.float32)
    mask = np.ones(4096, bool)
    mask[4000:] = False
    index = nn_pallas.build_target_index(jnp.asarray(tgt), jnp.asarray(mask))
    order = np.asarray(jnp.argsort(nn_pallas._morton_keys(jnp.asarray(src)),
                                   stable=True))
    src_s = jnp.asarray(src[order])
    i0, d0, l0, _, _ = map(np.asarray,
                           nn_pallas.nearest_neighbors_pallas(src_s, index))
    dist, _ = cKDTree(tgt[:4000]).query(src[order], k=1)
    true_d2 = (dist * dist).astype(np.float32)
    d2nd_cap, _ = cKDTree(tgt[:4000]).query(np.asarray(src_s), k=2)
    d2nd_cap = (d2nd_cap[:, 1] ** 2).astype(np.float32)
    for cap in (0.5, 2.0, 8.0):
        cap2 = np.float32(cap * cap)
        ic, dc, lc, b2c, _ = map(np.asarray, nn_pallas.nearest_neighbors_pallas(
            src_s, index, cap2=jnp.float32(cap2)))
        below = d0 < cap2 * (1.0 - 1e-4)  # clear of the cap's own f32 edge
        np.testing.assert_array_equal(ic[below], i0[below])
        np.testing.assert_allclose(dc[below], d0[below], rtol=3e-5, atol=1e-7)
        # capped rows certify they are at/above the cap
        assert (dc[~below] >= cap2 * (1.0 - 1e-4)).all()
        # the bound stays sound vs the f64 KDTree truth, and never exceeds cap2
        assert (lc <= true_d2 + 1e-5 * (1.0 + true_d2)).all()
        assert (lc <= cap2 + 1e-6).all()
        # the second-nearest bound stays sound under capping too
        assert (b2c <= d2nd_cap + 1e-5 * (1.0 + d2nd_cap)).all()


def test_icp_capped_matches_uncapped():
    """The capped correspondence search is bit-equivalent ICP: correspondences
    always get exact NNs, non-correspondences contribute exactly zero, so the
    transform/fitness/rmse/iteration sequence matches search_cap=inf."""
    rng = np.random.default_rng(17)
    cloud = rng.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
    true = _rigid(0.015, [0.08, -0.04, 0.02])
    target = (cloud @ true[:3, :3].T + true[:3, 3]
              + rng.normal(scale=0.01, size=cloud.shape)).astype(np.float32)
    pad = 4096
    src = np.full((pad, 3), 1e9, np.float32)
    src[:3000] = cloud
    dst = np.full((pad, 3), 1e9, np.float32)
    dst[:3000] = target
    m = np.zeros(pad, bool)
    m[:3000] = True
    for thr in (0.02, 0.3):
        ref = registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                               jnp.asarray(m), threshold=thr, cached=True,
                               search_cap=float("inf"))
        got = registration_icp(jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst),
                               jnp.asarray(m), threshold=thr, cached=True)
        assert int(ref.iterations) == int(got.iterations)
        np.testing.assert_allclose(np.asarray(ref.transformation),
                                   np.asarray(got.transformation),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.asarray(ref.fitness),
                                   np.asarray(got.fitness), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(ref.inlier_rmse),
                                   np.asarray(got.inlier_rmse), rtol=1e-5)


# ------------------------------------------------------------------ Hungarian

@pytest.mark.parametrize("seed,n", [(0, 4), (1, 8), (2, 16), (3, 32)])
def test_hungarian_square_matches_scipy(seed, n):
    cost = np.random.default_rng(seed).uniform(0, 10, size=(n, n)).astype(np.float32)
    col4row = np.asarray(solve_square(jnp.asarray(cost)))
    ri, ci = scipy_lsa(cost)
    ours = cost[np.arange(n), col4row].sum()
    theirs = cost[ri, ci].sum()
    assert abs(ours - theirs) < 1e-4, (ours, theirs)
    assert len(set(col4row.tolist())) == n  # a valid permutation


@pytest.mark.parametrize("r,c", [(3, 7), (7, 3), (5, 5)])
def test_hungarian_rectangular_matches_scipy(r, c):
    cost = np.random.default_rng(42).uniform(0, 10, size=(r, c)).astype(np.float32)
    col4row, valid = linear_sum_assignment(jnp.asarray(cost))
    ri, ci = scipy_lsa(cost)
    got = {(i, int(col4row[i])) for i in range(r) if valid[i]}
    assert len(got) == min(r, c)
    ours = sum(cost[i, j] for i, j in got)
    theirs = cost[ri, ci].sum()
    assert abs(ours - theirs) < 1e-4


def test_hungarian_masked():
    cost = np.array([[1.0, 9.0, 9.0],
                     [9.0, 1.0, 9.0],
                     [9.0, 9.0, 1.0]], np.float32)
    row_mask = jnp.asarray([True, False, True])
    col_mask = jnp.asarray([True, True, False])
    col4row, valid = linear_sum_assignment(jnp.asarray(cost), row_mask, col_mask)
    assert bool(valid[0]) and int(col4row[0]) == 0
    assert not bool(valid[1])
    # row 2's only valid columns are 0,1; col 0 taken -> col 1 (cost 9) still valid
    assert bool(valid[2]) and int(col4row[2]) == 1


# ------------------------------------------------------------------ SOM

def test_som_matches_oracle():
    rng = np.random.default_rng(6)
    g, res = 50, (0.2, 0.2)
    # dense mixed evidence: many points per cell with interleaved static/moving
    # hits exercises the order-dependent clamping exactly
    pts = rng.uniform(-1.0, 1.0, size=(300, 3))
    residuals = rng.choice([0.05, 0.4, 1.0], size=300)
    som0 = np.full((g, g), 0.05)
    expect = refb.update_som(som0, pts, residuals, 0.2, 0.6, g, res)
    pad = 512
    p = np.full((pad, 3), 1e9, np.float32)
    p[:300] = pts
    m = np.zeros(pad, bool)
    m[:300] = True
    r = np.zeros(pad, np.float32)
    r[:300] = residuals
    got = np.asarray(update_som(jnp.asarray(som0.astype(np.float32)), jnp.asarray(p),
                                jnp.asarray(m), jnp.asarray(r), 0.2, 0.6, res))
    np.testing.assert_allclose(got, expect, atol=1e-5)
