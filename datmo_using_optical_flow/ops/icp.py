"""Point-to-point ICP on device (ego-motion estimation).

Device equivalent of Open3D's ``registration_icp(source, target, threshold,
I, TransformationEstimationPointToPoint())`` as invoked at ``GMFA/GMFA.py:297-309``:

* correspondences: 1-NN of each transformed source point in the target, gated by
  ``max_correspondence_distance`` — here the pruned NN kernel or the plain
  XLA sweep (:mod:`datmo_using_optical_flow.ops.nn`) instead of a KD-tree;
* per-iteration rigid estimate: Kabsch/SVD over the masked correspondence set;
* Open3D's convergence criteria: stop when both |Δfitness| and |Δinlier_rmse|
  drop below their relative thresholds, or after ``max_iterations`` (default 30);
* everything under one ``lax.while_loop`` with static shapes.

Returns the 4x4 transform mapping source -> target, plus fitness/inlier_rmse —
the same observables Open3D reports.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from datmo_using_optical_flow.ops.linalg import matmul
from datmo_using_optical_flow.ops.nn import (
    nearest_neighbors_active, nearest_neighbors_active_inplace,
    nearest_neighbors_scan, sort_order)


class IcpResult(NamedTuple):
    transformation: jnp.ndarray  # (4, 4)
    fitness: jnp.ndarray         # scalar: |correspondences| / |valid source|
    inlier_rmse: jnp.ndarray     # scalar
    iterations: jnp.ndarray = jnp.asarray(0)  # while_loop steps taken (diagnostic)
    # (3,) totals over all iterations of [swept rows, certificate-kept rows,
    # exclusion-shell-skipped rows] — diagnostics for the incremental-search
    # machinery (zeros on the uncached path)
    sweep_stats: jnp.ndarray = jnp.zeros((3,), jnp.float32)


def _kabsch(src: jnp.ndarray, dst: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted rigid alignment src->dst (rotation+translation, no scale)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    cs = jnp.sum(src * w[:, None], axis=0) / wsum
    cd = jnp.sum(dst * w[:, None], axis=0) / wsum
    s = (src - cs) * w[:, None]
    d = dst - cd
    h = matmul(s.T, d)  # (3, 3); feeds the SVD that fixes the transform
    u, _, vt = jnp.linalg.svd(h)
    det = jnp.linalg.det(matmul(vt.T, u.T))
    diag = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(det)
    r = matmul(matmul(vt.T, diag), u.T)
    t = cd - matmul(r, cs)
    return jnp.eye(4).at[:3, :3].set(r).at[:3, 3].set(t)


# Safety pad (meters) on the per-iteration displacement when shrinking the
# exclusion shell: covers the f32 rounding of ||p' - q|| at ROI-scale
# coordinates.  The d2 lower bound itself comes from the NN kernel
# (ops/nn_pallas.py: sound relative envelope on the direct-difference d2),
# so no d2-level slack is needed here.
_DELTA_PAD = 1e-4


def _icp_phase(srcf, smask, tgtf, tmask, thr2, relative_fitness, relative_rmse,
               max_iterations, init_transform, cached, tgt_index=None,
               cap2=None, sweep: str = "inplace", active_cap: int | None = None):
    """One ICP while_loop phase (Open3D criteria) from ``init_transform``.
    Returns the converged transform."""
    n = srcf.shape[0]
    n_valid = jnp.maximum(jnp.sum(smask.astype(jnp.float32)), 1.0)

    block_table = None
    if tgt_index is not None and sweep == "inplace":
        from datmo_using_optical_flow.ops import nn_pallas

        # per-(block, tile) pruning table built ONCE: the source only drifts
        # rigidly between iterations, so each sweep reuses it with the
        # max-displacement pad (order-preserving scalar subtraction) instead
        # of recomputing block-ball norms + a row argsort per iteration.
        # Invalid rows are rewritten by the SAME fill the in-place query
        # applies (nn_pallas.block_first_fill) so boundary blocks' balls
        # stay tight and consistent with the drift-soundness argument.
        src_build = nn_pallas.block_first_fill(srcf, smask, n)[:n]
        block_table = nn_pallas.build_block_table(src_build, tgt_index, n)

    def eval_full(transform, cache):
        pts = transform_points(srcf, transform)
        if tgt_index is None:
            idx, _ = nearest_neighbors_scan(pts, tgtf, tmask)
        else:
            # the prebuilt index; capped rows return d2 >= cap2 > thr2, so
            # every gate decision equals the exact sweep's
            from datmo_using_optical_flow.ops import nn_pallas
            idx = nn_pallas.nearest_neighbors_pallas(pts, tgt_index,
                                                     cap2=cap2)[0]
        dst = tgtf[idx]
        diff = pts - dst
        d2 = jnp.sum(diff * diff, axis=1)
        corr = smask & (d2 <= thr2)
        counts = jnp.stack([jnp.sum(smask.astype(jnp.float32)),
                            jnp.float32(0.0), jnp.float32(0.0)])
        return pts, dst, d2, corr, cache, counts

    def eval_cached(transform, cache):
        lo_old, qw, qpos, b2_old = cache
        pts = transform_points(srcf, transform)
        delta = jnp.linalg.norm(pts - qpos, axis=1) + _DELTA_PAD
        # the kernel's sound lower bound on the true NN distance at the last
        # query position, moved to the new position by the reverse triangle
        # inequality: points provably outside the correspondence threshold
        # skip the target sweep
        lo_new = jnp.sqrt(lo_old) - delta
        excluded = (lo_new > 0.0) & (lo_new * lo_new > thr2)
        # winner certificate (the classic closest-point cache, made sound):
        # the exact distance to the CARRIED winner coords strictly below the
        # decayed lower bound on the distance to any OTHER target point
        # proves the winner is still the unique nearest neighbor — the row
        # keeps (winner, exact d2) without a sweep.  Rows whose last sweep
        # found no candidate carry b2=0 and can never self-certify; capped
        # rows carry b2 <= ~cap^2, far below their winner distance — ditto.
        dw2 = jnp.sum((pts - qw) ** 2, axis=1)
        b2_dec = jnp.sqrt(b2_old) - delta
        certified = smask & ~excluded & (jnp.sqrt(dw2) + _DELTA_PAD < b2_dec)
        need = smask & ~excluded & ~certified
        if tgt_index is not None and sweep == "inplace":
            # the caller permuted the source by Morton rank once; excluded
            # rows cluster into whole blocks in that order, so the kernel
            # skips them IN PLACE (per-block active counts).  The pruning
            # table is the build-time one, padded by the max displacement
            # since build.  No gathers anywhere: the kernel returns winner
            # COORDS, carried in the cache.
            drift = jnp.max(jnp.where(
                smask, jnp.linalg.norm(pts - srcf, axis=1), 0.0)) + _DELTA_PAD
            _, d2_new, lo_q, b2_q, crd_new = nearest_neighbors_active_inplace(
                pts, tgtf, tmask, need, tgt_index, cap2=cap2,
                block_table=block_table, drift=drift)
        else:
            # compacting variant (the default): a stable partition moves
            # active rows to the front, keeping them mutually
            # Morton-coherent — the active set on real loads (the
            # correspondence shell + exclusion churn) is SCATTERED across
            # blocks, where in-place block skipping degenerates to a full
            # sweep.  The second-NN bound feeds the same certificates as the
            # in-place path.  (tgt_index None falls through to the exact XLA
            # sweep inside, which never certifies.)
            _, d2_new, lo_q, b2_q, crd_new = nearest_neighbors_active(
                pts, tgtf, tmask, need, index=tgt_index, cap2=cap2,
                active_cap=active_cap)
        # d2_new is the exact direct-subtraction distance at the winner;
        # certified rows contribute their exact carried-winner distance;
        # excluded rows +inf (provably outside the gate).
        dst = jnp.where(need[:, None], crd_new, qw)
        d2 = jnp.where(need, d2_new, jnp.where(certified, dw2, jnp.inf))
        corr = d2 <= thr2
        # certified rows re-anchor at the current position: their NN distance
        # is exactly dw2 and the second-nearest bound decays to b2_dec
        b2_dec2 = jnp.maximum(b2_dec, 0.0) ** 2
        b2_fresh = jnp.where(jnp.isfinite(d2_new), b2_q, 0.0)
        cache = (jnp.where(need, lo_q, jnp.where(certified, dw2, lo_old)),
                 dst,
                 jnp.where((need | certified)[:, None], pts, qpos),
                 jnp.where(need, b2_fresh, jnp.where(certified, b2_dec2, b2_old)))
        counts = jnp.stack([jnp.sum(need.astype(jnp.float32)),
                            jnp.sum(certified.astype(jnp.float32)),
                            jnp.sum((smask & excluded).astype(jnp.float32))])
        return pts, dst, d2, corr, cache, counts

    eval_state = eval_cached if cached else eval_full

    def observables(d2, corr):
        w = corr.astype(jnp.float32)
        cnt = jnp.sum(w)
        fitness = cnt / n_valid
        rmse = jnp.sqrt(jnp.sum(jnp.where(corr, d2, 0.0)) / jnp.maximum(cnt, 1.0))
        return w, cnt, fitness, rmse

    def cond(state):
        transform, f1, r1, f0, r0, it, cache = state
        first = it < 2  # need two evaluations before convergence can trigger
        keep = (jnp.abs(f0 - f1) >= relative_fitness) | \
               (jnp.abs(r0 - r1) >= relative_rmse)
        return (it < max_iterations) & (first | keep)

    def cond2(state):
        return cond(state[:-1])

    def body(state):
        transform, f1, r1, f0, r0, it, cache, stats = state
        pts, dst, d2, corr, cache, counts = eval_state(transform, cache)
        w, cnt, fitness, rmse = observables(d2, corr)
        update = _kabsch(pts, dst, w)
        # fewer than 3 correspondences: no reliable estimate; keep transform
        update = jnp.where(cnt >= 3, update, jnp.eye(4))
        new_transform = matmul(update, transform)
        return (new_transform, fitness, rmse, f1, r1, it + 1, cache,
                stats + counts)

    cache0 = (jnp.zeros((n,), jnp.float32),            # d2 lower bound at last query
              jnp.zeros((n, 3), jnp.float32),          # winner COORDS at last query
              jnp.full((n, 3), 1e9, jnp.float32),      # last query position
              jnp.zeros((n,), jnp.float32))            # second-NN d2 lower bound
    init = (init_transform, jnp.float32(0.0), jnp.float32(0.0),
            jnp.float32(-1.0), jnp.float32(-1.0), 0, cache0,
            jnp.zeros((3,), jnp.float32))
    transform, _, _, _, _, it, _, stats = jax.lax.while_loop(cond2, body, init)
    # The POST-LOOP observables (Open3D evaluates the final transform once
    # more after its loop) go through eval_full — exact 1-NN, identical
    # values to eval_cached with a cold cache (both paths are exact
    # direct-difference d2 with original-index tie-breaks).
    return transform, it, eval_full, observables, cache0, stats


# targets at or above this size default to incremental correspondence search
_CACHED_MIN = 1 << 15


@partial(jax.jit, static_argnames=("max_iterations", "cached", "coarse_stride",
                                   "search_cap", "sweep", "active_cap"))
def registration_icp(source: jnp.ndarray, source_mask: jnp.ndarray,
                     target: jnp.ndarray, target_mask: jnp.ndarray,
                     threshold: float = 0.02, max_iterations: int = 30,
                     relative_fitness: float = 1e-6,
                     relative_rmse: float = 1e-6,
                     cached: bool | None = None,
                     coarse_stride: int | None = None,
                     search_cap: float | None = None,
                     tgt_index=None, src_order=None,
                     sweep: str = "compact",
                     active_cap=(16384, 32768)) -> IcpResult:
    """ICP with identity init (the reference always passes I, GMFA.py:302).

    ``cached`` (default: on for targets >= 32k points) enables incremental
    correspondence search: the NN distance is 1-Lipschitz in the query
    position, so a source point whose kernel-certified lower bound on its NN
    distance (ops/nn_pallas.py), minus its displacement accumulated since the
    bound was measured, stays above ``max_correspondence_distance`` provably
    cannot become a correspondence — it skips the target sweep
    (:func:`ops.nn.nearest_neighbors_active`).  At GMFA's quirk threshold
    (0.02 m on LiDAR-scale clouds, GMFA.py:305 — fitness ~0.003) almost every
    point is excluded after the first sweep, so the 30-iteration loop costs a
    couple of full sweeps instead of 30.  Exact: excluded points are provably
    non-correspondences, and correspondence d2 is a direct difference
    (faithful to Open3D's double-precision gating).  ``cached=False`` runs
    the plain XLA sweep (:func:`ops.nn.nearest_neighbors_scan`) on every
    iteration.

    ``coarse_stride`` (default: off) runs a first while_loop phase on every
    ``stride``-th source/target point (1/stride^2 sweep cost), then reruns the
    full-resolution loop from the coarse transform.  Helps only when the
    convergence criteria fire before ``max_iterations``; at GMFA's threshold
    they do not (fitness jitter >> 1e-6), so it stays off by default.  Fixed
    point pinned by tests/test_gmfa_ops.py::test_icp_coarse_matches_full.

    ``search_cap`` (meters; default 5x threshold on the cached kernel path):
    capped correspondence search.  ICP only ever *uses* a neighbor when its
    distance is inside ``threshold``: correspondences get exact NNs either
    way, non-correspondences contribute exactly zero to Kabsch/fitness/rmse
    whatever index they carry, and the capped sweep's lower bound (>= the
    cap for capped rows) still drives the exclusion shell soundly.  The
    transform/fitness/rmse sequence is therefore BIT-IDENTICAL to the
    uncapped run (pinned by tests/test_gmfa_ops.py::test_icp_capped_matches_uncapped)
    while tiles farther than the cap from a whole source block are skipped
    even before every row has a candidate — at GMFA load most of the sweep.
    The margin above ``threshold`` keeps capped rows excluded for
    ~(cap - threshold)/per-iteration-displacement iterations before they are
    re-queried.  Set to ``float('inf')`` to disable.

    ``tgt_index`` / ``src_order``: optional prebuilt target index
    (``ops.nn_pallas.build_target_index``) and source spatial order
    (``ops.nn.sort_order``) for the cached path — GMFA computes one
    order per cloud per frame and shares it across ICP, the classification
    sweep, and the next frame (a rigid transform preserves spatial
    coherence, and the results are permutation-independent).

    ``sweep``: how per-iteration re-queries visit the active subset.
    ``"compact"`` (default): a stable partition moves active rows to the
    front (keeping their carried Morton coherence) — on real loads the
    active set (correspondence shell + exclusion churn) is SCATTERED across
    blocks, where the alternative degenerates.  ``"inplace"``: rows stay put
    and whole inactive blocks skip; wins only when actives are
    block-coherent.  Winner certificates (the second-NN-bound skip) apply on
    BOTH sweeps.

    ``active_cap`` (static; compact sweep only): iterations whose active set
    fits the cap run the kernel — and its per-iteration pruning-table build —
    over only the first ``active_cap`` partitioned rows, with a ``lax.cond``
    full-width fallback otherwise (every active row is always swept; results
    identical), so the per-iteration table build shrinks with the active
    set.  ``None`` disables.
    """
    srcf = source.astype(jnp.float32)
    tgtf = target.astype(jnp.float32)
    smask = source_mask
    thr2 = jnp.float32(threshold * threshold)
    if cached is None:
        cached = target.shape[0] >= _CACHED_MIN
    if coarse_stride is None:
        coarse_stride = 1
    if search_cap is None:
        cap = 5.0 * jnp.asarray(threshold, jnp.float32)
    elif not np.isfinite(search_cap):
        cap = None                                   # exact sweep
    else:
        cap = jnp.asarray(search_cap, jnp.float32)
    if cap is not None:
        cap = jnp.maximum(cap, jnp.asarray(threshold, jnp.float32))
    cap2 = None if cap is None else cap * cap        # never cap inside the gate

    if cached:
        from datmo_using_optical_flow.ops import nn_pallas
        if nn_pallas.eligible(target.shape[0]):
            # built once; every incremental re-query reuses it
            if tgt_index is None:
                tgt_index = nn_pallas.build_target_index(tgtf, target_mask)
            # run the whole loop in Morton-permuted source space: fitness,
            # rmse, and Kabsch are permutation-invariant reductions, and
            # per-iteration re-queries then skip whole inactive blocks in
            # place.  sort_order masks invalid rows to the END — an unmasked
            # key would let sentinel/padding coords sort mid-cloud and
            # inflate blocks' bounding boxes.
            morder = (sort_order(srcf, smask)
                      if src_order is None else src_order)
            srcf = srcf[morder]
            smask = smask[morder]
        else:
            tgt_index = None
    else:
        tgt_index = None

    t0 = jnp.eye(4)
    it_c = jnp.asarray(0)
    if coarse_stride > 1:
        cs = coarse_stride
        t0, it_c, _, _, _, _ = _icp_phase(srcf[::cs], smask[::cs], tgtf[::cs],
                                       target_mask[::cs], thr2, relative_fitness,
                                       relative_rmse, max_iterations, t0,
                                       cached=False)

    transform, it_f, eval_final, observables, cache0, stats = _icp_phase(
        srcf, smask, tgtf, target_mask, thr2, relative_fitness, relative_rmse,
        max_iterations, t0, cached, tgt_index=tgt_index, cap2=cap2, sweep=sweep,
        active_cap=active_cap)
    _, _, d2, corr, _, _ = eval_final(transform, cache0)
    _, _, fitness, rmse = observables(d2, corr)
    return IcpResult(transform, fitness, rmse, it_c + it_f, stats)


def transform_points(points: jnp.ndarray, transformation: jnp.ndarray) -> jnp.ndarray:
    """Apply a 4x4 rigid transform ((R @ p) + t, the reference's GMFA.py:77)."""
    return matmul(points, transformation[:3, :3].T) + transformation[:3, 3]
