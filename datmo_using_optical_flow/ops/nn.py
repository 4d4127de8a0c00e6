"""Batched exact 1-nearest-neighbor over padded point sets.

Replacement for the reference's per-point Python KDTree loops
(``GMFA/GMFA.py:84-91`` and :109-119 — its worst hot loop: one Python->C++ FLANN
call per point).  Two implementations of one contract:

* :func:`nearest_neighbors_scan` — a plain XLA sweep over target tiles with a
  running (min, argmin) reduction; the reference for the kernel and the path
  for target clouds past the kernel's size limit;
* the pruned Pallas kernel (:mod:`ops.nn_pallas`) on Morton-sorted clouds,
  whose sound lower bounds drive the incremental-ICP exclusion shell
  (ops/icp.py).

Both compute d2 by direct differences of the coordinates, never the
``|s|^2 + |t|^2 - 2 s.t`` expansion: at ROI-scale coordinates (~30 m) the
expansion's cancellation error is as large as GMFA's 0.02^2 ICP gate, and
its matrix product may run in reduced precision on the GPU.  Ties break at
the lowest original target index (KDTree/cKDTree parity).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

_TILE = 512
_BIG_I = np.int32(2 ** 30)
# Relative error envelope of a direct-difference d2: three subtractions,
# three squares and two adds of non-negative terms round to within ~5 ulp
# (2^-24 each) of the exact value; 1e-6 leaves a 3x margin.  A computed d2
# times (1 - ALPHA) is a sound lower bound on the exact one.
ALPHA = np.float32(1e-6)


def _morton_keys(p: jnp.ndarray) -> jnp.ndarray:
    """int32 Morton (Z-order) codes of (N, 3) points, 10 bits/dim over the
    data's bounding box.  Only a spatial sort key — rounding is harmless."""
    lo = jnp.min(p, axis=0)
    hi = jnp.max(p, axis=0)
    # one shared scale (cubic cells): per-dim normalization would stretch the
    # thin z extent of ground-plane clouds across the full key range and
    # destroy physical locality
    scale = 1023.0 / jnp.maximum(jnp.max(hi - lo), 1e-12)
    q = jnp.clip((p - lo) * scale, 0.0, 1023.0).astype(jnp.int32)  # (N, 3)
    key = jnp.zeros(p.shape[:1], jnp.int32)
    for bit in range(10):
        for d in range(3):
            key = key | (((q[:, d] >> bit) & 1) << (3 * bit + d))
    return key


def sort_order(pts: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Morton order of a masked cloud (invalid rows last) — the spatial
    permutation the NN kernel's target index applies.  Exposed so callers can
    compute it once and reuse it: a rigid transform preserves spatial
    coherence, so the order of a cloud indexed last frame (or registered this
    frame) is a valid — and equally tight — order for its transformed self
    (models/gmfa.py carries it across ICP, classification, and frames)."""
    ptsf = jnp.where(mask[:, None], pts.astype(jnp.float32), 0.0)
    key = jnp.where(mask, _morton_keys(ptsf), _BIG_I)
    return jnp.argsort(key, stable=True)


@jax.jit
def nearest_neighbors(src: jnp.ndarray, tgt: jnp.ndarray, tgt_mask: jnp.ndarray
                      ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """For each src point, the index + squared distance of its nearest valid tgt.

    ``src``: (N, 3); ``tgt``: (M, 3) padded; ``tgt_mask``: (M,) validity.
    Returns ``(idx (N,), sqdist (N,))``; if no valid target exists, idx = 0 and
    sqdist = +inf.
    """
    idx, d2, _ = nearest_neighbors_with_bound(src, tgt, tgt_mask)
    return idx, d2


@jax.jit
def nearest_neighbors_with_bound(src: jnp.ndarray, tgt: jnp.ndarray,
                                 tgt_mask: jnp.ndarray, cap2=None,
                                 tgt_order=None, src_order=None
                                 ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """:func:`nearest_neighbors` plus a SOUND lower bound on the true min d2
    per row (true NN d2 >= bound).

    ``cap2``: optional squared search cap (kernel path only — the scan stays
    exact, a valid instance of the capped contract): rows whose true NN d2 <
    cap2 are exact; other rows return a candidate (or idx 0 / d2 +inf) with
    d2 >= cap2.  Callers that only threshold the distance below
    ``sqrt(cap2)`` (GMFA's residual classifier) get identical decisions for a
    fraction of the sweep cost.

    ``tgt_order`` / ``src_order``: optional precomputed spatial permutations
    (:func:`sort_order`) — one Morton argsort per cloud per frame instead of
    one per query; results are identical for any permutation, only pruning
    tightness varies."""
    from datmo_using_optical_flow.ops import nn_pallas

    if not nn_pallas.eligible(tgt.shape[0]):
        idx, d2 = nearest_neighbors_scan(src, tgt, tgt_mask)
        return idx, d2, jnp.maximum(d2 * (1.0 - ALPHA), 0.0)
    index = nn_pallas.build_target_index(tgt, tgt_mask, order=tgt_order)
    order = (jnp.argsort(_morton_keys(src.astype(jnp.float32)), stable=True)
             if src_order is None else src_order)
    idx_s, d2_s, lo_s, _, _ = nn_pallas.nearest_neighbors_pallas(
        src[order], index, cap2=cap2)
    inv = jnp.zeros_like(order).at[order].set(
        jnp.arange(order.shape[0], dtype=order.dtype), unique_indices=True)
    return idx_s[inv], d2_s[inv], lo_s[inv]


@jax.jit
def nearest_neighbors_scan(src: jnp.ndarray, tgt: jnp.ndarray,
                           tgt_mask: jnp.ndarray
                           ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact plain-XLA sweep: d2 by direct differences on separate
    coordinate columns (no inner reduce, so each tile fuses into one
    min/argmin reduction), lowest index on ties."""
    m = tgt.shape[0]
    pad = (-m) % _TILE
    tgt_p = jnp.pad(tgt.astype(jnp.float32), ((0, pad), (0, 0)))
    mask_p = jnp.pad(tgt_mask, ((0, pad),))
    n_tiles = tgt_p.shape[0] // _TILE
    tiles = (tgt_p.reshape(n_tiles, _TILE, 3).transpose(0, 2, 1),
             mask_p.reshape(n_tiles, _TILE))
    src = src.astype(jnp.float32)
    sx, sy, sz = (src[:, k:k + 1] for k in range(3))

    def tile_step(carry, xs):
        best_d, best_i = carry
        (tile, tm), j = xs
        dx = sx - tile[0][None, :]
        dy = sy - tile[1][None, :]
        dz = sz - tile[2][None, :]
        d2 = jnp.where(tm[None, :], dx * dx + dy * dy + dz * dz, jnp.inf)
        ti = jnp.argmin(d2, axis=1).astype(jnp.int32)   # first minimum
        td = jnp.min(d2, axis=1)
        # strict: an earlier (lower-index) tile keeps its tie
        take = td < best_d
        return (jnp.where(take, td, best_d),
                jnp.where(take, ti + j * _TILE, best_i)), None

    init = (jnp.full((src.shape[0],), jnp.inf, jnp.float32),
            jnp.zeros((src.shape[0],), jnp.int32))
    (best_d, best_i), _ = jax.lax.scan(
        tile_step, init, (tiles, jnp.arange(n_tiles, dtype=jnp.int32)))
    return best_i, best_d


def _masked(active, idx, d2, lo, d2nd, crd):
    """Inactive rows -> idx 0 / d2 +inf / lower bound +inf / second bound 0
    (never certifies) / zero coords."""
    return (jnp.where(active, idx, 0), jnp.where(active, d2, jnp.inf),
            jnp.where(active, lo, jnp.inf), jnp.where(active, d2nd, 0.0),
            jnp.where(active[:, None], crd, 0.0))


def nearest_neighbors_active(src: jnp.ndarray, tgt: jnp.ndarray,
                             tgt_mask: jnp.ndarray, active: jnp.ndarray,
                             index=None, cap2=None, active_cap=None
                             ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                                        jnp.ndarray, jnp.ndarray]:
    """1-NN for only the ``active`` subset of source rows; cost scales with
    the subset size (the cached-ICP hot path, :func:`ops.icp.registration_icp`).

    Returns ``(idx, d2, lower_bound, second_lower_bound, coords)``: active
    rows get exactly what the full query would return (each row's reduction
    is row-independent); inactive rows return idx=0 / +inf / +inf / 0 /
    zeros.  ``second_lower_bound`` soundly bounds the distance to the
    closest target EXCLUDING the winner (the ICP winner-certificate input);
    ``coords`` are the winner's coordinates.

    Active rows are moved to the front by a STABLE partition: callers keep
    ``src`` spatially sorted (ICP Morton-permutes its cloud once, outside
    the while_loop), and a stable partition preserves that order within the
    active prefix, so the active rows stay mutually Morton-coherent and the
    kernel's blocks past the prefix return at once.  (With an unsorted
    ``src`` the results are still exact; only pruning tightness suffers.)

    ``cap2``: optional squared-distance search cap (see
    :func:`ops.nn_pallas.nearest_neighbors_pallas`).  The XLA sweep ignores
    it (always exact — a valid instance of the capped contract) and never
    certifies (second bound 0).

    ``active_cap`` (static int or ascending tuple of ints, multiples of the
    kernel block size): when the active count fits a cap, the kernel — and
    its per-call pruning table — run over only the first ``cap`` partitioned
    rows (``lax.cond`` tiers; the full-width call otherwise), so the table
    build shrinks with the active set.  Identical results for active rows.
    """
    from datmo_using_optical_flow.ops import nn_pallas

    n = src.shape[0]
    srcf = src.astype(jnp.float32)
    if not nn_pallas.eligible(tgt.shape[0]):
        idx, d2 = nearest_neighbors_scan(src, tgt, tgt_mask)
        crd = jnp.where(jnp.isfinite(d2)[:, None],
                        tgt.astype(jnp.float32)[idx], 0.0)
        return _masked(active, idx, d2, jnp.maximum(d2 * (1.0 - ALPHA), 0.0),
                       jnp.zeros((n,), jnp.float32), crd)

    if index is None:
        index = nn_pallas.build_target_index(tgt, tgt_mask)
    n_active = jnp.sum(active.astype(jnp.int32))
    # stable partition: rows[k] is the k-th active row (then the inactive
    # ones, in order)
    rows = jnp.argsort(~active, stable=True).astype(jnp.int32)
    caps = (active_cap,) if isinstance(active_cap, int) else active_cap
    caps = tuple(c for c in (caps or ())
                 if c < n and c % nn_pallas._SRC_BLOCK == 0)

    def sweep(width):
        def run(_):
            pre = srcf[rows[:width]]
            out = nn_pallas.nearest_neighbors_pallas(pre, index, n_active, cap2)
            # scatter the prefix's results back to their rows; prefix rows
            # past n_active are dropped
            dest = jnp.where(jnp.arange(width) < n_active, rows[:width], n)
            init = (jnp.zeros((n,), jnp.int32),
                    jnp.full((n,), jnp.inf, jnp.float32),
                    jnp.full((n,), jnp.inf, jnp.float32),
                    jnp.zeros((n,), jnp.float32),
                    jnp.zeros((n, 3), jnp.float32))
            return tuple(o.at[dest].set(v, mode="drop")
                         for o, v in zip(init, out))
        return run

    branch = sweep(n)
    for capb in sorted(caps, reverse=True):
        branch = (lambda nxt, small, cb: lambda op: jax.lax.cond(
            n_active <= cb, small, nxt, op))(branch, sweep(capb), capb)
    return _masked(active, *branch(0))


def nearest_neighbors_active_inplace(src: jnp.ndarray, tgt: jnp.ndarray,
                                     tgt_mask: jnp.ndarray,
                                     active: jnp.ndarray, index, cap2=None,
                                     block_table=None, drift=None
                                     ) -> tuple[jnp.ndarray, jnp.ndarray,
                                                jnp.ndarray, jnp.ndarray,
                                                jnp.ndarray]:
    """Subset 1-NN with NO row movement: ``src`` must already be spatially
    coherent (Morton order — incremental ICP permutes its cloud once, outside
    the while_loop), and rows stay in place.  The kernel skips whole blocks
    whose per-block active count is zero; inactive rows inside mixed blocks
    are rewritten to the block's first active row (keeping its bounding box
    tight) and their results discarded.  Same return contract as
    :func:`nearest_neighbors_active`."""
    from datmo_using_optical_flow.ops import nn_pallas

    n = src.shape[0]
    b = nn_pallas._SRC_BLOCK
    npad = -(-n // b) * b
    counts = jnp.sum(jnp.pad(active, (0, npad - n)).astype(jnp.int32)
                     .reshape(-1, b), axis=1)
    src_clean = nn_pallas.block_first_fill(src, active, n)
    out = nn_pallas.nearest_neighbors_pallas(
        src_clean[:n], index, cap2=cap2, block_counts=counts,
        block_table=block_table, drift=drift)
    return _masked(active, *out)


def align_by_nearest(points: jnp.ndarray, reference: jnp.ndarray,
                     ref_mask: jnp.ndarray) -> jnp.ndarray:
    """Replace each point by its nearest valid reference point
    (the reference's NN 'alignment' for mismatched cloud sizes, GMFA.py:84-91)."""
    idx, _ = nearest_neighbors(points, reference, ref_mask)
    return reference[idx]
