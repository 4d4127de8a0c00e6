"""Pruned exact 1-NN as a Pallas kernel on the Triton route: GMFA's hot kernel.

Replaces the reference's per-point Python KDTree loops (``GMFA/GMFA.py:84-91``,
:109-119) at reference load (~10^5 x 10^5 points after x10 densification).

* **Spatial pruning** (the KD-tree's job, reformulated fixed-shape): sources
  and targets are Morton-sorted, so source blocks and target tiles are both
  spatially compact.  A precomputed (n_blocks, m_tiles) bound table
  ``lb2[b, j] <= min d2 between any point of block b and tile j``, sorted
  ascending per block, lets each program walk its tiles nearest-first in a
  ``while_loop`` and stop at the first tile whose bound exceeds the block's
  worst row — work the data lets it skip, which a dense XLA sweep cannot.
* **Direct differences**: d2 = (sx-tx)^2 + (sy-ty)^2 + (sz-tz)^2 in f32 on
  the CUDA cores (K = 3 is too shallow for tensor cores).  All terms are
  non-negative, so the computed d2 is within a relative ``ALPHA`` of the
  exact d2 of the f32 inputs; the kernel's lower bounds are
  ``computed * (1 - ALPHA)``.  Tie-breaking is exact: candidates carry their
  original indices and d2 does not depend on tile membership, so the lowest
  original index among equal minima wins, as in the plain XLA sweep
  (:func:`ops.nn.nearest_neighbors_scan`).

Each program owns one ``_SRC_BLOCK``-row source block and keeps its running
(min, argmin, lower bound, second-nearest bound) rows in registers; it reads
its own row of the bound table from device memory, one scalar per visited
tile.  Programs whose block has no active row return at once.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from datmo_using_optical_flow.ops.nn import _BIG_I, ALPHA, _morton_keys

# Block and tile sizes: powers of two (Triton).  A (64, 64) d2 tile is 4096
# values, 32 per thread at 4 warps, which leaves registers for the eight
# per-row carries and keeps ~1600 programs in flight at reference load
# (132 SMs); see PERF.md for the sizes measured on the card.
_SRC_BLOCK = 64
_TGT_TILE = 64
_NUM_WARPS = 4
# the bound table is (n_blocks, m_tiles) f32 + int32; past this many targets
# it outgrows a sensible per-call footprint and callers take the XLA sweep
MAX_TARGET = 1 << 18

# absolute slack for subnormal flushing of tiny d2
_ABS = np.float32(1e-12)
# absolute slack (meters) subtracted from the geometric tile bound to cover
# its own f32 rounding
_LB_PAD = np.float32(1e-3)


def _interpret() -> bool:
    """Compiled on the GPU, interpreted on the CPU (tests); nothing else."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(f"the NN kernel runs on 'gpu' or 'cpu', not {backend!r}")


class TargetIndex(NamedTuple):
    """Morton-sorted target structure (build once, query often — ICP
    re-queries the same target every iteration)."""
    coords: jnp.ndarray      # (3, Mp) sorted coords, zero where invalid
    tidx: jnp.ndarray        # (Mp,) int32 original indices, _BIG_I if invalid
    tpos: jnp.ndarray        # (M,) int32 sorted position of each original index
    tile_cent: jnp.ndarray   # (m_tiles, 3) tile bounding-box centers
    tile_rad: jnp.ndarray    # (m_tiles,) tile bounding radii (-inf if empty)
    tile_lo: jnp.ndarray     # (m_tiles, 3) tile AABB mins (+inf if empty)
    tile_hi: jnp.ndarray     # (m_tiles, 3) tile AABB maxs (-inf if empty)


def build_target_index(tgt: jnp.ndarray, tgt_mask: jnp.ndarray,
                       order: jnp.ndarray | None = None) -> TargetIndex:
    """Morton-sort targets (invalid rows last) and precompute per-tile
    bounding boxes and balls.

    ``order``: optional precomputed permutation (from :func:`ops.nn.sort_order`,
    or a carried order of a rigidly-moved copy of this cloud).  Correctness
    does not depend on it — tie-breaking uses original indices and invalid
    rows are masked — only pruning tightness does."""
    m = tgt.shape[0]
    mp = -(-m // _TGT_TILE) * _TGT_TILE
    tgtf = jnp.where(tgt_mask[:, None], tgt.astype(jnp.float32), 0.0)
    if order is None:
        key = jnp.where(tgt_mask, _morton_keys(tgtf), _BIG_I)
        order = jnp.argsort(key, stable=True)
    order = order.astype(jnp.int32)
    mask_s = jnp.pad(tgt_mask[order], (0, mp - m))
    pts = jnp.pad(tgtf[order], ((0, mp - m), (0, 0)))
    tidx = jnp.where(mask_s, jnp.pad(order, (0, mp - m)), _BIG_I)
    tpos = jnp.zeros((m,), jnp.int32).at[order].set(
        jnp.arange(m, dtype=jnp.int32), unique_indices=True)

    m_tiles = mp // _TGT_TILE
    tiles = pts.reshape(m_tiles, _TGT_TILE, 3)
    mtile = mask_s.reshape(m_tiles, _TGT_TILE)
    lo = jnp.min(jnp.where(mtile[:, :, None], tiles, jnp.inf), axis=1)
    hi = jnp.max(jnp.where(mtile[:, :, None], tiles, -jnp.inf), axis=1)
    has = jnp.any(mtile, axis=1)
    cent = jnp.where(has[:, None], (lo + hi) * 0.5, 0.0)
    rad = jnp.where(
        has,
        jnp.max(jnp.linalg.norm(
            jnp.where(mtile[:, :, None], tiles - cent[:, None, :], 0.0),
            axis=2), axis=1),
        -jnp.inf)  # empty tile: its bound is +inf below -> never visited
    return TargetIndex(coords=pts.T, tidx=tidx, tpos=tpos, tile_cent=cent,
                       tile_rad=rad, tile_lo=lo, tile_hi=hi)


def block_first_fill(src: jnp.ndarray, keep: jnp.ndarray,
                     n: int | None = None) -> jnp.ndarray:
    """Rewrite rows where ``keep`` is False to their ``_SRC_BLOCK``-block's
    first kept row's coordinates (array tail padded with edge rows).  Returns
    the padded (npad, 3) cloud.

    Dropped or invalid rows (1e9 sentinels, excluded points) would otherwise
    inflate the block's bounding box and defeat the tile pruning; their
    results are discarded.  Blocks with no kept row keep row 0 — their sweep
    is skipped.  Pruning soundness only needs every filled row to land inside
    the build-time box (+drift), which any kept row does (query keep-sets
    are subsets of build keep-sets)."""
    n = src.shape[0] if n is None else n
    b = _SRC_BLOCK
    npad = -(-n // b) * b
    srcp = jnp.pad(src.astype(jnp.float32)[:n], ((0, npad - n), (0, 0)),
                   mode="edge")
    keepp = jnp.pad(keep[:n], (0, npad - n))
    rows = srcp.reshape(-1, b, 3)
    first_active = jnp.argmax(keepp.reshape(-1, b), axis=1)  # 0 if none kept
    rep = jnp.take_along_axis(rows, first_active[:, None, None], axis=1)
    rep = jnp.broadcast_to(rep, (npad // b, b, 3)).reshape(npad, 3)
    return jnp.where(keepp[:, None], srcp, rep)


def build_block_table(src: jnp.ndarray, index: TargetIndex,
                      n: int | None = None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-(source block, target tile) pruning table: LINEAR lower bounds on
    the block-to-tile distance sorted ascending per block, plus the tile
    visit order.

    Reusable across rigid drift (ops/icp.py): if every source point has moved
    at most ``drift`` since the table was built, ``max(lb - drift, 0)`` is a
    sound bound for the moved cloud, and a uniform scalar subtraction
    preserves the ascending order exactly."""
    n = src.shape[0] if n is None else n
    block = _SRC_BLOCK
    np_ = -(-n // block) * block
    n_blocks = np_ // block
    srcf = jnp.pad(src.astype(jnp.float32)[:n], ((0, np_ - n), (0, 0)),
                   mode="edge")
    blocks = srcf.reshape(n_blocks, block, 3)
    blo = jnp.min(blocks, axis=1)
    bhi = jnp.max(blocks, axis=1)
    bc = (blo + bhi) * 0.5
    br = jnp.max(jnp.linalg.norm(blocks - bc[:, None, :], axis=2), axis=1)
    d_ct = jnp.linalg.norm(bc[:, None, :] - index.tile_cent[None, :, :], axis=2)
    ball = d_ct - br[:, None] - index.tile_rad[None, :]
    # AABB gap bound: for any p in the block box and q in the tile box,
    # |p_d - q_d| >= gap_d per dimension — far tighter than the ball bound
    # for box-shaped Morton blocks.  Both are valid; take the larger.
    gap = jnp.maximum(
        jnp.maximum(index.tile_lo[None, :, :] - bhi[:, None, :],
                    blo[:, None, :] - index.tile_hi[None, :, :]), 0.0)
    aabb = jnp.linalg.norm(gap, axis=2)
    lb = jnp.maximum(jnp.maximum(ball, aabb) - _LB_PAD, 0.0)
    lb = jnp.where(jnp.isfinite(index.tile_rad)[None, :], lb, jnp.inf)
    torder = jnp.argsort(lb, axis=1).astype(jnp.int32)
    return jnp.take_along_axis(lb, torder, axis=1), torder


def _kernel(cnt_ref, cap_ref, lb_ref, ord_ref, t_ref, tid_ref, s_ref,
            idx_ref, d2_ref, lo_ref, d2nd_ref, *, m_tiles: int, bs: int,
            ts: int):
    b = pl.program_id(0)
    rows = pl.ds(b * bs, bs)
    active = cnt_ref[b] > 0
    cap2 = cap_ref[0]
    sx = s_ref[0, rows][:, None]
    sy = s_ref[1, rows][:, None]
    sz = s_ref[2, rows][:, None]
    inf = jnp.full((bs,), jnp.inf, jnp.float32)
    big = jnp.full((bs,), _BIG_I, jnp.int32)

    def bound(j):
        return lb_ref[b, jnp.minimum(j, m_tiles - 1)]

    def cond(c):
        j, bmax = c[0], c[1]
        # lb is ascending and bmax only decreases, so the first failing
        # tile ends the block exactly
        return active & (j < m_tiles) & (bound(j) <= bmax)

    def body(c):
        j, _, bd, bi, bl, s1, s2, s1t, sm2, bti = c
        jt = ord_ref[b, j]
        cols = pl.ds(jt * ts, ts)
        tid = tid_ref[cols][None, :]
        dx = sx - t_ref[0, cols][None, :]
        dy = sy - t_ref[1, cols][None, :]
        dz = sz - t_ref[2, cols][None, :]
        d2 = jnp.where(tid < _BIG_I, dx * dx + dy * dy + dz * dz, jnp.inf)
        td = jnp.min(d2, axis=1)
        # lowest ORIGINAL index among the tile's minima
        eq = d2 == td[:, None]
        ti = jnp.min(jnp.where(eq, tid, _BIG_I), axis=1)
        finite = td < jnp.inf
        take = (td < bd) | ((td == bd) & finite & (ti < bi))
        # the tile's smallest d2 other than its own winner (an equal-valued
        # tie counts): bounds every non-winner point of this tile
        t2 = jnp.min(jnp.where(eq & (tid == ti[:, None]), jnp.inf, d2), axis=1)
        tl = td * (1.0 - ALPHA)
        # second-nearest bound: min over tiles OTHER than the winner's tile
        # of their slacked minimum (the two smallest tracked with the first
        # one's tile id), and the slacked second minimum of every tile
        new_min = tl < s1
        s2 = jnp.where(new_min, s1, jnp.minimum(s2, tl))
        s1t = jnp.where(new_min, jt, s1t)
        s1 = jnp.where(new_min, tl, s1)
        sm2 = jnp.minimum(sm2, t2 * (1.0 - ALPHA))
        bti = jnp.where(take, jt, bti)
        bi = jnp.where(take, ti, bi)
        bd = jnp.where(take, td, bd)
        bl = jnp.minimum(bl, tl)
        bmax = jnp.minimum(jnp.max(bd), cap2)
        return (j + 1, bmax, bd, bi, bl, s1, s2, s1t, sm2, bti)

    # s1t and bti start unequal so an empty row never matches its own tile
    init = (jnp.int32(0), cap2, inf, big, inf, inf, inf,
            jnp.full((bs,), -1, jnp.int32), inf, jnp.full((bs,), -2, jnp.int32))
    j_fin, _, bd, bi, bl, s1, s2, s1t, sm2, bti = jax.lax.while_loop(
        cond, body, init)
    idx_ref[rows] = jnp.where(active & (bi < _BIG_I), bi, 0)
    d2_ref[rows] = jnp.where(active, bd, jnp.inf)
    # every skipped tile lies above bmax >= the row's computed best (or the
    # cap), so the visited tiles' slacked minima bound the row; rows with no
    # candidate below the cap get the cap itself
    lo_ref[rows] = jnp.where(
        active, jnp.maximum(jnp.minimum(bl, cap2) - _ABS, 0.0), jnp.inf)
    # skipped tiles lie at/above the break tile's (ascending) bound
    floor = jnp.where(j_fin < m_tiles, bound(j_fin), jnp.inf)
    other = jnp.where(bti == s1t, s2, s1)
    second = jnp.minimum(jnp.minimum(other, sm2), floor)
    d2nd_ref[rows] = jnp.where(active, jnp.maximum(second - _ABS, 0.0),
                               jnp.inf)


def nearest_neighbors_pallas(src: jnp.ndarray, index: TargetIndex,
                             n_active: jnp.ndarray | None = None,
                             cap2: jnp.ndarray | None = None,
                             block_counts: jnp.ndarray | None = None,
                             block_table=None, drift=None
                             ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                                        jnp.ndarray, jnp.ndarray]:
    """1-NN of each ``src`` row among the index's valid targets.

    Returns ``(idx, sqdist, sqdist_lower_bound, second_lower_bound, coords)``:
    idx in ORIGINAL target numbering with lowest-index tie-breaking (0 when
    no valid target, sqdist +inf); both bounds are SOUND (true value >=
    bound), tight when sources arrive spatially sorted.
    ``second_lower_bound`` bounds the distance to the closest target
    EXCLUDING the winner (+inf on skipped blocks) — the ICP
    winner-certificate input.  ``coords`` are the winner's (x, y, z) (zeros
    when no candidate) so callers need no target cloud of their own.

    ``n_active`` (scalar int32): only the first ``n_active`` source rows are
    queried; blocks past it return at once (idx 0 / +inf).

    ``block_counts`` ((n_blocks,) int32, overrides ``n_active``): per-block
    active-row counts for IN-PLACE subset queries — blocks with count 0
    return at once (idx 0 / +inf for their rows).

    ``cap2`` (scalar float32, default +inf = exact sweep): search cap on
    squared distance.  Rows whose true NN d2 is below ``cap2`` get exactly the
    uncapped result; other rows may return any candidate (or idx 0 / +inf)
    with d2 >= cap2, and the returned lower bound stays sound (<= cap2).

    ``block_table`` / ``drift``: a prebuilt :func:`build_block_table` for a
    cloud every row of which has since moved at most ``drift``.
    """
    block, tile = _SRC_BLOCK, _TGT_TILE
    n = src.shape[0]
    np_ = -(-n // block) * block
    n_blocks = np_ // block
    m_tiles = index.coords.shape[1] // tile
    if n_active is None:
        n_active = jnp.int32(n)
    if cap2 is None:
        cap2 = jnp.float32(jnp.inf)
    if block_counts is None:
        block_counts = jnp.clip(
            jnp.asarray(n_active, jnp.int32)
            - jnp.arange(n_blocks, dtype=jnp.int32) * block, 0, block)
    # pad rows with the last row's coords (zeros would drag block bounding
    # boxes toward the origin)
    srcf = jnp.pad(src.astype(jnp.float32), ((0, np_ - n), (0, 0)),
                   mode="edge")
    if block_table is None:
        lb_lin, torder = build_block_table(srcf, index)
    else:
        lb_lin, torder = block_table
    if drift is not None:
        # every row moved by <= drift since the table was built: each linear
        # bound shrinks by at most drift, and a uniform scalar subtraction
        # preserves the ascending visit order exactly
        lb_lin = jnp.maximum(lb_lin - jnp.asarray(drift, jnp.float32), 0.0)
    lb2 = jnp.where(jnp.isfinite(lb_lin), lb_lin * lb_lin, jnp.inf)

    out = [jax.ShapeDtypeStruct((np_,), jnp.int32)] + \
        [jax.ShapeDtypeStruct((np_,), jnp.float32)] * 3
    idx, d2, lo, d2nd = pl.pallas_call(
        partial(_kernel, m_tiles=m_tiles, bs=block, ts=tile),
        out_shape=out,
        grid=(n_blocks,),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=1),
        interpret=_interpret(),
        name="nn_pruned",
    )(jnp.asarray(block_counts, jnp.int32).reshape(n_blocks),
      jnp.asarray(cap2, jnp.float32).reshape(1), lb2, torder,
      index.coords, index.tidx, srcf.T)
    idx, d2, lo, d2nd = idx[:n], d2[:n], lo[:n], d2nd[:n]
    crd = jnp.where(jnp.isfinite(d2)[:, None],
                    index.coords[:, index.tpos[idx]].T, 0.0)
    return idx, d2, lo, d2nd, crd


def eligible(m: int) -> bool:
    return m <= MAX_TARGET
