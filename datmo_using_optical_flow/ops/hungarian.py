"""Exact linear-sum assignment on device (Jonker-Volgenant shortest augmenting path).

Device replacement for ``scipy.optimize.linear_sum_assignment`` as used by the
reference's track association (``GMFA/GMFA.py:204``).  The matrices are tiny
(tracks x clusters, tens x tens), so the goal is exactness + fixed shapes inside
jit, not raw FLOPs: rectangular inputs are padded to a square with a large finite
cost (dummy assignments absorb the slack without perturbing real pairs), and the
classic O(n³) potentials algorithm runs as ``fori``/``while`` loops.

Returns the column assigned to each row; optimality is exact (ties may resolve
differently from scipy, with equal total cost).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_BIG = 1e9
_INF = jnp.float32(3e38)
# compacted-tier capacity: both masked counts must fit for the small solve
_COMPACT_CAP = 16


@partial(jax.jit, static_argnames=())
def solve_square(cost: jnp.ndarray) -> jnp.ndarray:
    """Assignment for a square (n, n) float cost matrix -> col4row (n,) int32."""
    n = cost.shape[0]
    cost = cost.astype(jnp.float32)
    # columns 0..n-1 real, column n is the virtual start column j0
    u = jnp.zeros((n,), jnp.float32)
    v = jnp.zeros((n + 1,), jnp.float32)
    p = jnp.full((n + 1,), -1, jnp.int32)  # p[j] = row matched to column j

    def assign_row(i, carry):
        u, v, p = carry
        p = p.at[n].set(i)
        minv = jnp.full((n + 1,), _INF).at[n].set(-_INF)  # virtual col never re-picked
        used = jnp.zeros((n + 1,), bool)
        way = jnp.zeros((n + 1,), jnp.int32)

        def cond(s):
            _, _, p_, _, _, _, j0 = s
            return p_[j0] != -1

        def body(s):
            u_, v_, p_, minv_, used_, way_, j0 = s
            used_ = used_.at[j0].set(True)
            i0 = p_[j0]
            cur = cost[i0, :] - u_[i0] - v_[:n]
            improve = (~used_[:n]) & (cur < minv_[:n])
            minv_ = minv_.at[:n].set(jnp.where(improve, cur, minv_[:n]))
            way_ = way_.at[:n].set(jnp.where(improve, j0, way_[:n]))
            masked = jnp.where(used_[:n], _INF, minv_[:n])
            j1 = jnp.argmin(masked).astype(jnp.int32)
            delta = masked[j1]
            # update potentials
            urows = jnp.where(used_, p_, -1)
            add = jnp.zeros((n,), jnp.float32)
            valid = (urows >= 0)
            add = add.at[jnp.where(valid, urows, 0)].add(
                jnp.where(valid, delta, 0.0))
            # each used column has a distinct matched row, so the scatter adds
            # delta exactly once per such row
            u_ = u_ + add
            v_ = jnp.where(used_, v_ - delta, v_)
            minv_ = jnp.where(used_, minv_, minv_ - delta)
            return u_, v_, p_, minv_, used_, way_, j1

        u, v, p, minv, used, way, j0 = jax.lax.while_loop(
            cond, body, (u, v, p, minv, used, way, jnp.int32(n)))

        # augment along the alternating path back to the virtual column
        def aug_cond(s):
            _, j0 = s
            return j0 != n

        def aug_body(s):
            p_, j0 = s
            j1 = way[j0]
            p_ = p_.at[j0].set(p_[j1])
            return p_, j1

        p, _ = jax.lax.while_loop(aug_cond, aug_body, (p, j0))
        return u, v, p

    u, v, p = jax.lax.fori_loop(0, n, assign_row, (u, v, p))
    col4row = jnp.zeros((n,), jnp.int32)
    col4row = col4row.at[p[:n]].set(jnp.arange(n, dtype=jnp.int32))
    return col4row


def linear_sum_assignment(cost: jnp.ndarray, row_mask: jnp.ndarray | None = None,
                          col_mask: jnp.ndarray | None = None
                          ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Masked rectangular assignment over a padded (R, C) cost matrix.

    Returns ``(col4row (R,), valid (R,))`` where ``valid`` marks rows that got a
    real (unmasked-column) partner — the device analogue of scipy's
    ``(row_ind, col_ind)`` for the reference's use (every real row of the smaller
    side gets matched; cost thresholding happens downstream, GMFA.py:208-211).

    Numerical note: masked/slack entries are padded with ``max(real cost) + 1``,
    not a huge constant — in float32 a huge pad would absorb the real costs in
    the potential updates and destroy optimality of the real sub-assignment.
    Dummy *rows* are constant-cost, so they never perturb real rows' optimum.
    """
    r, c = cost.shape
    cost = cost.astype(jnp.float32)
    finite = jnp.isfinite(cost)
    if row_mask is not None:
        finite = finite & row_mask[:, None]
    if col_mask is not None:
        finite = finite & col_mask[None, :]
    big = jnp.max(jnp.where(finite, cost, 0.0)) + 1.0
    masked_cost = jnp.where(finite, cost, big)

    def _solve_full(_):
        if r <= c:
            padded = jnp.zeros((c, c), jnp.float32).at[:r, :c].set(masked_cost)
            return solve_square(padded)[:r]
        # transpose so every (real) column row gets matched, then invert
        padded = jnp.zeros((r, r), jnp.float32).at[:c, :r].set(masked_cost.T)
        row4col = solve_square(padded)[:c]  # row index for each real column
        return jnp.full((r,), c, jnp.int32).at[row4col].set(
            jnp.arange(c, dtype=jnp.int32), mode="drop")

    # Compacted tier (r5): solve_square's cost is its SEQUENTIAL row loop
    # (n fori rows x an inner Dijkstra while_loop — ~17 ms in-program at the
    # GMFA 64x32 capacity), while the REAL problem is tiny: GMFA's unmatched
    # tracks are dropped every frame, so live rows/cols are a handful.  When
    # both masked counts fit _COMPACT_CAP, gather the valid rows/columns
    # (top_k over sign-flipped iota keys — ascending, stable), solve the
    # (_COMPACT_CAP, _COMPACT_CAP) sub-problem, and scatter assignments back.
    # Optimality over the valid sub-matrix is the same problem; masked
    # rows/cols only ever pair with slack in the full solve and are reported
    # unmatched (col4row = c) here — ``valid`` is computed identically either
    # way.  (Degenerate ties between equal-cost optima may resolve
    # differently than the full solve, as they already may vs scipy.)
    if (row_mask is not None and col_mask is not None
            and min(r, c) > _COMPACT_CAP):
        nrow = jnp.sum(row_mask.astype(jnp.int32))
        ncol = jnp.sum(col_mask.astype(jnp.int32))

        def _solve_small(_):
            k = _COMPACT_CAP

            def top_idx(mask, n):
                iota = jnp.arange(n, dtype=jnp.int32)
                sentinel = jnp.int32(-(2 ** 31) + 1)
                vals, _ = jax.lax.top_k(jnp.where(mask, -iota, sentinel), k)
                okay = vals > sentinel
                return jnp.where(okay, -vals, 0), okay

            ridx, rok = top_idx(row_mask, r)
            cidx, cok = top_idx(col_mask, c)
            sub = masked_cost[ridx][:, cidx]
            sub = jnp.where(rok[:, None] & cok[None, :], sub, big)
            sub4 = solve_square(sub)                     # (k,) in sub-col space
            subcol = jnp.clip(sub4, 0, k - 1)
            mapped = jnp.where(cok[subcol], cidx[subcol], c)
            out = jnp.full((r,), c, jnp.int32)
            dest = jnp.where(rok, ridx, r)
            return out.at[dest].set(mapped, mode="drop")

        col4row = jax.lax.cond((nrow <= _COMPACT_CAP) & (ncol <= _COMPACT_CAP),
                               _solve_small, _solve_full, 0)
    else:
        col4row = _solve_full(0)
    inb = col4row < c
    chosen = masked_cost[jnp.arange(r), jnp.clip(col4row, 0, c - 1)]
    valid = inb & (chosen < big)
    if row_mask is not None:
        valid = valid & row_mask
    if col_mask is not None:
        valid = valid & col_mask[jnp.clip(col4row, 0, c - 1)]
    return col4row, valid
