"""Static Occupancy Map (SOM) update — exact sequential-clamp semantics on device.

Device equivalent of ``update_som_with_gmfa`` + ``point_to_grid_index``
(``GMFA/GMFA.py:65-70,134-142``).  The reference applies per-point ±0.1 evidence
*sequentially with clamping to [0.05, 0.95]*, which is order-dependent: e.g. a
decrement while the cell sits at the floor is a no-op, so summed-then-clipped
updates diverge on cells receiving mixed evidence (common, since the map starts
at the floor).

Exact replication: a clipped add ``v -> min(max(v + a, l), h)`` is closed under
composition — ``(a, l, h)`` triples form a monoid:

    compose(t1, t2) = (a1+a2, min(max(l1+a2, l2), h2), min(max(h1+a2, l2), h2))

so each cell's ordered hit sequence reduces with one **sorted segmented
associative scan**: stable-sort hits by cell (preserving point order within a
cell), scan the monoid with segment resets, take each segment's last triple, and
apply it to the cell's current value.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_NEG = jnp.float32(-3e38)
_POS = jnp.float32(3e38)


def point_grid_indices(points: jnp.ndarray, grid_size: int, cell_resolution
                       ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Row/col per point (``GMFA.py:65-70``): floor-divide with half-grid offset."""
    rx, ry = cell_resolution
    row = jnp.floor_divide(points[:, 0] + grid_size * rx / 2.0, rx).astype(jnp.int32)
    col = jnp.floor_divide(points[:, 1] + grid_size * ry / 2.0, ry).astype(jnp.int32)
    return row, col


def _compose(t1, t2):
    a1, l1, h1 = t1
    a2, l2, h2 = t2
    a = a1 + a2
    l = jnp.minimum(jnp.maximum(l1 + a2, l2), h2)
    h = jnp.minimum(jnp.maximum(h1 + a2, l2), h2)
    return a, l, h


def update_som(som: jnp.ndarray, points: jnp.ndarray, mask: jnp.ndarray,
               residuals: jnp.ndarray, static_threshold: float,
               moving_threshold: float, cell_resolution,
               increment: float = 0.1, decrement: float = 0.1,
               max_value: float = 0.95, min_value: float = 0.05) -> jnp.ndarray:
    """Sequential-exact static/moving evidence accumulation (``GMFA.py:134-142``)."""
    g = som.shape[0]
    n = points.shape[0]
    row, col = point_grid_indices(points, g, cell_resolution)
    inb = mask & (row >= 0) & (row < g) & (col >= 0) & (col < g)
    static = inb & (residuals < static_threshold)
    moving = inb & (residuals > moving_threshold)
    hit = static | moving  # mid-band residuals are no-ops in the reference
    delta = jnp.where(static, increment, jnp.where(moving, -decrement, 0.0)).astype(jnp.float32)
    cell = jnp.where(hit, row * g + col, g * g).astype(jnp.int32)

    # stable sort by cell: within a cell, original point order is preserved
    order = jnp.argsort(cell, stable=True)
    cell_s = cell[order]
    delta_s = delta[order]

    # per-hit clipped-add triple; no-op hits are the monoid identity
    is_hit = cell_s < g * g
    a = jnp.where(is_hit, delta_s, 0.0)
    lo = jnp.where(is_hit, jnp.float32(min_value), _NEG)
    hi = jnp.where(is_hit, jnp.float32(max_value), _POS)

    # segmented scan: reset composition at segment (cell) starts
    first = jnp.concatenate([jnp.ones((1,), bool), cell_s[1:] != cell_s[:-1]])

    def seg_op(x, y):
        fx, (ax, lx, hx) = x
        fy, (ay, ly, hy) = y
        comp = _compose((ax, lx, hx), (ay, ly, hy))
        t = tuple(jnp.where(fy, p2, p1) for p1, p2 in zip(comp, (ay, ly, hy)))
        return fx | fy, t

    _, (a_sc, lo_sc, hi_sc) = jax.lax.associative_scan(seg_op, (first, (a, lo, hi)))

    # last element of each segment carries the cell's full composition
    last = jnp.concatenate([cell_s[1:] != cell_s[:-1], jnp.ones((1,), bool)])
    valid_last = last & is_hit
    tgt = jnp.where(valid_last, cell_s, g * g)
    acc_a = jnp.zeros((g * g + 1,), jnp.float32).at[tgt].set(a_sc, mode="drop")[:g * g]
    acc_l = jnp.full((g * g + 1,), _NEG).at[tgt].set(lo_sc, mode="drop")[:g * g]
    acc_h = jnp.full((g * g + 1,), _POS).at[tgt].set(hi_sc, mode="drop")[:g * g]

    flat = som.reshape(-1)
    out = jnp.minimum(jnp.maximum(flat + acc_a, acc_l), acc_h)
    return out.reshape(g, g).astype(som.dtype)
