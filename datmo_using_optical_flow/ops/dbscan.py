"""On-device DBSCAN via tiled neighbor counting + union-find label propagation.

Device equivalent of ``sklearn.cluster.DBSCAN`` as used by the reference at
``Optical_flow/main.py:231-259`` (features ``[row, col, vx, vy]``) and
``GMFA/GMFA.py:57-63`` (raw 3-D points).  Everything is fixed-shape:

* pairwise squared distances tile-by-tile by direct differences (never materializing
  the full N x N matrix);
* core mask = neighbor count (inclusive of self) >= min_samples;
* connected components over the core-core graph by iterated min-hooking +
  pointer doubling (``lax.while_loop``, O(log N) rounds);
* border points attach to the minimum-rooted neighboring cluster.

Label semantics vs sklearn: cluster ids are assigned by ascending minimum core
index, which equals sklearn's visitation order.  A border point reachable from
two clusters gets the lower cluster id here — which coincides with sklearn,
because sklearn expands clusters fully in ascending id order, so the "first BFS
visitor" of a shared border point is always the lower-id cluster (pinned by
``tests/test_dbscan.py::test_dbscan_shared_border_point`` across point
orderings).  Noise = -1, padding rows also report -1.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_TILE = 512
# below this padded size the whole pairwise matrix is computed at once: one
# pass + row reductions beat the tiled scan's sequential dispatches
_FULL_MATRIX_MAX = 8192
_INF_I32 = jnp.iinfo(jnp.int32).max


def _pad_len(n: int) -> int:
    return (-n) % _TILE


def _sqdist_tile(feats: jnp.ndarray, tile: jnp.ndarray) -> jnp.ndarray:
    """(N, T) squared euclidean distances by direct differences, one feature
    column at a time (K <= 4: no matrix product, and no ``|x|^2+|t|^2-2x.t``
    cancellation at grid coordinates of ~200 cells against eps^2)."""
    d2 = None
    for k in range(feats.shape[1]):
        dk = feats[:, k:k + 1] - tile[:, k][None, :]
        d2 = dk * dk if d2 is None else d2 + dk * dk
    return d2


@partial(jax.jit, static_argnames=("min_samples",))
def _core_mask(feats: jnp.ndarray, valid: jnp.ndarray, eps: jnp.ndarray,
               min_samples: int) -> jnp.ndarray:
    n = feats.shape[0]
    eps2 = eps * eps
    validf = valid.astype(feats.dtype)

    def count_tile(carry, j):
        tile = jax.lax.dynamic_slice_in_dim(feats, j * _TILE, _TILE, 0)
        tvalid = jax.lax.dynamic_slice_in_dim(validf, j * _TILE, _TILE, 0)
        d2 = _sqdist_tile(feats, tile)
        cnt = jnp.sum((d2 <= eps2) * tvalid[None, :], axis=1)
        return carry + cnt, None

    counts, _ = jax.lax.scan(count_tile, jnp.zeros((n,), feats.dtype),
                             jnp.arange(n // _TILE))
    return valid & (counts >= min_samples)


def _min_rep_over_core_neighbors(feats, core, eps2, rep):
    """For every point: min rep among *core* points within eps (excluding nothing)."""
    n = feats.shape[0]

    def tile_step(carry, j):
        tile = jax.lax.dynamic_slice_in_dim(feats, j * _TILE, _TILE, 0)
        tcore = jax.lax.dynamic_slice_in_dim(core, j * _TILE, _TILE, 0)
        trep = jax.lax.dynamic_slice_in_dim(rep, j * _TILE, _TILE, 0)
        d2 = _sqdist_tile(feats, tile)
        adj = (d2 <= eps2) & tcore[None, :]
        cand = jnp.min(jnp.where(adj, trep[None, :], _INF_I32), axis=1)
        return jnp.minimum(carry, cand), None

    out, _ = jax.lax.scan(tile_step, jnp.full((n,), _INF_I32, jnp.int32),
                          jnp.arange(n // _TILE))
    return out


@partial(jax.jit, static_argnames=("min_samples", "max_rounds"))
def dbscan(features: jnp.ndarray, valid: jnp.ndarray, eps: float | jnp.ndarray,
           min_samples: int, max_rounds: int = 64) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Run DBSCAN on padded ``(N, D)`` features.

    Returns ``(labels, core_mask)``: labels are int32, -1 for noise/padding,
    cluster ids 0..k-1 ordered by ascending minimum core index (sklearn order).
    """
    n, _ = features.shape
    pad = _pad_len(n)
    feats = jnp.pad(features.astype(jnp.float32), ((0, pad), (0, 0)),
                    constant_values=3e18)  # padding far from everything
    validp = jnp.pad(valid, ((0, pad),))
    npad = feats.shape[0]
    eps = jnp.asarray(eps, jnp.float32)
    eps2 = eps * eps

    if npad <= _FULL_MATRIX_MAX:
        # full pairwise matrix in one shot (same math as the tiled scan)
        d2 = _sqdist_tile(feats, feats)
        nbr = (d2 <= eps2) & validp[None, :]
        counts = jnp.sum(nbr.astype(feats.dtype), axis=1)
        core = validp & (counts >= min_samples)
        adjc = nbr & core[None, :]

        def min_rep(rep):
            return jnp.min(jnp.where(adjc, rep[None, :], _INF_I32), axis=1)
    else:
        core = _core_mask(feats, validp, eps, min_samples)

        def min_rep(rep):
            return _min_rep_over_core_neighbors(feats, core, eps2, rep)

    idx = jnp.arange(npad, dtype=jnp.int32)
    rep0 = jnp.where(core, idx, _INF_I32)

    def cond(state):
        rep, changed, it = state
        return changed & (it < max_rounds)

    def body(state):
        rep, _, it = state
        hooked = min_rep(rep)
        new = jnp.where(core, jnp.minimum(rep, hooked), rep)
        # pointer doubling (guard INF sentinels)
        safe = jnp.where(new == _INF_I32, 0, new)
        new2 = jnp.where(new == _INF_I32, new, new[safe])
        safe2 = jnp.where(new2 == _INF_I32, 0, new2)
        new3 = jnp.where(new2 == _INF_I32, new2, new2[safe2])
        return new3, jnp.any(new3 != rep), it + 1

    rep, _, _ = jax.lax.while_loop(cond, body, (rep0, jnp.asarray(True), 0))

    # attach border points: min root among core neighbors
    border_rep = min_rep(rep)
    point_rep = jnp.where(core, rep, border_rep)
    assigned = validp & (point_rep != _INF_I32)

    # compact cluster ids by ascending root index (== sklearn visitation order)
    is_root = core & (rep == idx)
    root_rank = jnp.cumsum(is_root.astype(jnp.int32)) - 1
    safe_rep = jnp.where(assigned, point_rep, 0)
    labels = jnp.where(assigned, root_rank[safe_rep], -1).astype(jnp.int32)
    return labels[:n], core[:n]


@partial(jax.jit, static_argnames=("min_samples", "grid_shape", "max_cells"))
def dbscan_velocity_grid(vx: jnp.ndarray, vy: jnp.ndarray, valid_mask: jnp.ndarray,
                         eps: float, min_samples: int, grid_shape: tuple[int, int],
                         max_cells: int):
    """Pipeline-A clustering (``main.py:231-259``): features = [row, col, vx, vy]
    of masked cells, compacted to a fixed ``max_cells`` capacity.

    Returns ``(labels, rows, cols, cell_mask, count)`` — the device analogue of
    sklearn's ``(labels_, valid_indices)``; row-major cell order matches
    ``np.nonzero`` so artifact parity holds.
    """
    from datmo_using_optical_flow.utils.padding import compact_masked

    h, w = grid_shape
    rows = (jnp.arange(h * w, dtype=jnp.int32) // w)
    cols = (jnp.arange(h * w, dtype=jnp.int32) % w)
    feats_full = jnp.stack([rows.astype(jnp.float32), cols.astype(jnp.float32),
                            vx.reshape(-1), vy.reshape(-1)], axis=1)
    mask = valid_mask.reshape(-1).astype(bool)
    feats, cmask, count = compact_masked(feats_full, mask, max_cells, fill_value=3e18)
    labels, _ = dbscan(feats, cmask, eps, min_samples)
    r = feats[:, 0].astype(jnp.int32)
    c = feats[:, 1].astype(jnp.int32)
    r = jnp.where(cmask, r, -1)
    c = jnp.where(cmask, c, -1)
    return labels, r, c, cmask, count
