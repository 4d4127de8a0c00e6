"""Halo exchange for row-sharded grids (spatial parallelism for stencils).

The stencil-pipeline analogue of sequence/context parallelism (SURVEY.md §2.5):
BEV/flow grids larger than one device's comfortable tile are sharded along rows
across a mesh axis; separable correlations then need ``radius`` boundary rows
from each neighbor, exchanged with ``ppermute``.

Used inside ``shard_map`` bodies — every function here takes the mesh axis name.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def halo_exchange_rows(x: jnp.ndarray, radius: int, axis_name: str,
                       edge_mode: str = "edge") -> jnp.ndarray:
    """Pad a row-sharded block with ``radius`` rows from each mesh neighbor.

    ``x``: this device's (H_local, W) block.  Returns (H_local + 2*radius, W);
    at the global image edges the halo is synthesized per ``edge_mode``:
    'edge' replication (the polyexp/box-filter convention) or 'reflect101'
    (cv2.GaussianBlur's BORDER_REFLECT_101).
    """
    n = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    top = x[:radius]       # rows this device sends upward
    bot = x[-radius:]      # rows this device sends downward
    # receive from neighbors: perm maps source -> destination
    down = [(i, i + 1) for i in range(n - 1)]   # bot of i -> halo-top of i+1
    up = [(i + 1, i) for i in range(n - 1)]     # top of i+1 -> halo-bottom of i
    from_above = jax.lax.ppermute(bot, axis_name, down)
    from_below = jax.lax.ppermute(top, axis_name, up)
    # global edges: synthesize the out-of-image halo rows
    if edge_mode == "reflect101":
        edge_top = x[1:radius + 1][::-1]
        edge_bot = x[-radius - 1:-1][::-1]
    else:
        edge_top = jnp.repeat(x[:1], radius, axis=0)
        edge_bot = jnp.repeat(x[-1:], radius, axis=0)
    first = idx == 0
    last = idx == n - 1
    top_halo = jnp.where(first, edge_top, from_above)
    bot_halo = jnp.where(last, edge_bot, from_below)
    return jnp.concatenate([top_halo, x, bot_halo], axis=0)


def sharded_sep_filter(x: jnp.ndarray, ky: np.ndarray, kx: np.ndarray,
                       axis_name: str) -> jnp.ndarray:
    """Separable 2-D filter on a row-sharded block, edge-padded globally.

    Matches :func:`datmo_using_optical_flow.ops.farneback.sep_filter` with
    ``pad_mode='edge'`` applied to the *global* image: the vertical pass gets its
    cross-shard support rows via halo exchange; the horizontal pass is local.
    """
    from datmo_using_optical_flow.ops.farneback import _corr_axis

    ry = len(ky) // 2
    h_local = x.shape[0]
    padded = halo_exchange_rows(x, ry, axis_name)
    # _corr_axis edge-pads its input again; the interior rows [ry : ry+h_local]
    # of its output are supported entirely by true halo rows — keep those.
    v = _corr_axis(padded, ky, -2, "edge")[ry:ry + h_local]
    return _corr_axis(v, kx, -1, "edge")


def sharded_box_blur5(m: jnp.ndarray, winsize: int, axis_name: str) -> jnp.ndarray:
    """Row-sharded equivalent of ``ops.farneback.box_blur5`` ((5, H_local, W))."""
    from datmo_using_optical_flow.ops.farneback import _corr_axis

    r = winsize // 2
    h_local = m.shape[1]
    ones = np.ones(winsize, dtype=np.float32)
    blocks = jnp.stack([halo_exchange_rows(m[c], r, axis_name)
                        for c in range(m.shape[0])])
    v = _corr_axis(blocks, ones, -2, "edge")[:, r:r + h_local]
    out = _corr_axis(v, ones, -1, "edge")
    return out * np.float32(1.0 / (winsize * winsize))
