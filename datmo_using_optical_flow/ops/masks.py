"""Velocity-grid derivation and motion masks (pipeline A stages A6-A8, A11).

Device equivalents of:

* flow -> m/s conversion + curl angular velocity (``Optical_flow/main.py:131-164``);
* continuity mask (``main.py:224-228``) — the only mask the reference applies;
* propagation masks (``main.py:167-221``) — dead code in the reference's main loop
  but part of its API surface, so provided (as deterministic scatters);
* point-in-polygon road filter (``main.py:297-334``, shapely in the reference) —
  implemented as a vmapped crossing-number test.

``np.gradient`` semantics (central differences, one-sided at edges) are replicated
exactly by :func:`gradient`.
"""

from __future__ import annotations

import jax.numpy as jnp


def gradient(a: jnp.ndarray, axis: int) -> jnp.ndarray:
    """np.gradient along one axis: central differences, one-sided edges."""
    a = jnp.moveaxis(a, axis, 0)
    interior = (a[2:] - a[:-2]) * 0.5
    first = (a[1] - a[0])[None]
    last = (a[-1] - a[-2])[None]
    return jnp.moveaxis(jnp.concatenate([first, interior, last], axis=0), 0, axis)


def velocity_from_flow(flow: jnp.ndarray, x_range, y_range
                       ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Flow px/frame -> m/s + curl angular velocity (``main.py:143-164``).

    Replicates the reference exactly: pixel size uses shape[1] for x and shape[0]
    for y, and dt is *not* applied in the scaling (``main.py:131`` accepts dt but
    never uses it).
    """
    vx_px, vy_px = flow[..., 0], flow[..., 1]
    pixel_size_x = (x_range[1] - x_range[0]) / flow.shape[1]
    pixel_size_y = (y_range[1] - y_range[0]) / flow.shape[0]
    velocity_x = vx_px * pixel_size_x
    velocity_y = vy_px * pixel_size_y
    dvx_dy = gradient(velocity_x, 0)
    dvy_dx = gradient(velocity_y, 1)
    angular_velocity = dvy_dx - dvx_dy
    return velocity_x, velocity_y, angular_velocity


def continuity_mask(vx: jnp.ndarray, vy: jnp.ndarray, alpha_cont: float) -> jnp.ndarray:
    """|div v| and |curl v| gate (``main.py:224-228``); int mask like the reference."""
    div_v = gradient(vx, 1) + gradient(vy, 0)
    curl_v = gradient(vy, 1) - gradient(vx, 0)
    return ((jnp.abs(div_v) <= alpha_cont) & (jnp.abs(curl_v) <= alpha_cont)).astype(jnp.int32)


def _scatter_last_writer(vx: jnp.ndarray, vy: jnp.ndarray, i2: jnp.ndarray,
                         j2: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Forward-scatter with numpy's last-writer-wins (row-major) collision order.

    XLA scatters are unordered on duplicates, so determinism is recovered by
    scattering each writer's row-major rank with ``max`` and gathering the winner.
    """
    h, w = vx.shape
    ok = (i2 >= 0) & (i2 < h) & (j2 >= 0) & (j2 < w)
    target = jnp.where(ok, i2 * w + j2, h * w).reshape(-1)
    writer = jnp.arange(h * w, dtype=jnp.int32)
    best = jnp.full((h * w + 1,), -1, dtype=jnp.int32).at[target].max(writer)[:h * w]
    has = best >= 0
    src = jnp.maximum(best, 0)
    pvx = jnp.where(has, vx.reshape(-1)[src], 0.0).reshape(h, w)
    pvy = jnp.where(has, vy.reshape(-1)[src], 0.0).reshape(h, w)
    return pvx, pvy


def propagation_mask(vx: jnp.ndarray, vy: jnp.ndarray, dt: float, grid_resolution,
                     alpha_p: float) -> jnp.ndarray:
    """Propagation gate (``main.py:167-183``): scatter each cell's velocity to its
    predicted cell, keep cells where scattered ~= actual within alpha_p."""
    h, w = vx.shape
    ii = jnp.arange(h)[:, None]
    jj = jnp.arange(w)[None, :]
    i2 = (ii + jnp.floor(vx * dt / grid_resolution[0])).astype(jnp.int32)
    j2 = (jj + jnp.floor(vy * dt / grid_resolution[1])).astype(jnp.int32)
    pvx, pvy = _scatter_last_writer(vx, vy, i2, j2)
    mask = (jnp.abs(pvx - vx) <= alpha_p) & (jnp.abs(pvy - vy) <= alpha_p)
    return mask.astype(jnp.int32)


def propagation_mask_with_acceleration(vx, vy, ax, ay, dt, grid_resolution,
                                       alpha_p: float) -> jnp.ndarray:
    """Propagation gate including the 1/2·a·t² term (``main.py:185-221``)."""
    h, w = vx.shape
    dxr, dyr = grid_resolution
    ii = jnp.arange(h)[:, None]
    jj = jnp.arange(w)[None, :]
    i2 = (ii + jnp.floor((vx * dt + 0.5 * ax * dt * dt) / dxr)).astype(jnp.int32)
    j2 = (jj + jnp.floor((vy * dt + 0.5 * ay * dt * dt) / dyr)).astype(jnp.int32)
    pvx, pvy = _scatter_last_writer(vx, vy, i2, j2)
    mask = (jnp.abs(pvx - vx) <= alpha_p) & (jnp.abs(pvy - vy) <= alpha_p)
    return mask.astype(jnp.int32)


def points_in_polygon(points_xy: jnp.ndarray, polygon_xy: jnp.ndarray) -> jnp.ndarray:
    """Crossing-number point-in-polygon test (shapely-free equivalent of the
    reference's road-ROI filter, ``main.py:297-334``).

    ``points_xy``: (N, 2); ``polygon_xy``: (V, 2) closed or open ring.
    Returns a boolean mask; points exactly on an edge follow the half-open
    crossing convention (matches ``shapely.contains`` for interior points).
    """
    px = points_xy[:, 0][:, None]
    py = points_xy[:, 1][:, None]
    x1 = polygon_xy[:, 0][None, :]
    y1 = polygon_xy[:, 1][None, :]
    x2 = jnp.roll(polygon_xy[:, 0], -1)[None, :]
    y2 = jnp.roll(polygon_xy[:, 1], -1)[None, :]
    cond = (y1 > py) != (y2 > py)
    denom = jnp.where(y2 - y1 == 0, 1.0, y2 - y1)
    xint = x1 + (py - y1) / denom * (x2 - x1)
    crossings = jnp.sum(cond & (px < xint), axis=1)
    return (crossings % 2) == 1
