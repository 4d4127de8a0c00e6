"""BEV rasterization as segment reductions (no Python loops).

Device equivalent of ``compute_bev_grid`` (``Optical_flow/main.py:98-126``), which
the reference implements as a pure-Python nested-list binning loop — its slowest stage.
Here it is segment reductions over statically-shaped point buffers, summed in
a fixed order.

Reference semantics replicated exactly:

* bin edges via ``np.arange(lo, hi, step)`` — grid shape = number of arange entries;
* ``x_idx = int((x - x0)/w)`` — **truncation toward zero** (``main.py:106-107``), so
  points in ``(x0 - w, x0)`` land in bin 0;
* cell value ``(a·mean(z) + b·std(z))/h_max`` with population std (``main.py:114-118``);
* renormalize by grid max, then ``(v*255).astype(uint8)`` truncation (``main.py:122-123``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from datmo_using_optical_flow.ops.linalg import div_rn, sqrt_rn


def _ordered_segment_sum(values: jnp.ndarray, segments: jnp.ndarray,
                         order: jnp.ndarray, num_segments: int) -> jnp.ndarray:
    """Float segment sum in a FIXED order: sort by segment (``order`` is the
    stable argsort of ``segments``), segmented inclusive scan, keep each
    segment's last element.  A float scatter-add runs on the GPU with
    atomics in an order that changes from run to run; this sum is the same
    bits on every run and on every backend, so the uint8 BEV is too."""
    seg = segments[order]
    vals = values[order]
    first = jnp.concatenate([jnp.ones((1,), bool), seg[1:] != seg[:-1]])

    def op(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va + vb)

    _, run = jax.lax.associative_scan(op, (first, vals))
    last = jnp.concatenate([seg[1:] != seg[:-1], jnp.ones((1,), bool)])
    dest = jnp.where(last, seg, num_segments)
    return jnp.zeros((num_segments,), values.dtype).at[dest].set(
        run, mode="drop")


@partial(jax.jit, static_argnames=("grid_shape",))
def bev_cell_stats(points: jnp.ndarray, mask: jnp.ndarray, grid_shape: tuple[int, int],
                   x_range, y_range, grid_resolution
                   ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-cell (count, mean_z, std_z) over points binned into the BEV grid.

    Returns float arrays of shape ``grid_shape`` (= (nx, ny); row = x bin as in the
    reference, ``main.py:111``).
    """
    nx, ny = grid_shape
    w, h = grid_resolution
    dtype = points.dtype
    # IEEE divisions and square roots throughout (ops/linalg.py): the uint8
    # BEV is then the same bits on the GPU as on the CPU
    xi = jnp.trunc(div_rn(points[:, 0] - x_range[0], jnp.float32(w))).astype(jnp.int32)
    yi = jnp.trunc(div_rn(points[:, 1] - y_range[0], jnp.float32(h))).astype(jnp.int32)
    ok = mask & (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
    cell = jnp.where(ok, xi * ny + yi, nx * ny)  # out-of-grid -> scratch segment
    num_segments = nx * ny + 1

    z = points[:, 2]
    zm = jnp.where(ok, z, 0.0)
    # counts are integers: exact in any summation order
    cnt = jax.ops.segment_sum(ok.astype(jnp.int32), cell,
                              num_segments).astype(dtype)
    order = jnp.argsort(cell, stable=True)
    s1 = _ordered_segment_sum(zm, cell, order, num_segments)
    safe_cnt = jnp.maximum(cnt, 1.0)
    mean = div_rn(s1, safe_cnt)
    # two-pass variance (matches np.std's mean-of-squared-deviations numerics
    # far better than E[z^2]-E[z]^2)
    dev = jnp.where(ok, z - mean[cell], 0.0)
    s2 = _ordered_segment_sum(dev * dev, cell, order, num_segments)
    std = sqrt_rn(div_rn(s2, safe_cnt))

    cnt = cnt[:-1].reshape(nx, ny)
    mean = mean[:-1].reshape(nx, ny)
    std = std[:-1].reshape(nx, ny)
    return cnt, mean, std


@partial(jax.jit, static_argnames=("grid_shape",))
def compute_bev_grid(points: jnp.ndarray, mask: jnp.ndarray, grid_shape: tuple[int, int],
                     x_range, y_range, grid_resolution, a: float = 0.5, b: float = 0.5,
                     h_max: float = 5.0) -> jnp.ndarray:
    """uint8 BEV grid, bit-matching ``compute_bev_grid`` (``main.py:98-126``)."""
    cnt, mean, std = bev_cell_stats(points, mask, grid_shape, x_range, y_range, grid_resolution)
    vals = jnp.where(cnt > 0, div_rn(a * mean + b * std, jnp.float32(h_max)), 0.0)
    vmax = jnp.max(vals)
    # reference divides unconditionally (main.py:122); empty grids give 0/0 -> we guard
    vals = div_rn(vals, jnp.where(vmax > 0, vmax, 1.0))
    # numpy's float->uint8 astype truncates toward zero then wraps modulo 256
    # (negative cell values — possible since mean(z) can be < 0 — wrap, main.py:123);
    # XLA's convert would clamp, so wrap explicitly for bit-parity.
    i32 = jnp.trunc(vals * 255.0).astype(jnp.int32)
    return (i32 % 256).astype(jnp.uint8)
