"""Row-sharded Farnebäck level: spatial parallelism for grids beyond one device.

The SURVEY.md §2.5 'spatial parallelism' design: the flow grid is sharded along
rows across a mesh axis; each stencil pass exchanges halo rows between devices
(``ppermute``), and the flow-compensated warp reads the target coefficient planes
through a halo of ``warp_halo`` rows — i.e. **vertical displacement is bounded by
the halo depth** (per level; coarse-to-fine keeps per-level vertical residuals
small).  Horizontal displacement is unrestricted (rows are complete).  Flows
within the bound are bit-compatible with the unsharded level; beyond it the warp
clamps to the halo edge (a documented deviation from unsharded behavior).

All functions run inside ``shard_map`` bodies on blocks of shape
``(5, H_local, W)`` / ``(H_local, W)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from datmo_using_optical_flow.oracle.np_farneback import BORDER, BORDER_ATTEN
from datmo_using_optical_flow.ops.farneback import solve_flow
from datmo_using_optical_flow.parallel.halo import (halo_exchange_rows,
                                                        sharded_box_blur5)


def _halo_stack(planes: jnp.ndarray, radius: int, axis_name: str) -> jnp.ndarray:
    """halo_exchange_rows over the leading channel axis: (C, hl, W) -> (C, hl+2r, W)."""
    return jnp.stack([halo_exchange_rows(planes[c], radius, axis_name)
                      for c in range(planes.shape[0])])


def sharded_poly_exp(img_block: jnp.ndarray, n: int, sigma: float,
                     axis_name: str) -> jnp.ndarray:
    """Row-sharded polynomial expansion -> (5, H_local, W) coefficient blocks."""
    from datmo_using_optical_flow.ops.farneback import poly_exp

    hl = img_block.shape[0]
    ext = halo_exchange_rows(img_block, n, axis_name)
    # the unsharded poly_exp edge-pads again; its interior rows are supported
    # entirely by true halo rows
    return poly_exp(ext, n, sigma)[:, n:n + hl, :]


def _border_scale_rows(ys_global: jnp.ndarray, h_global: int) -> jnp.ndarray:
    near = jnp.minimum(ys_global, h_global - 1 - ys_global)
    atten = jnp.asarray(BORDER_ATTEN)
    return jnp.where(near < BORDER, atten[jnp.clip(near, 0, BORDER - 1)], 1.0)


def sharded_update_matrices(R0: jnp.ndarray, R1ext: jnp.ndarray, dx: jnp.ndarray,
                            dy: jnp.ndarray, axis_name: str, warp_halo: int,
                            h_global: int) -> jnp.ndarray:
    """Flow-compensated normal-equation planes on a row-sharded block.

    ``R1ext``: (5, H_local + 2*warp_halo, W) from :func:`_halo_stack`.
    Matches :func:`ops.farneback.update_matrices` exactly while |dy| stays within
    ``warp_halo`` rows of the local block.
    """
    _, hl, w = R0.shape
    start = jax.lax.axis_index(axis_name) * hl
    xs = jnp.arange(w, dtype=dx.dtype)[None, :]
    ys_local = jnp.arange(hl, dtype=dx.dtype)[:, None]
    ys_global = ys_local + start

    fx = xs + dx
    fy = ys_global + dy
    x1 = jnp.floor(fx)
    y1 = jnp.floor(fy)
    fx = fx - x1
    fy = fy - y1
    x1i = x1.astype(jnp.int32)
    y1i = y1.astype(jnp.int32)  # global row index
    inside = (x1i >= 0) & (x1i < w - 1) & (y1i >= 0) & (y1i < h_global - 1)
    x1c = jnp.clip(x1i, 0, max(w - 2, 0))
    # local row in the extended block; clamping bounds the vertical displacement
    y1l = jnp.clip(y1i - start + warp_halo, 0, hl + 2 * warp_halo - 2)

    flat = R1ext.reshape(5, -1)
    base = (y1l * w + x1c).reshape(-1)

    def take(off):
        return flat[:, base + off].reshape(5, hl, w)

    a00 = ((1 - fx) * (1 - fy))[None]
    a01 = (fx * (1 - fy))[None]
    a10 = ((1 - fx) * fy)[None]
    a11 = (fx * fy)[None]
    r = a00 * take(0) + a01 * take(1) + a10 * take(w) + a11 * take(w + 1)

    r2 = jnp.where(inside, r[0], 0.0)
    r3 = jnp.where(inside, r[1], 0.0)
    r4 = jnp.where(inside, (R0[2] + r[2]) * 0.5, R0[2])
    r5 = jnp.where(inside, (R0[3] + r[3]) * 0.5, R0[3])
    r6 = jnp.where(inside, (R0[4] + r[4]) * 0.25, R0[4] * 0.5)
    r2 = (R0[0] - r2) * 0.5
    r3 = (R0[1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    col_scale = jnp.asarray(
        np.where(np.minimum(np.arange(w), w - 1 - np.arange(w)) < BORDER,
                 BORDER_ATTEN[np.minimum(np.minimum(np.arange(w), w - 1 - np.arange(w)),
                                         BORDER - 1)], 1.0).astype(np.float32))
    scale = _border_scale_rows(ys_global.astype(jnp.int32), h_global) * col_scale[None, :]
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
    return jnp.stack([
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    ], axis=0)


def sharded_farneback_level(R0: jnp.ndarray, R1: jnp.ndarray, dx: jnp.ndarray,
                            dy: jnp.ndarray, winsize: int, iterations: int,
                            axis_name: str, h_global: int,
                            warp_halo: int = 16) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One pyramid level on row-sharded blocks (matrices -> blur -> solve)."""
    R1ext = _halo_stack(R1, warp_halo, axis_name)
    M = sharded_update_matrices(R0, R1ext, dx, dy, axis_name, warp_halo, h_global)
    for i in range(iterations):
        dx, dy = solve_flow(sharded_box_blur5(M, winsize, axis_name))
        if i < iterations - 1:
            M = sharded_update_matrices(R0, R1ext, dx, dy, axis_name, warp_halo,
                                        h_global)
    return dx, dy


def sharded_farneback_flow(img1_block: jnp.ndarray, img2_block: jnp.ndarray,
                           axis_name: str, pyr_scale: float = 0.3, levels: int = 5,
                           winsize: int = 15, iterations: int = 5, poly_n: int = 5,
                           poly_sigma: float = 5.0, warp_halo: int = 16,
                           fast_warp: bool = False) -> jnp.ndarray:
    """Full pyramidal Farnebäck flow on row-sharded images.

    Level scheduling: the downsampled levels cost ~``pyr_scale²`` of level 0
    (e.g. ~10% combined at pyr_scale 0.3), so they run **replicated** from an
    all-gathered copy of the images (a few MB between devices), while the dominant
    full-resolution level runs **row-sharded** with halo-exchange stencils and
    the halo-bounded warp.  ``img*_block``: this device's (H_local, W) rows;
    returns this device's (H_local, W, 2) flow block.  Bit-compatible with the
    unsharded flow while level-0 vertical displacement stays within
    ``warp_halo`` rows.
    """
    from datmo_using_optical_flow.oracle.np_farneback import level_sizes
    from datmo_using_optical_flow.ops.farneback import (gaussian_blur,
                                                            resize_bilinear)

    hl, w = img1_block.shape
    n = jax.lax.psum(1, axis_name)
    h_global = hl * n
    idx = jax.lax.axis_index(axis_name)

    sizes = level_sizes(h_global, w, pyr_scale, levels)
    # coarse levels (k >= 1) replicated on the gathered image
    im1_full = jax.lax.all_gather(img1_block, axis_name, tiled=True)
    im2_full = jax.lax.all_gather(img2_block, axis_name, tiled=True)
    n_coarse = len(sizes) - 1
    if n_coarse > 0:
        # run the coarse pyramid (same schedule minus level 0), replicated
        dxc = dyc = None
        for k, scale, lh, lw in sizes[:-1]:
            sigma = (1.0 / scale - 1.0) * 0.5
            smooth_sz = max(int(round(sigma * 5)) | 1, 3)
            if dxc is None:
                dxc = jnp.zeros((lh, lw), jnp.float32)
                dyc = jnp.zeros((lh, lw), jnp.float32)
            else:
                inv = np.float32(1.0 / pyr_scale)
                dxc = resize_bilinear(dxc, lh, lw) * inv
                dyc = resize_bilinear(dyc, lh, lw) * inv
            from datmo_using_optical_flow.ops.farneback import (farneback_level,
                                                                    poly_exp)

            Rs = []
            for im in (im1_full, im2_full):
                f = gaussian_blur(im.astype(jnp.float32), smooth_sz, sigma)
                f = resize_bilinear(f, lh, lw)
                Rs.append(poly_exp(f, poly_n, poly_sigma))
            dxc, dyc = farneback_level(Rs[0], Rs[1], dxc, dyc, winsize, iterations,
                                       fast_warp=fast_warp)
        # upsample to full res and take this device's rows
        inv = np.float32(1.0 / pyr_scale)
        dx_full = resize_bilinear(dxc, h_global, w) * inv
        dy_full = resize_bilinear(dyc, h_global, w) * inv
        dx = jax.lax.dynamic_slice_in_dim(dx_full, idx * hl, hl, 0)
        dy = jax.lax.dynamic_slice_in_dim(dy_full, idx * hl, hl, 0)
    else:
        dx = jnp.zeros((hl, w), jnp.float32)
        dy = jnp.zeros((hl, w), jnp.float32)

    # level 0: sharded polyexp + level iterations (level-0 prep blur is 3-tap)
    from datmo_using_optical_flow.ops.farneback import _corr_axis
    from datmo_using_optical_flow.oracle.np_farneback import gaussian_kernel

    k3 = gaussian_kernel(3, 0.0).astype(np.float32)
    ext = halo_exchange_rows(img1_block.astype(jnp.float32), 1, axis_name,
                             edge_mode="reflect101")
    f1 = _corr_axis(_corr_axis(ext, k3, -2, "reflect")[1:1 + hl], k3, -1, "reflect")
    ext = halo_exchange_rows(img2_block.astype(jnp.float32), 1, axis_name,
                             edge_mode="reflect101")
    f2 = _corr_axis(_corr_axis(ext, k3, -2, "reflect")[1:1 + hl], k3, -1, "reflect")
    R0 = sharded_poly_exp(f1, poly_n, poly_sigma, axis_name)
    R1 = sharded_poly_exp(f2, poly_n, poly_sigma, axis_name)
    dx, dy = sharded_farneback_level(R0, R1, dx, dy, winsize, iterations, axis_name,
                                     h_global, warp_halo)
    return jnp.stack([dx, dy], axis=-1)
