"""Point-cloud geometry ops (mask-based, statically shaped).

Device equivalents of the reference preprocessing stages:

* X-flip          — ``Optical_flow/main.py:65`` / ``GMFA/GMFA.py:36``
* ROI box filter  — ``filter_points_in_roi`` (``Optical_flow/main.py:30-36``)
* densifier       — ``increase_point_density`` (``Optical_flow/main.py:38-57``), but with
  explicit PRNG (the reference's ``np.random.normal`` at ``main.py:54`` is unseeded)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def flip_x(points: jnp.ndarray) -> jnp.ndarray:
    """Negate the X coordinate (``points[:, 0] = -points[:, 0]``, ``main.py:65``)."""
    return points.at[:, 0].multiply(-1.0)


def roi_mask(points: jnp.ndarray, roi_bounds) -> jnp.ndarray:
    """Inclusive axis-aligned box membership, matching ``main.py:30-36``.

    ``roi_bounds = (x_min, x_max, y_min, y_max, z_min, z_max)``.
    Returns a boolean mask over rows (caller ANDs with its validity mask).
    """
    x_min, x_max, y_min, y_max, z_min, z_max = roi_bounds
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    return (
        (x >= x_min) & (x <= x_max)
        & (y >= y_min) & (y <= y_max)
        & (z >= z_min) & (z <= z_max)
    )


def roi_mask_2d(points: jnp.ndarray, roi_bounds_xy) -> jnp.ndarray:
    """2-D (x, y) box membership (``GMFA/GMFA.py:371-381``)."""
    x_min, x_max, y_min, y_max = roi_bounds_xy
    x, y = points[:, 0], points[:, 1]
    return (x >= x_min) & (x <= x_max) & (y >= y_min) & (y <= y_max)


def densify(points: jnp.ndarray, mask: jnp.ndarray, key: jax.Array,
            expansion_factor: int = 10, noise_std: float = 0.01,
            noise: jnp.ndarray | None = None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Replicate each point ``expansion_factor``× with N(0, noise_std²) jitter.

    Matches ``increase_point_density`` (``main.py:38-57``): ``np.repeat`` ordering
    (point i's replicas occupy rows ``i*k .. i*k+k-1``) + additive Gaussian noise.
    ``noise`` may be supplied explicitly (shape ``(N*k, 3)``) for bit-parity tests
    against the CPU oracle; otherwise it is drawn from ``key``.

    Returns ``(expanded_points, expanded_mask)`` with static shape ``(N*k, 3)``.
    """
    n = points.shape[0]
    k = expansion_factor
    rep = jnp.repeat(points, k, axis=0)
    rep_mask = jnp.repeat(mask, k, axis=0)
    if noise is None:
        noise = jax.random.normal(key, (n * k, 3), dtype=points.dtype) * noise_std
    out = rep + noise.astype(points.dtype)
    # keep padding rows at their sentinel location (don't jitter them into the scene)
    out = jnp.where(rep_mask[:, None], out, rep)
    return out, rep_mask
