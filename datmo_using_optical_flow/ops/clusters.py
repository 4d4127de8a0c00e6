"""Cluster post-processing utilities (reference A10/A11 capabilities).

Both are *dead code* in the reference's main loop but part of its API surface
(SURVEY.md §2.1), so they exist here as first-class device ops:

* per-cluster mean speed — ``calculate_dbscan_cluster_velocities``
  (``Optical_flow/main.py:261-294``);
* road-polygon cluster filter — ``filter_clusters_by_roi``
  (``main.py:297-334``, shapely in the reference; crossing-number test here).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from datmo_using_optical_flow.ops.masks import points_in_polygon


def cluster_mean_speeds(labels: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray,
                        vx: jnp.ndarray, vy: jnp.ndarray, max_clusters: int
                        ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mean velocity magnitude per cluster (``main.py:261-294``).

    Returns ``(speeds (K,), exists (K,))`` — the device analogue of the
    reference's ``{cluster_id: avg_velocity}`` dict.
    """
    k = max_clusters
    valid = labels >= 0
    lab = jnp.where(valid, labels, k)
    w = vx[jnp.maximum(rows, 0), jnp.maximum(cols, 0)]
    u = vy[jnp.maximum(rows, 0), jnp.maximum(cols, 0)]
    mag = jnp.sqrt(w * w + u * u)
    cnt = jax.ops.segment_sum(valid.astype(jnp.float32), lab, k + 1)[:k]
    s = jax.ops.segment_sum(jnp.where(valid, mag, 0.0), lab, k + 1)[:k]
    return s / jnp.maximum(cnt, 1.0), cnt > 0


def filter_clusters_by_polygon(labels: jnp.ndarray, rows: jnp.ndarray,
                               cols: jnp.ndarray, vx: jnp.ndarray, vy: jnp.ndarray,
                               polygon_xy: jnp.ndarray) -> tuple[jnp.ndarray, ...]:
    """Keep cluster cells inside a road polygon (``main.py:297-334``).

    The reference tests ``Point(col, row)`` against the polygon (:321), i.e. the
    polygon lives in (col, row) grid coordinates — replicated.  Returns
    ``(labels, rows, cols, vx_cells, vy_cells, keep_mask)`` where non-kept slots
    have label -1; the caller compacts if a dense view is needed.
    """
    pts = jnp.stack([cols.astype(jnp.float32), rows.astype(jnp.float32)], axis=1)
    inside = points_in_polygon(pts, polygon_xy) & (labels >= 0)
    w = vx[jnp.maximum(rows, 0), jnp.maximum(cols, 0)]
    u = vy[jnp.maximum(rows, 0), jnp.maximum(cols, 0)]
    out_labels = jnp.where(inside, labels, -1)
    return out_labels, rows, cols, w, u, inside
