"""RANSAC ground-plane segmentation as vmapped batched hypothesis scoring.

Device equivalent of Open3D's C++ ``segment_plane(distance_threshold=0.5,
ransac_n=5, num_iterations=5000)`` (``Optical_flow/main.py:73``, ``GMFA/GMFA.py:41``):
all ``num_iterations`` hypotheses are sampled and scored at once on device —
candidate planes are least-squares fits (centroid + smallest covariance eigenvector)
of ``ransac_n`` random points, scored against all points with a single tiled
matmul-style reduction, followed by a least-squares refit on the winning inlier set.

Unlike Open3D there is no early exit; 5000 batched hypotheses are cheap on the device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from datmo_using_optical_flow.ops.linalg import matmul


def _plane_from_points(pts: jnp.ndarray, w: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted least-squares plane fit. Returns (unit_normal, d) with n·p + d = 0."""
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    centroid = jnp.sum(pts * w[:, None], axis=0) / wsum
    centered = (pts - centroid) * w[:, None]
    cov = matmul(centered.T, centered)
    # smallest eigenvector of the 3x3 covariance = plane normal
    _, vecs = jnp.linalg.eigh(cov)
    normal = vecs[:, 0]
    norm = jnp.maximum(jnp.linalg.norm(normal), 1e-12)
    normal = normal / norm
    d = -jnp.sum(normal * centroid)
    return normal, d


def _score_planes(points: jnp.ndarray, mask: jnp.ndarray, normals: jnp.ndarray,
                  ds: jnp.ndarray, threshold: float, chunk: int = 256) -> jnp.ndarray:
    """Inlier counts for K planes vs N points, tiled over hypothesis chunks."""
    k = normals.shape[0]
    pad = (-k) % chunk
    normals_p = jnp.pad(normals, ((0, pad), (0, 0)))
    ds_p = jnp.pad(ds, ((0, pad),))
    maskf = mask.astype(points.dtype)

    def count_chunk(args):
        n_c, d_c = args
        # (N, 3) @ (3, chunk) -> (N, chunk) distances
        dist = jnp.abs(matmul(points, n_c.T) + d_c[None, :])
        return jnp.sum((dist <= threshold) * maskf[:, None], axis=0)

    counts = jax.lax.map(count_chunk,
                         (normals_p.reshape(-1, chunk, 3), ds_p.reshape(-1, chunk)))
    return counts.reshape(-1)[:k]


@partial(jax.jit, static_argnames=("ransac_n", "num_iterations", "refine"))
def segment_plane(points: jnp.ndarray, mask: jnp.ndarray, key: jax.Array,
                  distance_threshold: float = 0.5, ransac_n: int = 5,
                  num_iterations: int = 5000, refine: bool = True
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Find the dominant plane; return ``(plane, inlier_mask)``.

    ``plane`` is ``[a, b, c, d]`` with unit normal and ``a x + b y + c z + d = 0``.
    ``inlier_mask`` marks valid points within ``distance_threshold`` of the plane
    (the ground, in the reference's usage — callers invert it, ``main.py:74``).
    """
    n = points.shape[0]
    num_valid = jnp.maximum(jnp.sum(mask.astype(jnp.int32)), 1)

    # sample ransac_n valid-point indices per hypothesis (uniform over the first
    # num_valid rows; callers pass compacted buffers so valid rows lead)
    u = jax.random.uniform(key, (num_iterations, ransac_n), dtype=jnp.float32)
    idx = jnp.minimum((u * num_valid.astype(jnp.float32)).astype(jnp.int32), num_valid - 1)
    samples = points[idx]  # (K, ransac_n, 3)

    normals, ds = jax.vmap(lambda p: _plane_from_points(p, jnp.ones(p.shape[0], p.dtype)))(samples)
    counts = _score_planes(points, mask, normals, ds, distance_threshold)
    best = jnp.argmax(counts)
    normal, d = normals[best], ds[best]

    def inliers_of(normal, d):
        dist = jnp.abs(matmul(points, normal) + d)
        return (dist <= distance_threshold) & mask

    inl = inliers_of(normal, d)
    if refine:
        # final least-squares refit on the winning inlier set (Open3D does the same)
        normal, d = _plane_from_points(points, inl.astype(points.dtype))
        inl = inliers_of(normal, d)

    # orient the normal upward (+z), matching the common ground-plane convention
    sign = jnp.where(normal[2] < 0, -1.0, 1.0).astype(points.dtype)
    plane = jnp.concatenate([normal * sign, (d * sign)[None]])
    return plane, inl


def remove_ground(points: jnp.ndarray, mask: jnp.ndarray, key: jax.Array,
                  distance_threshold: float = 0.5, ransac_n: int = 5,
                  num_iterations: int = 5000) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Ground removal: plane fit + invert-select (``main.py:73-75``).

    Returns ``(plane, non_ground_mask)``; callers AND with their validity mask.
    """
    plane, inl = segment_plane(points, mask, key, distance_threshold, ransac_n, num_iterations)
    return plane, mask & ~inl
