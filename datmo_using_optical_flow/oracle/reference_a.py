"""CPU oracle for pipeline A (reference ``Optical_flow/main.py``).

Each function reproduces the observable behavior of its reference counterpart
(file:line cited per function) in vectorized numpy, with two deliberate deviations:

* randomness is injectable (the reference's densifier noise at ``main.py:54`` is
  unseeded) so the device path and the oracle can share identical noise;
* the defects catalogued in SURVEY.md §2.4 (first-frame acceleration crash, etc.)
  are fixed on the healthy path.
"""

from __future__ import annotations

import numpy as np


def flip_x(points: np.ndarray) -> np.ndarray:
    """``points[:, 0] = -points[:, 0]`` (``main.py:65``)."""
    out = points.copy()
    out[:, 0] = -out[:, 0]
    return out


def filter_points_in_roi(points: np.ndarray, roi_bounds) -> np.ndarray:
    """Inclusive box filter (``main.py:30-36``)."""
    x_min, x_max, y_min, y_max, z_min, z_max = roi_bounds
    keep = (
        (points[:, 0] >= x_min) & (points[:, 0] <= x_max)
        & (points[:, 1] >= y_min) & (points[:, 1] <= y_max)
        & (points[:, 2] >= z_min) & (points[:, 2] <= z_max)
    )
    return points[keep]


def increase_point_density(points: np.ndarray, expansion_factor: int = 10,
                           noise_std: float = 0.01,
                           noise: np.ndarray | None = None,
                           rng: np.random.Generator | None = None) -> np.ndarray:
    """Replication + jitter (``main.py:38-57``) with injectable noise."""
    rep = np.repeat(points, expansion_factor, axis=0)
    if noise is None:
        rng = rng or np.random.default_rng(0)
        noise = rng.normal(scale=noise_std, size=rep.shape)
    return rep + noise


def compute_bev_grid(points: np.ndarray, grid_resolution, x_range, y_range,
                     a: float = 0.5, b: float = 0.5, h_max: float = 5.0) -> np.ndarray:
    """uint8 BEV grid with the exact semantics of ``main.py:98-126``:
    trunc-toward-zero binning, population std, max-renormalization, uint8 trunc."""
    w, h = grid_resolution
    nx = len(np.arange(x_range[0], x_range[1], w))
    ny = len(np.arange(y_range[0], y_range[1], h))
    xi = ((points[:, 0] - x_range[0]) / w).astype(np.int64)  # int() truncation
    yi = ((points[:, 1] - y_range[0]) / h).astype(np.int64)
    ok = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
    xi, yi, z = xi[ok], yi[ok], points[ok, 2]
    cell = xi * ny + yi
    n_cells = nx * ny
    cnt = np.bincount(cell, minlength=n_cells).astype(np.float64)
    s1 = np.bincount(cell, weights=z, minlength=n_cells)
    mean = np.divide(s1, cnt, out=np.zeros_like(s1), where=cnt > 0)
    dev = z - mean[cell]
    s2 = np.bincount(cell, weights=dev * dev, minlength=n_cells)
    std = np.sqrt(np.divide(s2, cnt, out=np.zeros_like(s2), where=cnt > 0))
    vals = np.where(cnt > 0, (a * mean + b * std) / h_max, 0.0).reshape(nx, ny)
    vmax = vals.max()
    if vmax > 0:
        vals = vals / vmax
    return (vals * 255.0).astype(np.uint8)


def farneback_flow(bev1: np.ndarray, bev2: np.ndarray, params: dict | None = None) -> np.ndarray:
    """The reference's actual flow kernel: cv2 with the hard-coded params of
    ``main.py:132-142``.  This *is* the oracle — no reimplementation."""
    import cv2

    p = dict(pyr_scale=0.3, levels=5, winsize=15, iterations=5, poly_n=5,
             poly_sigma=5, flags=0)
    if params:
        p.update(params)
    return cv2.calcOpticalFlowFarneback(bev1.astype(np.float32), bev2.astype(np.float32),
                                        None, **p)


def velocity_from_flow(flow: np.ndarray, x_range, y_range) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flow px/frame → m/s scaling + curl angular velocity (``main.py:143-164``).
    Note the reference's pixel_size uses shape[1] for x and shape[0] for y and
    ignores dt in the scaling — replicated as-is."""
    vx_px, vy_px = flow[..., 0], flow[..., 1]
    pixel_size_x = (x_range[1] - x_range[0]) / flow.shape[1]
    pixel_size_y = (y_range[1] - y_range[0]) / flow.shape[0]
    velocity_x = vx_px * pixel_size_x
    velocity_y = vy_px * pixel_size_y
    dvx_dy, dvx_dx = np.gradient(velocity_x)
    dvy_dy, dvy_dx = np.gradient(velocity_y)
    angular_velocity = dvy_dx - dvx_dy
    return velocity_x, velocity_y, angular_velocity


def continuity_mask(vx: np.ndarray, vy: np.ndarray, alpha_cont: float) -> np.ndarray:
    """|div| and |curl| gate via np.gradient stencils (``main.py:224-228``)."""
    div_v = np.gradient(vx, axis=1) + np.gradient(vy, axis=0)
    curl_v = np.gradient(vy, axis=1) - np.gradient(vx, axis=0)
    return ((np.abs(div_v) <= alpha_cont) & (np.abs(curl_v) <= alpha_cont)).astype(int)


def propagation_mask(vx: np.ndarray, vy: np.ndarray, dt: float, grid_resolution,
                     alpha_p: float) -> np.ndarray:
    """Forward-scatter propagation gate (``main.py:167-183``) — vectorized.

    Scatter order note: the reference's Python loop writes cells in row-major order,
    so on collisions the *last* (largest (i, j)) writer wins; ``np.ufunc.at``-free
    assignment below applies updates in index order over the flattened arrays,
    which reproduces that."""
    h, w = vx.shape
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    i2 = ii + np.floor(vx * dt / grid_resolution[0]).astype(np.int64)
    j2 = jj + np.floor(vy * dt / grid_resolution[1]).astype(np.int64)
    ok = (i2 >= 0) & (i2 < h) & (j2 >= 0) & (j2 < w)
    prop_vx = np.zeros_like(vx)
    prop_vy = np.zeros_like(vy)
    prop_vx[i2[ok], j2[ok]] = vx[ok]
    prop_vy[i2[ok], j2[ok]] = vy[ok]
    mask = (np.abs(prop_vx - vx) <= alpha_p) & (np.abs(prop_vy - vy) <= alpha_p)
    return mask.astype(int)


def propagation_mask_with_acceleration(vx, vy, ax, ay, dt, grid_resolution, alpha_p):
    """Propagation gate including ½at² (``main.py:185-221``)."""
    h, w = vx.shape
    dx, dy = grid_resolution
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    i2 = ii + np.floor((vx * dt + 0.5 * ax * dt**2) / dx).astype(np.int64)
    j2 = jj + np.floor((vy * dt + 0.5 * ay * dt**2) / dy).astype(np.int64)
    ok = (i2 >= 0) & (i2 < h) & (j2 >= 0) & (j2 < w)
    prop_vx = np.zeros_like(vx)
    prop_vy = np.zeros_like(vy)
    prop_vx[i2[ok], j2[ok]] = vx[ok]
    prop_vy[i2[ok], j2[ok]] = vy[ok]
    mask = (np.abs(prop_vx - vx) <= alpha_p) & (np.abs(prop_vy - vy) <= alpha_p)
    return mask.astype(int)


def dbscan_clustering(vx_f: np.ndarray, vy_f: np.ndarray, valid_mask: np.ndarray,
                      eps: float = 5.0, min_samples: int = 3):
    """sklearn DBSCAN on [row, col, vx, vy] features (``main.py:231-259``)."""
    from sklearn.cluster import DBSCAN

    valid_indices = np.array(np.nonzero(valid_mask)).T
    features = np.column_stack((valid_indices, vx_f[valid_mask.astype(bool)],
                                vy_f[valid_mask.astype(bool)]))
    if features.shape[0] == 0:
        return np.empty((0,), dtype=np.int64), valid_indices
    labels = DBSCAN(eps=eps, min_samples=min_samples).fit(features).labels_
    return labels, valid_indices


def extract_cluster_data(labels, indices, vx, vy):
    """Per-cluster centroid / measurement / covariance eigenvalues (``main.py:402-434``)."""
    clusters = {}
    for label in np.unique(labels):
        if label == -1:
            continue
        m = labels == label
        pts = indices[m]
        cvx = vx[pts[:, 0], pts[:, 1]]
        cvy = vy[pts[:, 0], pts[:, 1]]
        centroid = pts.mean(axis=0)
        cov = np.cov(pts.T)
        eig = np.linalg.eigvals(cov)
        clusters[int(label)] = {
            "centroid": centroid,
            "measurement": [centroid[0], centroid[1], cvx.mean(), cvy.mean()],
            "eigenvalues": eig,
        }
    return clusters


class RefEKF:
    """The reference's quirky 4-state EKF (``main.py:437-467``): unicycle-ish predict
    with a constant-velocity F, and H = I₄ update — internally inconsistent state
    semantics preserved on purpose (SURVEY.md §2.1 A12)."""

    def __init__(self, state, process_noise, measurement_noise):
        self.state = np.array(state, dtype=np.float64)
        self.P = np.eye(4)
        self.Q = process_noise
        self.R = measurement_noise
        self.F = np.eye(4)
        self.H = np.eye(4)

    def predict(self, dt, u):
        v, omega = u
        theta = self.state[2]
        self.F[0, 2] = dt
        self.F[1, 3] = dt
        self.state[0] += self.state[3] * np.cos(theta) * dt
        self.state[1] += self.state[3] * np.sin(theta) * dt
        self.state[2] += omega * dt
        self.state[3] += v * dt
        self.P = self.F @ self.P @ self.F.T + self.Q

    def update(self, z):
        y = z - self.H @ self.state
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.state = self.state + K @ y
        self.P = (np.eye(4) - K @ self.H) @ self.P


def track_clusters(tracks: dict, clusters: dict, dt, process_noise, measurement_noise,
                   gamma: float) -> dict:
    """Greedy GNN association + EKF update (``main.py:468-506``), quirks preserved:
    clusters iterate in key order; several clusters may claim the same track (the
    shared EKF object is predicted/updated once per claimant, last claimant kept);
    all new tracks in a frame share the id ``max(old_keys)+1`` (last one survives);
    unmatched old tracks are dropped."""
    new_tracks = {}
    for _, cluster in sorted(clusters.items()):
        cluster_feature = np.array([*cluster["centroid"], *cluster["eigenvalues"]],
                                   dtype=np.float64)
        matched, best = None, float("inf")
        for track_id, ekf in tracks.items():
            track_feature = np.array([ekf.state[0], ekf.state[1], 0.0, 0.0])
            dist = np.linalg.norm(cluster_feature - track_feature)
            if dist < best and dist < gamma:
                matched, best = track_id, dist
        if matched is not None:
            ekf = tracks[matched]
            ekf.predict(dt, cluster["measurement"][2:])
            ekf.update(np.asarray(cluster["measurement"], dtype=np.float64))
            new_tracks[matched] = ekf
        else:
            new_id = max(tracks.keys(), default=0) + 1
            new_tracks[new_id] = RefEKF(cluster["measurement"], process_noise,
                                        measurement_noise)
    return new_tracks


def manage_tracks(tracks, track_lifetimes, confirmed_tracks, M1, N1, M2, N2):
    """M/N confirm-then-delete lifecycle (``main.py:507-515``)."""
    for track_id in list(tracks.keys()):
        life = track_lifetimes[track_id]
        if track_id in confirmed_tracks:
            if life > N2 and life - M2 <= N2:
                del tracks[track_id]
        else:
            if life >= N1 and life - M1 <= N1:
                confirmed_tracks.add(track_id)
