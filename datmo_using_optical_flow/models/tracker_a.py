"""Pipeline-A tracking: fixed-capacity track table + quirk-exact EKF + greedy GNN.

Device re-expression of the reference's tracking stack (``Optical_flow/main.py``):

* ``extract_cluster_data`` (:402-434) -> :func:`extract_clusters` (segment means,
  ddof=1 covariance, closed-form symmetric 2x2 eigenvalues);
* ``class EKF`` (:437-467) -> :func:`_ekf_predict` / :func:`_ekf_update`.  The
  reference's model is internally inconsistent (predict treats state[2:4] as
  (theta, speed), update as (vx, vy)); we replicate *behavior*, not intent
  (SURVEY.md §2.1 A12);
* ``track_clusters`` (:468-506) -> :func:`associate_and_update`, a ``lax.scan``
  over cluster slots preserving the reference's sequential dict semantics: later
  clusters see states mutated by earlier claimants of the same track; several
  clusters may claim one track (each predict+updates it); all new tracks in a
  frame share one id ``max(old_ids, default=0)+1`` and only the last survives;
  unmatched old tracks are dropped;
* ``manage_tracks`` (:507-515) + lifetime bookkeeping (:622-634) ->
  :func:`lifecycle` as masked integer ops.

Everything operates on a :class:`TrackTable` pytree with static capacity and an
alive mask — no dynamic shapes anywhere.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from datmo_using_optical_flow.ops.linalg import matmul


class TrackTable(NamedTuple):
    """Fixed-capacity track table (the device analogue of the ``tracks`` dict)."""

    state: jnp.ndarray      # (T, 4)
    cov: jnp.ndarray        # (T, 4, 4)
    tid: jnp.ndarray        # (T,) int32 — reference dict keys
    alive: jnp.ndarray      # (T,) bool
    lifetime: jnp.ndarray   # (T,) int32
    confirmed: jnp.ndarray  # (T,) bool


def new_track_table(capacity: int) -> TrackTable:
    return TrackTable(
        state=jnp.zeros((capacity, 4), jnp.float32),
        cov=jnp.zeros((capacity, 4, 4), jnp.float32),
        tid=jnp.zeros((capacity,), jnp.int32),
        alive=jnp.zeros((capacity,), bool),
        lifetime=jnp.zeros((capacity,), jnp.int32),
        confirmed=jnp.zeros((capacity,), bool),
    )


class Clusters(NamedTuple):
    """Per-slot cluster data (device analogue of ``extract_cluster_data`` output)."""

    exists: jnp.ndarray       # (K,) bool
    centroid: jnp.ndarray     # (K, 2) [row, col]
    measurement: jnp.ndarray  # (K, 4) [crow, ccol, mean vx, mean vy]
    eigenvalues: jnp.ndarray  # (K, 2)


def extract_clusters(labels: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray,
                     vx: jnp.ndarray, vy: jnp.ndarray, max_clusters: int) -> Clusters:
    """Per-cluster centroid/measurement/eigenvalues (``main.py:402-434``).

    ``labels/rows/cols`` are the compacted DBSCAN outputs; ``vx/vy`` the filtered
    velocity grids (cells gathered at each cluster's (row, col) indices).
    """
    k = max_clusters
    valid = labels >= 0
    lab = jnp.where(valid, labels, k)

    # all segment reductions as one-hot matmuls: a fixed summation order
    # (a float scatter-add's order varies from run to run on the GPU), and
    # labels are bounded by max_clusters, so the one-hot is tiny
    onehot = (lab[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)

    def seg(vals):
        # (..., n) @ (n, k) -> (..., k) at full f32: reduced-precision
        # operands would lose integer exactness of row/col indices ~2000
        return matmul(vals, onehot)

    ones = valid.astype(jnp.float32)
    r = rows.astype(jnp.float32)
    c = cols.astype(jnp.float32)
    w = vx[jnp.maximum(rows, 0), jnp.maximum(cols, 0)]
    u = vy[jnp.maximum(rows, 0), jnp.maximum(cols, 0)]
    first = seg(jnp.stack([ones, jnp.where(valid, r, 0), jnp.where(valid, c, 0),
                           jnp.where(valid, w, 0), jnp.where(valid, u, 0)]))
    cnt, sum_r, sum_c, sum_w, sum_u = first
    safe = jnp.maximum(cnt, 1.0)
    mr, mc = sum_r / safe, sum_c / safe
    mw, mu = sum_w / safe, sum_u / safe

    # ddof=1 covariance of (row, col) like np.cov (main.py:426)
    dr = jnp.where(valid, r - mr[lab.clip(0, k - 1)], 0.0) * ones
    dc = jnp.where(valid, c - mc[lab.clip(0, k - 1)], 0.0) * ones
    second = seg(jnp.stack([dr * dr, dc * dc, dr * dc]))
    srr, scc, src = second
    denom = cnt - 1.0
    ok2 = denom > 0
    a = jnp.where(ok2, srr / jnp.where(ok2, denom, 1.0), jnp.nan)
    d = jnp.where(ok2, scc / jnp.where(ok2, denom, 1.0), jnp.nan)
    b = jnp.where(ok2, src / jnp.where(ok2, denom, 1.0), jnp.nan)
    half_tr = (a + d) * 0.5
    disc = jnp.sqrt(jnp.maximum(((a - d) * 0.5) ** 2 + b * b, 0.0))
    eig = jnp.stack([half_tr + disc, half_tr - disc], axis=1)

    exists = cnt > 0
    centroid = jnp.stack([mr, mc], axis=1)
    measurement = jnp.stack([mr, mc, mw, mu], axis=1)
    return Clusters(exists, centroid, measurement, eig)


def _ekf_predict(state, cov, dt, u, q):
    """Reference EKF.predict (``main.py:446-460``), quirks preserved."""
    v, omega = u[0], u[1]
    theta = state[2]
    f = jnp.eye(4, dtype=state.dtype).at[0, 2].set(dt).at[1, 3].set(dt)
    new_state = jnp.array([
        state[0] + state[3] * jnp.cos(theta) * dt,
        state[1] + state[3] * jnp.sin(theta) * dt,
        state[2] + omega * dt,
        state[3] + v * dt,
    ])
    new_cov = matmul(matmul(f, cov), f.T) + q
    return new_state, new_cov


def _ekf_update(state, cov, z, r):
    """Reference EKF.update (``main.py:462-467``): H = I4."""
    s = cov + r
    k = matmul(cov, jnp.linalg.inv(s))
    new_state = state + matmul(k, z - state)
    new_cov = matmul(jnp.eye(4, dtype=state.dtype) - k, cov)
    return new_state, new_cov


def associate_and_update(table: TrackTable, clusters: Clusters, dt: float,
                         q_scale: float, r_scale: float, gamma: float) -> TrackTable:
    """``track_clusters`` (``main.py:468-506``) as a scan over cluster slots."""
    cap = table.state.shape[0]
    q = jnp.eye(4, dtype=jnp.float32) * q_scale
    r = jnp.eye(4, dtype=jnp.float32) * r_scale

    old_alive = table.alive
    # reference: new_track_id = max(tracks.keys(), default=0) + 1, from OLD keys
    new_id = jnp.max(jnp.where(old_alive, table.tid, 0)) + 1
    # One reserved slot for the (single surviving) new track of this frame.
    # Prefer a "ghost" slot carrying the same recycled id: the reference's
    # ``track_lifetimes`` / ``confirmed_tracks`` are keyed by id and survive a
    # manage_tracks deletion into the next frame (main.py:622-634 cleanup runs
    # *before* the deletion), so a reborn id inherits its stale lifetime and
    # confirmed status — replicated by reusing that slot.
    free_slots = ~old_alive
    ghost = free_slots & (table.tid == new_id) & (table.lifetime > 0)
    new_slot = jnp.where(jnp.any(ghost), jnp.argmax(ghost), jnp.argmax(free_slots))
    has_free = jnp.any(free_slots)
    inherits = jnp.any(ghost)

    def body(carry, cl):
        state, cov, in_new = carry
        exists, centroid, meas, eig = cl
        feat = jnp.concatenate([centroid, eig])
        track_feat = jnp.concatenate([state[:, :2],
                                      jnp.zeros((cap, 2), state.dtype)], axis=1)
        dist = jnp.linalg.norm(feat[None, :] - track_feat, axis=1)
        dist = jnp.where(old_alive, dist, jnp.inf)
        best = jnp.argmin(dist)
        matched = exists & (dist[best] < gamma)

        # matched branch: predict with u = measurement[2:4], then update
        ps, pc = _ekf_predict(state[best], cov[best], dt, meas[2:4], q)
        us, uc = _ekf_update(ps, pc, meas, r)
        state = jnp.where(matched, state.at[best].set(us), state)
        cov = jnp.where(matched, cov.at[best].set(uc), cov)
        in_new = jnp.where(matched, in_new.at[best].set(True), in_new)

        # unmatched: fresh EKF in the reserved slot (overwrites earlier ones)
        make_new = exists & ~matched & has_free
        state = jnp.where(make_new, state.at[new_slot].set(meas), state)
        cov = jnp.where(make_new,
                        cov.at[new_slot].set(jnp.eye(4, dtype=jnp.float32)), cov)
        in_new = jnp.where(make_new, in_new.at[new_slot].set(True), in_new)
        return (state, cov, in_new), make_new

    init = (table.state, table.cov, jnp.zeros((cap,), bool))
    (state, cov, in_new), new_created = jax.lax.scan(
        body, init, (clusters.exists, clusters.centroid, clusters.measurement,
                     clusters.eigenvalues))

    created = jnp.any(new_created)
    is_new_slot = created & (jnp.arange(cap) == new_slot)
    tid = jnp.where(is_new_slot, new_id, table.tid)
    # a non-inheriting birth starts with clean lifecycle state in its slot
    reset = is_new_slot & ~inherits
    lifetime = jnp.where(reset, 0, table.lifetime)
    confirmed = jnp.where(reset, False, table.confirmed)
    return table._replace(state=state, cov=cov, tid=tid.astype(jnp.int32),
                          alive=in_new, lifetime=lifetime.astype(jnp.int32),
                          confirmed=confirmed)


def lifecycle(table: TrackTable, m1: int, n1: int, m2: int, n2: int) -> TrackTable:
    """Lifetime bookkeeping (``main.py:622-634``) + ``manage_tracks`` (:507-515).

    Reference order within a frame: lifetimes of current tracks increment (new
    tracks start at 1, via the birth-time reset in :func:`associate_and_update`);
    lifetimes of absent ids are dropped (dead slots -> 0) — EXCEPT a track deleted
    by manage_tracks this frame keeps its lifetime into the next frame (cleanup
    ran before the deletion), which is what makes the reference's id-recycling
    rebirth quirk observable.  ``confirmed`` is per-id-forever in the reference
    (the set never shrinks); per-slot flags replicate that except when a ghost
    slot is overwritten by a different id before its id recycles (doubly-exotic;
    documented deviation).
    """
    alive = table.alive
    lifetime = jnp.where(alive, table.lifetime + 1, 0).astype(jnp.int32)
    confirmed = table.confirmed
    delete = alive & confirmed & (lifetime > n2) & (lifetime - m2 <= n2)
    confirm = alive & ~confirmed & (lifetime >= n1) & (lifetime - m1 <= n1)
    confirmed = confirmed | confirm
    alive = alive & ~delete
    # deleted-this-frame slots keep their lifetime (ghost); long-dead slots are 0
    return table._replace(alive=alive, lifetime=lifetime, confirmed=confirmed)


def track_step(table: TrackTable, clusters: Clusters, dt: float, q_scale: float,
               r_scale: float, gamma: float, m1: int, n1: int, m2: int,
               n2: int) -> TrackTable:
    """One full tracking step: association + EKF + lifecycle (``main.py:618-634``)."""
    table = associate_and_update(table, clusters, dt, q_scale, r_scale, gamma)
    return lifecycle(table, m1, n1, m2, n2)
