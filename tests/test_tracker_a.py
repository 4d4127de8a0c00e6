"""Pipeline-A tracker parity vs the CPU oracle (reference ``Optical_flow/main.py``:
EKF :437-467, track_clusters :468-506, manage_tracks :507-515, lifetimes :622-634)."""

import jax.numpy as jnp
import numpy as np

from datmo_using_optical_flow.models import tracker_a as ta
from datmo_using_optical_flow.oracle import reference_a as ref

CAP_T, CAP_K = 16, 8
DT, Q, R, GAMMA = 1.0, 0.1, 0.05, 0.5


def _clusters_device(cluster_dicts):
    """Build the padded Clusters pytree from oracle-style dicts (by label order)."""
    exists = np.zeros(CAP_K, bool)
    centroid = np.zeros((CAP_K, 2), np.float32)
    meas = np.zeros((CAP_K, 4), np.float32)
    eig = np.zeros((CAP_K, 2), np.float32)
    for slot, (label, c) in enumerate(sorted(cluster_dicts.items())):
        exists[slot] = True
        centroid[slot] = c["centroid"]
        meas[slot] = c["measurement"]
        e = np.real(np.asarray(c["eigenvalues"]))
        eig[slot] = sorted(e, reverse=True)
    return ta.Clusters(jnp.asarray(exists), jnp.asarray(centroid), jnp.asarray(meas),
                       jnp.asarray(eig))


def _mk_cluster(cx, cy, vx, vy, e1=0.01, e2=0.02):
    return {"centroid": np.array([cx, cy]), "measurement": [cx, cy, vx, vy],
            "eigenvalues": np.array([max(e1, e2), min(e1, e2)])}


def _oracle_run(frames):
    """Replicates the reference main-loop tracking block (main.py:618-634)."""
    tracks, lifetimes, confirmed = {}, {}, set()
    history = []
    for clusters in frames:
        tracks = ref.track_clusters(tracks, clusters, DT, np.eye(4) * Q, np.eye(4) * R,
                                    GAMMA)
        for tid in list(lifetimes):
            if tid in tracks:
                lifetimes[tid] += 1
            else:
                del lifetimes[tid]
        for tid in tracks:
            if tid not in lifetimes:
                lifetimes[tid] = 1
        ref.manage_tracks(tracks, lifetimes, confirmed, M1=1, N1=4, M2=10, N2=15)
        history.append({tid: (ekf.state.copy(), lifetimes.get(tid))
                        for tid, ekf in tracks.items()})
    return history


def _device_run(frames):
    table = ta.new_track_table(CAP_T)
    history = []
    for clusters in frames:
        table = ta.track_step(table, _clusters_device(clusters), DT, Q, R, GAMMA,
                              1, 4, 10, 15)
        alive = np.asarray(table.alive)
        snap = {}
        for i in np.nonzero(alive)[0]:
            snap[int(table.tid[i])] = (np.asarray(table.state[i]),
                                       int(table.lifetime[i]))
        history.append(snap)
    return history


def _compare(oracle_hist, device_hist):
    assert len(oracle_hist) == len(device_hist)
    for f, (o, d) in enumerate(zip(oracle_hist, device_hist)):
        assert set(o) == set(d), f"frame {f}: ids {set(o)} vs {set(d)}"
        for tid in o:
            np.testing.assert_allclose(d[tid][0], o[tid][0], atol=2e-3,
                                       err_msg=f"frame {f} track {tid}")
            assert d[tid][1] == o[tid][1], f"frame {f} track {tid} lifetime"


def test_single_target_track():
    frames = [{0: _mk_cluster(10 + 0.1 * i, 5 + 0.05 * i, 0.1, 0.05)} for i in range(10)]
    _compare(_oracle_run(frames), _device_run(frames))


def test_track_deleted_after_confirmation_window():
    """The reference's full quirk cascade: track confirms at lifetime 4, manage
    deletes it at lifetime 16; each subsequent frame the id is recycled
    (max(keys)+1), inherits the stale lifetime + eternal confirmed status, and is
    insta-deleted again — until the inherited lifetime passes N2+M2=25, when the
    reborn track survives."""
    frames = [{0: _mk_cluster(10 + 0.01 * i, 5, 0.01, 0.0)} for i in range(30)]
    o, d = _oracle_run(frames), _device_run(frames)
    _compare(o, d)
    assert set(o[14]) == {1}                      # alive at lifetime 15
    assert all(not o[f] for f in range(15, 25))   # insta-deleted rebirth window
    assert set(o[25]) == {1} and o[25][1][1] == 26  # survives past N2+M2


def test_two_targets_and_noise_birth():
    rng = np.random.default_rng(0)
    frames = []
    for i in range(12):
        f = {0: _mk_cluster(5 + 0.05 * i, 0, 0.05, 0.0),
             1: _mk_cluster(-5, 3 + 0.05 * i, 0.0, 0.05)}
        if i == 6:  # transient cluster far away: births a track, dies next frame
            f[2] = _mk_cluster(50, 50, 1.0, 1.0)
        frames.append(f)
    _compare(_oracle_run(frames), _device_run(frames))


def test_same_track_claimed_twice():
    """Two clusters within gamma of one track: both predict+update it sequentially
    (reference dict-object aliasing, main.py:496-500)."""
    frames = [
        {0: _mk_cluster(10.0, 5.0, 0.1, 0.0)},
        {0: _mk_cluster(10.05, 5.0, 0.1, 0.0), 1: _mk_cluster(10.1, 5.05, 0.1, 0.0)},
        {0: _mk_cluster(10.2, 5.1, 0.1, 0.0)},
    ]
    _compare(_oracle_run(frames), _device_run(frames))


def test_unmatched_old_tracks_dropped():
    """Reference drops tracks that match no cluster (new_tracks only keeps matched)."""
    frames = [
        {0: _mk_cluster(0.0, 0.0, 0.1, 0.0), 1: _mk_cluster(8.0, 8.0, 0.1, 0.0)},
        {0: _mk_cluster(0.1, 0.0, 0.1, 0.0)},  # second target vanishes
        {0: _mk_cluster(0.2, 0.0, 0.1, 0.0)},
    ]
    o, d = _oracle_run(frames), _device_run(frames)
    _compare(o, d)
    assert len(o[1]) == 1


def test_extract_clusters_matches_oracle():
    rng = np.random.default_rng(1)
    h, w = 30, 30
    vx = rng.normal(size=(h, w)).astype(np.float32)
    vy = rng.normal(size=(h, w)).astype(np.float32)
    # three synthetic clusters of cells
    labels = np.full(40, -1, np.int64)
    rows = np.zeros(40, np.int64)
    cols = np.zeros(40, np.int64)
    k = 0
    for cid, (r0, c0, n) in enumerate([(3, 4, 8), (15, 20, 12), (25, 5, 6)]):
        for j in range(n):
            labels[k] = cid
            rows[k] = r0 + (j % 3)
            cols[k] = c0 + (j // 3)
            k += 1
    idx = np.stack([rows, cols], axis=1)
    expect = ref.extract_cluster_data(labels[:k], idx[:k], vx, vy)

    pad_r = np.full(64, -1, np.int32)
    pad_c = np.full(64, -1, np.int32)
    pad_l = np.full(64, -1, np.int32)
    pad_r[:k], pad_c[:k], pad_l[:k] = rows[:k], cols[:k], labels[:k]
    got = ta.extract_clusters(jnp.asarray(pad_l), jnp.asarray(pad_r),
                              jnp.asarray(pad_c), jnp.asarray(vx), jnp.asarray(vy),
                              CAP_K)
    for cid, c in expect.items():
        assert bool(got.exists[cid])
        np.testing.assert_allclose(np.asarray(got.centroid[cid]), c["centroid"],
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(got.measurement[cid]),
                                   np.asarray(c["measurement"], np.float64), atol=1e-5)
        np.testing.assert_allclose(np.sort(np.asarray(got.eigenvalues[cid])),
                                   np.sort(np.real(c["eigenvalues"])), atol=1e-4)
    assert int(got.exists.sum()) == len(expect)
