"""Integration test: pipeline A end-to-end vs a CPU-oracle run of the reference
algorithms sharing the same BEV inputs (``process_multiple_frames``, main.py:541-641,
with defect #1 fixed on both sides — SURVEY.md §4 'artifact parity')."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from datmo_using_optical_flow.config import CapacityConfig, PipelineAConfig
from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow.oracle import reference_a as ref
from datmo_using_optical_flow.sim.synthetic import SyntheticScene, write_synthetic_sequence


@pytest.fixture(scope="module")
def cfg():
    return PipelineAConfig(
        capacities=CapacityConfig(max_raw_points=8192, max_roi_points=2048,
                                  max_cells=2048, max_clusters=8, max_tracks=16))


@pytest.fixture(scope="module")
def bev_seq(cfg):
    """Deterministic BEV sequence from synthetic PCDs through the device preprocessor."""
    from datmo_using_optical_flow.io.frames import pad_points
    from datmo_using_optical_flow.io.pcd import read_pcd

    paths = write_synthetic_sequence(SyntheticScene(seed=9), "/tmp/test_pipea_seq", 4)
    pipe = PipelineA(cfg, fast_warp=False)
    bevs = []
    key = jax.random.PRNGKey(0)
    for i, p in enumerate(paths):
        pts, mask = pad_points(read_pcd(p, dtype=np.float32), cfg.capacities.max_raw_points)
        key, k = jax.random.split(key)
        bevs.append(np.asarray(pipe.preprocess(jnp.asarray(pts), jnp.asarray(mask), k)))
    return bevs


def _oracle_pipeline(bevs, cfg):
    """The reference's per-pair loop (main.py:561-634) on shared BEVs, defect #1 fixed."""
    tracks, lifetimes, confirmed = {}, {}, set()
    per_pair = []
    for i in range(len(bevs) - 1):
        flow = ref.farneback_flow(bevs[i], bevs[i + 1])
        vx, vy, _ = ref.velocity_from_flow(flow, cfg.x_range, cfg.y_range)
        cont = ref.continuity_mask(vx, vy, cfg.masks.alpha_cont)
        vx_f, vy_f = vx * cont, vy * cont
        mag = np.sqrt(vx_f ** 2 + vy_f ** 2)
        dvx_dy, _ = np.gradient(vx_f)
        _, dvy_dx = np.gradient(vy_f)
        ang = dvy_dx - dvx_dy
        valid = mag > cfg.velocity_threshold
        labels, idx = ref.dbscan_clustering(vx_f, vy_f, valid, cfg.dbscan.eps,
                                            cfg.dbscan.min_samples)
        clusters = ref.extract_cluster_data(labels, idx, vx_f, vy_f)
        tracks = ref.track_clusters(tracks, clusters, cfg.dt,
                                    np.eye(4) * cfg.tracker.process_noise,
                                    np.eye(4) * cfg.tracker.measurement_noise,
                                    cfg.tracker.gamma)
        snapshot = {tid: ekf.state.copy() for tid, ekf in tracks.items()}
        for tid in list(lifetimes):
            if tid in tracks:
                lifetimes[tid] += 1
            else:
                del lifetimes[tid]
        for tid in tracks:
            lifetimes.setdefault(tid, 1)
        ref.manage_tracks(tracks, lifetimes, confirmed, 1, 4, 10, 15)
        per_pair.append(dict(vx_f=vx_f, vy_f=vy_f, mag=mag, ang=ang, labels=labels,
                             idx=idx, snapshot=snapshot))
    return per_pair, tracks


def test_pipeline_matches_oracle(bev_seq, cfg):
    pipe = PipelineA(cfg, fast_warp=False)
    carry = pipe.init_carry()
    oracle_pairs, oracle_final = _oracle_pipeline(bev_seq, cfg)

    for i in range(len(bev_seq) - 1):
        carry, out = pipe.step(jnp.asarray(bev_seq[i]), jnp.asarray(bev_seq[i + 1]), carry)
        o = oracle_pairs[i]
        np.testing.assert_allclose(np.asarray(out.velocity_x), o["vx_f"],
                                   atol=2e-4, err_msg=f"pair {i} vx")
        np.testing.assert_allclose(np.asarray(out.magnitude), o["mag"], atol=2e-4)
        n = int(out.cell_count)
        assert n == len(o["labels"]), f"pair {i} cell count"
        got_idx = np.stack([np.asarray(out.rows)[:n], np.asarray(out.cols)[:n]], axis=1)
        np.testing.assert_array_equal(got_idx, o["idx"])
        np.testing.assert_array_equal(np.asarray(out.labels)[:n], o["labels"])
        got_tracks = PipelineA._tracks_dict(out.snapshot)
        assert set(got_tracks) == set(o["snapshot"]), f"pair {i} track ids"
        for tid, st in o["snapshot"].items():
            np.testing.assert_allclose(got_tracks[tid], st, atol=5e-3,
                                       err_msg=f"pair {i} track {tid}")

    final = PipelineA._tracks_dict(carry.table)
    assert set(final) == set(oracle_final)


def test_stream_mode_matches_pair_mode(cfg, bev_seq):
    """step_stream (pyramid carried across frames) equals the pair-mode step
    over consecutive frames — the pyramid is a pure function of the BEV, so
    reuse == recompute (up to XLA fusion float roundoff between the two
    programs)."""
    pipe = PipelineA(cfg, fast_warp=False)
    pair_carry = pipe.init_carry()
    stream_carry = pipe.init_stream_carry()

    stream_carry, out0 = pipe.step_stream(jnp.asarray(bev_seq[0]), stream_carry)
    assert bool(out0.skip)  # priming frame produces no pair

    for i in range(1, len(bev_seq)):
        pair_carry, pout = pipe.step(jnp.asarray(bev_seq[i - 1]),
                                     jnp.asarray(bev_seq[i]), pair_carry)
        stream_carry, sout = pipe.step_stream(jnp.asarray(bev_seq[i]), stream_carry)
        assert bool(pout.skip) == bool(sout.skip)
        np.testing.assert_allclose(np.asarray(sout.velocity_x),
                                   np.asarray(pout.velocity_x), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(sout.labels), np.asarray(pout.labels))
        np.testing.assert_allclose(np.asarray(stream_carry.step.table.state),
                                   np.asarray(pair_carry.table.state), atol=1e-4)

    # a zero frame mid-stream: this pair AND the next are skipped
    h, w = cfg.grid_shape
    zero = jnp.zeros((h, w), jnp.uint8)
    stream_carry, out_z = pipe.step_stream(zero, stream_carry)
    assert bool(out_z.skip)
    stream_carry, out_after = pipe.step_stream(jnp.asarray(bev_seq[0]), stream_carry)
    assert bool(out_after.skip)  # predecessor was invalid
    stream_carry, out_ok = pipe.step_stream(jnp.asarray(bev_seq[1]), stream_carry)
    assert not bool(out_ok.skip)  # stream recovers


def test_process_files_writes_artifacts(cfg, tmp_path):
    paths = write_synthetic_sequence(SyntheticScene(seed=9), str(tmp_path / "seq"), 3)
    pipe = PipelineA(cfg)
    out_dir = str(tmp_path / "out")
    summary = pipe.process_files(paths, output_dir=out_dir, save_png=False)
    assert summary["pairs"] == 2
    for i in range(3):
        assert os.path.exists(os.path.join(out_dir, f"bev_frame_{i}.npy"))
    for i in range(2):
        for name in (f"velocity_x_frame_{i}.npy", f"velocity_y_frame_{i}.npy",
                     f"dbscan_labels_frame_{i}.npy", f"dbscan_indices_frame_{i}.npy",
                     f"ekf_tracks_frame_{i}.yaml"):
            assert os.path.exists(os.path.join(out_dir, name)), name
    bev = np.load(os.path.join(out_dir, "bev_frame_0.npy"))
    assert bev.dtype == np.uint8 and bev.shape == cfg.grid_shape
    assert os.path.exists(os.path.join(out_dir, "filtered_velocities.csv"))


def test_process_files_writer_failure_raises(cfg, tmp_path, monkeypatch):
    """A failing artifact writer (e.g. disk full) must FAIL the run, not
    deadlock it: the background writer thread records the exception, keeps
    draining its queues, and the main loop re-raises."""
    import pytest

    from datmo_using_optical_flow.io.artifacts import ArtifactSink

    def boom(self, *a, **k):
        raise OSError("disk full (synthetic)")

    monkeypatch.setattr(ArtifactSink, "save_bev", boom)
    paths = write_synthetic_sequence(SyntheticScene(seed=9), str(tmp_path / "seq"), 4)
    pipe = PipelineA(cfg)
    with pytest.raises(OSError, match="disk full"):
        pipe.process_files(paths, output_dir=str(tmp_path / "out"), save_png=False)


def test_pipeline_deterministic(cfg, bev_seq):
    """Same inputs + same keys -> identical outputs (explicit PRNG everywhere)."""
    pipe = PipelineA(cfg, fast_warp=False)
    outs = []
    for _ in range(2):
        carry = pipe.init_carry()
        carry, out = pipe.step(jnp.asarray(bev_seq[0]), jnp.asarray(bev_seq[1]), carry)
        outs.append(np.asarray(out.velocity_x))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_scan_steps_matches_host_loop(cfg, bev_seq):
    """lax.scan over a clip == the per-pair host loop (same carry evolution)."""
    pipe = PipelineA(cfg, fast_warp=False)
    stack = jnp.asarray(np.stack(bev_seq))
    final_scan, outs = pipe.scan_steps(stack, pipe.init_carry())

    carry = pipe.init_carry()
    for i in range(len(bev_seq) - 1):
        carry, out = pipe.step(jnp.asarray(bev_seq[i]), jnp.asarray(bev_seq[i + 1]),
                               carry)
        np.testing.assert_allclose(np.asarray(outs.velocity_x[i]),
                                   np.asarray(out.velocity_x), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(final_scan.table.alive),
                                  np.asarray(carry.table.alive))
    np.testing.assert_allclose(np.asarray(final_scan.table.state),
                               np.asarray(carry.table.state), atol=1e-4)


def test_scan_steps_large_grid_dispatch_matches_scan(cfg, bev_seq):
    """The per-frame dispatch branch (grids above SCAN_MAX_CELLS) produces the
    same results as the single-program lax.scan branch."""
    pipe = PipelineA(cfg, fast_warp=False)
    stack = jnp.asarray(np.stack(bev_seq))
    f_scan, o_scan = pipe.scan_steps(stack, pipe.init_carry())
    old = PipelineA.SCAN_MAX_CELLS
    try:
        PipelineA.SCAN_MAX_CELLS = 1  # force the dispatch branch
        f_d, o_d = pipe.scan_steps(stack, pipe.init_carry())
    finally:
        PipelineA.SCAN_MAX_CELLS = old
    np.testing.assert_allclose(np.asarray(o_d.velocity_x),
                               np.asarray(o_scan.velocity_x), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(o_d.labels), np.asarray(o_scan.labels))
    np.testing.assert_allclose(np.asarray(f_d.table.state),
                               np.asarray(f_scan.table.state), atol=1e-4)


def test_process_files_renders_pngs(cfg, tmp_path):
    """save_png=True renders the reference's PNG artifact set (saving_utils
    :67,:77,:117,:142)."""
    paths = write_synthetic_sequence(SyntheticScene(seed=9), str(tmp_path / "seq"), 3)
    pipe = PipelineA(cfg)
    out_dir = str(tmp_path / "out")
    pipe.process_files(paths, output_dir=out_dir, save_png=True)
    for name in ("bev_frame_0.png", "velocity_grid_frame_0.png",
                 "dbscan_frame_0.png", "ekf_tracks_frame_0.png"):
        assert os.path.exists(os.path.join(out_dir, name)), name
