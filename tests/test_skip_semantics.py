"""Failure-handling semantics: a bad frame pair is a masked no-op, never a crash
(the reference's per-pair try/except + None-BEV skip, ``Optical_flow/main.py:
565-637``; GMFA's no-moving-points ``continue``, ``GMFA.py:475-477``)."""

import jax
import jax.numpy as jnp
import numpy as np

from datmo_using_optical_flow.config import CapacityConfig, PipelineAConfig
from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA


def _cfg():
    return PipelineAConfig(
        capacities=CapacityConfig(max_raw_points=1024, max_roi_points=256,
                                  max_cells=256, max_clusters=4, max_tracks=8))


def test_zero_bev_pair_is_noop():
    cfg = _cfg()
    pipe = PipelineA(cfg, fast_warp=False)
    h, w = cfg.grid_shape
    rng = np.random.default_rng(0)
    good = jnp.asarray(rng.integers(1, 255, size=(h, w)).astype(np.uint8))
    zero = jnp.zeros((h, w), jnp.uint8)

    carry = pipe.init_carry()
    carry, out = pipe.step(good, good, carry)
    assert not bool(out.skip)
    # snapshot BEFORE stepping: the carry is donated (consumed) by step
    ref_vx = np.asarray(carry.prev_vx)
    ref_alive = np.asarray(carry.table.alive)

    # empty-BEV pair: carry must be untouched
    carry2, out2 = pipe.step(good, zero, carry)
    assert bool(out2.skip)
    np.testing.assert_array_equal(np.asarray(carry2.prev_vx), ref_vx)
    np.testing.assert_array_equal(np.asarray(carry2.table.alive), ref_alive)

    # stream continues fine afterwards
    carry3, out3 = pipe.step(good, good, carry2)
    assert not bool(out3.skip)


def test_donated_step_matches_undonated():
    """donate=True (opt-in buffer donation) produces identical results and
    consumes the input carry."""
    cfg = _cfg()
    h, w = cfg.grid_shape
    rng = np.random.default_rng(1)
    b1 = jnp.asarray(rng.integers(1, 255, size=(h, w)).astype(np.uint8))
    b2 = jnp.asarray(rng.integers(1, 255, size=(h, w)).astype(np.uint8))

    ref_pipe = PipelineA(cfg, fast_warp=False)
    ref_carry, ref_out = ref_pipe.step(b1, b2, ref_pipe.init_carry())

    don_pipe = PipelineA(cfg, fast_warp=False, donate=True)
    old = don_pipe.init_carry()
    carry, out = don_pipe.step(b1, b2, old)
    np.testing.assert_array_equal(np.asarray(carry.prev_vx),
                                  np.asarray(ref_carry.prev_vx))
    np.testing.assert_array_equal(np.asarray(out.velocity_x),
                                  np.asarray(ref_out.velocity_x))
    assert old.prev_vx.is_deleted()  # the donated carry was consumed


def test_empty_roi_preprocess_yields_zero_bev():
    cfg = _cfg()
    pipe = PipelineA(cfg)
    # points far outside the ROI -> zero BEV (the reference's None analogue)
    pts = jnp.full((64, 3), 500.0)
    mask = jnp.ones((64,), bool)
    bev = pipe.preprocess(pts, mask, jax.random.PRNGKey(0))
    assert int(jnp.sum(bev)) == 0


def test_corrupt_pcd_mid_sequence_is_skipped(tmp_path):
    """A corrupt PCD file mid-stream becomes an empty frame -> skipped pair;
    the stream continues (reference's blanket per-pair except, main.py:635-637)."""
    from datmo_using_optical_flow.sim.synthetic import (SyntheticScene,
                                                            write_synthetic_sequence)

    from datmo_using_optical_flow.sim.synthetic import BoxTarget

    cfg = _cfg()
    # a scene small enough for the test capacities (max_raw_points=1024)
    scene = SyntheticScene(seed=4, ground_points=500,
                           targets=(BoxTarget(center0=(4.0, 0.0, 0.75),
                                              velocity=(0.3, 0.2),
                                              points_per_frame=300),))
    paths = write_synthetic_sequence(scene, str(tmp_path / "s"), 4)
    with open(paths[2], "wb") as f:
        f.write(b"this is not a pcd file")
    pipe = PipelineA(cfg, fast_warp=False)
    summary = pipe.process_files(paths, output_dir=str(tmp_path / "o"))
    # pairs (0,1) processed; pairs touching the corrupt frame 2 skipped;
    # the (2,3) slot re-anchors on frame 3 after the empty frame
    assert summary["pairs"] >= 1
    import os

    assert os.path.exists(tmp_path / "o" / "bev_frame_3.npy")
