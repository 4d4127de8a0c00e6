"""Checkpoint/resume of the streaming runners: resumed runs produce bit-identical
final state to uninterrupted runs (SURVEY.md §5.4), for BOTH pipelines."""

import os

import jax
import numpy as np

from datmo_using_optical_flow.config import (CapacityConfig, DbscanConfig,
                                                 GMFAConfig, IcpConfig,
                                                 PipelineAConfig)
from datmo_using_optical_flow.models.gmfa import GMFAPipeline
from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow.sim.synthetic import (BoxTarget, SyntheticScene,
                                                        write_synthetic_sequence)


def test_resume_matches_uninterrupted(tmp_path):
    cfg = PipelineAConfig(
        capacities=CapacityConfig(max_raw_points=8192, max_roi_points=1024,
                                  max_cells=1024, max_clusters=8, max_tracks=16))
    # a slow target that stays inside the ROI for all 6 frames
    scene = SyntheticScene(seed=13, targets=(BoxTarget(center0=(4.0, 0.0, 0.75),
                                                       velocity=(0.6, 0.3)),))
    paths = write_synthetic_sequence(scene, str(tmp_path / "seq"), 6)
    ckpt = str(tmp_path / "state.npz")

    pipe = PipelineA(cfg, fast_warp=False)
    # full run with checkpoints every 3 frames
    full = pipe.process_files(paths, output_dir=str(tmp_path / "full"),
                              checkpoint_every=3, checkpoint_path=ckpt)
    import os

    assert os.path.exists(ckpt)
    data = np.load(ckpt)
    assert int(data["step"]) == 6  # snapshot at frame 6

    # run only the first 3 frames, checkpointing, then resume for the rest
    p2 = PipelineA(cfg, fast_warp=False)
    p2.process_files(paths[:3], output_dir=str(tmp_path / "part1"),
                     checkpoint_every=3, checkpoint_path=ckpt)
    resumed = p2.process_files(paths, output_dir=str(tmp_path / "part2"),
                               checkpoint_path=ckpt, resume=True)

    assert set(resumed["tracks"]) == set(full["tracks"])
    for tid, st in full["tracks"].items():
        np.testing.assert_allclose(resumed["tracks"][tid], st, atol=1e-6,
                                   err_msg=f"track {tid}")
    assert resumed["pairs"] == full["pairs"] - 2  # resumed from frame 3 -> pairs 3..5


def test_gmfa_resume_matches_uninterrupted(tmp_path):
    """GMFA checkpoint/resume: the restored GmfaCarry (previous cloud, track
    table, SOM, previous centroids) plus index-derived PRNG keys make the
    resumed run bit-identical to the uninterrupted one."""
    cfg = GMFAConfig(
        dbscan=DbscanConfig(eps=1.0, min_samples=30),
        icp=IcpConfig(threshold=0.1),
        capacities=CapacityConfig(max_raw_points=8192, max_roi_points=1024,
                                  max_cells=1024, max_clusters=8, max_tracks=16))
    scene = SyntheticScene(seed=21, targets=(BoxTarget(center0=(5.0, -3.0, 0.75),
                                                       velocity=(2.0, 1.0)),))
    paths = write_synthetic_sequence(scene, str(tmp_path / "seq"), 6)
    ckpt = str(tmp_path / "gmfa_state.npz")

    pipe = GMFAPipeline(cfg, max_moving_points=4096)
    full = pipe.process_files(paths, checkpoint_every=3, checkpoint_path=ckpt)
    assert os.path.exists(ckpt)
    assert int(np.load(ckpt)["step"]) == 6

    p2 = GMFAPipeline(cfg, max_moving_points=4096)
    p2.process_files(paths[:3], checkpoint_every=3, checkpoint_path=ckpt)
    assert int(np.load(ckpt)["step"]) == 3
    resumed = p2.process_files(paths, checkpoint_path=ckpt, resume=True)

    # bit-identical final carry (every leaf: prev cloud, table, SOM, centroids)
    for got, exp in zip(jax.tree.leaves(resumed["carry"]),
                        jax.tree.leaves(full["carry"])):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))
    # resumed rows are the tail of the full run's rows
    assert resumed["rows"] == full["rows"][len(full["rows"]) - len(resumed["rows"]):]
    assert resumed["rows"], "expected post-resume track rows"


def test_checkpoint_legacy_and_missing_leaf(tmp_path):
    """Old archives load into newer carries: positional leaf_<i> keys (the
    pre-path-keyed format) still resolve, and a leaf the snapshot predates
    (GmfaCarry.prev_order) falls back to the template's value."""
    from datmo_using_optical_flow.utils.checkpoint import (load_checkpoint,
                                                               save_checkpoint)

    cfg = GMFAConfig(capacities=CapacityConfig(
        max_raw_points=4096, max_roi_points=512, max_cells=512,
        max_clusters=4, max_tracks=8))
    pipe = GMFAPipeline(cfg, max_moving_points=1024)
    carry = pipe.init_carry()
    carry = carry._replace(som=carry.som + 0.25,
                           prev_mask=carry.prev_mask.at[:7].set(True))

    # current (path-keyed) round trip
    p1 = str(tmp_path / "new.npz")
    save_checkpoint(p1, carry, step=4)
    back = load_checkpoint(p1, pipe.init_carry())
    for got, exp in zip(jax.tree.leaves(back), jax.tree.leaves(carry)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))

    # legacy positional archive WITHOUT the trailing prev_order leaf
    leaves = jax.tree.leaves(carry)
    legacy = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves[:-1])}
    p2 = str(tmp_path / "old.npz")
    np.savez(p2, step=4, n=len(leaves) - 1, **legacy)
    back = load_checkpoint(p2, pipe.init_carry())
    restored = jax.tree.leaves(back)
    for got, exp in zip(restored[:-1], leaves[:-1]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))
    # the missing leaf keeps the template's (functionally valid) arange
    np.testing.assert_array_equal(np.asarray(restored[-1]),
                                  np.asarray(pipe.init_carry().prev_order))
