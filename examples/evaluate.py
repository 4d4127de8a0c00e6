"""End-to-end evaluation on synthetic ground truth.

Computes the metric categories the reference names but never implements
(``README.md:8``): velocity estimation accuracy, detection precision/recall, and
computational efficiency (FPS) — for both pipelines, on a deterministic synthetic
scene with known target velocities.

Usage: python examples/evaluate.py [num_frames]

NOTE: this is the quick well-separated sanity scene (P/R saturate near 1.0 by
design).  The ADVERSARIAL quality surface — crossing targets with clutter,
occlusion shadows, curving targets, noise/density sweeps, where P/R genuinely
degrade — is ``benchmarks/bench_quality.py``.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv: list[str]) -> int:
    from datmo_using_optical_flow.config import (CapacityConfig, DbscanConfig,
                                                     GMFAConfig, IcpConfig,
                                                     PipelineAConfig)
    from datmo_using_optical_flow.models.gmfa import GMFAPipeline
    from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow.sim.synthetic import (BoxTarget, SyntheticScene,
                                                            write_synthetic_sequence)
    from datmo_using_optical_flow.utils.metrics import (detection_pr,
                                                            velocity_accuracy)

    n_frames = int(argv[0]) if argv else 6
    target = BoxTarget(center0=(5.0, -3.0, 0.75), velocity=(2.0, 1.0))
    scene = SyntheticScene(seed=11, targets=(target,))
    seq_dir = "/tmp/datmo_eval_seq"
    paths = write_synthetic_sequence(scene, seq_dir, n_frames)
    gt_vel = np.asarray(target.velocity)

    caps = CapacityConfig(max_raw_points=8192, max_roi_points=2048,
                          max_cells=2048, max_clusters=8, max_tracks=16)
    report: dict = {}

    # ---------------- pipeline B (GMFA): velocity + detection vs ground truth
    cfg_b = GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=30),
                       icp=IcpConfig(threshold=0.1), capacities=caps)
    pipe_b = GMFAPipeline(cfg_b, max_moving_points=8192)
    t0 = time.perf_counter()
    out_b = pipe_b.process_files(paths)
    elapsed_b = time.perf_counter() - t0
    # per-frame detection P/R + velocity error on the last frames (tracker warmed)
    prs, vels = [], []
    for row in out_b["rows"]:
        frame = row["Frame"]
        # ground-truth target position at frame f+1 (GMFA logs use frame index i-1
        # for cloud i); the x axis is flipped by preprocessing
        t_pos = np.asarray(target.center0[:2]) + gt_vel * (frame + 1)
        t_pos = np.array([-t_pos[0], t_pos[1]])
        prs.append(detection_pr(np.array([[row["X"], row["Y"]]]), t_pos[None, :],
                                gate=3.0))
        if frame >= 2:
            # velocity in flipped coords: vx negated; GMFA dt=0.1 while the scene
            # advances per frame, so velocities are in m per 0.1s -> scale by dt
            est = np.array([row["VX"], row["VY"]]) * cfg_b.dt
            vels.append(velocity_accuracy(est[None, :],
                                          np.array([[-gt_vel[0], gt_vel[1]]])))
    report["gmfa"] = {
        "frames": n_frames,
        "fps": round(len(out_b["rows"]) / max(elapsed_b, 1e-9), 2),
        "detection_precision": round(float(np.mean([p["precision"] for p in prs])), 3),
        "detection_recall": round(float(np.mean([p["recall"] for p in prs])), 3),
        "velocity_mae_mps": round(float(np.mean([v["vel_mae"] for v in vels])), 3)
        if vels else None,
    }

    # ---------------- pipeline A: runs end-to-end, reports efficiency + detections
    cfg_a = PipelineAConfig(capacities=caps)
    pipe_a = PipelineA(cfg_a)
    t0 = time.perf_counter()
    out_a = pipe_a.process_files(paths, output_dir="/tmp/datmo_eval_out_a")
    elapsed_a = time.perf_counter() - t0
    report["optical_flow"] = {
        "pairs": out_a["pairs"],
        "fps": round(out_a["pairs"] / max(elapsed_a, 1e-9), 2),
        "live_tracks": len(out_a["tracks"]),
        "stage_seconds": {k: round(v, 2) for k, v in out_a["timings"].items()},
    }

    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
