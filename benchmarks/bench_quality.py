"""Adversarial detection-quality benchmark (VERDICT r4 missing #2).

The reference names its quality surface — "velocity estimation accuracy,
detection precision, recall" (``/root/reference/README.md:8``) — but ships no
numbers and no evaluation code, and the r1-r4 stand-in (`examples/evaluate.py`)
used well-separated constant-velocity boxes that saturate P/R at 1.0.  This
benchmark runs BOTH pipelines over >= 50-frame synthetic clips designed to
make them fail in measurable ways:

* ``crossing_clutter``: two targets whose paths CROSS mid-clip (association
  stress) + transient clutter blobs every frame (false-positive bait for the
  residual classifiers);
* ``occlusion``: a target passes BEHIND a static obstacle under the LiDAR
  cylinder-shadow model (missed detections, track death/rebirth);
* ``accel_turn``: constant-acceleration (curving) targets against the
  constant-velocity motion models;
* ``noise_hi`` / ``sparse``: sensor-noise x8 and ~1/4-density sweeps of the
  easy scene;
* ``easy``: the r1-style sanity scene (expected to stay ~saturated).

Reported per scene and pipeline: detection precision/recall (greedy 3 m gate
per frame), matched-track velocity MAE vs ground truth, and — for pipeline A —
artifact agreement vs the CPU oracle loop (cv2 Farnebäck + sklearn DBSCAN +
numpy EKF replayed on the run's own saved BEVs; velocity grids toleranced,
DBSCAN label partitions exact-compared).  Output: one JSON document.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_FRAMES = 52
GATE_M = 3.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def scenes():
    """Trajectory design constraints (why everything circles):

    * GMFA only labels a point moving when its inter-frame residual exceeds
      0.6 m (GMFA.py:432), so targets must displace >= ~0.62 m/frame;
    * pipeline A's ROI is +-10 m and GMFA's moving ROI caps y < 5 m
      (GMFA.py:472) — a straight 0.62 m/frame path leaves the box in ~25 of
      the 50 frames.  Constant-speed circles (``turn_rate``) keep the speed
      above threshold for the whole clip while continuously changing heading
      — itself an adversarial input for both constant-velocity trackers.
    """
    from datmo_using_optical_flow.sim.synthetic import BoxTarget, SyntheticScene

    # R = 5 m circle about (0, -1): speed 0.65, inside every ROI, y <= 4
    circle = BoxTarget(center0=(5.0, -1.0, 0.75), velocity=(0.0, 0.65),
                       turn_rate=0.13, points_per_frame=600)
    easy = dict(ground_points=4000, ground_extent=20.0, seed=101,
                targets=(circle,))
    yield "easy", SyntheticScene(**easy)

    yield "crossing_clutter", SyntheticScene(
        ground_points=4000, ground_extent=20.0, seed=102,
        static_boxes=(BoxTarget(center0=(-8.0, -8.0, 1.0), velocity=(0, 0),
                                points_per_frame=800),),
        targets=(
            # concentric circles (R=5 and R=7.2) around (0, -1) at different
            # angular rates: the targets repeatedly close within ~2 m and
            # separate — association/crossing stress
            circle,
            BoxTarget(center0=(-7.2, -1.0, 0.75), velocity=(0.0, -0.65),
                      turn_rate=0.09, size=(3.0, 1.6, 1.4),
                      points_per_frame=600),
        ),
        clutter_blobs=5, clutter_points=40,
    )

    yield "occlusion", SyntheticScene(
        ground_points=4000, ground_extent=20.0, seed=103, occlusion=True,
        static_boxes=(BoxTarget(center0=(4.0, 1.6, 1.25),
                                size=(5.0, 3.0, 2.5), velocity=(0, 0),
                                points_per_frame=1200),),
        targets=(
            # straight pass at x=8 through the (4, 1.6) box's shadow cone
            # (the ray from the origin sensor): occluded around frames ~18-28
            BoxTarget(center0=(8.0, -9.5, 0.75), velocity=(0.0, 0.62),
                      points_per_frame=600),
        ),
    )

    yield "turn_tight", SyntheticScene(
        ground_points=4000, ground_extent=20.0, seed=104,
        targets=(
            # R = 3 m at 0.66 m/frame: ~1.7 revolutions over the clip — the
            # heading turns ~12.6 deg/frame against constant-velocity KFs
            BoxTarget(center0=(3.0, -2.0, 0.75), velocity=(0.0, 0.66),
                      turn_rate=0.22, points_per_frame=600),
        ),
    )

    hi = dict(easy)
    hi.update(seed=105, sensor_noise=0.08)
    yield "noise_hi", SyntheticScene(**hi)

    sparse = dict(easy)
    sparse.update(
        seed=106, ground_points=1200,
        targets=(BoxTarget(center0=(5.0, -1.0, 0.75), velocity=(0.0, 0.65),
                           turn_rate=0.13, points_per_frame=150),))
    yield "sparse", SyntheticScene(**sparse)


def greedy_match(det: np.ndarray, gt: np.ndarray, gate: float):
    """Greedy nearest matching (the utils.metrics.detection_pr rule), returning
    (pairs, tp, fp, fn) where pairs is a list of (det_row, gt_row) indices."""
    det = np.atleast_2d(det).reshape(-1, 2)
    gt = np.atleast_2d(gt).reshape(-1, 2)
    matched: set[int] = set()
    pairs = []
    for ti, t in enumerate(gt):
        if det.shape[0] == 0:
            break
        d = np.linalg.norm(det - t, axis=1)
        d[list(matched)] = np.inf
        j = int(np.argmin(d))
        if d[j] <= gate:
            matched.add(j)
            pairs.append((j, ti))
    tp = len(pairs)
    return pairs, tp, det.shape[0] - tp, gt.shape[0] - tp


class PRAccum:
    def __init__(self):
        self.tp = self.fp = self.fn = 0
        self.vel_err: list[float] = []

    def add(self, det_pos, det_vel, gt_pos, gt_vel, gate=GATE_M,
            gt_in_region=None):
        """``gt_in_region``: boolean mask over GT rows — a truth outside the
        pipeline's detectable region (pipeline A's +-10 m ROI, GMFA's moving
        ROI) is an IGNORE region, not a miss: detections matched to it are
        dropped from both TP and FP, and it never counts as FN."""
        gt_pos = np.atleast_2d(gt_pos).reshape(-1, 2)
        if gt_in_region is None:
            gt_in_region = np.ones(len(gt_pos), bool)
        pairs, _tp, _fp, _fn = greedy_match(det_pos, gt_pos, gate)
        matched_det = {dj for dj, _ in pairs}
        kept = [(dj, ti) for dj, ti in pairs if gt_in_region[ti]]
        self.tp += len(kept)
        n_det = np.atleast_2d(det_pos).reshape(-1, 2).shape[0]
        self.fp += n_det - len(matched_det)
        matched_gt = {ti for _, ti in pairs}
        self.fn += int(sum(1 for ti in range(len(gt_pos))
                           if gt_in_region[ti] and ti not in matched_gt))
        for dj, ti in kept:
            if det_vel is not None:
                self.vel_err.append(float(np.linalg.norm(
                    np.asarray(det_vel)[dj] - np.asarray(gt_vel)[ti])))

    def report(self) -> dict:
        prec = self.tp / max(self.tp + self.fp, 1)
        rec = self.tp / max(self.tp + self.fn, 1)
        return {
            "precision": round(prec, 4), "recall": round(rec, 4),
            "tp": self.tp, "fp": self.fp, "fn": self.fn,
            "velocity_mae_mps": (round(float(np.mean(self.vel_err)), 4)
                                 if self.vel_err else None),
        }


def eval_gmfa(scene, paths, dt_scene: float) -> dict:
    """GMFA (pipeline B): track rows vs ground truth.  GMFA positions are in
    flipped-x meters; its velocities are per cfg.dt (0.1 s) while the scene
    advances dt_scene per frame, so estimates scale by cfg.dt / dt_scene."""
    import jax

    from datmo_using_optical_flow.config import (CapacityConfig, DbscanConfig,
                                                     GMFAConfig, IcpConfig)
    from datmo_using_optical_flow.models.gmfa import GMFAPipeline
    from datmo_using_optical_flow.sim.synthetic import ground_truth

    cfg = GMFAConfig(
        dbscan=DbscanConfig(eps=1.0, min_samples=150),
        icp=IcpConfig(threshold=0.1),
        capacities=CapacityConfig(max_raw_points=16384, max_roi_points=4096,
                                  max_cells=4096, max_clusters=16, max_tracks=32))
    pipe = GMFAPipeline(cfg, max_moving_points=16384)
    import contextlib

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # keep stdout JSON-clean
        out = pipe.process_files(paths)
    elapsed = time.perf_counter() - t0
    by_frame: dict[int, list[dict]] = {}
    for row in out["rows"]:
        by_frame.setdefault(int(row["Frame"]), []).append(row)
    acc = PRAccum()
    warmup = 3  # tracker needs a couple frames of history
    for f in range(warmup, N_FRAMES - 1):
        rows = by_frame.get(f, [])
        det_pos = np.array([[r["X"], r["Y"]] for r in rows]).reshape(-1, 2)
        # velocities are finite differences of flipped positions over cfg.dt
        det_vel = np.array([[r["VX"], r["VY"]] for r in rows]).reshape(-1, 2) \
            * (cfg.dt / dt_scene)
        gt_pos, gt_vel = ground_truth(scene, f + 1, dt_scene)
        gt_pos = gt_pos * np.array([-1.0, 1.0])   # preprocess flips x
        gt_vel = gt_vel * np.array([-1.0, 1.0])
        # detectable region: GMFA ROI intersect moving ROI (flipped coords)
        rb, mb = cfg.roi_bounds, cfg.moving_roi_bounds
        margin = 0.5
        in_region = ((gt_pos[:, 0] > max(rb[0], mb[0]) + margin)
                     & (gt_pos[:, 0] < min(rb[1], mb[1]) - margin)
                     & (gt_pos[:, 1] > max(rb[2], mb[2]) + margin)
                     & (gt_pos[:, 1] < min(rb[3], mb[3]) - margin))
        acc.add(det_pos, det_vel, gt_pos, gt_vel, gt_in_region=in_region)
    rep = acc.report()
    rep["frames"] = N_FRAMES
    rep["fps"] = round((N_FRAMES - 1) / max(out["elapsed"], 1e-9), 2)
    del jax  # imported for side effect ordering only
    return rep


def eval_pipeline_a(scene, paths, dt_scene: float, workdir: str) -> dict:
    """Pipeline A: per-pair EKF track yamls vs ground truth + CPU-oracle
    artifact agreement on the run's own BEVs (the test_scale_parity method)."""
    from datmo_using_optical_flow.config import CapacityConfig, PipelineAConfig
    from datmo_using_optical_flow.io.artifacts import load_tracks_yaml
    from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow.oracle import reference_a as ref
    from datmo_using_optical_flow.sim.synthetic import ground_truth

    # max_cells 16384: the clutter scenes exceed 4096 moving cells, and the
    # overflow truncation both hides real clusters and desyncs the DBSCAN
    # artifact comparison vs the (uncapped) oracle (8 truncated pairs in the
    # first capture) — quality evaluation needs the uncapped behavior
    cfg = PipelineAConfig(
        capacities=CapacityConfig(max_raw_points=16384, max_roi_points=4096,
                                  max_cells=16384, max_clusters=32, max_tracks=32))
    out_dir = os.path.join(workdir, "a_artifacts")
    pipe = PipelineA(cfg, fast_warp=False)
    import contextlib

    with contextlib.redirect_stdout(sys.stderr):  # keep stdout JSON-clean
        summary = pipe.process_files(paths, output_dir=out_dir, save_png=False,
                                     seed=0)

    res_x = cfg.grid_resolution[0]
    res_y = cfg.grid_resolution[1]
    x0, y0 = cfg.x_range[0], cfg.y_range[0]
    acc = PRAccum()
    warmup = 3
    for pair in range(warmup, N_FRAMES - 1):
        p = os.path.join(out_dir, f"ekf_tracks_frame_{pair}.yaml")
        tracks = load_tracks_yaml(open(p).read()) if os.path.exists(p) else {}
        det_pos, det_vel = [], []
        for _tid, st in (tracks or {}).items():
            # state [cx, cy] are BEV cell indices (row = x bin, col = y bin)
            det_pos.append([x0 + st[0] * res_x, y0 + st[1] * res_y])
            # the reference's velocity axes come from flow (dx = axis-1 = the
            # y-bin direction, dy = axis-0 = x-bin), so world (vx, vy) is the
            # SWAP of the state's (vx, vy) — a reference quirk kept as-is
            det_vel.append([st[3], st[2]])
        gt_pos, gt_vel = ground_truth(scene, pair + 1, dt_scene)
        gt_pos = gt_pos * np.array([-1.0, 1.0])   # preprocess flips x
        gt_vel = gt_vel * np.array([-1.0, 1.0])
        rb = cfg.roi_bounds
        margin = 0.5
        in_region = ((gt_pos[:, 0] > rb[0] + margin)
                     & (gt_pos[:, 0] < rb[1] - margin)
                     & (gt_pos[:, 1] > rb[2] + margin)
                     & (gt_pos[:, 1] < rb[3] - margin))
        acc.add(np.asarray(det_pos).reshape(-1, 2),
                np.asarray(det_vel).reshape(-1, 2), gt_pos, gt_vel,
                gt_in_region=in_region)
    rep = acc.report()
    rep["pairs"] = summary["pairs"]

    # ---- oracle artifact agreement on the run's own BEVs ----
    try:
        import cv2  # noqa: F401
        import sklearn  # noqa: F401
    except ImportError:
        rep["oracle_agreement"] = "not run: the oracle needs cv2 and sklearn"
        return rep
    bevs = [np.load(os.path.join(out_dir, f"bev_frame_{i}.npy"))
            for i in range(N_FRAMES)]
    max_v = 0.0
    labels_equal = 0
    pairs_total = 0
    for i in range(N_FRAMES - 1):
        if not os.path.exists(os.path.join(out_dir, f"velocity_x_frame_{i}.npy")):
            continue  # skipped pair (invalid BEV) writes no pair artifacts
        flow = ref.farneback_flow(bevs[i], bevs[i + 1])
        vx, vy, _ = ref.velocity_from_flow(flow, cfg.x_range, cfg.y_range)
        cont = ref.continuity_mask(vx, vy, cfg.masks.alpha_cont)
        vx_f, vy_f = vx * cont, vy * cont
        got_vx = np.load(os.path.join(out_dir, f"velocity_x_frame_{i}.npy"))
        got_vy = np.load(os.path.join(out_dir, f"velocity_y_frame_{i}.npy"))
        max_v = max(max_v, float(np.abs(got_vx - vx_f).max()),
                    float(np.abs(got_vy - vy_f).max()))
        mag = np.sqrt(vx_f ** 2 + vy_f ** 2)
        valid = mag > cfg.velocity_threshold
        labels, idx = ref.dbscan_clustering(vx_f, vy_f, valid, cfg.dbscan.eps,
                                            cfg.dbscan.min_samples)
        got_l = np.load(os.path.join(out_dir, f"dbscan_labels_frame_{i}.npy"))
        got_i = np.load(os.path.join(out_dir, f"dbscan_indices_frame_{i}.npy"))
        pairs_total += 1
        if (got_l.shape == np.asarray(labels).shape
                and np.array_equal(got_l, labels)
                and np.array_equal(got_i, idx)):
            labels_equal += 1
    rep["oracle_agreement"] = {
        "bev_source": "run's own uint8 BEV artifacts (device BEV parity is "
                      "pinned exactly by tests/test_geometry.py)",
        "velocity_grid_max_abs_diff_mps": round(max_v, 7),
        "dbscan_label_partitions_equal": f"{labels_equal}/{pairs_total}",
    }
    return rep


def main() -> None:
    from datmo_using_optical_flow.sim.synthetic import write_synthetic_sequence

    report: dict = {"n_frames": N_FRAMES, "gate_m": GATE_M, "scenes": {}}
    dt_scene = 1.0
    with tempfile.TemporaryDirectory() as tmp:
        for name, scene in scenes():
            log(f"=== scene {name}")
            seq_dir = os.path.join(tmp, name)
            paths = write_synthetic_sequence(scene, seq_dir, N_FRAMES, dt=dt_scene)
            entry: dict = {}
            t0 = time.perf_counter()
            entry["gmfa"] = eval_gmfa(scene, paths, dt_scene)
            log(f"  gmfa: {entry['gmfa']}")
            entry["optical_flow"] = eval_pipeline_a(scene, paths, dt_scene,
                                                    seq_dir)
            log(f"  optical_flow: {entry['optical_flow']}")
            entry["wall_s"] = round(time.perf_counter() - t0, 1)
            report["scenes"][name] = entry
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
