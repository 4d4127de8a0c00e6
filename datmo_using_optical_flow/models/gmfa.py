"""Pipeline B: General Model-Free Approach (GMFA) DATMO, end-to-end on the device.

Device re-composition of the reference's ``GMFA/GMFA.py`` ``__main__`` loop
(:424-536): ICP ego-motion compensation -> residual-motion classification ->
moving-point ROI + DBSCAN -> Hungarian association -> track update/birth ->
static occupancy map -> per-track KF.  Replicated quirks (on purpose):

* a frame with zero moving ROI points is skipped *without* updating the previous
  cloud (the reference's ``continue`` at GMFA.py:477 bypasses the update at :531);
* residuals are index-wise when the cloud sizes happen to match and NN-aligned
  otherwise (GMFA.py:79-91);
* the SOM update pairs moving point k with the *full cloud's* residual k
  (the zip misalignment at GMFA.py:491/134);
* unmatched tracks are dropped (only assigned tracks survive ``update_tracks``,
  GMFA.py:216-232) and every surviving track KF-updates against its *own*
  feature centroid (GMFA.py:494-497);
* new-track ids are random ints < 1e5 (GMFA.py:252) — here from an explicit key;
* ``previous_positions`` (birth-velocity lookup) only refreshes on frames with
  >= 1 live track (the indentation bug at GMFA.py:500-523 nests the update in the
  per-track loop).
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from datmo_using_optical_flow.config import GMFAConfig
from datmo_using_optical_flow.io.frames import DiskFrameSource
from datmo_using_optical_flow.ops import points as point_ops
from datmo_using_optical_flow.ops.dbscan import dbscan
from datmo_using_optical_flow.ops.hungarian import linear_sum_assignment
from datmo_using_optical_flow.ops.icp import registration_icp, transform_points
from datmo_using_optical_flow.ops.linalg import matmul
from datmo_using_optical_flow.ops.nn import nearest_neighbors_with_bound
from datmo_using_optical_flow.ops.ransac import remove_ground
from datmo_using_optical_flow.ops.som import update_som
from datmo_using_optical_flow.utils.padding import compact_masked


class TrackTableB(NamedTuple):
    state: jnp.ndarray     # (T, 4) [x, y, vx, vy]
    cov: jnp.ndarray       # (T, 4, 4)
    features: jnp.ndarray  # (T, 4) [cx, cy, lmax, lmin]
    tid: jnp.ndarray       # (T,)
    age: jnp.ndarray       # (T,)
    alive: jnp.ndarray     # (T,)


def new_track_table_b(capacity: int) -> TrackTableB:
    return TrackTableB(
        state=jnp.zeros((capacity, 4), jnp.float32),
        cov=jnp.zeros((capacity, 4, 4), jnp.float32),
        features=jnp.zeros((capacity, 4), jnp.float32),
        tid=jnp.zeros((capacity,), jnp.int32),
        age=jnp.zeros((capacity,), jnp.int32),
        alive=jnp.zeros((capacity,), bool),
    )


class GmfaCarry(NamedTuple):
    prev_points: jnp.ndarray     # (P, 3) previous expanded cloud
    prev_mask: jnp.ndarray       # (P,)
    table: TrackTableB
    som: jnp.ndarray             # (G, G)
    prev_centroids: jnp.ndarray  # (K, 2) previous frame's cluster centroids
    prev_exists: jnp.ndarray     # (K,)
    # (P,) int32 spatial (Morton) order of prev_points, computed when that
    # cloud was current and reused by ICP's source permutation and the
    # classification sweep's target index (rigid motion preserves spatial
    # coherence; results are permutation-independent, only pruning tightness
    # varies — an arange placeholder is functionally valid)
    prev_order: jnp.ndarray


class GmfaOutputs(NamedTuple):
    skip: jnp.ndarray            # bool: no moving ROI points (frame skipped)
    classifications: jnp.ndarray  # (P,) int32 in {0(pad), 1, 2, 3}
    residuals: jnp.ndarray       # (P,)
    moving_points: jnp.ndarray   # (M, 3) compacted moving ROI points
    moving_count: jnp.ndarray
    labels: jnp.ndarray          # (M,) DBSCAN labels of moving points
    n_clusters: jnp.ndarray
    transformation: jnp.ndarray  # (4, 4) ICP ego-motion
    fitness: jnp.ndarray


class GMFAPipeline:
    """Streaming runner for the GMFA pipeline."""

    def __init__(self, cfg: GMFAConfig | None = None, max_moving_points: int = 8192,
                 donate: bool = False):
        self.cfg = (cfg or GMFAConfig()).validate()
        self.max_moving = max_moving_points
        self.donate = donate
        # cached per config so equal-config pipelines share compilations
        self._preprocess = _cached_gmfa_preprocess(self.cfg)
        self._step = _cached_gmfa_step(self.cfg, max_moving_points, donate)

    def preprocess(self, points: jnp.ndarray, mask: jnp.ndarray, key: jax.Array):
        """flip -> RANSAC -> ROI -> densify (GMFA ``preprocess_pcd``, GMFA.py:31-55).
        Returns (expanded_points, expanded_mask)."""
        return self._preprocess(points, mask, key)

    def init_carry(self) -> GmfaCarry:
        c = self.cfg
        p = c.capacities.max_expanded_points
        g = c.som.grid_size
        return GmfaCarry(
            prev_points=jnp.full((p, 3), 1e9, jnp.float32),
            prev_mask=jnp.zeros((p,), bool),
            table=new_track_table_b(c.capacities.max_tracks),
            som=jnp.full((g, g), c.som.init_value, jnp.float32),
            prev_centroids=jnp.zeros((c.capacities.max_clusters, 2), jnp.float32),
            prev_exists=jnp.zeros((c.capacities.max_clusters,), bool),
            prev_order=jnp.arange(p, dtype=jnp.int32),
        )

    def step(self, points: jnp.ndarray, mask: jnp.ndarray, carry: GmfaCarry,
             key: jax.Array) -> tuple[GmfaCarry, GmfaOutputs]:
        """One GMFA frame step.  With ``donate=True`` the carry is donated —
        treat it as consumed and use the returned carry.  A skipped frame
        returns the old carry values (including the stale previous cloud)."""
        return self._step(points, mask, carry, key)

    def seed_carry(self, points: jnp.ndarray, mask: jnp.ndarray,
                   carry: GmfaCarry | None = None) -> GmfaCarry:
        """Seed a carry's previous-cloud slots (the reference's first frame,
        GMFA.py:455-463) WITH the cloud's Morton order.

        Seeding via bare ``_replace(prev_points=...)`` leaves ``prev_order``
        at the arange placeholder — functionally valid (results are
        permutation-independent) but it destroys the spatial coherence the
        NN kernel's block pruning, in-place block skipping, and exclusion
        shell all rely on: the first frame's ICP then runs near-brute-force.
        Every seeding path must go through here."""
        if carry is None:
            carry = self.init_carry()
        return carry._replace(prev_points=points, prev_mask=mask,
                              prev_order=_seed_order_jit()(points, mask))

    def process_files(self, pcd_files: Sequence[str], output_xlsx: str | None = None,
                      seed: int = 0, progress: bool = False,
                      plot_dir: str | None = None, checkpoint_every: int = 0,
                      checkpoint_path: str | None = None, resume: bool = False,
                      h2d_q16: bool = False) -> dict:
        """Run GMFA over a PCD sequence (reference __main__, GMFA.py:424-536).

        Returns {"rows": track-log rows, "som": final SOM}; writes
        ``track_data.xlsx`` (or .csv fallback) like ``save_tracks_to_excel``.
        With ``plot_dir``, saves the reference's three per-frame plots
        (GMFA.py:526-528: SOM heat map, moving-vs-static, final positions) as
        PNGs instead of blocking windows.

        Checkpoint/resume (SURVEY.md §5.4 — absent in the reference): with
        ``checkpoint_every=K`` the :class:`GmfaCarry` (previous expanded cloud,
        track table, SOM, previous centroids — the loop carries at
        GMFA.py:424-536) snapshots to ``checkpoint_path`` (.npz) every K frames;
        ``resume=True`` restores it and continues from the recorded frame.
        Per-frame PRNG keys are index-derived so resumed runs are bit-identical.
        """
        import queue as _queue
        import threading

        from datmo_using_optical_flow.utils.checkpoint import (load_checkpoint,
                                                                   save_checkpoint)
        from datmo_using_optical_flow.utils.hostpack import HostPacker

        c = self.cfg
        source = DiskFrameSource(pcd_files, capacity=c.capacities.max_raw_points,
                                 quantize_q16=h2d_q16)
        carry = self.init_carry()
        key = jax.random.PRNGKey(seed)
        rows: list[dict] = []
        have_prev = False
        start_frame = 0
        if resume and checkpoint_path:
            data = np.load(checkpoint_path)
            start_frame = int(data["step"])
            carry = load_checkpoint(checkpoint_path, carry)
            have_prev = True  # the carry includes the previous expanded cloud
            if progress:
                print(f"resumed from {checkpoint_path} at frame {start_frame}")

        # Per-frame observables mirror through the SAME two-stage background
        # pipeline as PipelineA.process_files: the enqueue
        # loop never calls jax.device_get, stage 1 drains several queued
        # frames per readback (one packed uint8 buffer each — the track-log
        # observables are ~1.3 KB/frame, plus the moving cloud + SOM only
        # when plots are requested), stage 2 builds the track-log rows and
        # writes plots.  Queues are bounded; a failed thread records its
        # exception and keeps draining so the producer never deadlocks.
        pack_fn, packer = _cached_gmfa_obs_pack(c, self.max_moving,
                                                bool(plot_dir))
        work: _queue.Queue = _queue.Queue(maxsize=32)
        ready: _queue.Queue = _queue.Queue(maxsize=4)
        exc: list[BaseException] = []

        def _mirror(i: int, obs: dict) -> None:
            if bool(obs["skip"]):
                # the step already kept the stale carry on-device (GMFA.py:477)
                if progress:
                    print(f"frame {i}: no moving ROI points, skipped")
                return
            alive = obs["alive"].astype(bool)
            tid, state = obs["tid"], obs["state"]
            for s in np.nonzero(alive)[0]:
                st = state[s]
                rows.append({"Frame": i - 1, "Track ID": int(tid[s]),
                             "X": float(st[0]), "Y": float(st[1]),
                             "VX": float(st[2]), "VY": float(st[3])})
            if progress:
                print(f"frame {i}: moving={int(obs['moving_count'])} "
                      f"clusters={int(obs['n_clusters'])} tracks={int(alive.sum())}")
            if plot_dir:
                self._save_frame_plots_host(plot_dir, i, obs)

        def _transfer():
            done = False
            while not done:
                batch = [work.get()]
                while len(batch) < 16:
                    try:
                        batch.append(work.get_nowait())
                    except _queue.Empty:
                        break
                got = len(batch)
                if batch[-1] is None:
                    done = True
                    batch.pop()
                if batch and not exc:
                    try:
                        bufs = np.asarray(HostPacker.stack([b for _, b in batch]))
                        ready.put(([i for i, _ in batch], bufs))
                    except BaseException as e:  # noqa: BLE001
                        exc.append(e)
                for _ in range(got):
                    work.task_done()
            ready.put(None)

        def _writer():
            while True:
                item = ready.get()
                if item is None:
                    ready.task_done()
                    return
                idxs, bufs = item
                if not exc:
                    try:
                        for i, buf in zip(idxs, bufs):
                            _mirror(i, packer.unpack(buf))
                    except BaseException as e:  # noqa: BLE001
                        exc.append(e)
                ready.task_done()

        threads = [threading.Thread(target=_transfer, daemon=True),
                   threading.Thread(target=_writer, daemon=True)]
        for t in threads:
            t.start()

        def _flush():
            work.join()
            ready.join()
            if exc:
                raise exc[0]

        t_start = time.perf_counter()
        try:
            for i, (pts, mask) in enumerate(source):
                if i < start_frame:
                    continue
                if exc:
                    raise exc[0]
                # index-derived keys: resume reproduces the uninterrupted stream
                kp, ks = jax.random.split(jax.random.fold_in(key, i))
                ex, exmask = self.preprocess(jnp.asarray(pts), jnp.asarray(mask), kp)
                if not have_prev:
                    carry = self.seed_carry(ex, exmask, carry)
                    have_prev = True
                    if checkpoint_every and checkpoint_path \
                            and (i + 1) % checkpoint_every == 0:
                        _flush()  # snapshots never run ahead of queued artifacts
                        save_checkpoint(checkpoint_path, carry, step=i + 1)
                    continue
                carry, out = self.step(ex, exmask, carry, ks)
                work.put((i, pack_fn(out, carry.table, carry.som)))
                if checkpoint_every and checkpoint_path \
                        and (i + 1) % checkpoint_every == 0:
                    _flush()
                    save_checkpoint(checkpoint_path, carry, step=i + 1)
        finally:
            work.put(None)
            for t in threads:
                t.join()
        if exc:
            raise exc[0]
        elapsed = time.perf_counter() - t_start
        if output_xlsx:
            save_tracks_to_excel(rows, output_xlsx)
        return {"rows": rows, "som": np.asarray(carry.som), "carry": carry,
                "elapsed": elapsed}

    def scan_steps(self, points: jnp.ndarray, masks: jnp.ndarray,
                   carry: GmfaCarry, seed: int = 0
                   ) -> tuple[GmfaCarry, GmfaOutputs]:
        """Process a whole clip of preprocessed (expanded) clouds with O(1)
        carried state (SURVEY.md §5.7's temporal axis, for pipeline B):
        ``lax.scan`` of the full 11-stage GMFA step over the (T, P, 3) stack in
        ONE device program.  Frame 0 primes the previous cloud (as
        ``process_files`` does); returns the final carry and T-1 stacked
        per-frame outputs.  Per-frame keys are index-derived from ``seed``
        exactly like ``process_files``, so the two forms agree bit-for-bit on
        track ids too (parity pinned by tests/test_gmfa_pipeline.py).
        """
        carry = self.seed_carry(points[0], masks[0], carry)
        base = jax.random.PRNGKey(seed)
        keys = jax.vmap(
            lambda i: jax.random.split(jax.random.fold_in(base, i))[1]
        )(jnp.arange(1, points.shape[0]))
        run = _cached_gmfa_scan(self.cfg, self.max_moving)
        return run(carry, points[1:], masks[1:], keys)

    @staticmethod
    def _maybe_checkpoint(carry: GmfaCarry, frame: int, every: int,
                          path: str | None, save_fn) -> None:
        if every and path and (frame + 1) % every == 0:
            save_fn(path, carry, step=frame + 1)

    @staticmethod
    def _save_frame_plots_host(plot_dir: str, frame: int, obs: dict) -> None:
        """The per-frame plots of GMFA.py:525-527 (SOM heat map, moving-vs-static,
        positions+velocities, final moving-object detection), saved non-blocking
        from the packed host observables (no device access)."""
        import os

        from datmo_using_optical_flow.io import viz

        os.makedirs(plot_dir, exist_ok=True)
        n_mov = int(obs["moving_count"])
        pts = np.asarray(obs["moving_points"])[:n_mov]
        cls = np.full(n_mov, 2)
        alive = obs["alive"].astype(bool)
        states = [obs["state"][s] for s in np.nonzero(alive)[0]]
        viz.plot_som_heat_map(np.asarray(obs["som"]),
                              save_path=os.path.join(plot_dir, f"som_frame_{frame}.png"))
        viz.plot_moving_vs_static(pts, cls, states,
                                  save_path=os.path.join(plot_dir,
                                                         f"moving_static_frame_{frame}.png"))
        viz.visualize_positions_and_velocities(
            pts, cls, states,
            save_path=os.path.join(plot_dir, f"positions_frame_{frame}.png"))
        viz.visualize_final_positions_and_velocities(
            pts, states, title=f"Frame {frame}: Moving Object Detection",
            save_path=os.path.join(plot_dir, f"final_positions_frame_{frame}.png"))


def save_tracks_to_excel(rows: list[dict], output_file: str = "track_data.xlsx") -> None:
    """``save_tracks_to_excel`` (``GMFA.py:419-422``); a CSV with the same
    columns when pandas or openpyxl is not installed."""
    columns = ["Frame", "Track ID", "X", "Y", "VX", "VY"]
    alt = output_file.rsplit(".", 1)[0] + ".csv"
    try:
        import pandas as pd
    except ImportError:
        import csv

        with open(alt, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(columns)
            writer.writerows([r[c] for c in columns] for r in rows)
        print(f"pandas unavailable; track data saved to {alt}")
        return
    df = pd.DataFrame(rows, columns=columns)
    try:
        df.to_excel(output_file, index=False)
    except (ImportError, ModuleNotFoundError):
        df.to_csv(alt, index=False)
        print(f"openpyxl unavailable; track data saved to {alt}")
        return
    print(f"Track data saved to {output_file}")


# ------------------------------------------------------------------ jitted impls

import functools


@functools.lru_cache(maxsize=32)
def _cached_gmfa_preprocess(cfg: GMFAConfig):
    return jax.jit(partial(_gmfa_preprocess_impl, cfg=cfg))


@functools.cache
def _seed_order_jit():
    from datmo_using_optical_flow.ops.nn import sort_order
    return jax.jit(sort_order)


@functools.lru_cache(maxsize=32)
def _cached_gmfa_scan(cfg: GMFAConfig, max_moving: int):
    # the whole-clip lax.scan compiles once per (cfg, max_moving); a fresh
    # closure per scan_steps call would recompile the multi-second scan
    # program on every clip (jax.jit caches by function identity)
    def run(c, pts, mks, ks):
        def body(cc, xs):
            p, m, k = xs
            return _gmfa_step_impl(p, m, cc, k, cfg=cfg, max_moving=max_moving)

        return jax.lax.scan(body, c, (pts, mks, ks))

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def _cached_gmfa_obs_pack(cfg: GMFAConfig, max_moving: int, plots: bool):
    """Jitted (GmfaOutputs, TrackTableB, som) -> one flat uint8 buffer of the
    track-log observables (skip flag, alive/tid/state, counts — ~1.3 KB at the
    64-track capacity), plus the moving cloud + SOM when per-frame plots are
    requested.  The matching :class:`~utils.hostpack.HostPacker` unpacks the
    single transferred vector host-side (the per-frame ``jax.device_get`` this
    replaces paid one transfer per leaf)."""
    from datmo_using_optical_flow.utils.hostpack import HostPacker

    t = cfg.capacities.max_tracks
    g = cfg.som.grid_size

    def shrink(out: GmfaOutputs, table: TrackTableB, som: jnp.ndarray) -> dict:
        obs = {"skip": out.skip, "alive": table.alive, "tid": table.tid,
               "state": table.state, "moving_count": out.moving_count,
               "n_clusters": out.n_clusters}
        if plots:
            obs["moving_points"] = out.moving_points
            obs["som"] = som
        return obs

    example = jax.eval_shape(
        shrink,
        GmfaOutputs(
            skip=jax.ShapeDtypeStruct((), jnp.bool_),
            classifications=jax.ShapeDtypeStruct((1,), jnp.int32),
            residuals=jax.ShapeDtypeStruct((1,), jnp.float32),
            moving_points=jax.ShapeDtypeStruct((max_moving, 3), jnp.float32),
            moving_count=jax.ShapeDtypeStruct((), jnp.int32),
            labels=jax.ShapeDtypeStruct((max_moving,), jnp.int32),
            n_clusters=jax.ShapeDtypeStruct((), jnp.int32),
            transformation=jax.ShapeDtypeStruct((4, 4), jnp.float32),
            fitness=jax.ShapeDtypeStruct((), jnp.float32)),
        TrackTableB(
            state=jax.ShapeDtypeStruct((t, 4), jnp.float32),
            cov=jax.ShapeDtypeStruct((t, 4, 4), jnp.float32),
            features=jax.ShapeDtypeStruct((t, 4), jnp.float32),
            tid=jax.ShapeDtypeStruct((t,), jnp.int32),
            age=jax.ShapeDtypeStruct((t,), jnp.int32),
            alive=jax.ShapeDtypeStruct((t,), jnp.bool_)),
        jax.ShapeDtypeStruct((g, g), jnp.float32))
    packer = HostPacker(example)
    pack_fn = jax.jit(lambda out, table, som: packer.pack_impl(
        shrink(out, table, som)))
    return pack_fn, packer


@functools.lru_cache(maxsize=32)
def _cached_gmfa_step(cfg: GMFAConfig, max_moving: int, donate: bool = False):
    # donate=True reuses the carry's buffers in place (see _cached_step in
    # optical_flow_datmo.py for the measured trade-off on this backend); safe
    # because skip semantics are applied on-device so callers always adopt the
    # returned carry
    return jax.jit(partial(_gmfa_step_impl, cfg=cfg, max_moving=max_moving),
                   donate_argnums=(2,) if donate else ())


def _gmfa_preprocess_impl(points, mask, key, cfg: GMFAConfig):
    c = cfg
    if points.dtype == jnp.int16:
        # q16 fixed-point H2D payload (io.frames.Q16_SCALE) — exact dequant
        from datmo_using_optical_flow.io.frames import dequantize_points_q16
        points = dequantize_points_q16(points)
    kr, kd = jax.random.split(key)
    p = point_ops.flip_x(points)
    _, non_ground = remove_ground(p, mask, kr, c.ransac.distance_threshold,
                                  c.ransac.ransac_n, c.ransac.num_iterations)
    roi = non_ground & point_ops.roi_mask(p, c.roi_bounds)
    cpts, cmask, _ = compact_masked(p, roi, c.capacities.max_roi_points)
    return point_ops.densify(cpts, cmask, kd, c.capacities.expansion_factor,
                             c.noise_std)


def _cluster_features(points: jnp.ndarray, labels: jnp.ndarray, k: int):
    """[cx, cy, lmax, lmin] per cluster from the 3-D point covariance (ddof=1),
    replicating ``calculate_feature_vector`` (GMFA.py:164-169)."""
    valid = labels >= 0
    lab = jnp.where(valid, labels, k)
    seg = partial(jax.ops.segment_sum, num_segments=k + 1)
    ones = valid.astype(jnp.float32)
    cnt = seg(ones, lab)[:k]
    safe = jnp.maximum(cnt, 1.0)
    sums = seg(jnp.where(valid[:, None], points, 0.0), lab)[:k]
    mean = sums / safe[:, None]
    dev = jnp.where(valid[:, None], points - mean[jnp.clip(lab, 0, k - 1)], 0.0)
    # 3x3 covariance per cluster
    outer = dev[:, :, None] * dev[:, None, :]
    cov = seg(outer.reshape(-1, 9), lab)[:k].reshape(k, 3, 3)
    denom = jnp.maximum(cnt - 1.0, 1.0)[:, None, None]
    cov = cov / denom
    eig = jnp.linalg.eigvalsh(cov)  # ascending
    feats = jnp.stack([mean[:, 0], mean[:, 1], eig[:, 2], eig[:, 0]], axis=1)
    exists = cnt > 0
    return feats, mean[:, :2], exists, cnt


def _gmfa_step_impl(points, mask, carry: GmfaCarry, key, cfg: GMFAConfig,
                    max_moving: int, diag_stop: str | None = None):
    """``diag_stop`` (static; benchmarks/diag_gmfa_step.py only) truncates the
    program after the named stage and returns that stage's live values —
    cumulative-prefix timing locates where in-program composition costs
    appear (the r2 DCE-proof ablation methodology, applied to pipeline B)."""
    c = cfg
    n_cur = jnp.sum(mask.astype(jnp.int32))
    n_prev = jnp.sum(carry.prev_mask.astype(jnp.int32))

    # One spatial (Morton) sort of the NEW cloud per frame, shared by: the
    # ICP target index (this frame), the classification sweep's source order
    # (this frame), and — carried — the ICP source order and classification
    # target order of the NEXT frame.  Rigid motion preserves coherence, so
    # the carried order stays pruning-tight for the transformed cloud.
    from datmo_using_optical_flow.ops import icp as icp_mod
    from datmo_using_optical_flow.ops import nn_pallas
    from datmo_using_optical_flow.ops.nn import sort_order
    share = nn_pallas.eligible(points.shape[0])
    cur_order = sort_order(points, mask) if share else None
    icp_share = share and points.shape[0] >= icp_mod._CACHED_MIN
    cur_index = (nn_pallas.build_target_index(points, mask, order=cur_order)
                 if icp_share else None)
    if diag_stop == "orders":
        return (cur_order, points)

    # 1. ICP ego-motion: previous -> current (GMFA.py:465)
    icp = registration_icp(carry.prev_points, carry.prev_mask, points, mask,
                           c.icp.threshold, c.icp.max_iterations,
                           c.icp.relative_fitness, c.icp.relative_rmse,
                           tgt_index=cur_index,
                           src_order=carry.prev_order if icp_share else None)
    prev_t = transform_points(carry.prev_points, icp.transformation)
    if diag_stop == "icp":
        return (icp.transformation, icp.fitness, icp.sweep_stats)

    # 2. residuals: index-wise when sizes match, NN-aligned otherwise (GMFA.py:79-91).
    # Capped sweep: every residual consumer thresholds at static/moving
    # (classification here, SOM increments in ops/som.py), so the NN search
    # stops certifying beyond 2x moving_threshold — points provably farther
    # keep label 2 (moving) with residual := the cap (or the capped
    # candidate's true distance, whichever the sweep found); all decisions
    # are identical to the exact sweep, at a fraction of the tile visits.
    cls_cap = 2.0 * jnp.float32(c.moving_threshold)
    idx, d2s, _ = nearest_neighbors_with_bound(
        points, prev_t, carry.prev_mask, cap2=cls_cap * cls_cap,
        tgt_order=carry.prev_order if share else None, src_order=cur_order)
    aligned = prev_t[idx]
    same_size = n_cur == n_prev
    ref_pts = jnp.where(same_size, prev_t, aligned)
    residuals = jnp.linalg.norm(points - ref_pts, axis=1)
    # rows the capped sweep returned no candidate for are certified farther
    # than the cap; index 0 would otherwise alias an arbitrary point
    residuals = jnp.where(same_size | jnp.isfinite(d2s), residuals, cls_cap)
    residuals = jnp.where(mask, residuals, 0.0)

    # 3. classification 3/2/1 (GMFA.py:127-130); 0 marks padding
    cls = jnp.where(residuals < c.static_threshold, 3,
                    jnp.where(residuals > c.moving_threshold, 2, 1))
    cls = jnp.where(mask, cls, 0).astype(jnp.int32)
    if diag_stop == "cls":
        return (residuals, cls)

    # 4. moving-point ROI (GMFA.py:472-473) + compaction
    moving = (cls == 2) & point_ops.roi_mask_2d(points, c.moving_roi_bounds)
    mpts, mmask, mcount = compact_masked(points, moving, max_moving)
    skip = mcount == 0
    if diag_stop == "compact":
        return (mpts, mcount)

    # 5. DBSCAN on raw 3-D moving points (GMFA.py:480: min_samples hard-coded in
    # the reference; here from config whose default replicates it)
    labels, _ = dbscan(mpts, mmask, c.dbscan.eps, c.dbscan.min_samples)
    kmax = c.capacities.max_clusters
    feats, centroids2d, exists, _counts = _cluster_features(mpts, labels, kmax)
    n_clusters = jnp.sum(exists.astype(jnp.int32))
    if diag_stop == "dbscan":
        return (labels, feats, n_clusters)

    # 6. Hungarian association on feature distances (GMFA.py:182-213)
    tb = carry.table
    diff = tb.features[:, None, :] - feats[None, :, :]
    cost = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 0.0))
    col4row, pair_ok = linear_sum_assignment(cost, row_mask=tb.alive, col_mask=exists)
    assigned = pair_ok & (cost[jnp.arange(cost.shape[0]),
                               jnp.clip(col4row, 0, kmax - 1)] < c.cost_threshold)
    if diag_stop == "hungarian":
        return (col4row, assigned)

    # 7. update matched tracks; drop unmatched (GMFA.py:216-232, :487)
    ci = jnp.clip(col4row, 0, kmax - 1)
    new_pos = centroids2d[ci]
    vel = (new_pos - tb.state[:, :2]) / c.dt
    upd_state = jnp.concatenate([new_pos, vel], axis=1)
    state = jnp.where(assigned[:, None], upd_state, tb.state)
    features = jnp.where(assigned[:, None], feats[ci], tb.features)
    age = jnp.where(assigned, tb.age + 1, tb.age)
    alive = assigned  # only matched survive

    # 8. births from unassigned clusters (GMFA.py:235-258)
    claimed = jnp.zeros((kmax + 1,), bool).at[
        jnp.where(assigned, ci, kmax)].set(True, mode="drop")[:kmax]
    unassigned = exists & ~claimed
    free = ~alive
    # slot for the j-th unassigned cluster = j-th free slot
    birth_rank = jnp.cumsum(unassigned.astype(jnp.int32)) - 1      # per cluster
    free_idx = jnp.cumsum(free.astype(jnp.int32)) - 1              # per slot
    cap = alive.shape[0]
    slot_of_rank = jnp.full((kmax + 1,), cap, jnp.int32)
    slot_of_rank = slot_of_rank.at[jnp.where(free, free_idx, kmax)].set(
        jnp.arange(cap, dtype=jnp.int32), mode="drop")
    target_slot = jnp.where(unassigned, slot_of_rank[jnp.clip(birth_rank, 0, kmax)], cap)

    prev_pos_known = carry.prev_exists
    birth_vel = jnp.where(prev_pos_known[:, None],
                          (centroids2d - carry.prev_centroids) / c.dt, 0.0)
    birth_state = jnp.concatenate([centroids2d, birth_vel], axis=1)
    tids_new = jax.random.randint(key, (kmax,), 0, 100000).astype(jnp.int32)

    state = state.at[target_slot].set(birth_state, mode="drop")
    features = features.at[target_slot].set(feats, mode="drop")
    cov = tb.cov.at[target_slot].set(
        jnp.broadcast_to(jnp.eye(4) * c.initial_covariance, (kmax, 4, 4)), mode="drop")
    tid = tb.tid.at[target_slot].set(tids_new, mode="drop")
    age = age.at[target_slot].set(1, mode="drop")
    born = jnp.zeros((cap,), bool).at[target_slot].set(unassigned, mode="drop")
    alive = alive | born
    if diag_stop == "births":
        return (state, alive, tid)

    # 9. SOM update with the reference's misaligned (moving point k, residual k)
    if residuals.shape[0] >= max_moving:
        som_res = residuals[:max_moving]
    else:
        som_res = jnp.pad(residuals, (0, max_moving - residuals.shape[0]))
    som = update_som(carry.som, mpts, mmask & (jnp.arange(max_moving) < n_cur),
                     som_res, c.static_threshold, c.moving_threshold,
                     c.som.cell_resolution, c.som.static_increment,
                     c.som.moving_decrement, c.som.max_value, c.som.min_value)
    if diag_stop == "som":
        return (som,)

    # 10. KF predict+update per live track against its own feature (GMFA.py:494-497)
    f_mat = jnp.array([[1, 0, c.dt, 0], [0, 1, 0, c.dt],
                       [0, 0, 1, 0], [0, 0, 0, 1]], jnp.float32)
    q = jnp.diag(jnp.asarray(c.kf_process_noise, jnp.float32))
    h = jnp.array([[1, 0, 0, 0], [0, 1, 0, 0]], jnp.float32)
    r = jnp.eye(2, dtype=jnp.float32) * c.kf_measurement_noise

    def kf(state_i, cov_i, feat_i):
        x = state_i[:, None]
        xp = matmul(f_mat, x)
        pp = matmul(matmul(f_mat, cov_i), f_mat.T) + q
        z = feat_i[:2][:, None]
        y = z - matmul(h, xp)
        s = matmul(matmul(h, pp), h.T) + r
        kk = matmul(matmul(pp, h.T), jnp.linalg.inv(s))
        xu = xp + matmul(kk, y)
        pu = matmul(jnp.eye(4) - matmul(kk, h), pp)
        return xu[:, 0], pu

    kf_state, kf_cov = jax.vmap(kf)(state, cov, features)
    if diag_stop == "kf":
        return (kf_state, kf_cov)
    state = jnp.where(alive[:, None], kf_state, state)
    cov = jnp.where(alive[:, None, None], kf_cov, cov)

    table = TrackTableB(state=state, cov=cov, features=features, tid=tid,
                        age=age.astype(jnp.int32), alive=alive)

    # 11. previous_positions refresh only when tracks exist (indentation quirk)
    any_tracks = jnp.any(alive)
    prev_centroids = jnp.where(any_tracks, centroids2d, carry.prev_centroids)
    prev_exists = jnp.where(any_tracks, exists, carry.prev_exists)

    # skip semantics on-device (GMFA.py:475-477's ``continue``): a frame with no
    # moving ROI points leaves the WHOLE carry untouched — including the stale
    # previous cloud — so the host runner can always adopt the returned carry
    # (which in turn makes carry donation safe).
    advanced = GmfaCarry(prev_points=points, prev_mask=mask, table=table, som=som,
                         prev_centroids=prev_centroids, prev_exists=prev_exists,
                         prev_order=(cur_order if cur_order is not None
                                     else carry.prev_order))
    new_carry = jax.tree.map(lambda new, old: jnp.where(skip, old, new),
                             advanced, carry)
    outputs = GmfaOutputs(skip=skip, classifications=cls, residuals=residuals,
                          moving_points=mpts, moving_count=mcount, labels=labels,
                          n_clusters=n_clusters, transformation=icp.transformation,
                          fitness=icp.fitness)
    return new_carry, outputs
