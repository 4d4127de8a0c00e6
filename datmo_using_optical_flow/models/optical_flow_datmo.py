"""Pipeline A: BEV + Farnebäck-flow DATMO, end-to-end on the device.

The device re-composition of ``Optical_flow/main.py:process_multiple_frames``
(:541-641): PCD points stream in as fixed-capacity padded buffers; everything from
preprocessing to the track table advances inside TWO jitted programs
(:func:`PipelineA.preprocess` per frame, :func:`PipelineA.step` per frame pair),
so the frame→tracks path never leaves the device; artifacts are mirrored to host
asynchronously by the runner.

Defects fixed relative to the reference (SURVEY.md §2.4) while keeping healthy-path
parity:

* first-frame acceleration crash (``main.py:588-589``) — acceleration is computed
  only when a previous velocity grid exists;
* each PCD is preprocessed once per appearance instead of twice per pair
  (``main.py:568-569``) — outputs differ only through the (explicitly keyed)
  densifier noise, which the reference leaves unseeded;
* config is authoritative (RANSAC/Farnebäck blocks honored, see config.py).
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from datmo_using_optical_flow.config import PipelineAConfig
from datmo_using_optical_flow.io.artifacts import ArtifactSink
from datmo_using_optical_flow.io.frames import DiskFrameSource
from datmo_using_optical_flow.models import tracker_a
from datmo_using_optical_flow.ops import bev as bev_ops
from datmo_using_optical_flow.ops import masks as mask_ops
from datmo_using_optical_flow.ops import points as point_ops
from datmo_using_optical_flow.ops.dbscan import dbscan_velocity_grid
from datmo_using_optical_flow.ops.farneback import _farneback_impl
from datmo_using_optical_flow.ops.ransac import remove_ground
from datmo_using_optical_flow.utils.padding import compact_masked


class StepOutputs(NamedTuple):
    """Per-frame-pair observables mirrored to host for artifacts/metrics."""

    skip: jnp.ndarray           # bool: invalid BEV pair -> masked no-op (main.py:572-574)
    velocity_x: jnp.ndarray     # filtered vx grid (saved at main.py:610)
    velocity_y: jnp.ndarray
    magnitude: jnp.ndarray
    angular: jnp.ndarray        # curl of the filtered grids (main.py:604-606)
    raw_velocity_x: jnp.ndarray  # pre-mask grids (saved at main.py:580)
    raw_velocity_y: jnp.ndarray
    labels: jnp.ndarray         # compacted DBSCAN labels
    rows: jnp.ndarray
    cols: jnp.ndarray
    cell_count: jnp.ndarray
    cell_overflow: jnp.ndarray  # bool: valid cells hit max_cells (coverage truncated)
    snapshot: tracker_a.TrackTable  # post-association table (artifact at main.py:619)


class StepCarry(NamedTuple):
    prev_vx: jnp.ndarray
    prev_vy: jnp.ndarray
    has_prev: jnp.ndarray  # bool scalar
    table: tracker_a.TrackTable


class StreamCarry(NamedTuple):
    """Carry for the stream-mode step: pair state plus the previous frame's
    Farnebäck coefficient pyramid, so each frame's polynomial expansion runs
    ONCE instead of twice (the reference preprocesses every PCD twice per
    pair, ``Optical_flow/main.py:568-569``)."""

    step: StepCarry
    pyr: tuple                   # per-level (5, lh, lw) planes of prev frame
    frame_valid: jnp.ndarray     # bool: previous frame had nonzero BEV
    has_frame: jnp.ndarray       # bool: any previous frame seen


class PipelineA:
    """Streaming runner for the optical-flow DATMO pipeline."""

    def __init__(self, cfg: PipelineAConfig | None = None, fast_warp: bool = True,
                 donate: bool = False):
        self.cfg = (cfg or PipelineAConfig()).validate()
        self.fast_warp = fast_warp
        self.donate = donate
        # jitted programs are cached per (cfg, flags): two pipelines with equal
        # configs share compilations (configs are frozen/hashable dataclasses)
        self._preprocess = _cached_preprocess(self.cfg)
        self._step = _cached_step(self.cfg, fast_warp, donate)
        self._stream_step = _cached_stream_step(self.cfg, fast_warp, donate)

    # -------------------------------------------------------------- device fns

    def preprocess(self, points: jnp.ndarray, mask: jnp.ndarray, key: jax.Array):
        """points+mask -> uint8 BEV grid (reference ``preprocess_pcd``, main.py:59-95)."""
        return self._preprocess(points, mask, key)

    def init_carry(self) -> StepCarry:
        h, w = self.cfg.grid_shape
        return StepCarry(
            prev_vx=jnp.zeros((h, w), jnp.float32),
            prev_vy=jnp.zeros((h, w), jnp.float32),
            has_prev=jnp.asarray(False),
            table=tracker_a.new_track_table(self.cfg.capacities.max_tracks),
        )

    def step(self, bev1: jnp.ndarray, bev2: jnp.ndarray, carry: StepCarry
             ) -> tuple[StepCarry, StepOutputs]:
        """One frame-pair DATMO step (main.py:565-634 healthy path).

        With ``donate=True`` the carry is donated to the device program —
        treat it as consumed and use the returned carry.
        """
        return self._step(bev1, bev2, carry)

    def init_stream_carry(self) -> StreamCarry:
        from datmo_using_optical_flow.oracle.np_farneback import level_sizes

        fb = self.cfg.farneback
        h, w = self.cfg.grid_shape
        pyr = tuple(jnp.zeros((5, lh, lw), jnp.float32)
                    for _, _, lh, lw in level_sizes(h, w, fb.pyr_scale, fb.levels))
        return StreamCarry(step=self.init_carry(), pyr=pyr,
                           frame_valid=jnp.asarray(False),
                           has_frame=jnp.asarray(False))

    def step_stream(self, bev: jnp.ndarray, carry: StreamCarry
                    ) -> tuple[StreamCarry, StepOutputs]:
        """Stream-mode step: feed ONE new frame; the previous frame's
        coefficient pyramid rides in the carry (each frame expanded once
        instead of twice).  The first call primes the pyramid and reports
        ``skip=True``.  Matches :meth:`step` over consecutive frames (up to
        XLA-fusion float roundoff between the two programs).
        """
        return self._stream_step(bev, carry)

    # above this grid size, scan_steps dispatches per frame instead of using
    # lax.scan: the bound caps the scan program's compile time, and grids
    # past 1080p (4K: benchmarks/diag_4k.py) stream per frame.
    SCAN_MAX_CELLS = 1088 * 1920

    def scan_steps(self, bevs: jnp.ndarray, carry: StepCarry
                   ) -> tuple[StepCarry, StepOutputs]:
        """Process a whole clip with O(1) carried state (SURVEY.md §5.7's
        temporal scaling axis): ``lax.scan`` over the (T, H, W) BEV stack in
        ONE device program at moderate grid sizes, or per-frame async dispatch
        of the same stream step above ``SCAN_MAX_CELLS`` (measured trade-off
        on the class attribute).  Same semantics either way: returns the final
        carry and T-1 stacked per-pair outputs.
        """
        cfg, fast_warp = self.cfg, self.fast_warp
        h, w = cfg.grid_shape
        sc = StreamCarry(step=carry, pyr=self.init_stream_carry().pyr,
                         frame_valid=jnp.asarray(False),
                         has_frame=jnp.asarray(False))

        if h * w > self.SCAN_MAX_CELLS:
            # large grids: per-frame dispatch (async, keeps the device busy),
            # then stack the per-pair outputs on device
            sc, _ = self.step_stream(bevs[0], sc)
            outs = []
            for i in range(1, bevs.shape[0]):
                sc, out = self.step_stream(bevs[i], sc)
                outs.append(out)
            stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
            return sc.step, stacked

        @jax.jit
        def run(stack, sc0):
            def body(c, bev):
                return _stream_step_impl(bev, c, cfg=cfg, fast_warp=fast_warp)

            # prime the pyramid with frame 0, then scan the remaining frames
            # (each frame's polynomial expansion runs once, not twice)
            sc0, _ = body(sc0, stack[0])
            final, outs = jax.lax.scan(body, sc0, stack[1:])
            return final.step, outs

        return run(bevs, sc)

    # -------------------------------------------------------------- host runner

    def process_files(self, pcd_files: Sequence[str], output_dir: str | None = None,
                      save_png: bool = False, seed: int = 0, progress: bool = False,
                      checkpoint_every: int = 0, checkpoint_path: str | None = None,
                      resume: bool = False, h2d_q16: bool = False) -> dict:
        """Run the full pipeline over a PCD sequence, writing parity artifacts.

        ``h2d_q16``: ship raw points host->device as int16 fixed point
        (2^-10 m/LSB — half the H2D bytes; +-0.5 mm host-side rounding, far
        below sensor noise) for link-bound deployments.

        Equivalent of ``process_multiple_frames(pcd_files, config)`` (main.py:541).
        Returns a summary dict with final tracks and per-stage timings.

        Checkpoint/resume (SURVEY.md §5.4 — absent in the reference): with
        ``checkpoint_every=K`` the carried pipeline state (track table, lifetimes,
        previous velocity grids — the reference's entire mutable state,
        main.py:552-559) snapshots to ``checkpoint_path`` (.npz) every K frames;
        ``resume=True`` restores it and continues from the recorded frame.
        """
        from datmo_using_optical_flow.utils.checkpoint import (load_checkpoint,
                                                                   save_checkpoint)

        c = self.cfg
        sink = ArtifactSink(output_dir or c.output_folder, save_png=save_png)
        source = DiskFrameSource(pcd_files, capacity=c.capacities.max_raw_points,
                                 quantize_q16=h2d_q16)
        carry = self.init_stream_carry()
        key = jax.random.PRNGKey(seed)

        start_frame = 0
        if resume and checkpoint_path:
            data = np.load(checkpoint_path)
            start_frame = int(data["step"])
            # the carry includes the previous frame's pyramid, so the resumed
            # stream continues bit-identically with no re-derivation
            carry = load_checkpoint(checkpoint_path, carry)
            if progress:
                print(f"resumed from {checkpoint_path} at frame {start_frame}")

        # Artifact mirroring runs on a two-stage background pipeline so the
        # enqueue loop never stalls on host I/O and transfers overlap file
        # writes.  Each frame's observables shrink on device to the minimal
        # artifact set (uint8 BEV, the two filtered f32 velocity grids, int16
        # cluster labels/indices, the track snapshot — magnitude/angular/valid
        # cells are recomputed host-side from the transferred grids with the
        # oracle's own numpy ops) and pack into ONE flat uint8 buffer
        # (utils/hostpack.py).  Stage 1 drains several queued frames per
        # readback (latency amortized across the batch); stage 2 unpacks and
        # writes files.  Queues are bounded so a slow disk applies
        # backpressure instead of accumulating device buffers.
        import queue as _queue
        import threading

        from datmo_using_optical_flow.utils.hostpack import HostPacker

        timings = {"preprocess": 0.0, "step": 0.0, "artifacts": 0.0,
                   "artifacts_transfer": 0.0}
        state = {"pairs": 0}
        work: _queue.Queue = _queue.Queue(maxsize=32)    # device bufs
        ready: _queue.Queue = _queue.Queue(maxsize=4)    # host batches
        pack_fn, packer = _cached_obs_pack(self.cfg)

        def _mirror(i: int, obs: dict) -> None:
            sink.save_bev(obs["bev"], i)
            if not bool(obs["skip"]):
                # a skipped pair (first frame / invalid BEV) writes no pair
                # artifacts, like the reference (main.py:572-574)
                self._write_pair_artifacts_host(sink, obs, i - 1)
                state["pairs"] += 1
                if progress:
                    snap = obs["snapshot"]
                    print(f"pair {i - 1}: cells={int(obs['count'])} "
                          f"tracks={int(np.asarray(snap.alive).sum())}")
                if bool(obs["overflow"]):
                    print(f"pair {i - 1}: WARNING valid cells exceed "
                          f"max_cells={self.cfg.capacities.max_cells}; "
                          f"clustering truncated")

        # a failed pipeline thread must fail the RUN, not deadlock it: each
        # thread records its first exception here and keeps DRAINING its input
        # queue (so producers never block on a dead consumer); the main loop
        # re-raises at the next enqueue / at the end
        exc: list[BaseException] = []

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
                        t0 = time.perf_counter()
                        # one D2H transfer for the whole drained batch
                        bufs = np.asarray(HostPacker.stack([b for _, b in batch]))
                        timings["artifacts_transfer"] += time.perf_counter() - t0
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
                        t0 = time.perf_counter()
                        for i, buf in zip(idxs, bufs):
                            _mirror(i, packer.unpack(buf))
                        timings["artifacts"] += time.perf_counter() - t0
                    except BaseException as e:  # noqa: BLE001
                        exc.append(e)
                ready.task_done()

        threads = [threading.Thread(target=_transfer, daemon=True),
                   threading.Thread(target=_writer, daemon=True)]
        for t in threads:
            t.start()
        try:
            for i, (pts, mask) in enumerate(source):
                if i < start_frame:
                    continue
                if exc:
                    raise exc[0]
                # per-frame key derivation is index-based so resume is
                # bit-reproducible
                k = jax.random.fold_in(key, i)
                try:
                    t0 = time.perf_counter()
                    bev = self.preprocess(jnp.asarray(pts), jnp.asarray(mask), k)
                    timings["preprocess"] += time.perf_counter() - t0
                except Exception as e:  # noqa: BLE001
                    # a bad frame must not kill the stream (the reference's
                    # blanket per-pair except, main.py:635-637)
                    print(f"Error processing frame {i}: {e}")
                    continue

                t0 = time.perf_counter()
                carry, out = self.step_stream(bev, carry)
                timings["step"] += time.perf_counter() - t0

                work.put((i, pack_fn(bev, out)))
                if (i and checkpoint_every and checkpoint_path
                        and (i + 1) % checkpoint_every == 0):
                    # flush the artifact pipeline first: a snapshot must never
                    # run ahead of its frames' artifacts (a crash in between
                    # would otherwise resume past frames whose files were
                    # still queued and never write them)
                    work.join()
                    ready.join()
                    if exc:
                        raise exc[0]
                    save_checkpoint(checkpoint_path, carry, step=i + 1)
        finally:
            work.put(None)
            for t in threads:
                t.join()
        if exc:
            raise exc[0]

        tracks = self._tracks_dict(carry.step.table)
        sink.print_final_track_velocities(tracks)
        return {"tracks": tracks, "timings": timings, "pairs": state["pairs"]}

    @staticmethod
    def _tracks_dict(table: tracker_a.TrackTable) -> dict[int, np.ndarray]:
        alive, tid, state = jax.device_get((table.alive, table.tid, table.state))
        return {int(tid[i]): state[i] for i in np.nonzero(alive)[0]}

    def _write_pair_artifacts(self, sink: ArtifactSink, out: StepOutputs,
                              pair_index: int) -> None:
        # one batched device->host transfer instead of one per array
        host = jax.device_get(out)
        obs = {"vx": host.velocity_x, "vy": host.velocity_y,
               "magnitude": host.magnitude, "angular": host.angular,
               "labels": host.labels, "rows": host.rows, "cols": host.cols,
               "count": host.cell_count, "snapshot": host.snapshot}
        self._write_pair_artifacts_host(sink, obs, pair_index)

    @staticmethod
    def _write_pair_artifacts_host(sink: ArtifactSink, obs: dict,
                                   pair_index: int) -> None:
        vx = np.asarray(obs["vx"], dtype=np.float32)
        vy = np.asarray(obs["vy"], dtype=np.float32)
        if "magnitude" in obs:
            magnitude, angular = obs["magnitude"], obs["angular"]
        else:
            # recomputed from the transferred grids with the reference's own
            # numpy arithmetic (main.py:600-606) — identical f32 ops to the
            # device's mask_ops.gradient/sqrt, so the artifact parity is the
            # oracle's, and 2 of the 4 full-resolution grids never cross to
            # the host
            magnitude = np.sqrt(vx * vx + vy * vy)
            angular = _np_gradient(vy, 1) - _np_gradient(vx, 0)
        # reference saves raw grids (main.py:580) then overwrites with filtered
        # (main.py:610) under the same index -> net artifact is the filtered grid
        sink.save_velocity_grid(vx, vy, pair_index)
        sink.append_filtered_velocities(vx, vy, magnitude, angular, pair_index)
        n = int(obs["count"])
        labels = np.asarray(obs["labels"][:n], dtype=np.int32)
        idx = np.stack([obs["rows"][:n], obs["cols"][:n]], axis=1).astype(np.int32)
        sink.save_dbscan_results(labels, idx, pair_index)
        snap = obs["snapshot"]
        tracks = {int(snap.tid[i]): snap.state[i] for i in np.nonzero(snap.alive)[0]}
        sink.save_ekf_tracks(tracks, pair_index)
        sink.append_track_velocities(tracks, pair_index)


# ------------------------------------------------------------------ jitted impls

import functools


def _np_gradient(a: np.ndarray, axis: int) -> np.ndarray:
    """np.gradient along one axis — the same f32 arithmetic as
    :func:`ops.masks.gradient` (central differences, one-sided edges)."""
    a = np.moveaxis(a, axis, 0)
    out = np.concatenate([(a[1] - a[0])[None], (a[2:] - a[:-2]) * np.float32(0.5),
                          (a[-1] - a[-2])[None]], axis=0)
    return np.moveaxis(out, 0, axis)


@functools.lru_cache(maxsize=32)
def _cached_obs_pack(cfg: PipelineAConfig):
    """Jitted (bev, StepOutputs) -> flat uint8 buffer of the minimal artifact
    observables, plus the matching :class:`HostPacker` for host-side unpack.

    Only what the artifact sink genuinely needs crosses to the host: the uint8
    BEV, the two filtered f32 velocity grids, int16 cluster labels/indices,
    and the (tiny) track snapshot.  magnitude/angular are pure functions of
    the filtered grids and valid cells of the labels — recomputed host-side
    (``_write_pair_artifacts_host``).  ~3x fewer bytes than the full
    StepOutputs at the 200x200 production shape.
    """
    from datmo_using_optical_flow.utils.hostpack import HostPacker

    h, w = cfg.grid_shape
    idx_t = jnp.int16 if max(h, w, cfg.capacities.max_cells) < 2 ** 15 else jnp.int32

    def shrink(bev: jnp.ndarray, out: StepOutputs) -> dict:
        return {"bev": bev, "skip": out.skip,
                "vx": out.velocity_x, "vy": out.velocity_y,
                "labels": out.labels.astype(idx_t),
                "rows": out.rows.astype(idx_t), "cols": out.cols.astype(idx_t),
                "count": out.cell_count, "overflow": out.cell_overflow,
                "snapshot": out.snapshot}

    example = jax.eval_shape(
        shrink,
        jax.ShapeDtypeStruct((h, w), jnp.uint8),
        _example_outputs(cfg))
    packer = HostPacker(example)
    pack_fn = jax.jit(lambda bev, out: packer.pack_impl(shrink(bev, out)))
    return pack_fn, packer


def _example_outputs(cfg: PipelineAConfig) -> StepOutputs:
    """Shape/dtype skeleton of StepOutputs for a given config (eval_shape use)."""
    h, w = cfg.grid_shape
    cap = cfg.capacities
    grid = jax.ShapeDtypeStruct((h, w), jnp.float32)
    cells = jax.ShapeDtypeStruct((cap.max_cells,), jnp.int32)
    return StepOutputs(
        skip=jax.ShapeDtypeStruct((), jnp.bool_),
        velocity_x=grid, velocity_y=grid, magnitude=grid, angular=grid,
        raw_velocity_x=grid, raw_velocity_y=grid,
        labels=cells, rows=cells, cols=cells,
        cell_count=jax.ShapeDtypeStruct((), jnp.int32),
        cell_overflow=jax.ShapeDtypeStruct((), jnp.bool_),
        snapshot=jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
            tracker_a.new_track_table(cap.max_tracks)))


@functools.lru_cache(maxsize=32)
def _cached_preprocess(cfg: PipelineAConfig):
    return jax.jit(partial(_preprocess_impl, cfg=cfg))


@functools.lru_cache(maxsize=32)
def _cached_stream_step(cfg: PipelineAConfig, fast_warp: bool,
                        donate: bool = False):
    return jax.jit(partial(_stream_step_impl, cfg=cfg, fast_warp=fast_warp),
                   donate_argnums=(1,) if donate else ())


@functools.lru_cache(maxsize=32)
def _cached_step(cfg: PipelineAConfig, fast_warp: bool, donate: bool = False):
    # donate=True reuses the carry's buffers (two full-resolution velocity grids
    # + track table) for the new carry instead of allocating fresh ones; callers
    # must then treat the passed carry as consumed.  Default off; the option
    # matters where device memory headroom is the binding constraint.
    return jax.jit(partial(_step_impl, cfg=cfg, fast_warp=fast_warp),
                   donate_argnums=(2,) if donate else ())


def _preprocess_impl(points: jnp.ndarray, mask: jnp.ndarray, key: jax.Array,
                     cfg: PipelineAConfig) -> jnp.ndarray:
    """flip -> RANSAC ground removal -> ROI -> compact -> densify -> BEV
    (reference ``preprocess_pcd``, ``Optical_flow/main.py:59-95``).

    int16 inputs are q16 fixed-point (2^-10 m/LSB, ``io.frames.Q16_SCALE``)
    shipped at half the H2D bytes on link-bound deployments; dequantized
    exactly here on device."""
    c = cfg
    if points.dtype == jnp.int16:
        from datmo_using_optical_flow.io.frames import dequantize_points_q16
        points = dequantize_points_q16(points)
    kr, kd = jax.random.split(key)
    p = point_ops.flip_x(points)
    _, non_ground = remove_ground(p, mask, kr, c.ransac.distance_threshold,
                                  c.ransac.ransac_n, c.ransac.num_iterations)
    roi = non_ground & point_ops.roi_mask(p, c.roi_bounds)
    cpts, cmask, _ = compact_masked(p, roi, c.capacities.max_roi_points)
    ex, exmask = point_ops.densify(cpts, cmask, kd, c.capacities.expansion_factor,
                                   c.noise_std)
    return bev_ops.compute_bev_grid(ex, exmask, c.grid_shape, c.x_range, c.y_range,
                                    c.grid_resolution, c.bev_a, c.bev_b, c.z_max)


def _step_impl(bev1: jnp.ndarray, bev2: jnp.ndarray, carry: StepCarry,
               cfg: PipelineAConfig, fast_warp: bool
               ) -> tuple[StepCarry, StepOutputs]:
    fb = cfg.farneback
    from datmo_using_optical_flow.ops.farneback import OPTFLOW_FARNEBACK_GAUSSIAN

    flow = _farneback_impl(bev1.astype(jnp.float32), bev2.astype(jnp.float32),
                           fb.pyr_scale, fb.levels, fb.winsize, fb.iterations,
                           fb.poly_n, fb.poly_sigma, fast_warp,
                           gaussian=bool(fb.flags & OPTFLOW_FARNEBACK_GAUSSIAN))
    pair_valid = jnp.any(bev1 > 0) & jnp.any(bev2 > 0)
    return _datmo_tail(flow, pair_valid, carry, cfg)


def _stream_step_impl(bev: jnp.ndarray, carry: StreamCarry, cfg: PipelineAConfig,
                      fast_warp: bool) -> tuple[StreamCarry, StepOutputs]:
    """Stream-mode step: one NEW frame per call; the previous frame's
    coefficient pyramid rides in the carry, halving per-pair pyramid work.

    Equals the pair mode over consecutive frames up to XLA-fusion float
    roundoff (pinned by tests/test_pipeline_a.py::test_stream_mode_matches_pair_mode):
    the pyramid is a pure function of the BEV, so reusing it equals
    recomputing it.
    """
    from datmo_using_optical_flow.ops.farneback import (
        OPTFLOW_FARNEBACK_GAUSSIAN, build_pyramid, flow_from_pyramids)

    fb = cfg.farneback
    pyr2 = build_pyramid(bev.astype(jnp.float32), fb.pyr_scale, fb.levels,
                         fb.poly_n, fb.poly_sigma)
    flow = flow_from_pyramids(carry.pyr, pyr2, fb.pyr_scale, fb.winsize,
                              fb.iterations, fast_warp,
                              gaussian=bool(fb.flags & OPTFLOW_FARNEBACK_GAUSSIAN))
    cur_valid = jnp.any(bev > 0)
    pair_valid = carry.has_frame & carry.frame_valid & cur_valid
    new_step, outputs = _datmo_tail(flow, pair_valid, carry.step, cfg)
    new_carry = StreamCarry(step=new_step, pyr=pyr2, frame_valid=cur_valid,
                            has_frame=jnp.asarray(True))
    return new_carry, outputs


def _datmo_tail(flow: jnp.ndarray, pair_valid: jnp.ndarray, carry: StepCarry,
                cfg: PipelineAConfig) -> tuple[StepCarry, StepOutputs]:
    c = cfg
    velocity_x, velocity_y, _ = mask_ops.velocity_from_flow(flow, c.x_range, c.y_range)

    # acceleration (defect #1 fixed: only when a previous grid exists); feeds the
    # acceleration-aware propagation mask, which the reference defines but never
    # applies (main.py:596-597) — available via mask_ops for API parity
    _ax = jnp.where(carry.has_prev, (velocity_x - carry.prev_vx) / c.dt, 0.0)
    _ay = jnp.where(carry.has_prev, (velocity_y - carry.prev_vy) / c.dt, 0.0)

    cont = mask_ops.continuity_mask(velocity_x, velocity_y, c.masks.alpha_cont)
    combined = cont.astype(velocity_x.dtype)
    vx_f = velocity_x * combined
    vy_f = velocity_y * combined
    magnitude = jnp.sqrt(vx_f * vx_f + vy_f * vy_f)
    angular = mask_ops.gradient(vy_f, 1) - mask_ops.gradient(vx_f, 0)

    valid = magnitude > c.velocity_threshold
    labels, rows, cols, cmask, count = dbscan_velocity_grid(
        vx_f, vy_f, valid, c.dbscan.eps, c.dbscan.min_samples, c.grid_shape,
        c.capacities.max_cells)

    clusters = tracker_a.extract_clusters(labels, rows, cols, vx_f, vy_f,
                                          c.capacities.max_clusters)
    t = c.tracker
    snapshot = tracker_a.associate_and_update(carry.table, clusters, c.dt,
                                              t.process_noise, t.measurement_noise,
                                              t.gamma)
    table = tracker_a.lifecycle(snapshot, t.m1, t.n1, t.m2, t.n2)

    # failure handling (SURVEY.md §5.3): an invalid BEV pair (empty ROI produces
    # an all-zero grid; reference's preprocess returns None, main.py:572-574 skips
    # the pair) becomes a masked no-op — the carried state is left untouched so a
    # bad frame never kills the stream.
    skip = ~pair_valid
    advanced = StepCarry(prev_vx=velocity_x, prev_vy=velocity_y,
                         has_prev=jnp.asarray(True), table=table)
    new_carry = jax.tree.map(lambda new, old: jnp.where(skip, old, new),
                             advanced, carry)
    # no silent caps: surface when the valid-cell set was truncated to capacity
    total_valid = jnp.sum(valid.astype(jnp.int32))
    outputs = StepOutputs(skip=skip, velocity_x=vx_f, velocity_y=vy_f,
                          magnitude=magnitude, angular=angular,
                          raw_velocity_x=velocity_x, raw_velocity_y=velocity_y,
                          labels=labels, rows=rows, cols=cols, cell_count=count,
                          cell_overflow=total_valid > c.capacities.max_cells,
                          snapshot=snapshot)
    return new_carry, outputs
