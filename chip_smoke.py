"""Smoke test on one NVIDIA GPU: both DATMO pipelines through their normal
entry points at real sizes, every NN kernel compiled for the card and checked
against plain references.

    python chip_smoke.py                # one card: phases 1-6 below
    python chip_smoke.py --four-cards   # only the multi-device paths, 4 cards

One line per phase (its wall time and its numbers); the card's name and power
limit from ``nvidia-smi``; and as the LAST line, only when every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Any failed check raises, so the script exits non-zero without that line.
It fails at once when JAX's default backend is not the GPU.  Scratch files go
to ``<repo>/.smoke_out`` (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

OUT = os.path.join(REPO, ".smoke_out")


def say(phase: str, t0: float, **numbers) -> None:
    items = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{phase}] {time.perf_counter() - t0:.1f}s {items}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps: int = 5) -> float:
    """Median wall time of ``fn()`` (which must block on its result)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def block(tree):
    import jax

    return jax.block_until_ready(tree)


# ------------------------------------------------------------------ scenes

def carla_scene(seed: int = 42):
    """~56k raw points per frame: the CARLA 32-channel density of the
    reference's data (three movers, one static box, ground)."""
    from datmo_using_optical_flow.sim.synthetic import BoxTarget, SyntheticScene

    return SyntheticScene(
        ground_points=40000, ground_extent=25.0,
        static_boxes=(BoxTarget(center0=(-8.0, 6.0, 1.0), velocity=(0, 0),
                                points_per_frame=4000),),
        targets=(BoxTarget(center0=(6.0, -4.0, 0.75), velocity=(1.5, 0.8),
                           points_per_frame=4000),
                 BoxTarget(center0=(-6.0, 5.0, 0.75), velocity=(-1.0, -1.2),
                           size=(3.0, 1.6, 1.4), points_per_frame=4000),
                 BoxTarget(center0=(0.0, 10.0, 0.75), velocity=(0.5, -1.5),
                           points_per_frame=4000)),
        seed=seed)


def gmfa_config(max_roi_points: int = 10240):
    """bench_gmfa's reference load: 10240 ROI points densified x10."""
    from datmo_using_optical_flow.config import CapacityConfig, GMFAConfig

    return GMFAConfig(capacities=CapacityConfig(
        max_raw_points=65536, max_roi_points=max_roi_points, max_cells=4096,
        max_clusters=32, max_tracks=64))


def flow_config(h: int = 1080, w: int = 1920):
    """bench.py's pipeline-A configuration: the DATMO grid is the frame."""
    from datmo_using_optical_flow.config import CapacityConfig, PipelineAConfig

    return PipelineAConfig(
        x_range=(0.0, h * 0.1), y_range=(0.0, w * 0.1), grid_resolution=(0.1, 0.1),
        capacities=CapacityConfig(max_cells=4096, max_clusters=32, max_tracks=64))


# ------------------------------------------------------------------ phases

def phase_device() -> dict:
    from datmo_using_optical_flow.utils.compile_cache import enable
    from datmo_using_optical_flow.utils.device import (
        card_name_and_power_limit, require_gpu)

    t0 = time.perf_counter()
    device = require_gpu()
    card = card_name_and_power_limit()
    print(f"card: {card}", flush=True)
    cache = enable()
    say("device", t0, kind=repr(device["kind"]), count=device["count"],
        compile_cache=cache)
    return device


def _read_artifacts(out_dir: str, n_frames: int) -> dict:
    import glob

    from datmo_using_optical_flow.io.artifacts import load_tracks_yaml

    arts = {}
    for i in range(n_frames):
        arts[f"bev{i}"] = np.load(os.path.join(out_dir, f"bev_frame_{i}.npy"))
    for path in sorted(glob.glob(os.path.join(out_dir, "*_frame_*.npy"))):
        arts[os.path.basename(path)] = np.load(path)
    for path in sorted(glob.glob(os.path.join(out_dir, "ekf_tracks_frame_*.yaml"))):
        with open(path) as f:
            arts[os.path.basename(path)] = load_tracks_yaml(f.read())
    return arts


def phase_pipeline_a_points(n_frames: int = 6) -> None:
    """PipelineA.process_files on CARLA-density PCDs at the reference rig
    (200x200 BEV @ 0.2 m), against the same program on the CPU backend."""
    import jax

    from datmo_using_optical_flow.config import PipelineAConfig
    from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow.sim.synthetic import write_synthetic_sequence

    t0 = time.perf_counter()
    paths = write_synthetic_sequence(carla_scene(), os.path.join(OUT, "pcd"),
                                     n_frames)
    cfg = PipelineAConfig()
    runs = {}
    for name, dev in (("gpu", jax.devices()[0]), ("cpu", jax.devices("cpu")[0])):
        out_dir = os.path.join(OUT, f"a_{name}")
        shutil.rmtree(out_dir, ignore_errors=True)
        with jax.default_device(dev):
            summary = PipelineA(cfg).process_files(paths, output_dir=out_dir,
                                                   save_png=False)
        runs[name] = (summary, _read_artifacts(out_dir, n_frames))
    summary, gpu = runs["gpu"]
    _, cpu = runs["cpu"]
    for kind in ("bev_frame_", "velocity_x_frame_", "dbscan_labels_frame_",
                 "ekf_tracks_frame_"):
        check(any(k.startswith(kind) for k in gpu), f"no {kind} artifacts")
    check(set(gpu) == set(cpu), "GPU and CPU runs wrote different artifact sets")
    bev_diff = sum(int(np.sum(gpu[f"bev{i}"] != cpu[f"bev{i}"]))
                   for i in range(n_frames))
    vel_err = max((float(np.max(np.abs(gpu[k] - cpu[k])))
                   for k in gpu if k.startswith("velocity_")), default=0.0)
    lab_diff = sum(int(np.sum(gpu[k] != cpu[k])) if gpu[k].shape == cpu[k].shape
                   else max(gpu[k].size, cpu[k].size)
                   for k in gpu if k.startswith("dbscan_"))
    trk_err = 0.0
    for k in gpu:
        if k.startswith("ekf_tracks_"):
            check(set(gpu[k]) == set(cpu[k]), f"{k}: track ids differ")
            for tid in gpu[k]:
                trk_err = max(trk_err, float(np.max(np.abs(
                    np.asarray(gpu[k][tid]) - np.asarray(cpu[k][tid])))))
    # velocity grids and track states: 5e-3 m/s / 5e-3 m — f32 flow
    # roundoff differs between the backends' fusions and is amplified by
    # ill-conditioned 2x2 solves in static regions; 20x under the 0.1 m/s
    # DATMO threshold
    check(bev_diff == 0, f"BEV differs from the CPU backend in {bev_diff} cells")
    check(vel_err <= 5e-3, f"velocity grids differ from the CPU by {vel_err}")
    check(lab_diff == 0, f"DBSCAN labels/indices differ in {lab_diff} entries")
    check(trk_err <= 5e-3, f"track states differ from the CPU by {trk_err}")

    # run-to-run: one frame twice on the card, bit for bit
    from datmo_using_optical_flow.io.frames import DiskFrameSource

    pipe = PipelineA(cfg)
    (pts, mask), = list(DiskFrameSource(paths[:1],
                                        capacity=cfg.capacities.max_raw_points))
    key = jax.random.PRNGKey(7)

    def once():
        bev = pipe.preprocess(jax.numpy.asarray(pts), jax.numpy.asarray(mask), key)
        carry = pipe.init_stream_carry()
        carry, _ = pipe.step_stream(bev, carry)
        carry, out = pipe.step_stream(bev, carry)
        return jax.device_get((bev, out))

    a, b = once(), once()
    same = all(np.array_equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    check(same, "one frame run twice on the card gave different bits")
    say("pipeline_a_points", t0, frames=n_frames, pairs=summary["pairs"],
        tracks=len(summary["tracks"]), bev_cells_differing=bev_diff,
        velocity_max_abs_diff=vel_err, dbscan_entries_differing=lab_diff,
        track_state_max_abs_diff=trk_err, run_to_run_identical=same)


def phase_pipeline_a_1080p(n_frames: int = 12, hw=(1080, 1920)) -> None:
    """Stream mode at 1080x1920 (bench.py's configuration), and one frame
    pair's flow against the independent numpy Farneback oracle."""
    import jax
    import jax.numpy as jnp

    from bench import make_frames
    from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA
    from datmo_using_optical_flow.oracle.np_farneback import calc_flow
    from datmo_using_optical_flow.ops.farneback import farneback_flow

    t0 = time.perf_counter()
    cfg = flow_config(*hw)
    h, w = cfg.grid_shape
    frames = make_frames(n_frames, h, w)
    dev_frames = [jnp.asarray(f) for f in frames]
    pipe = PipelineA(cfg, fast_warp=True)
    carry = pipe.init_stream_carry()
    t_c = time.perf_counter()
    carry, out = block(pipe.step_stream(dev_frames[0], carry))
    carry, out = block(pipe.step_stream(dev_frames[1], carry))
    compile_s = time.perf_counter() - t_c
    times = []
    for f in dev_frames[2:]:
        t1 = time.perf_counter()
        carry, out = block(pipe.step_stream(f, carry))
        times.append((time.perf_counter() - t1) * 1e3)
    step_ms = float(np.median(times))
    check(not bool(out.skip), "1080p stream step skipped a valid pair")

    # flow vs the numpy oracle on the host, full size
    flow = np.asarray(farneback_flow(dev_frames[0].astype(jnp.float32),
                                     dev_frames[1].astype(jnp.float32),
                                     cfg.farneback, fast_warp=True))
    t_o = time.perf_counter()
    ref = calc_flow(frames[0].astype(np.float32), frames[1].astype(np.float32))
    oracle_s = time.perf_counter() - t_o
    epe = np.linalg.norm(flow - ref, axis=-1)
    check(float(epe.max()) <= 0.1, f"1080p worst-case EPE {epe.max()} > 0.1 px")
    say("pipeline_a_1080p", t0, frames=len(times), median_ms_per_frame=step_ms,
        set_up_compile_s=round(compile_s, 1), cells=int(out.cell_count),
        epe_size=f"{h}x{w}", epe_max_px=float(epe.max()),
        epe_p99_px=float(np.percentile(epe, 99)),
        oracle_s=round(oracle_s, 1))


def _reference_clouds(n_frames: int, stride: int = 1, max_roi_points: int = 10240):
    """Preprocessed (flip, RANSAC, ROI, densify x10) clouds of the CARLA
    scene: ~10^5 points each, GMFA's reference load (``stride`` thins the
    raw frames for rehearsals on the CPU)."""
    import jax
    import jax.numpy as jnp

    from datmo_using_optical_flow.io.frames import pad_points
    from datmo_using_optical_flow.models.gmfa import GMFAPipeline
    from datmo_using_optical_flow.sim.synthetic import synthetic_frame

    cfg = gmfa_config(max_roi_points)
    pipe = GMFAPipeline(cfg, max_moving_points=16384)
    scene = carla_scene()
    key = jax.random.PRNGKey(0)
    clouds = []
    for i in range(n_frames):
        raw = synthetic_frame(scene, i, dt=cfg.dt).astype(np.float32)[::stride]
        padded, mask = pad_points(raw, cfg.capacities.max_raw_points)
        clouds.append(pipe.preprocess(jnp.asarray(padded), jnp.asarray(mask),
                                      jax.random.fold_in(key, i)))
    return cfg, pipe, block(clouds)


def phase_gmfa(n_frames: int = 6, **scale) -> dict:
    """GMFAPipeline at the reference load; the NN kernel against f64
    cKDTree; the first frame's ICP against the scipy oracle."""
    import jax
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    from datmo_using_optical_flow.oracle.reference_b import icp_point_to_point
    from datmo_using_optical_flow.ops import nn_pallas
    from datmo_using_optical_flow.ops.icp import registration_icp
    from datmo_using_optical_flow.ops.nn import sort_order

    t0 = time.perf_counter()
    cfg, pipe, clouds = _reference_clouds(n_frames, **scale)
    n_pts = int(jnp.sum(clouds[0][1]))
    key = jax.random.PRNGKey(1)
    carry = pipe.seed_carry(*clouds[0])
    t_c = time.perf_counter()
    carry, out = block(pipe.step(*clouds[1], carry, key))
    compile_s = time.perf_counter() - t_c
    times = []
    for i in range(2, n_frames):
        t1 = time.perf_counter()
        carry, out = block(pipe.step(*clouds[i], carry, jax.random.fold_in(key, i)))
        times.append((time.perf_counter() - t1) * 1e3)
    step_ms = float(np.median(times))

    # the kernel against f64 cKDTree on the reference cloud
    (tgt, tmask), (src, smask) = clouds[0], clouds[1]
    tgt_h, src_h = np.asarray(tgt)[np.asarray(tmask)], np.asarray(src)[np.asarray(smask)]
    src_v = jnp.asarray(src_h)
    order = sort_order(src_v, jnp.ones(src_v.shape[0], bool))
    index = nn_pallas.build_target_index(tgt, tmask)
    idx, d2, lo, d2nd, _ = (np.asarray(x) for x in block(
        nn_pallas.nearest_neighbors_pallas(src_v[order], index)))
    inv = np.argsort(np.asarray(order))
    idx, d2, lo, d2nd = idx[inv], d2[inv], lo[inv], d2nd[inv]
    # original target numbering of the valid rows
    valid_rows = np.nonzero(np.asarray(tmask))[0]
    tree = cKDTree(tgt_h.astype(np.float64))
    dist, kidx = tree.query(src_h.astype(np.float64), k=2)
    true1, true2 = dist[:, 0] ** 2, dist[:, 1] ** 2
    ours = ((src_h.astype(np.float64) - np.asarray(tgt, np.float64)[idx]) ** 2).sum(1)
    differ = idx != valid_rows[kidx[:, 0]]
    ties = differ & (ours == true1)
    check(not np.any(differ & ~ties),
          f"{int(np.sum(differ & ~ties))} NN winners differ from f64 cKDTree")
    unsound_lo = int(np.sum(lo > true1))
    unsound_2nd = int(np.sum(d2nd > true2))
    check(unsound_lo == 0, f"{unsound_lo} rows with lower_bound > true d2")
    check(unsound_2nd == 0, f"{unsound_2nd} unsound second bounds")

    # the first frame's ICP against the scipy oracle
    icp = block(registration_icp(clouds[0][0], clouds[0][1], clouds[1][0],
                                 clouds[1][1], cfg.icp.threshold,
                                 cfg.icp.max_iterations, cfg.icp.relative_fitness,
                                 cfg.icp.relative_rmse))
    prev_h = np.asarray(clouds[0][0])[np.asarray(clouds[0][1])].astype(np.float64)
    t_oracle = icp_point_to_point(prev_h, src_h.astype(np.float64),
                                  cfg.icp.threshold, cfg.icp.max_iterations,
                                  cfg.icp.relative_fitness, cfg.icp.relative_rmse)
    t_err = float(np.max(np.abs(np.asarray(icp.transformation) - t_oracle)))
    # GMFA's 0.02 m gate leaves ICP short of convergence (fitness ~1e-3), and
    # its iterates are chaotic under f32 summation order: transforms agree
    # to ~1e-2, not to rounding
    check(t_err <= 2e-2, f"ICP transform differs from the scipy oracle by {t_err}")
    say("gmfa", t0, points=n_pts, frames=len(times), median_ms_per_frame=step_ms,
        set_up_compile_s=round(compile_s, 1), moving=int(out.moving_count),
        clusters=int(out.n_clusters), nn_rows=len(idx),
        nn_winners_differing=int(differ.sum()), nn_exact_ties=int(ties.sum()),
        unsound_lower_bounds=unsound_lo, unsound_second_bounds=unsound_2nd,
        icp_fitness=float(icp.fitness), icp_iterations=int(icp.iterations),
        icp_max_abs_diff_vs_oracle=t_err)
    return {"cfg": cfg, "clouds": clouds, "step_ms": step_ms}


def phase_kernel_vs_xla(gm: dict) -> None:
    """The NN kernel against the plain XLA sweep at the reference load: ICP
    cached (kernel + incremental shell) vs uncached (XLA sweep every
    iteration), the classification sweep, and the whole GMFA step."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from datmo_using_optical_flow.models import gmfa as gmfa_mod
    from datmo_using_optical_flow.ops import nn_pallas
    from datmo_using_optical_flow.ops.icp import registration_icp
    from datmo_using_optical_flow.ops.nn import (nearest_neighbors_scan,
                                                     nearest_neighbors_with_bound)

    t0 = time.perf_counter()
    cfg, clouds = gm["cfg"], gm["clouds"]
    (p, pm), (c, cm) = clouds[0], clouds[1]
    ic = cfg.icp

    def icp_ms(cached):
        f = jax.jit(lambda a, am, b, bm: registration_icp(
            a, am, b, bm, ic.threshold, ic.max_iterations, ic.relative_fitness,
            ic.relative_rmse, cached=cached))
        block(f(p, pm, c, cm))
        return median_ms(lambda: block(f(p, pm, c, cm)))

    cap = 2.0 * cfg.moving_threshold
    cls_k = jax.jit(lambda a, b, bm: nearest_neighbors_with_bound(
        a, b, bm, cap2=jnp.float32(cap * cap)))
    cls_x = jax.jit(nearest_neighbors_scan)
    block(cls_k(c, p, pm))
    block(cls_x(c, p, pm))
    icp_cached, icp_xla = icp_ms(True), icp_ms(False)
    sweep_k = median_ms(lambda: block(cls_k(c, p, pm)))
    sweep_x = median_ms(lambda: block(cls_x(c, p, pm)))

    # the whole GMFA step with every cloud past the kernel's size limit:
    # the same program on the plain XLA sweep.  The limit is read while
    # tracing, so traces cached on either side of the swap are dropped.
    limit = nn_pallas.MAX_TARGET
    nn_pallas.MAX_TARGET = 0
    jax.clear_caches()
    try:
        step_x = jax.jit(partial(gmfa_mod._gmfa_step_impl, cfg=cfg, max_moving=16384))
        pipe = gmfa_mod.GMFAPipeline(cfg, max_moving_points=16384)
        carry = pipe.seed_carry(p, pm)
        key = jax.random.PRNGKey(1)
        block(step_x(c, cm, carry, key))
        gmfa_x = median_ms(lambda: block(step_x(c, cm, carry, key)), reps=3)
    finally:
        nn_pallas.MAX_TARGET = limit
        jax.clear_caches()
    step_k = jax.jit(partial(gmfa_mod._gmfa_step_impl, cfg=cfg, max_moving=16384))
    block(step_k(c, cm, carry, key))
    gmfa_k = median_ms(lambda: block(step_k(c, cm, carry, key)), reps=3)
    say("kernel_vs_xla", t0, icp_kernel_cached_ms=icp_cached,
        icp_xla_uncached_ms=icp_xla, classification_kernel_ms=sweep_k,
        classification_xla_ms=sweep_x, gmfa_step_kernel_ms=gmfa_k,
        gmfa_step_xla_ms=gmfa_x)


def phase_stages(hw=(1080, 1920)) -> None:
    """Device times of the stages that run a lax.while_loop (Hungarian,
    DBSCAN's pointer doubling), and of each 1080p pyramid level."""
    import jax
    import jax.numpy as jnp

    from bench import make_frames
    from datmo_using_optical_flow.ops.dbscan import dbscan
    from datmo_using_optical_flow.ops.farneback import (build_pyramid,
                                                            farneback_level)
    from datmo_using_optical_flow.ops.hungarian import linear_sum_assignment

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    cost = jnp.asarray(rng.uniform(0, 2, size=(64, 32)).astype(np.float32))
    hung = jax.jit(lambda c: linear_sum_assignment(
        c, row_mask=jnp.ones(64, bool), col_mask=jnp.ones(32, bool))[0])
    block(hung(cost))
    hung_ms = median_ms(lambda: block(hung(cost)))
    pts = jnp.asarray(np.concatenate([
        rng.normal(size=(4000, 3)) * 0.4 + off
        for off in ([6, -4, 0.75], [-6, 5, 0.75], [0, 10, 0.75], [3, 3, 0.5])
    ]).astype(np.float32))
    pts = jnp.pad(pts, ((0, 16384 - pts.shape[0]), (0, 0)), constant_values=1e9)
    pmask = jnp.arange(16384) < 16000
    db = jax.jit(lambda q, m: dbscan(q, m, 0.5, 1000)[0])
    block(db(pts, pmask))
    db_ms = median_ms(lambda: block(db(pts, pmask)))

    frames = make_frames(2, *hw)
    f0, f1 = (jnp.asarray(f, jnp.float32) for f in frames)
    pyr0 = block(build_pyramid(f0, 0.3, 5, 5, 5.0))
    pyr1 = block(build_pyramid(f1, 0.3, 5, 5, 5.0))
    levels = []
    for r0, r1 in zip(pyr0, pyr1):
        _, lh, lw = r0.shape
        zero = jnp.zeros((lh, lw), jnp.float32)
        lvl = jax.jit(lambda a, b, x, y: farneback_level(
            a, b, x, y, 15, 5, fast_warp=True))
        block(lvl(r0, r1, zero, zero))
        ms = median_ms(lambda: block(lvl(r0, r1, zero, zero)))
        # bytes a fused level must move per pixel and iteration: R0 planes
        # (5 f32), the packed R1 corner row (28 B), flow in and out (16 B)
        bound_ms = 5 * lh * lw * (20 + 28 + 16) / 3.35e12 * 1e3
        levels.append(f"{lh}x{lw}:{ms:.3f}ms(bound {bound_ms:.3f}ms)")
    poly = jax.jit(lambda f: build_pyramid(f, 0.3, 5, 5, 5.0))
    block(poly(f0))
    poly_ms = median_ms(lambda: block(poly(f0)))
    say("stages", t0, hungarian_64x32_ms=hung_ms, dbscan_16384_ms=db_ms,
        pyramid_build_ms=poly_ms, flow_levels=";".join(levels))


def phase_four_cards(n_devices: int = 4, hw=(1088, 1920), **gmfa_scale) -> None:
    """The multi-device paths on ``n_devices`` devices, each against its
    one-device result: stream-parallel pipeline A (one 1080p stream per
    card), stream-parallel GMFA at the reference load, the row-sharded flow
    with ppermute halos, and the 2-D stream x space mesh."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from bench import make_frames
    from datmo_using_optical_flow.models.gmfa import _gmfa_step_impl
    from datmo_using_optical_flow.models.optical_flow_datmo import (
        PipelineA, _datmo_tail, _step_impl)
    from datmo_using_optical_flow.ops.farneback import _farneback_impl
    from datmo_using_optical_flow.parallel.mesh import (stream_mesh,
                                                            stream_space_mesh)
    from datmo_using_optical_flow.parallel.sharded_flow import (
        sharded_farneback_flow)
    from datmo_using_optical_flow.parallel.streams import (
        init_gmfa_stream_carry, init_stream_carry, make_multi_stream_gmfa_step,
        make_multi_stream_step, seed_gmfa_stream_carry)

    devices = jax.devices()[:n_devices]
    check(len(devices) == n_devices, f"need {n_devices} devices, have {len(devices)}")
    h, w = hw
    cfg = flow_config(h, w)
    check(cfg.grid_shape == (h, w), f"grid {cfg.grid_shape} != {(h, w)}")
    one = jax.jit(lambda a, b, c: _step_impl(a, b, c, cfg=cfg, fast_warp=True))
    scenes = [make_frames(2, h, w, seed=20 + s, n_objects=3)
              for s in range(n_devices)]
    b1 = jnp.asarray(np.stack([sc[0] for sc in scenes]))
    b2 = jnp.asarray(np.stack([sc[1] for sc in scenes]))

    # 1. stream-parallel pipeline A, one stream per device
    t0 = time.perf_counter()
    mesh = stream_mesh(n_devices, devices)
    step = make_multi_stream_step(cfg, mesh, fast_warp=True)
    _, outs, metrics = block(step(b1, b2, init_stream_carry(cfg, n_devices)))
    ref = PipelineA(cfg).init_carry()
    err = 0.0
    for s in range(n_devices):
        _, o = block(one(b1[s], b2[s], ref))
        err = max(err, float(jnp.max(jnp.abs(outs.velocity_x[s] - o.velocity_x))))
        check(int(outs.cell_count[s]) == int(o.cell_count),
              f"stream {s}: cells differ from one device")
    check(err <= 5e-3, f"stream-parallel pipeline A differs by {err}")
    say("four_cards_streams_a", t0, streams=n_devices, size=f"{h}x{w}",
        velocity_max_abs_diff=err, total_cells=int(metrics["total_cells"]))

    # 2. stream-parallel GMFA, one stream per device
    t0 = time.perf_counter()
    gcfg, gpipe, clouds = _reference_clouds(n_devices + 1, **gmfa_scale)
    max_moving = 16384
    prev = jnp.stack([clouds[s][0] for s in range(n_devices)])
    prev_m = jnp.stack([clouds[s][1] for s in range(n_devices)])
    cur = jnp.stack([clouds[s + 1][0] for s in range(n_devices)])
    cur_m = jnp.stack([clouds[s + 1][1] for s in range(n_devices)])
    keys = jnp.stack([jax.random.PRNGKey(100 + s) for s in range(n_devices)])
    gstep = make_multi_stream_gmfa_step(gcfg, mesh, max_moving=max_moving)
    gcarry = seed_gmfa_stream_carry(init_gmfa_stream_carry(gcfg, n_devices),
                                    prev, prev_m)
    gcarry2, gouts, _ = block(gstep(cur, cur_m, gcarry, keys))
    gone = jax.jit(lambda q, m, c, k: _gmfa_step_impl(q, m, c, k, cfg=gcfg,
                                                      max_moving=max_moving))
    t_err = 0.0
    for s in range(n_devices):
        c1, o1 = block(gone(cur[s], cur_m[s], gpipe.seed_carry(prev[s], prev_m[s]),
                            keys[s]))
        t_err = max(t_err, float(jnp.max(jnp.abs(gouts.transformation[s]
                                                 - o1.transformation))))
        check(bool(jnp.all(gouts.labels[s] == o1.labels)),
              f"GMFA stream {s}: DBSCAN labels differ from one device")
    check(t_err <= 1e-5, f"stream-parallel GMFA transforms differ by {t_err}")
    say("four_cards_streams_gmfa", t0, streams=n_devices,
        points=int(jnp.sum(cur_m[0])), transform_max_abs_diff=t_err)

    # 3. row-sharded flow with ppermute halos over n_devices shards
    t0 = time.perf_counter()
    img1, img2 = (jnp.asarray(f, jnp.float32) for f in make_frames(2, h, w, seed=3))
    space = Mesh(np.asarray(devices), ("space",))
    flow_fn = jax.jit(shard_map(lambda a, b: sharded_farneback_flow(a, b, "space"),
                                mesh=space, in_specs=(P("space"), P("space")),
                                out_specs=P("space"), check_vma=False))
    got = block(flow_fn(img1, img2))
    exp = block(jax.jit(lambda a, b: _farneback_impl(a, b, 0.3, 5, 15, 5, 5, 5.0))(
        img1, img2))
    epe = float(jnp.max(jnp.linalg.norm(got - exp, axis=-1)))
    check(epe <= 1e-3, f"row-sharded flow differs from one device by {epe} px")
    say("four_cards_row_sharded_flow", t0, size=f"{h}x{w}", shards=n_devices,
        epe_max_vs_one_device_px=epe)

    # 4. the 2-D (stream x space) mesh: each stream's flow row-sharded
    t0 = time.perf_counter()
    n_stream, n_space = 2, n_devices // 2
    mesh2 = stream_space_mesh(n_stream, n_space, devices)

    def combined_one(x1, x2, c):
        flow_loc = sharded_farneback_flow(x1.astype(jnp.float32),
                                          x2.astype(jnp.float32), "space")
        flow_full = jax.lax.all_gather(flow_loc, "space", tiled=True)
        pv = (jax.lax.psum(jnp.any(x1 > 0).astype(jnp.int32), "space") > 0) \
            & (jax.lax.psum(jnp.any(x2 > 0).astype(jnp.int32), "space") > 0)
        return _datmo_tail(flow_full, pv, c, cfg)

    combined = jax.jit(shard_map(
        jax.vmap(combined_one), mesh=mesh2,
        in_specs=(P("stream", "space"), P("stream", "space"), P("stream")),
        out_specs=P("stream"), check_vma=False))
    _, outs2 = block(combined(b1[:n_stream], b2[:n_stream],
                              init_stream_carry(cfg, n_stream)))
    # the row-sharded flow warps with exact f32 corners, so its one-device
    # reference does too (fast_warp's packed corners differ by up to a few
    # px at ill-conditioned pixels)
    exact = jax.jit(lambda a, b, c: _step_impl(a, b, c, cfg=cfg, fast_warp=False))
    err2 = 0.0
    for s in range(n_stream):
        _, o = block(exact(b1[s], b2[s], ref))
        err2 = max(err2, float(jnp.max(jnp.abs(outs2.velocity_x[s] - o.velocity_x))))
        check(int(outs2.cell_count[s]) == int(o.cell_count),
              f"2-D mesh stream {s}: cells differ from one device")
    check(err2 <= 5e-3, f"2-D mesh pipeline A differs by {err2}")
    say("four_cards_stream_x_space", t0, mesh=f"{n_stream}x{n_space}",
        velocity_max_abs_diff=err2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on four cards")
    args = ap.parse_args(argv)
    os.makedirs(OUT, exist_ok=True)
    device = phase_device()
    if args.four_cards:
        check(device["count"] >= 4, f"--four-cards needs 4 cards, have {device['count']}")
        phase_four_cards(4)
        device["count"] = 4
    else:
        phase_pipeline_a_points()
        phase_pipeline_a_1080p()
        gm = phase_gmfa()
        phase_kernel_vs_xla(gm)
        phase_stages()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
