"""Headline benchmark: end-to-end DATMO throughput at 1080p on one GPU.

Workload (BASELINE.json north star): the full pipeline-A frame->tracks step on
1920x1080 frames — pyramidal Farnebäck flow (0.3/5/15/5/5/5, the reference's
executed params, ``Optical_flow/main.py:132-140``), velocity conversion,
continuity mask, on-device DBSCAN, EKF track table — one stream-mode step per
frame, dispatched asynchronously the way a streaming deployment would.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"} with
vs_baseline = fps / 30 (the >= 30 FPS north-star target).  Diagnostics go to
stderr: the device and the card's name and power limit, and the compile time,
which is set-up and not part of the rate.  Fails when JAX finds no GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_frames(n: int, h: int, w: int, seed: int = 0, n_objects: int = 6) -> np.ndarray:
    """Synthetic 1080p 'CARLA-like' uint8 frames: textured background + textured
    objects translating at up to ~6 px/frame (so dense flow has real signal)."""
    rng = np.random.default_rng(seed)

    def smooth_noise(shape, scale=8):
        small = rng.uniform(0, 255, (shape[0] // scale + 2, shape[1] // scale + 2))
        ys = np.linspace(0, small.shape[0] - 1.001, shape[0])
        xs = np.linspace(0, small.shape[1] - 1.001, shape[1])
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        a = small[y0][:, x0]
        b = small[y0][:, x0 + 1]
        c = small[y0 + 1][:, x0]
        d = small[y0 + 1][:, x0 + 1]
        return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy

    base = smooth_noise((h, w)) * 0.4
    objs = []
    for _ in range(n_objects):
        size = int(rng.integers(60, 140))
        objs.append({
            "tex": smooth_noise((size, size), scale=4) * 0.8 + 40,
            "pos": rng.uniform([0.15 * h, 0.15 * w], [0.7 * h, 0.7 * w]),
            "vel": rng.uniform(-6, 6, size=2),
            "size": size,
        })
    frames = np.empty((n, h, w), np.uint8)
    for t in range(n):
        img = base.copy()
        for o in objs:
            cy, cx = (o["pos"] + o["vel"] * t).astype(int)
            s = o["size"]
            y0, x0 = np.clip(cy, 0, h - s), np.clip(cx, 0, w - s)
            img[y0:y0 + s, x0:x0 + s] = o["tex"]
        img += rng.normal(scale=1.0, size=(h, w))
        frames[t] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def main() -> None:
    import jax
    import jax.numpy as jnp

    from datmo_using_optical_flow.utils.compile_cache import enable as enable_cache
    from datmo_using_optical_flow.utils.device import (
        card_name_and_power_limit, require_gpu)

    device = require_gpu()
    log(f"device: {device}; card: {card_name_and_power_limit()}")
    log(f"compile cache: {enable_cache()}")

    from datmo_using_optical_flow.config import CapacityConfig, PipelineAConfig
    from datmo_using_optical_flow.models.optical_flow_datmo import (
        PipelineA, _stream_step_impl)

    h, w = 1080, 1920
    # grid_shape is (nx, ny) = (x bins, y bins); configure ranges so the DATMO
    # grid exactly matches the 1080p frame shape
    cfg = PipelineAConfig(
        x_range=(0.0, h * 0.1), y_range=(0.0, w * 0.1), grid_resolution=(0.1, 0.1),
        capacities=CapacityConfig(max_cells=4096, max_clusters=32, max_tracks=64),
    )
    assert cfg.grid_shape == (h, w), cfg.grid_shape

    n_frames = 25  # 1 priming frame + 24 timed frames per sweep
    frames = make_frames(n_frames, h, w)
    dev_frames = [jnp.asarray(f) for f in frames]

    pipe = PipelineA(cfg, fast_warp=True)

    # stream mode: one NEW frame per dispatch; the previous frame's coefficient
    # pyramid rides in the carry (each frame's polynomial expansion runs once).
    # One async dispatch per frame: back-to-back step dispatches pipeline, so
    # the device is the bottleneck.
    @jax.jit
    def step(bev, carry):
        new_carry, out = _stream_step_impl(bev, carry, cfg=cfg, fast_warp=True)
        return (new_carry, out.cell_count,
                jnp.sum(new_carry.step.table.alive.astype(jnp.int32)))

    log("compiling 1080p DATMO step (first compile is slow)...")
    t0 = time.time()
    carry = pipe.init_stream_carry()
    carry, cells, tracks = step(dev_frames[0], carry)   # prime the pyramid
    carry, cells, tracks = step(dev_frames[1], carry)
    _ = int(tracks)  # force
    log(f"set-up (compile + first run): {time.time() - t0:.1f}s; "
        f"cells={int(cells)} tracks={int(tracks)}")

    reps = 3
    done = 0
    elapsed = 0.0
    for _ in range(reps):
        carry = pipe.init_stream_carry()
        carry, cells, tracks = step(dev_frames[0], carry)  # prime the pyramid
        _ = int(tracks)  # sync: the one-time prime is not part of steady state
        t0 = time.time()
        for i in range(1, n_frames):
            carry, cells, tracks = step(dev_frames[i], carry)
            done += 1
        _ = int(tracks)  # host sync once per sweep (streaming-style async dispatch)
        elapsed += time.time() - t0
    fps = done / elapsed
    log(f"per-frame {elapsed / done * 1e3:.2f} ms "
        f"({n_frames - 1} async step dispatches + 1 sync per sweep)")
    log(f"{done} frame pairs in {elapsed:.2f}s; final tracks={int(tracks)}")

    print(json.dumps({
        "metric": "end_to_end_datmo_fps_1080p_per_chip",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 4),
        "device": device,
    }))


if __name__ == "__main__":
    main()
