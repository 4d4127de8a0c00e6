"""Measure the above-SCAN_MAX_CELLS (4K-grid) streaming path once (VERDICT r4
weak #6): ``scan_steps`` at 2176x3840 takes the per-frame-dispatch branch —
this records its compile time, per-frame rate, and carry residency so the
``SCAN_MAX_CELLS`` boundary (models/optical_flow_datmo.py) is justified by
data above 1080p rather than reasoning.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    import jax

    from datmo_using_optical_flow.utils.compile_cache import enable as _ec
    _ec()
    from datmo_using_optical_flow.utils.device import (
        card_name_and_power_limit, require_gpu)
    print(f"device: {require_gpu()}; card: {card_name_and_power_limit()}",
          file=sys.stderr, flush=True)
    import jax.numpy as jnp

    from datmo_using_optical_flow.config import CapacityConfig, PipelineAConfig
    from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA

    log(f"devices: {jax.devices()}")
    h, w = 2176, 3840
    cfg = PipelineAConfig(
        x_range=(0.0, h * 0.1), y_range=(0.0, w * 0.1), grid_resolution=(0.1, 0.1),
        capacities=CapacityConfig(max_cells=4096, max_clusters=32, max_tracks=64),
    )
    assert cfg.grid_shape == (h, w), cfg.grid_shape
    assert h * w > PipelineA.SCAN_MAX_CELLS  # must exercise the dispatch branch

    from bench import make_frames

    n_frames = 6
    frames = make_frames(n_frames, h, w, seed=1, n_objects=8)
    bevs = jnp.asarray(frames)

    pipe = PipelineA(cfg, fast_warp=True)
    carry = pipe.init_carry()
    carry_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                      for x in jax.tree.leaves(pipe.init_stream_carry()))
    log(f"stream-carry residency at 4K: {carry_bytes / 1e6:.1f} MB")

    log("compiling 4K stream step (first compile)...")
    t0 = time.time()
    new_carry, outs = pipe.scan_steps(bevs[:3], carry)
    _ = int(np.asarray(outs.cell_count)[-1])
    compile_s = time.time() - t0
    log(f"compile+first 2 pairs: {compile_s:.1f}s")

    reps = 2
    done = 0
    t0 = time.time()
    for _ in range(reps):
        _, outs = pipe.scan_steps(bevs, pipe.init_carry())
        _ = int(np.asarray(outs.cell_count)[-1])
        done += n_frames - 1
    elapsed = time.time() - t0
    fps = done / elapsed
    log(f"{done} pairs in {elapsed:.2f}s")

    print(json.dumps({
        "metric": "datmo_4k_dispatch_fps",
        "value": round(fps, 3),
        "unit": "frames/s",
        "grid": f"{h}x{w}",
        "compile_s": round(compile_s, 1),
        "stream_carry_mb": round(carry_bytes / 1e6, 1),
    }))


if __name__ == "__main__":
    main()
