"""BASELINE config[4] (one-card form): 4 concurrent 1080p DATMO streams,
advanced together in one device program on one GPU (across several cards the
same streams map one per device via parallel.streams.make_multi_stream_step).

Stream mode: each stream carries its previous frame's coefficient pyramid, so
per new frame only that frame's polynomial expansion runs.

Prints a JSON line with per-stream and aggregate FPS.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    import jax

    from datmo_using_optical_flow.utils.compile_cache import enable as _ec
    _ec()
    from datmo_using_optical_flow.utils.device import (
        card_name_and_power_limit, require_gpu)
    print(f"device: {require_gpu()}; card: {card_name_and_power_limit()}",
          file=sys.stderr, flush=True)
    import jax.numpy as jnp

    from bench import make_frames
    from datmo_using_optical_flow.config import CapacityConfig, PipelineAConfig
    from datmo_using_optical_flow.models.optical_flow_datmo import (
        PipelineA, _stream_step_impl)

    h, w, n_streams = 1080, 1920, 4
    cfg = PipelineAConfig(
        x_range=(0.0, h * 0.1), y_range=(0.0, w * 0.1), grid_resolution=(0.1, 0.1),
        capacities=CapacityConfig(max_cells=4096, max_clusters=32, max_tracks=64),
    )
    # several frames per sync, the way streams dispatch asynchronously in
    # production and only the consumer syncs
    n_frames = 9
    frames = np.stack([make_frames(n_frames, h, w, seed=s) for s in range(n_streams)])
    dev_frames = [jnp.asarray(frames[:, t]) for t in range(n_frames)]

    pipe = PipelineA(cfg)
    carry0 = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_streams,) + x.shape),
        pipe.init_stream_carry())

    @jax.jit
    def step(bevs, c):
        # one program advancing all streams by one frame, sequential per stream
        carries, cells = [], []
        for s in range(bevs.shape[0]):
            cs = jax.tree.map(lambda v: v[s], c)
            nc, outs = _stream_step_impl(bevs[s], cs, cfg=cfg, fast_warp=True)
            carries.append(nc)
            cells.append(outs.cell_count)
        new_c = jax.tree.map(lambda *vs: jnp.stack(vs), *carries)
        return new_c, jnp.sum(jnp.stack(cells))

    t0 = time.time()
    carry, cells = step(dev_frames[0], carry0)  # prime the pyramids
    _ = int(cells)
    print(f"compile+prime: {time.time() - t0:.1f}s", file=sys.stderr)

    reps = 3
    done = 0
    elapsed = 0.0
    for _ in range(reps):
        carry, cells = step(dev_frames[0], carry)  # re-prime (not timed)
        _ = int(cells)
        t0 = time.time()
        for t in range(1, n_frames):
            carry, cells = step(dev_frames[t], carry)
            done += n_streams
        _ = int(cells)
        elapsed += time.time() - t0
    agg = done / elapsed
    print(f"{done} stream-frames in {elapsed:.2f}s; cells={int(cells)}",
          file=sys.stderr)

    print(json.dumps({
        "metric": "multistream_datmo_fps_4x1080p_one_card",
        "value": round(agg, 3),
        "unit": "frames/s aggregate",
        "per_stream_fps": round(agg / n_streams, 3),
    }))


if __name__ == "__main__":
    main()
