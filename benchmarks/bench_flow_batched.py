"""BASELINE config[1]: batched dense flow — 8 pipelined frame pairs at 720p,
EPE parity vs the numpy Farnebäck oracle (oracle/np_farneback.py, itself
pinned to cv2.calcOpticalFlowFarneback by tests/test_farneback.py).

Prints a JSON line with fps and the measured max EPE (budget: 0.1 px).
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
    from datmo_using_optical_flow.config import FarnebackConfig
    from datmo_using_optical_flow.ops.farneback import _farneback_impl
    from datmo_using_optical_flow.oracle.np_farneback import calc_flow

    h, w, batch = 720, 1280, 8
    cfg = FarnebackConfig()
    frames = make_frames(batch + 1, h, w, seed=3)
    im1 = jnp.asarray(frames[:batch].astype(np.float32))
    im2 = jnp.asarray(frames[1:batch + 1].astype(np.float32))

    @jax.jit
    def batched(a, b):
        # the pairs issued one after another inside one program
        fn = lambda x, y: _farneback_impl(x, y, cfg.pyr_scale, cfg.levels,
                                          cfg.winsize, cfg.iterations, cfg.poly_n,
                                          cfg.poly_sigma, fast_warp=False)
        return jnp.stack([fn(a[i], b[i]) for i in range(a.shape[0])])

    t0 = time.time()
    flows = batched(im1, im2)
    flows.block_until_ready()
    epe_max = 0.0
    for i in range(batch):
        ref = calc_flow(frames[i].astype(np.float32),
                        frames[i + 1].astype(np.float32), cfg.pyr_scale,
                        cfg.levels, cfg.winsize, cfg.iterations, cfg.poly_n,
                        cfg.poly_sigma)
        epe = np.linalg.norm(np.asarray(flows[i]) - ref, axis=-1)
        epe_max = max(epe_max, float(epe.max()))
    print(f"compile+run: {time.time() - t0:.1f}s; max EPE vs the oracle: {epe_max:.5f}",
          file=sys.stderr)

    reps = 3
    t0 = time.time()
    for _ in range(reps):
        out = batched(im1, im2)
        _ = float(jnp.sum(out))  # host sync
    fps = batch * reps / (time.time() - t0)

    print(json.dumps({
        "metric": "batched_farneback_fps_720p_x8",
        "value": round(fps, 3),
        "unit": "frames/s",
        "epe_max_px": round(epe_max, 5),
        "epe_budget_px": 0.1,
    }))


if __name__ == "__main__":
    main()
