"""Device-mesh helpers (SURVEY.md §2.5: the parallelism layer).

The reference is a single-threaded sequential loop; this framework's scaling axes
are (a) **stream parallelism** — embarrassingly parallel DATMO over camera/LiDAR
feeds, one stream per device/chip, and (b) **spatial parallelism** — BEV/flow
grids row-sharded across devices with halo exchange (the stencil-pipeline
analogue of sequence/context parallelism).  Collectives compile to XLA
psum/ppermute between devices; there is no custom comm backend.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401


def stream_mesh(n_streams: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the 'stream' axis (data parallelism over feeds)."""
    devices = devices if devices is not None else jax.devices()
    n = n_streams or len(devices)
    return Mesh(np.asarray(devices[:n]).reshape(n), axis_names=("stream",))


def stream_space_mesh(n_streams: int, n_space: int, devices=None) -> Mesh:
    """2-D mesh: 'stream' (data parallel) x 'space' (row-sharded grids + halos)."""
    devices = devices if devices is not None else jax.devices()
    need = n_streams * n_space
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_streams, n_space)
    return Mesh(arr, axis_names=("stream", "space"))
