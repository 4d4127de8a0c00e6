"""Single-transfer host mirroring of device pytrees.

Every device->host readback pays a fixed latency per array, so
``jax.device_get`` on a many-leaf pytree (e.g. the per-pair
:class:`~datmo_using_optical_flow.models.optical_flow_datmo.StepOutputs`) pays
it once per leaf.  :class:`HostPacker` flattens a pytree into ONE flat uint8
device buffer at exact byte density (a uint8 BEV costs 1 byte/px, an int16
index 2) with a single jitted concat, and reconstructs the numpy pytree
host-side from the single transferred vector.

Layout is fixed per tree structure; build one packer per (pipeline, config)
and reuse it for every frame.  Buffers from several frames can be stacked
device-side and transferred together (:meth:`HostPacker.stack`) to amortize
the round-trip latency further.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_SUPPORTED = (np.dtype(np.bool_), np.dtype(np.uint8), np.dtype(np.int8),
              np.dtype(np.int16), np.dtype(np.uint16), np.dtype(np.int32),
              np.dtype(np.uint32), np.dtype(np.float32))


def _to_bytes(x: jnp.ndarray) -> jnp.ndarray:
    """Losslessly reinterpret any supported leaf as a flat uint8 vector."""
    if x.dtype == jnp.bool_:
        x = x.astype(jnp.uint8)
    if jnp.dtype(x.dtype) not in _SUPPORTED:
        raise TypeError(f"HostPacker: unsupported leaf dtype {x.dtype}")
    if x.dtype != jnp.uint8:
        x = lax.bitcast_convert_type(x, jnp.uint8)  # adds a trailing (itemsize,)
    return x.reshape(-1)


class HostPacker:
    """Pack/unpack a fixed-structure pytree through one flat uint8 buffer."""

    def __init__(self, example_tree):
        leaves, self._treedef = jax.tree.flatten(example_tree)
        self._specs = [(tuple(l.shape), np.dtype(l.dtype)) for l in leaves]
        self.nbytes = sum(
            (int(np.prod(s)) if s else 1) * (1 if d == np.bool_ else d.itemsize)
            for s, d in self._specs)
        self.pack = jax.jit(self.pack_impl)

    def pack_impl(self, tree) -> jnp.ndarray:
        """Traceable pack (compose inside a larger jit via this method)."""
        parts = [_to_bytes(leaf) for leaf in jax.tree.leaves(tree)]
        return jnp.concatenate(parts) if len(parts) > 1 else parts[0]

    @staticmethod
    @functools.lru_cache(maxsize=16)
    def _stack_fn(k: int):
        return jax.jit(lambda *bufs: jnp.stack(bufs))

    @classmethod
    def stack(cls, bufs) -> jnp.ndarray:
        """Stack K packed buffers device-side (one jitted dispatch per K)."""
        return cls._stack_fn(len(bufs))(*bufs)

    def unpack(self, buf: np.ndarray):
        """Flat uint8 host vector -> pytree of numpy arrays (original dtypes)."""
        buf = np.ascontiguousarray(np.asarray(buf, dtype=np.uint8))
        out = []
        off = 0
        for shape, dtype in self._specs:
            n = int(np.prod(shape)) if shape else 1
            nb = n * (1 if dtype == np.bool_ else dtype.itemsize)
            seg = buf[off:off + nb]
            off += nb
            if dtype == np.bool_:
                a = seg.astype(np.bool_)
            elif dtype == np.uint8:
                a = seg
            else:
                # copy -> aligned base, then reinterpret (segments are tiny)
                a = seg.copy().view(dtype)
            out.append(a.reshape(shape))
        return jax.tree.unflatten(self._treedef, out)
