"""Stream-parallel DATMO: one feed per device over the 'stream' mesh axis.

The multi-stream deployment shape from BASELINE.json configs[4] (4x1080p feeds,
sustained per-stream DATMO): streams are embarrassingly parallel, so the full
pipeline-A frame-pair step runs under ``shard_map`` with every array sharded on
the leading stream axis; the only cross-stream communication is a ``psum`` of
monitoring metrics (exercising the interconnect without touching the hot path).

Both flagship drivers get the treatment: :func:`make_multi_stream_step` wraps
the pipeline-A frame-pair step (``Optical_flow/main.py:541``) and
:func:`make_multi_stream_gmfa_step` the full 11-stage GMFA frame step
(``GMFA/GMFA.py:424-536``: ICP -> residual classification -> DBSCAN ->
Hungarian -> track update -> SOM -> KF), each stream carrying its own
:class:`GmfaCarry` (previous expanded cloud, track table, SOM).
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from datmo_using_optical_flow.config import PipelineAConfig
from datmo_using_optical_flow.models.optical_flow_datmo import (StepCarry,
                                                                    _step_impl)
from datmo_using_optical_flow.models import tracker_a


def init_stream_carry(cfg: PipelineAConfig, n_streams: int) -> StepCarry:
    """Per-stream carry pytree with a leading stream axis."""
    h, w = cfg.grid_shape
    t = cfg.capacities.max_tracks

    def rep(x):
        return jnp.broadcast_to(x, (n_streams,) + x.shape)

    table = jax.tree.map(rep, tracker_a.new_track_table(t))
    return StepCarry(prev_vx=jnp.zeros((n_streams, h, w), jnp.float32),
                     prev_vy=jnp.zeros((n_streams, h, w), jnp.float32),
                     has_prev=jnp.zeros((n_streams,), bool),
                     table=table)


def make_multi_stream_step(cfg: PipelineAConfig, mesh: Mesh, fast_warp: bool = True):
    """Build the jitted stream-parallel step: (bev1, bev2, carry) -> (carry, metrics).

    ``bev1/bev2``: (n_streams, H, W) uint8, sharded on 'stream'.  Returns the
    advanced carry plus a dict of psum'd global metrics (total live tracks,
    total clustered cells) — the all-reduce crosses devices.
    """
    def per_stream(bev1, bev2, carry):
        # shard_map passes blocks with the stream axis of size n_local (=1 per
        # device when fully sharded); vmap over it to stay shape-agnostic
        def one(b1, b2, c):
            return _step_impl(b1, b2, c, cfg=cfg, fast_warp=fast_warp)

        new_carry, outs = jax.vmap(one)(bev1, bev2, carry)
        local_tracks = jnp.sum(new_carry.table.alive.astype(jnp.int32))
        local_cells = jnp.sum(outs.cell_count)
        metrics = {
            "total_tracks": jax.lax.psum(local_tracks, "stream"),
            "total_cells": jax.lax.psum(local_cells, "stream"),
        }
        return new_carry, outs, metrics

    spec = P("stream")
    carry_specs = StepCarry(prev_vx=spec, prev_vy=spec, has_prev=spec,
                            table=tracker_a.TrackTable(*([spec] * 6)))
    from datmo_using_optical_flow.models.optical_flow_datmo import StepOutputs

    n_plain = len(StepOutputs._fields) - 1  # all but the snapshot pytree
    out_specs = (carry_specs,
                 StepOutputs(*([spec] * n_plain),
                             snapshot=tracker_a.TrackTable(*([spec] * 6))),
                 {"total_tracks": P(), "total_cells": P()})
    fn = shard_map(per_stream, mesh=mesh, in_specs=(spec, spec, carry_specs),
                   out_specs=out_specs, check_vma=False)
    return jax.jit(fn)


def init_gmfa_stream_carry(cfg, n_streams: int):
    """Per-stream :class:`GmfaCarry` pytree with a leading stream axis."""
    from datmo_using_optical_flow.models.gmfa import GMFAPipeline

    carry = GMFAPipeline(cfg).init_carry()
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_streams,) + x.shape), carry)


def seed_gmfa_stream_carry(carry, points: jnp.ndarray, mask: jnp.ndarray):
    """Seed each stream's previous cloud WITH its Morton order — the
    stream-axis analogue of :meth:`GMFAPipeline.seed_carry` (a bare
    ``_replace(prev_points=...)`` leaves the arange placeholder and
    collapses the NN kernel's spatial pruning on every stream's first
    frame).  ``points``: (n_streams, P, 3), ``mask``: (n_streams, P)."""
    from datmo_using_optical_flow.ops.nn import sort_order

    order = jax.vmap(sort_order)(points, mask)
    return carry._replace(prev_points=points, prev_mask=mask,
                          prev_order=order)


def make_multi_stream_gmfa_step(cfg, mesh: Mesh, max_moving: int = 8192):
    """Build the jitted stream-parallel GMFA step:
    ``(points, mask, carry, keys) -> (carry, outputs, metrics)``.

    ``points``: (n_streams, P, 3) preprocessed (expanded) clouds, ``mask``
    (n_streams, P), ``keys`` (n_streams,) PRNG keys (uint32 key data) — all
    sharded on 'stream'; ``carry`` from :func:`init_gmfa_stream_carry`.
    Metrics (total live tracks / moving points across streams) are psum'd
    across devices; everything else is per-stream local, exactly the single-stream
    :func:`models.gmfa._gmfa_step_impl` per shard (parity pinned by
    tests/test_parallel.py).
    """
    from datmo_using_optical_flow.models.gmfa import (GmfaCarry, GmfaOutputs,
                                                          TrackTableB,
                                                          _gmfa_step_impl)

    def per_stream(points, mask, carry, keys):
        def one(p, m, c, k):
            return _gmfa_step_impl(p, m, c, k, cfg=cfg, max_moving=max_moving)

        new_carry, outs = jax.vmap(one)(points, mask, carry, keys)
        local_tracks = jnp.sum(new_carry.table.alive.astype(jnp.int32))
        local_moving = jnp.sum(outs.moving_count)
        metrics = {
            "total_tracks": jax.lax.psum(local_tracks, "stream"),
            "total_moving": jax.lax.psum(local_moving, "stream"),
        }
        return new_carry, outs, metrics

    spec = P("stream")
    carry_specs = GmfaCarry(prev_points=spec, prev_mask=spec,
                            table=TrackTableB(*([spec] * 6)),
                            som=spec, prev_centroids=spec, prev_exists=spec,
                            prev_order=spec)
    out_specs = (carry_specs,
                 GmfaOutputs(*([spec] * len(GmfaOutputs._fields))),
                 {"total_tracks": P(), "total_moving": P()})
    fn = shard_map(per_stream, mesh=mesh,
                   in_specs=(spec, spec, carry_specs, spec),
                   out_specs=out_specs, check_vma=False)
    return jax.jit(fn)
