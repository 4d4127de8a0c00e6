"""Every f32 matrix product in the lowered pipeline steps asks for full
precision: on the GPU an unannotated f32 product may run in TF32 (~10
mantissa bits), which the CPU suite computes exactly and so cannot see."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from datmo_using_optical_flow.config import CapacityConfig, GMFAConfig, PipelineAConfig
from datmo_using_optical_flow.models import gmfa
from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA, _stream_step_impl


def _lowered_stream_step():
    cfg = PipelineAConfig()
    carry = PipelineA(cfg).init_stream_carry()
    return jax.jit(partial(_stream_step_impl, cfg=cfg, fast_warp=True)).lower(
        jnp.zeros(cfg.grid_shape, jnp.uint8), carry)


def _gmfa_cfg():
    return GMFAConfig(capacities=CapacityConfig(
        max_raw_points=1024, max_roi_points=256, max_clusters=8, max_tracks=8))


def _lowered_gmfa_preprocess():
    cfg = _gmfa_cfg()
    return jax.jit(partial(gmfa._gmfa_preprocess_impl, cfg=cfg)).lower(
        jnp.zeros((1024, 3)), jnp.ones((1024,), bool), jax.random.PRNGKey(0))


def _lowered_gmfa_step():
    cfg = _gmfa_cfg()
    p = cfg.capacities.max_expanded_points
    carry = gmfa.GMFAPipeline(cfg, max_moving_points=256).init_carry()
    return jax.jit(partial(gmfa._gmfa_step_impl, cfg=cfg, max_moving=256)).lower(
        jnp.zeros((p, 3)), jnp.ones((p,), bool), carry, jax.random.PRNGKey(0))


@pytest.mark.parametrize("lower", [_lowered_stream_step, _lowered_gmfa_preprocess,
                                   _lowered_gmfa_step],
                         ids=["pipeline_a_stream_step", "gmfa_preprocess",
                              "gmfa_step"])
def test_every_dot_general_is_highest(lower):
    dots = [line for line in lower().as_text().splitlines()
            if "stablehlo.dot_general" in line]
    assert dots, "no matrix product found: the check would be vacuous"
    loose = [line.strip()[:160] for line in dots
             if "precision = [HIGHEST, HIGHEST]" not in line]
    assert not loose, loose


def _step(x, k):
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.inf) if k > 0 else np.float32(-np.inf))
    return x


@pytest.mark.parametrize("k", [-2, -1, 1, 2])
def test_round_quotient_recovers_ieee(k):
    """A quotient off by up to two units in the last place (XLA's GPU f32
    division is not correctly rounded) is rounded to numpy's IEEE one."""
    from datmo_using_optical_flow.ops.linalg import round_quotient

    rng = np.random.default_rng(10 + k)
    a = rng.uniform(-30, 30, 1 << 14).astype(np.float32)
    b = rng.uniform(0.01, 300, 1 << 14).astype(np.float32)
    got = np.asarray(jax.jit(round_quotient)(a, b, _step(a / b, k)))
    np.testing.assert_array_equal(got, a / b)


@pytest.mark.parametrize("k", [-2, -1, 1, 2])
def test_round_sqrt_recovers_ieee(k):
    from datmo_using_optical_flow.ops.linalg import round_sqrt

    rng = np.random.default_rng(20 + k)
    x = rng.uniform(0, 50, 1 << 14).astype(np.float32)
    got = np.asarray(jax.jit(round_sqrt)(x, _step(np.sqrt(x), k)))
    np.testing.assert_array_equal(got, np.sqrt(x))
