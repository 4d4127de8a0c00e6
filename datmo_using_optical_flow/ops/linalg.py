"""Full float32 precision on every backend.

On the GPU an f32 matrix product without a ``precision`` argument may run in
TF32 (~10 mantissa bits): ~3 cm of error on coordinates ~30 m from the
origin, wider than GMFA's 0.02 m ICP gate.  Every product of the pipelines
goes through :func:`matmul`, which asks XLA for the exact-f32 lowering
(pinned by tests/test_precision.py on the lowered steps).

XLA's GPU code for f32 division and square root is not correctly rounded
(an H100 differs from IEEE in ~1 of 4 quotients), so where a result must be
the same bits on every backend — the uint8 BEV — :func:`div_rn` and
:func:`sqrt_rn` round the device's answer to the IEEE one, using only
additions and multiplications, which are correctly rounded everywhere.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

matmul = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _split(x):
    """Veltkamp split of f32 ``x`` into hi + lo, each with <= 12 bits."""
    c = x * 4097.0
    hi = c - (c - x)
    return hi, x - hi


def _residual(a, q, b):
    """``a - q*b`` with the product taken exactly (Dekker); ``a - q*b`` is
    exact when ``q*b`` is within a factor 2 of ``a`` (Sterbenz), so only the
    final subtraction rounds."""
    p = q * b
    qh, ql = _split(q)
    bh, bl = _split(b)
    err = ((qh * bh - p) + qh * bl + ql * bh) + ql * bl
    return (a - p) - err


def _nearest(candidates, residuals):
    best, best_r = candidates[0], jnp.abs(residuals[0])
    for c, r in zip(candidates[1:], residuals[1:]):
        take = jnp.abs(r) < best_r
        best = jnp.where(take, c, best)
        best_r = jnp.where(take, jnp.abs(r), best_r)
    return best


def _neighbors(x, k: int = 2):
    """``x`` first (ties keep it), then its ``k`` float neighbors on either
    side, nearest first."""
    down, up, out = x, x, [x]
    for _ in range(k):
        down = jnp.nextafter(down, -jnp.inf)
        up = jnp.nextafter(up, jnp.inf)
        out += [down, up]
    return out


def round_quotient(a, b, q):
    """The correctly rounded ``a / b`` from an approximation ``q`` within two
    units in the last place: the neighbor with the smallest residual."""
    cands = _neighbors(q)
    best = _nearest(cands, [_residual(a, c, b) for c in cands])
    return jnp.where(jnp.isfinite(q) & (b != 0), best, q)


def round_sqrt(x, s):
    """The correctly rounded ``sqrt(x)`` from an approximation ``s`` within
    two units in the last place."""
    cands = _neighbors(s)
    best = _nearest(cands, [_residual(x, c, c) for c in cands])
    return jnp.where(jnp.isfinite(s) & (x > 0), best, s)


def div_rn(a, b):
    """IEEE (round-to-nearest) f32 division on every backend."""
    return round_quotient(a, b, a / b)


def sqrt_rn(x):
    """IEEE (round-to-nearest) f32 square root on every backend."""
    return round_sqrt(x, jnp.sqrt(x))
