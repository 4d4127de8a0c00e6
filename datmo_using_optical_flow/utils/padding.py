"""Fixed-capacity padded-buffer helpers.

The device-side convention replacing the reference's dynamic numpy filtering
(e.g. boolean masking at ``Optical_flow/main.py:30-36``): every array has a static
capacity and a validity mask; "filtering" = recomputing the mask; "compaction" =
stable scatter of valid rows to the front (preserving input order, like numpy
boolean indexing does).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pad_to(x: jnp.ndarray, capacity: int, fill_value=0) -> jnp.ndarray:
    """Pad (or truncate) the leading axis of ``x`` to ``capacity``."""
    n = x.shape[0]
    if n == capacity:
        return x
    if n > capacity:
        return x[:capacity]
    pad_width = [(0, capacity - n)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=fill_value)


# above this many input rows, compaction switches from cumsum+scatter to
# first_valid_indices+gather: row scatters over the 1080p velocity grid's 2M
# cells, and lax.top_k over its 2M keys, cost more than the bitpacked rank
# search below (~2 streaming passes over the mask)
_SCATTER_MAX = 1 << 15

# bits per rank-search block: 8 x 32-bit words = one 32-byte gather row
_RANK_BLOCK = 256
# below this many rows lax.top_k beats the bitpacked rank search (see the
# shape A/B in compact_masked)
_BITPACK_MIN = 1 << 20


def first_valid_indices(mask: jnp.ndarray, capacity: int
                        ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Indices of the first ``capacity`` True entries of ``mask``, ascending.

    Returns ``(idx, okay, count)``: ``idx[j]`` is the j-th valid index (0 where
    ``okay[j]`` is False), ``count = min(popcount(mask), capacity)``.  Exactly
    the indices ``lax.top_k`` on ``-iota`` keys would produce, but via a
    bitpacked hierarchical rank search that streams the mask twice instead of
    partially sorting 2M keys:

    * pack the mask into uint32 words, popcount each (``lax.population_count``);
    * per 256-bit block: cumulative valid counts -> ``searchsorted`` maps each
      output rank j to its block;
    * gather that block's 8 words (one 32-byte row) and locate the
      (j - prior)-th set bit by word-level popcount cumsum + bit expansion.
    """
    n = mask.shape[0]
    mask = mask.astype(bool)
    npad = -(-n // _RANK_BLOCK) * _RANK_BLOCK
    maskp = jnp.pad(mask, (0, npad - n))
    nw = npad // 32
    bits = maskp.reshape(nw, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, :]
    words = jnp.sum(bits << shifts, axis=1, dtype=jnp.uint32)
    wpc = jax.lax.population_count(words).astype(jnp.int32)
    nbk = npad // _RANK_BLOCK
    bc = jnp.sum(wpc.reshape(nbk, 8), axis=1)
    cum = jnp.cumsum(bc)                                    # inclusive
    total = cum[-1]

    j = jnp.arange(capacity, dtype=jnp.int32)
    okay = j < total
    b = jnp.clip(jnp.searchsorted(cum, j + 1, side="left"), 0, nbk - 1)
    b = b.astype(jnp.int32)
    prior = cum[b] - bc[b]
    r = j - prior                                           # rank within block

    wrows = words.reshape(nbk, 8)[b]                        # (capacity, 8) 32B rows
    wc = jax.lax.population_count(wrows).astype(jnp.int32)
    wcum = jnp.cumsum(wc, axis=1)                           # inclusive
    w = jnp.argmax(wcum >= (r + 1)[:, None], axis=1).astype(jnp.int32)
    prior_w = jnp.take_along_axis(wcum, w[:, None], axis=1)[:, 0] \
        - jnp.take_along_axis(wc, w[:, None], axis=1)[:, 0]
    r2 = r - prior_w                                        # rank within word

    word = jnp.take_along_axis(wrows, w[:, None], axis=1)[:, 0]
    wbits = ((word[:, None] >> shifts) & jnp.uint32(1)).astype(jnp.int32)
    bcum = jnp.cumsum(wbits, axis=1)
    pos = jnp.argmax((bcum == (r2 + 1)[:, None]) & (wbits == 1),
                     axis=1).astype(jnp.int32)

    idx = b * _RANK_BLOCK + w * 32 + pos
    idx = jnp.where(okay, idx, 0)
    count = jnp.minimum(total, capacity)
    return idx, okay, count


def compact_masked(x: jnp.ndarray, mask: jnp.ndarray, capacity: int,
                   fill_value=1e9) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Stable-compact rows of ``x`` where ``mask`` is True into a ``(capacity, ...)`` buffer.

    Returns ``(compacted, out_mask, count)`` where ``count`` is the number of valid rows
    (clamped to ``capacity``).  Order of surviving rows matches input order, so results
    are bit-compatible with numpy boolean indexing followed by padding.

    Small inputs use cumsum + scatter (O(N)); large inputs find the first
    ``capacity`` valid row indices with ``top_k`` and gather them (identical
    rows in identical order, so the two paths are bit-equal).
    """
    import jax

    mask = mask.astype(bool)
    n = x.shape[0]
    if n > _SCATTER_MAX and n > capacity:
        if n >= _BITPACK_MIN:
            # r4 chip A/B at the two production shapes: bitpacked 0.53 ms vs
            # top_k 2.50 at 2.07M/4096 (the 1080p tail), but top_k ~0 vs
            # bitpacked 1.97 at 131k/16384 (GMFA moving-point compaction) —
            # the bitpacked rank search pays O(capacity x 32) per call while
            # top_k pays O(n)
            idx, okay, count = first_valid_indices(mask, capacity)
        else:
            iota = jnp.arange(n, dtype=jnp.int32)
            sentinel = jnp.int32(-(2 ** 31) + 1)
            key = jnp.where(mask, -iota, sentinel)
            vals, _ = jax.lax.top_k(key, capacity)  # desc -idx == asc idx
            okay = vals > sentinel
            idx = jnp.where(okay, -vals, 0)
            count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), capacity)
        gathered = x[idx]
        shape_tail = (1,) * (x.ndim - 1)
        out = jnp.where(okay.reshape((capacity,) + shape_tail), gathered,
                        jnp.asarray(fill_value, x.dtype))
        return out, okay, count
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1          # destination row for valid entries
    count = jnp.minimum(pos[-1] + 1 if pos.shape[0] else 0, capacity)
    dest = jnp.where(mask & (pos < capacity), pos, capacity)  # invalid -> dropped slot
    out_shape = (capacity + 1,) + x.shape[1:]
    out = jnp.full(out_shape, fill_value, dtype=x.dtype)
    out = out.at[dest].set(x, mode="drop")
    out = out[:capacity]
    idx = jnp.arange(capacity)
    out_mask = idx < count
    return out, out_mask, count
