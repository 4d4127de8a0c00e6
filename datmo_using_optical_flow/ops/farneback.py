"""Pyramidal Farnebäck dense optical flow in plain JAX (XLA fuses the stencils).

Device replacement for ``cv2.calcOpticalFlowFarneback`` as invoked by the
reference (``Optical_flow/main.py:132-142``).  The semantics were pinned down
empirically against cv2 (see :mod:`datmo_using_optical_flow.oracle.np_farneback`
and tests/test_farneback.py); this module expresses them as XLA ops:

* **channel-first layouts**: coefficient/matrix planes are ``(5, H, W)``, so
  the contiguous dimension is W;
* **shift-add separable correlations**, which XLA fuses into elementwise
  chains;
* flow-compensated warping as flat linear gathers per bilinear corner;
* pyramid levels as a static Python loop — every shape static at trace time.

Everything is jit/vmap-compatible: batching over frame pairs is
:func:`farneback_flow_batched`.  The flow components travel as separate (H, W)
arrays internally; the public API returns OpenCV-compatible ``(H, W, 2)``.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from datmo_using_optical_flow.config import FarnebackConfig
from datmo_using_optical_flow.oracle.np_farneback import (
    BORDER,
    BORDER_ATTEN,
    gaussian_kernel,
    level_sizes,
    prepare_gaussian,
)


# ------------------------------------------------------------------ primitives

def _corr_axis(img: jnp.ndarray, kernel: np.ndarray, axis: int,
               pad_mode: str = "edge") -> jnp.ndarray:
    """1-D correlation along ``axis`` via shift-and-add.

    ``kernel`` is a static numpy array; taps with weight 0 are skipped.
    Works on arrays of any rank; ``axis`` counted from the end for flexibility.
    """
    k = np.asarray(kernel, dtype=np.float32)
    n = len(k) // 2
    size = img.shape[axis]
    pad = [(0, 0)] * img.ndim
    pad[axis] = (n, n)
    p = jnp.pad(img, pad, mode=pad_mode)
    out = None
    for i, w in enumerate(k):
        if w == 0.0:
            continue
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(i, i + size)
        term = np.float32(w) * p[tuple(sl)]
        out = term if out is None else out + term
    return out


def sep_filter(img: jnp.ndarray, ky: np.ndarray, kx: np.ndarray, pad_mode: str) -> jnp.ndarray:
    """Separable 2-D filter over the last two axes."""
    return _corr_axis(_corr_axis(img, ky, -2, pad_mode), kx, -1, pad_mode)


def gaussian_blur(img: jnp.ndarray, ksize: int, sigma: float) -> jnp.ndarray:
    """cv2.GaussianBlur (BORDER_REFLECT_101) — used in pyramid level prep."""
    k = gaussian_kernel(ksize, sigma).astype(np.float32)
    if len(k) == 1:
        return img
    return sep_filter(img, k, k, "reflect")


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """cv2.resize INTER_LINEAR (pixel-center convention), float path.

    Operates on the last two axes of (..., H, W).  Static sampling grids, so the
    per-axis interpolation compiles to two weighted static-index gathers.
    """
    h, w = img.shape[-2], img.shape[-1]
    if (out_h, out_w) == (h, w):
        return img
    sy, sx = h / out_h, w / out_w
    fy = (np.arange(out_h) + 0.5) * sy - 0.5
    fx = (np.arange(out_w) + 0.5) * sx - 0.5
    y0 = np.clip(np.floor(fy).astype(np.int32), 0, max(h - 2, 0))
    x0 = np.clip(np.floor(fx).astype(np.int32), 0, max(w - 2, 0))
    wy = np.clip(fy - y0, 0.0, 1.0).astype(np.float32) if h > 1 else np.zeros(out_h, np.float32)
    wx = np.clip(fx - x0, 0.0, 1.0).astype(np.float32) if w > 1 else np.zeros(out_w, np.float32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    rows0 = jnp.take(img, y0, axis=-2)
    rows1 = jnp.take(img, y1, axis=-2)
    wyj = jnp.asarray(wy)[:, None]
    v = rows0 * (1 - wyj) + rows1 * wyj
    # column pass via transpose + row-take: identical arithmetic to a
    # minor-axis take, so the values are bit-equal to the direct form
    vt = jnp.swapaxes(v, -1, -2)
    cols0 = jnp.swapaxes(jnp.take(vt, x0, axis=-2), -1, -2)
    cols1 = jnp.swapaxes(jnp.take(vt, x1, axis=-2), -1, -2)
    wxj = jnp.asarray(wx)
    return cols0 * (1 - wxj) + cols1 * wxj


# ------------------------------------------------------------------ poly expansion

def poly_exp(img: jnp.ndarray, n: int, sigma: float) -> jnp.ndarray:
    """Quadratic polynomial expansion -> (5, H, W) coefficient planes.

    Channels (validated vs cv2): [y-linear, x-linear, y², x², xy] scaled by the
    inverse-Gram entries (ig11/ig03/ig33/ig55) exactly as OpenCV computes them.
    """
    g, xg, xxg, invG = prepare_gaussian(n, sigma)
    ig11, ig03, ig33, ig55 = (np.float32(invG[1, 1]), np.float32(invG[0, 3]),
                              np.float32(invG[3, 3]), np.float32(invG[5, 5]))
    # vertical pass: three smoothed row planes from one padded image
    pv = jnp.pad(img, ((n, n), (0, 0)), mode="edge")
    h, w = img.shape
    row_g = row_xg = row_xxg = None
    for i in range(2 * n + 1):
        sl = pv[i:i + h]
        tg = np.float32(g[i]) * sl
        row_g = tg if row_g is None else row_g + tg
        if xg[i] != 0.0:
            t = np.float32(xg[i]) * sl
            row_xg = t if row_xg is None else row_xg + t
        t2 = np.float32(xxg[i]) * sl
        row_xxg = t2 if row_xxg is None else row_xxg + t2

    def corr_x(a, kern):
        return _corr_axis(a, kern.astype(np.float32), -1, "edge")

    b1 = corr_x(row_g, g)
    b2 = corr_x(row_g, xg)
    b3 = corr_x(row_xg, g)
    b4 = corr_x(row_g, xxg)
    b5 = corr_x(row_xxg, g)
    b6 = corr_x(row_xg, xg)

    return jnp.stack([
        b3 * ig11,                 # y-linear
        b2 * ig11,                 # x-linear
        b1 * ig03 + b5 * ig33,     # y^2
        b1 * ig03 + b4 * ig33,     # x^2
        b6 * ig55,                 # xy
    ], axis=0)


# ------------------------------------------------------------------ matrices / solve

def _border_scale(h: int, w: int) -> np.ndarray:
    """Certainty attenuation within BORDER=5 pixels of each edge (static)."""
    def axis_scale(size):
        idx = np.arange(size)
        near = np.minimum(idx, size - 1 - idx)
        return np.where(near < BORDER, BORDER_ATTEN[np.minimum(near, BORDER - 1)], 1.0)

    return (axis_scale(h)[:, None] * axis_scale(w)[None, :]).astype(np.float32)


def pack_corner_pairs(R1: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pack ALL four bilinear corners of all five channels into 28-byte rows so
    :func:`update_matrices` fetches everything with ONE gather per pixel.

    One 28-byte row per pixel instead of twenty 4-byte gathers: the warp's
    cost is set by gather count.  Layout per grid position s (7 f32 words,
    row-major table (H*W, 7)):

    * words 0-1: channel 0 (y-linear) corners (A,B) / (C,D) as int16 pairs
    * words 2-3: channel 1 (x-linear) likewise
    * words 4-6: channels 2-4 (y², x², xy), all four corners as int8 bytes

    int16 for the linear channels (they enter the Δb difference directly) and
    int8 for the quadratic ones (averaged and blurred) measures worst-case EPE
    0.056 px vs cv2 — indistinguishable from all-int16 (0.055 px; the tail is
    degenerate-determinant pixels, not quantization).  Corners:
    A = R1(y,x), B = (y,x+1), C = (y+1,x), D = (y+1,x+1), edge-replicated.
    Returns ``(table (H*W, 7) f32-typed, scale (5,))``.
    """
    c, h, w = R1.shape
    right = jnp.concatenate([R1[:, :, 1:], R1[:, :, -1:]], axis=2)
    down = jnp.concatenate([R1[:, 1:, :], R1[:, -1:, :]], axis=1)
    downright = jnp.concatenate([right[:, 1:, :], right[:, -1:, :]], axis=1)
    corners = jnp.stack([R1, right, down, downright])  # (4, 5, H, W)

    absmax = jnp.max(jnp.abs(R1), axis=(1, 2))  # (5,)
    qmax = jnp.asarray([32767.0, 32767.0, 127.0, 127.0, 127.0], jnp.float32)
    scale = jnp.maximum(absmax, 1e-20) / qmax  # (5,)
    q = jnp.clip(jnp.round(corners / scale[None, :, None, None]),
                 -qmax[None, :, None, None], qmax[None, :, None, None])

    def u16(x):
        return jax.lax.bitcast_convert_type(x.astype(jnp.int16), jnp.uint16).astype(jnp.uint32)

    def u8(x):
        return jax.lax.bitcast_convert_type(x.astype(jnp.int8), jnp.uint8).astype(jnp.uint32)

    words = [
        (u16(q[0, 0]) << 16) | u16(q[1, 0]),            # ch0: A|B
        (u16(q[2, 0]) << 16) | u16(q[3, 0]),            # ch0: C|D
        (u16(q[0, 1]) << 16) | u16(q[1, 1]),            # ch1: A|B
        (u16(q[2, 1]) << 16) | u16(q[3, 1]),            # ch1: C|D
    ]
    for ch in (2, 3, 4):
        words.append((u8(q[0, ch]) << 24) | (u8(q[1, ch]) << 16)
                     | (u8(q[2, ch]) << 8) | u8(q[3, ch]))
    table = jnp.stack([jax.lax.bitcast_convert_type(wd, jnp.float32)
                       for wd in words], axis=-1)  # (H, W, 7)
    return table.reshape(h * w, 7), scale


def _unpack_warp(g: jnp.ndarray, scale: jnp.ndarray, a00, a01, a10, a11):
    """Bilinear-combine the packed corners: (N, 7) rows -> list of 5 (N,) values."""
    u = jax.lax.bitcast_convert_type(g, jnp.uint32)  # (N, 7)

    def i16(word, hi):
        v = (word >> 16) if hi else word
        return jax.lax.bitcast_convert_type(v.astype(jnp.uint16), jnp.int16).astype(jnp.float32)

    def i8(word, byte):
        v = word >> (24 - 8 * byte)
        return jax.lax.bitcast_convert_type(v.astype(jnp.uint8), jnp.int8).astype(jnp.float32)

    out = []
    for ch, (wa, wb) in enumerate(((0, 1), (2, 3))):
        r = (a00 * i16(u[:, wa], True) + a01 * i16(u[:, wa], False)
             + a10 * i16(u[:, wb], True) + a11 * i16(u[:, wb], False))
        out.append(r * scale[ch])
    for j, ch in enumerate((2, 3, 4)):
        word = u[:, 4 + j]
        r = (a00 * i8(word, 0) + a01 * i8(word, 1)
             + a10 * i8(word, 2) + a11 * i8(word, 3))
        out.append(r * scale[ch])
    return out


def update_matrices(R0: jnp.ndarray, R1: jnp.ndarray, dx: jnp.ndarray,
                    dy: jnp.ndarray,
                    R1_packed: tuple[jnp.ndarray, jnp.ndarray] | None = None
                    ) -> jnp.ndarray:
    """Flow-compensated normal-equation planes M (5, H, W).

    The bilinear warp of R1 is flat linear gathers over (5, H*W).  When
    ``R1_packed`` (from :func:`pack_corner_pairs`) is given, both x-corners come
    from one gather at int16 fixed-point precision (~2x faster warp, worst-case
    ~5e-3 px EPE cost against the 0.1 px budget).
    """
    _, h, w = R0.shape
    xs = jnp.arange(w, dtype=dx.dtype)[None, :]
    ys = jnp.arange(h, dtype=dx.dtype)[:, None]
    fx = xs + dx
    fy = ys + dy
    x1 = jnp.floor(fx)
    y1 = jnp.floor(fy)
    fx = fx - x1
    fy = fy - y1
    x1i = x1.astype(jnp.int32)
    y1i = y1.astype(jnp.int32)
    inside = (x1i >= 0) & (x1i < w - 1) & (y1i >= 0) & (y1i < h - 1)
    x1c = jnp.clip(x1i, 0, max(w - 2, 0))
    y1c = jnp.clip(y1i, 0, max(h - 2, 0))

    base = (y1c * w + x1c).reshape(-1)
    a00 = ((1 - fx) * (1 - fy))[None]
    a01 = (fx * (1 - fy))[None]
    a10 = ((1 - fx) * fy)[None]
    a11 = (fx * fy)[None]
    if R1_packed is not None:
        table, scale = R1_packed
        rows_g = table[base]  # ONE gather: (h*w, 7) 28-byte rows
        flat_w = (a00.reshape(-1), a01.reshape(-1), a10.reshape(-1), a11.reshape(-1))
        vals = _unpack_warp(rows_g, scale, *flat_w)
        r = jnp.stack([v.reshape(h, w) for v in vals], axis=0)
    else:
        flat = R1.reshape(5, h * w)

        def take(offset):
            return flat[:, base + offset].reshape(5, h, w)

        r = a00 * take(0) + a01 * take(1) + a10 * take(w) + a11 * take(w + 1)

    r2 = jnp.where(inside, r[0], 0.0)
    r3 = jnp.where(inside, r[1], 0.0)
    r4 = jnp.where(inside, (R0[2] + r[2]) * 0.5, R0[2])
    r5 = jnp.where(inside, (R0[3] + r[3]) * 0.5, R0[3])
    r6 = jnp.where(inside, (R0[4] + r[4]) * 0.25, R0[4] * 0.5)
    r2 = (R0[0] - r2) * 0.5
    r3 = (R0[1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    scale = jnp.asarray(_border_scale(h, w))
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
    return jnp.stack([
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    ], axis=0)


def box_blur5(M: jnp.ndarray, winsize: int) -> jnp.ndarray:
    """Normalized box filter (BORDER_REPLICATE) over (5, H, W), separable shift-add."""
    ones = np.ones(winsize, dtype=np.float32)
    out = _corr_axis(_corr_axis(M, ones, -2, "edge"), ones, -1, "edge")
    return out * np.float32(1.0 / (winsize * winsize))


def gauss_blur5(M: jnp.ndarray, winsize: int) -> jnp.ndarray:
    """OPTFLOW_FARNEBACK_GAUSSIAN aggregation: separable normalized Gaussian with
    sigma = (winsize//2)*0.3, BORDER_REPLICATE (validated vs cv2 flags=256)."""
    m = winsize // 2
    x = np.arange(-m, m + 1, dtype=np.float64)
    sigma = m * 0.3
    g = np.exp(-x * x / (2 * sigma * sigma))
    g = (g / g.sum()).astype(np.float32)
    return _corr_axis(_corr_axis(M, g, -2, "edge"), g, -1, "edge")


def solve_flow(Mb: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel 2x2 solve with OpenCV's +1e-3 determinant regularizer."""
    g11, g12, g22, h1, h2 = Mb[0], Mb[1], Mb[2], Mb[3], Mb[4]
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return (g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet


def farneback_level(R0: jnp.ndarray, R1: jnp.ndarray, dx: jnp.ndarray, dy: jnp.ndarray,
                    winsize: int, iterations: int, fast_warp: bool = False,
                    gaussian: bool = False) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One pyramid level: iterations x (matrices -> blur -> solve)."""
    blur = gauss_blur5 if gaussian else box_blur5
    packed = pack_corner_pairs(R1) if fast_warp else None
    M = update_matrices(R0, R1, dx, dy, packed)
    for i in range(iterations):
        dx, dy = solve_flow(blur(M, winsize))
        if i < iterations - 1:
            M = update_matrices(R0, R1, dx, dy, packed)
    return dx, dy


# ------------------------------------------------------------------ pyramid driver

def build_pyramid(im, pyr_scale, levels, poly_n, poly_sigma):
    """Per-level polynomial-expansion planes for one frame.

    Returns a tuple of (5, lh, lw) coefficient arrays, coarsest-first (the
    order :func:`flow_from_pyramids` consumes).  Splitting this out of the
    flow lets a streaming runner compute each frame's pyramid ONCE and carry
    it to the next step — the reference preprocesses every PCD twice per pair
    (``Optical_flow/main.py:568-569``); pair-mode :func:`farneback_flow`
    likewise re-expands frame t for pairs (t-1, t) and (t, t+1).
    """
    h, w = im.shape
    out = []
    for k, scale, lh, lw in level_sizes(h, w, pyr_scale, levels):
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(int(round(sigma * 5)) | 1, 3)
        f = gaussian_blur(im.astype(jnp.float32), smooth_sz, sigma)
        f = resize_bilinear(f, lh, lw)
        out.append(poly_exp(f, poly_n, poly_sigma))
    return tuple(out)


def flow_from_pyramids(pyr1, pyr2, pyr_scale, winsize, iterations,
                       fast_warp=False, gaussian=False, flow0=None):
    """Pyramidal Farnebäck refinement over precomputed coefficient pyramids."""
    dx = dy = None
    for k, (R0, R1) in enumerate(zip(pyr1, pyr2)):
        _, lh, lw = R0.shape
        if dx is None:
            if flow0 is not None:  # OPTFLOW_USE_INITIAL_FLOW
                scale = np.float32(pyr_scale ** (len(pyr1) - 1))
                f0 = jnp.moveaxis(flow0.astype(jnp.float32), -1, 0)  # (2, H, W)
                f0 = resize_bilinear(f0, lh, lw) * scale
                dx, dy = f0[0], f0[1]
            else:
                dx = jnp.zeros((lh, lw), dtype=jnp.float32)
                dy = jnp.zeros((lh, lw), dtype=jnp.float32)
        else:
            inv = np.float32(1.0 / pyr_scale)
            dx = resize_bilinear(dx, lh, lw) * inv
            dy = resize_bilinear(dy, lh, lw) * inv
        dx, dy = farneback_level(R0, R1, dx, dy, winsize, iterations,
                                 fast_warp, gaussian)
    return jnp.stack([dx, dy], axis=-1)


def _farneback_impl(im1, im2, pyr_scale, levels, winsize, iterations, poly_n,
                    poly_sigma, fast_warp=False, gaussian=False, flow0=None):
    pyr1 = build_pyramid(im1, pyr_scale, levels, poly_n, poly_sigma)
    pyr2 = build_pyramid(im2, pyr_scale, levels, poly_n, poly_sigma)
    return flow_from_pyramids(pyr1, pyr2, pyr_scale, winsize, iterations,
                              fast_warp, gaussian, flow0)


_farneback = jax.jit(_farneback_impl,
                     static_argnames=("pyr_scale", "levels", "winsize", "iterations",
                                      "poly_n", "poly_sigma", "fast_warp",
                                      "gaussian"))

OPTFLOW_USE_INITIAL_FLOW = 4     # cv2 flag values
OPTFLOW_FARNEBACK_GAUSSIAN = 256


def farneback_flow(im1: jnp.ndarray, im2: jnp.ndarray,
                   cfg: FarnebackConfig = FarnebackConfig(),
                   fast_warp: bool = False,
                   flow0: jnp.ndarray | None = None) -> jnp.ndarray:
    """Dense flow im1 -> im2; returns (H, W, 2) [dx, dy] in pixels/frame.

    Drop-in equivalent of the reference's ``cv2.calcOpticalFlowFarneback(bev1, bev2,
    None, **farneback_params)`` (``Optical_flow/main.py:142``).  ``cfg.flags``
    honors cv2's OPTFLOW_FARNEBACK_GAUSSIAN (Gaussian window aggregation) and
    OPTFLOW_USE_INITIAL_FLOW (seed from ``flow0``).  ``fast_warp`` trades
    exactness (worst-case ~5e-2 px EPE vs ~3e-5) for a ~2x faster warp stage via
    packed int16 corner pairs.
    """
    gaussian = bool(cfg.flags & OPTFLOW_FARNEBACK_GAUSSIAN)
    if (cfg.flags & OPTFLOW_USE_INITIAL_FLOW) and flow0 is None:
        raise ValueError("flags request OPTFLOW_USE_INITIAL_FLOW but flow0 is None")
    init = flow0 if (cfg.flags & OPTFLOW_USE_INITIAL_FLOW) else None
    return _farneback(im1, im2, cfg.pyr_scale, cfg.levels, cfg.winsize,
                      cfg.iterations, cfg.poly_n, cfg.poly_sigma, fast_warp,
                      gaussian, init)


def farneback_flow_batched(im1: jnp.ndarray, im2: jnp.ndarray,
                           cfg: FarnebackConfig = FarnebackConfig(),
                           fast_warp: bool = False) -> jnp.ndarray:
    """Flow over a leading batch of frame pairs: (B, H, W) -> (B, H, W, 2),
    the pairs issued one after another inside one program."""
    fn = lambda a, b: _farneback_impl(a, b, cfg.pyr_scale, cfg.levels, cfg.winsize,
                                      cfg.iterations, cfg.poly_n, cfg.poly_sigma,
                                      fast_warp)

    @jax.jit
    def run(a, b):
        return jnp.stack([fn(a[i], b[i]) for i in range(a.shape[0])])

    return run(im1, im2)
