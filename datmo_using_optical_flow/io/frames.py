"""Frame sources: stream fixed-capacity padded point buffers to the device.

The reference consumes sorted lists of ``.pcd`` paths in a synchronous Python loop
(``Optical_flow/main.py:561-569``, ``GMFA/GMFA.py:446-455``).  Here the host side
produces statically-shaped ``(max_points, 3)`` buffers + validity masks so the device
program compiles once, and a double-buffered prefetcher overlaps disk decode with
device compute.
"""

from __future__ import annotations

import os
import re
from typing import Iterator, Sequence

import numpy as np

from datmo_using_optical_flow.io.pcd import read_pcd


def pad_points(points: np.ndarray, capacity: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Pad an (N, 3) array to ``(capacity, 3)`` and return (padded, validity_mask).

    If N > capacity, points are truncated (with a warning) — capacities should be
    sized from :class:`~datmo_using_optical_flow.config.CapacityConfig`.
    Padding rows are filled with a far-away sentinel so they fall outside every ROI.
    """
    points = np.asarray(points, dtype=dtype)
    n = points.shape[0]
    if n > capacity:
        import warnings

        warnings.warn(f"pad_points: truncating {n} points to capacity {capacity}")
        points = points[:capacity]
        n = capacity
    out = np.full((capacity, 3), 1e9, dtype=dtype)
    out[:n] = points
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return out, mask


# fixed-point H2D quantization: where the host->device link binds the
# from-points path (the ROI spans +-20 m with cm-scale
# sensor noise), int16 at 2^-10 m/LSB (0.98 mm, +-32 m range) halves the raw
# point bytes.  Dequantization (q * 2^-10) is exact in f32, so the only
# deviation from the f32 path is the +-0.5 mm host-side rounding — far below
# the scene's 10 mm sensor noise and the densifier's 10 mm jitter.  Opt-in.
Q16_SCALE = np.float32(1.0 / 1024.0)
_Q16_SENTINEL = np.int16(32767)  # dequantizes to ~32 m: outside every ROI


def quantize_points_q16(points: np.ndarray) -> np.ndarray:
    """(N, 3) float meters -> int16 fixed point at 2^-10 m/LSB (clipped).

    Host-side f32 arithmetic: the scale is a power of two so the division is
    exact, and an f32 rint at |q| <= 32767 is within half an LSB of the f64
    answer — this path is lossy by design and the f64 pass cost real host
    time on the 1-CPU container."""
    q = np.rint(np.asarray(points, np.float32) * np.float32(1.0 / Q16_SCALE))
    return np.clip(q, -32768, 32767).astype(np.int16)


def dequantize_points_q16(q):
    """Device-side exact dequantization (int16 * 2^-10 -> f32 meters)."""
    return q.astype(np.float32) * Q16_SCALE


def pad_points_q16(points: np.ndarray, capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """:func:`pad_points` with int16 fixed-point payload (half the H2D bytes)."""
    points = quantize_points_q16(points)
    n = points.shape[0]
    if n > capacity:
        import warnings

        warnings.warn(f"pad_points_q16: truncating {n} points to capacity {capacity}")
        points = points[:capacity]
        n = capacity
    out = np.full((capacity, 3), _Q16_SENTINEL, dtype=np.int16)
    out[:n] = points
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return out, mask


def natsort_key(path: str):
    """Natural-order sort key (the reference uses ``natsorted`` at ``GMFA/GMFA.py:446``)."""
    return [int(tok) if tok.isdigit() else tok for tok in re.split(r"(\d+)", os.path.basename(path))]


class DiskFrameSource:
    """Iterates PCD frames from disk as padded device-ready buffers.

    A pool of decode workers pads upcoming frames while the device consumes the
    current one (the streaming-runner half of SURVEY.md §1's layer (c)); the
    native C++ decoder releases the GIL during ctypes calls, so workers scale.
    Frames are delivered strictly in order regardless of decode completion order.
    """

    def __init__(self, pcd_files: Sequence[str] | None = None, folder: str | None = None,
                 capacity: int = 65536, prefetch: int = 4, workers: int = 2,
                 dtype=np.float32, quantize_q16: bool = False):
        """``quantize_q16``: deliver int16 fixed-point buffers (2^-10 m/LSB)
        instead of f32 — half the H2D bytes on link-bound deployments; the
        pipelines' preprocess dequantizes on device (see ``Q16_SCALE``)."""
        if pcd_files is None:
            if folder is None:
                raise ValueError("provide pcd_files or folder")
            pcd_files = [os.path.join(folder, f) for f in os.listdir(folder) if f.endswith(".pcd")]
            pcd_files = sorted(pcd_files, key=natsort_key)
        self.pcd_files = list(pcd_files)
        self.capacity = capacity
        self.prefetch = max(1, prefetch)
        self.workers = max(1, workers)
        self.dtype = dtype
        self.quantize_q16 = quantize_q16

    def __len__(self) -> int:
        return len(self.pcd_files)

    def _load(self, path: str) -> tuple[np.ndarray, np.ndarray]:
        try:
            points = read_pcd(path, dtype=self.dtype)
        except Exception as e:  # noqa: BLE001
            # a corrupt frame must not kill the stream (reference skip semantics,
            # Optical_flow/main.py:635-637): deliver an empty frame — downstream
            # produces a zero BEV / no moving points and the pair is skipped
            print(f"Error decoding {path}: {e}")
            points = np.zeros((0, 3), self.dtype)
        if self.quantize_q16:
            return pad_points_q16(points, self.capacity)
        return pad_points(points, self.capacity, self.dtype)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        from concurrent.futures import ThreadPoolExecutor

        n = len(self.pcd_files)
        if n == 0:
            return
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            window = self.prefetch
            futures = {i: pool.submit(self._load, self.pcd_files[i])
                       for i in range(min(window, n))}
            for i in range(n):
                item = futures.pop(i).result()
                nxt = i + window
                if nxt < n:
                    futures[nxt] = pool.submit(self._load, self.pcd_files[nxt])
                yield item
