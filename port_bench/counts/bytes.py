"""Device-memory bytes the hand-written kernels need, from the call sites'
shapes in the reference networks.

Each input byte is counted read once and each output byte written once.
K1 (bias + LeakyReLU forward) reads x and its bias and writes y at the
prior's call sites: the 8 style-MLP layers over the slots' styles and the
11 styled convs. K1b (its backward) reads x, the incoming gradient and the
bias and writes dx at the same sites. K2 (the SFT write-back) reads the
canvas, the residual of every canvas column that a valid window covers
(each such column has one winner) and the window tables, and writes the
canvas.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from port_bench.reference.nets import _PYRAMID, prior_channels, scaled


def k1_sites(width: float = 1.0) -> List[tuple]:
    """(elements per slot, channels) of each K1 call site of the prior."""
    ch = prior_channels(width)
    sdim = scaled(512, width, floor=32, multiple=4)
    sites = [(sdim, sdim)] * 8 + [(ch[4] * 16, ch[4])]
    for res in _PYRAMID:
        sites += [(ch[res] * res * res, ch[res])] * 2
    return sites


def k1_bytes(slots: int, dtype_bytes: int, width: float = 1.0) -> float:
    """K1's bytes over one prior forward of ``slots`` slots."""
    return sum((2 * slots * n + c) * dtype_bytes for n, c in k1_sites(width))


def k1b_bytes(slots: int, dtype_bytes: int, width: float = 1.0) -> float:
    """K1b's bytes over one prior backward of ``slots`` slots."""
    return sum((3 * slots * n + c) * dtype_bytes for n, c in k1_sites(width))


def covered_columns(centers: Sequence[float], half: int, width: int) -> int:
    """Canvas columns that some window of the given float32 center locs
    covers (the reference's window rule)."""
    cover = np.zeros(width, bool)
    for loc in centers:
        c = int(np.floor(np.float32(loc) * np.float32(width)))
        x1 = 0 if c < half else c - half
        x2 = width if c + half > width else c + half
        cover[x1:max(x1, x2)] = True
    return int(cover.sum())


def k2_bytes(rows: int, slots: int, lines: Iterable[Sequence[float]],
             dtype_bytes: int, width: float = 1.0) -> float:
    """K2's bytes over one restore of ``rows`` rows with ``slots`` slots,
    whose real lines have the given center locs: both SFT scales."""
    d = prior_channels(width)[64]
    lines = list(lines)
    total = 0.0
    for h, w, half in ((32, 512, 16), (64, 1024, 32)):
        cov = sum(covered_columns(c, half, w) for c in lines)
        total += (2 * rows * h * w * d + cov * h * d) * dtype_bytes
        total += 3 * rows * slots * 4
    return total
