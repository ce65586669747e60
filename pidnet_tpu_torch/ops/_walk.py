"""Block plans of the column-walk kernels (K1 in csrc/upsample_argmax.cu,
K2 in csrc/ce_front.cu), shared by ops/upsample_argmax.py and
ops/ce_front.py.

A walk kernel reads bilinear-upsampled logits. Each of its blocks owns a
band of output rows and a tile of output columns of one image, stages the
source pixels under their taps in shared memory, and walks the band's rows
with one thread (or `lpp` lanes) to each output column. `walk_plan` cuts
the output into those blocks; the kernels read the plan's band, tile,
lanes, window and threads. Under H-sharding the output is a window of rows
of a taller image (ops/resize.Rows), whose taps are the whole image's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from pidnet_tpu_torch.ops.resize import Rows, source_taps, window_taps

SMEM_OPT_IN = 232448  # 227 KB: the most shared memory an H100 block can opt in to
MIN_BLOCKS = 2 * 132  # two blocks on each of the H100's SMs
MAX_CLASSES = 32 * 32  # 32 lanes a pixel, 32 classes a lane
THREADS = 256  # the most threads of a walk block
BANDS = (64, 32, 16, 8, 4, 2)  # the bands a plan tries, largest first


def lanes_per_pixel(c: int, fn_name: str) -> int:
    """The fewest lanes, a power of two, that hold C classes in slices of
    at most 32; raises above 1024 classes."""
    if c > MAX_CLASSES:
        raise ValueError(f"{fn_name}: {c} classes, more than {MAX_CLASSES}")
    lpp = 1
    while -(-c // lpp) > 32:
        lpp *= 2
    return lpp


def class_slice(c: int, lpp: int) -> int:
    """The classes of one lane: ceil(C / lpp) rounded up to 4."""
    return (-(-c // lpp) + 3) // 4 * 4


def stage_bytes(c: int, window: int, lpp: int, itemsize: int) -> int:
    """Bytes of `window` staged pixels, each of lpp slices of `class_slice`
    slots, rounded up to 16."""
    return -(-window * lpp * class_slice(c, lpp) * itemsize // 16) * 16


def _spans(i0: np.ndarray, i1: np.ndarray, step: int):
    """(spans, 2) ranges [a, b) of `step` of the output indices whose taps
    are (i0, i1), and (spans, 2) the source ranges [i0(a), i1(b-1) + 1)
    their taps read."""
    a = np.arange(0, len(i0), step)
    b = np.minimum(a + step, len(i0))
    return np.stack([a, b], 1), np.stack([i0[a], i1[b - 1] + 1], 1)


class WalkPlan(NamedTuple):
    band: int  # output rows of a block
    tile: int  # output columns of a block
    lpp: int  # lanes that share a pixel, each with a slice of its classes
    rows: np.ndarray  # (bands, 2) output rows [a, b) of each band
    cols: np.ndarray  # (tiles, 2) output columns [a, b) of each tile
    src_rows: np.ndarray  # (bands, 2) source rows [r0, r1) each band stages
    src_cols: np.ndarray  # (tiles, 2) source columns [q0, q1) each tile stages
    window: int  # staged pixels a block has room for
    threads: int
    smem: int  # shared-memory bytes a block
    blocks: int


def walk_plan(n: int, h: int, w: int, oh: int, ow: int, align_corners: bool, lpp: int,
              smem_of, smem_target: int, rows: Rows | None = None) -> WalkPlan:
    """Blocks of a column walk: one per image, band of output rows and tile
    of output columns, each pixel owned by one block; lpp lanes to each of
    the tile's columns. The tile is the widest that fits 256 threads,
    evened out over the tiles. A block stages the source pixels under its
    taps, `src_rows` x `src_cols`; the kernel finds its own from the
    device's float32 taps, which may round by one ulp the other way at
    either end, so the window leaves room for two more rows and two more
    columns. The band is the largest of `BANDS` whose block needs at most
    `smem_target` bytes (`smem_of(window)`) and which still gives two
    blocks to each of the card's 132 SMs, else 1. `rows` (default the
    whole image) is the window of output rows the h local source rows
    serve; its rows' source ranges are local rows."""
    tile = -(-ow // -(-ow // (THREADS // lpp)))
    cols, src_cols = _spans(*source_taps(w, ow, align_corners)[:2], tile)
    nq = min(int((src_cols[:, 1] - src_cols[:, 0]).max()) + 2, w)
    row_taps = window_taps(rows or Rows.whole(h, oh), oh, align_corners)[:2]

    def window_of(band):
        spans, src_rows = _spans(*row_taps, band)
        return spans, src_rows, min(int((src_rows[:, 1] - src_rows[:, 0]).max()) + 2, h) * nq

    band = 1
    for cand in BANDS:
        spans, _, window = window_of(cand)
        if smem_of(window) <= smem_target and n * len(spans) * len(cols) >= MIN_BLOCKS:
            band = cand
            break
    spans, src_rows, window = window_of(band)
    threads = -(-tile * lpp // 32) * 32
    return WalkPlan(band, tile, lpp, spans, cols, src_rows, src_cols, window, threads,
                    smem_of(window), n * len(spans) * len(cols))
