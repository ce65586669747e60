"""Bilinear resize with PyTorch `F.interpolate` semantics (counterpart of
pidnet_tpu/ops/resize.py).

The network mixes both align_corners modes: False for every interior
resize, True at eval time (MODEL.ALIGN_CORNERS) and in tools/custom.
`source_taps` is torch's float32 source-index arithmetic, the same that
the CUDA kernels share (csrc/bilinear.cuh); `_interp_matrix` builds from
it the dense 1-D operator the JAX package builds, which the plain backward
of the fused loss front (ops/ce_front.py) applies.

Under H-sharding (parallel/spatial.py) a resize computes a window of the
output rows of a taller image from a slice of its source rows: `Rows`
names the window, `window_taps` gives each of its rows the whole image's
taps, `window_matrix` its rows of the dense operator, and `resize_rows`
resizes an NCHW slice to the window, the rows that the whole image's
resize gives there.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


def source_taps(in_size: int, out_size: int, align_corners: bool):
    """(i0, i1, lambda1) of every output index, torch's upsample_bilinear2d
    source index in float32:

    align_corners=True:  src = i * (in-1)/(out-1)      (0 when out == 1)
    align_corners=False: src = max(0, (i+0.5) * in/out - 0.5)

    i0 = min(floor(src), in-1), i1 = min(i0+1, in-1), lambda1 = src - i0."""
    i = np.arange(out_size, dtype=np.float32)
    if align_corners:
        scale = np.float32(0)
        if out_size > 1:
            scale = np.float32(in_size - 1) / np.float32(out_size - 1)
        src = i * scale
    else:
        scale = np.float32(in_size) / np.float32(out_size)
        src = np.maximum((i + np.float32(0.5)) * scale - np.float32(0.5), np.float32(0))
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, (src - i0).astype(np.float32)


@lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense (out_size, in_size) fp32 bilinear interpolation operator from
    `source_taps`; at the last tap both weights land on one column."""
    A = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == out_size:
        np.fill_diagonal(A, 1.0)
        return A
    i0, i1, w1 = source_taps(in_size, out_size, align_corners)
    w0 = 1.0 - w1
    np.add.at(A, (np.arange(out_size), i0), w0)
    np.add.at(A, (np.arange(out_size), i1), w1)
    return A


def interpolate(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor; the input itself when the size
    already matches."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[2:]) == (oh, ow):
        return x
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=align_corners)


def resize_bilinear(
    x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool
) -> torch.Tensor:
    """Bilinearly resize NHWC `x` to `out_hw` (NHWC out, same dtype)."""
    return interpolate(x.permute(0, 3, 1, 2), out_hw, align_corners).permute(0, 2, 3, 1)


class Rows(NamedTuple):
    """A window of output rows of an H resize whose source is a slice of
    the rows of a taller image: `src_size` global source rows, of which the
    local source's row 0 is global row `src_start` (negative where zero
    rows stand above the image), and `out_size` global output rows, of
    which the window's row 0 is global row `out_start`. The kernels take
    the four as their row arguments (csrc/bilinear.cuh's Rows)."""

    src_size: int
    src_start: int
    out_size: int
    out_start: int

    @staticmethod
    def whole(h: int, oh: int) -> "Rows":
        """The whole image: h source rows, oh output rows."""
        return Rows(h, 0, oh, 0)


def window_taps(rows: Rows, n_out: int, align_corners: bool):
    """(i0, i1, lambda1) of the window's `n_out` rows, from the whole
    image's `source_taps`, i0 and i1 as local source rows."""
    i0, i1, l1 = source_taps(rows.src_size, rows.out_size, align_corners)
    window = slice(rows.out_start, rows.out_start + n_out)
    return i0[window] - rows.src_start, i1[window] - rows.src_start, l1[window]


@lru_cache(maxsize=256)
def check_rows(rows: Rows, n_src: int, n_out: int, align_corners: bool) -> None:
    """Raise ValueError unless `rows` is a window of `n_out` output rows
    whose taps, both of each row's, read only the `n_src` local source
    rows."""
    if rows.out_start < 0 or rows.out_start + n_out > rows.out_size:
        raise ValueError(f"output rows [{rows.out_start}, {rows.out_start + n_out}) lie outside "
                         f"the image's {rows.out_size}")
    i0, i1, _ = window_taps(rows, n_out, align_corners)
    if n_out and (i0.min() < 0 or i1.max() >= n_src):
        raise ValueError(f"the taps of {rows} read local source rows [{int(i0.min())}, "
                         f"{int(i1.max()) + 1}) of {n_src}: the slice lacks halo rows")


@lru_cache(maxsize=64)
def window_matrix(rows: Rows, n_src: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_src) fp32: the window's rows of the whole image's dense
    operator (`_interp_matrix`), its columns the local source rows."""
    check_rows(rows, n_src, n_out, align_corners)
    a = _interp_matrix(rows.src_size, rows.out_size, align_corners)
    cols = np.arange(rows.src_start, rows.src_start + n_src)
    inside = (cols >= 0) & (cols < rows.src_size)
    out = np.zeros((n_out, n_src), np.float32)
    out[:, inside] = a[rows.out_start:rows.out_start + n_out, cols[inside]]
    return out


def resize_rows(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool,
                rows: Rows) -> torch.Tensor:
    """The window `rows` of the bilinear resize of an image to out_hw[0]
    of its rows and out_hw[1] columns, from NCHW `x`, a slice of its source
    rows: the W-lerp of each source row (F.interpolate), then each output
    row's H-lerp h0 top + h1 bot from its two taps, in fp32, cast back to
    x's dtype. Differentiable in x."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    check_rows(rows, x.shape[2], oh, align_corners)
    i0, i1, l1 = window_taps(rows, oh, align_corners)
    xf = x.float()
    if x.shape[3] != ow:
        xf = F.interpolate(xf, size=(x.shape[2], ow), mode="bilinear", align_corners=align_corners)
    h1 = torch.from_numpy(l1).to(x.device).view(1, 1, oh, 1)
    h0 = torch.from_numpy(np.float32(1) - l1).to(x.device).view(1, 1, oh, 1)
    top = xf.index_select(2, torch.from_numpy(i0).to(x.device))
    bot = xf.index_select(2, torch.from_numpy(i1).to(x.device))
    out = (h0 * top + h1 * bot).to(x.dtype)
    if x.is_contiguous(memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out
