"""Bilinear resize with PyTorch `F.interpolate` semantics (counterpart of
pidnet_tpu/ops/resize.py).

The network mixes both align_corners modes: False for every interior
resize, True at eval time (MODEL.ALIGN_CORNERS) and in tools/custom.
`source_taps` is torch's float32 source-index arithmetic, the same that
the CUDA kernels share (csrc/bilinear.cuh); `_interp_matrix` builds from
it the dense 1-D operator the JAX package builds, which the plain backward
of the fused loss front (ops/ce_front.py) applies.
"""

from __future__ import annotations

from functools import lru_cache

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
