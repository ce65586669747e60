"""Fused bilinear upsample + argmax for the class-map path (counterpart of
pidnet_tpu/ops/upsample_argmax.py).

Upsampling 1/8-resolution logits to the input size and argmaxing them as
two ops writes an (N, H, W, C) tensor to device memory only to reduce it
away again. The CUDA kernel (csrc/upsample_argmax.cu) is a column walk over
`plan`'s bands of output rows and tiles of output columns: each block
stages the source pixels under its taps in shared memory, and each output
column keeps the W-lerps of its two source rows in registers, so that a
pixel costs one FMA and one compare a class; only the (N, H, W) int32 map
is written. Ties go to the lowest class. exp() from the probability path
is dropped: it is monotonic, so the argmax does not change. What the walk
does not take (more than 1024 classes, or a window too large for a block's
shared memory) goes to the kernel's per-pixel form.

`upsample_argmax` launches a kernel for a CUDA tensor and raises on what
the kernels do not take; for a CPU tensor it runs the plain version,
`upsample_argmax_plain`. `upsample_argmax_rows` is the same for a window of
output rows of a taller image (H-sharding, parallel/spatial.py): the
logits are a slice of its rows with their halo and the taps the whole
image's (ops/resize.Rows); the whole image's window is `upsample_argmax`
itself. `launches` counts kernel launches of both, `window_launches` those
over a window other than the whole image.

The same function is the custom operator
`torch.ops.pidnet_tpu_torch.upsample_argmax(logits, oh, ow,
align_corners)`, registered when this module is imported, so that
`torch.export` records it as one node (convert/aot.py) and an exported
program runs K1 on the card and the plain version on the CPU. Its fake
returns the (N, oh, ow) int32 map; its launches count in `launches`.
"""

from __future__ import annotations

import contextlib
import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from pidnet_tpu_torch.ops._walk import (MAX_CLASSES, SMEM_OPT_IN, WalkPlan, lanes_per_pixel,
                                        stage_bytes, walk_plan)
from pidnet_tpu_torch.ops.resize import Rows, _interp_matrix, check_rows, window_matrix

launches = 0
window_launches = 0  # the launches over a window other than the whole image

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_SMEM_TARGET = 56 * 1024  # four blocks an SM
_fns: dict = {}


def upsample_argmax_plain(logits: torch.Tensor, out_hw, align_corners: bool,
                          rows: Rows | None = None) -> torch.Tensor:
    """(N,h,w,C) -> (N,oh,ow) int32: F.interpolate in fp32, then argmax
    (ties keep the lowest class). For a window `rows` other than the whole
    image, the upsample is the window's rows of the dense operators
    (ops/resize.window_matrix) instead."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    x = logits.permute(0, 3, 1, 2).float()
    if rows is None or rows == Rows.whole(x.shape[2], oh):
        up = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=align_corners)
    else:
        a = torch.from_numpy(window_matrix(rows, x.shape[2], oh, align_corners)).to(x.device)
        b = torch.from_numpy(_interp_matrix(x.shape[3], ow, align_corners)).to(x.device)
        up = torch.einsum("yi,ncij,xj->ncyx", a, x, b)
    return torch.argmax(up, dim=1).to(torch.int32)


@lru_cache(maxsize=64)
def plan(n: int, h: int, w: int, c: int, oh: int, ow: int, align_corners: bool,
         rows: Rows | None = None) -> WalkPlan | None:
    """The walk's blocks (ops/_walk.walk_plan), lpp lanes a pixel
    (`lanes_per_pixel`), with bands whose block fits in 56 KB of shared
    memory (four blocks an SM); None where the walk does not take the
    shape (more than 1024 classes, or a block that would need more than
    the opt-in), which the direct kernel then takes. The window is staged
    in fp32 whatever the logits' dtype, so the plan does not depend on it.
    `rows`: the window of output rows (default the whole image)."""
    if c > MAX_CLASSES:
        return None
    lpp = lanes_per_pixel(c, "upsample_argmax")
    p = walk_plan(n, h, w, oh, ow, align_corners, lpp,
                  lambda window: stage_bytes(c, window, lpp, 4), _SMEM_TARGET, rows)
    return p if p.smem <= SMEM_OPT_IN else None


def _kernel_fn(name: str):
    if name not in _fns:
        from pidnet_tpu_torch.ops._build import library

        fn = getattr(library("upsample_argmax"), name)
        n_ints = 11 if "direct" in name else 16
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * n_ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def upsample_argmax(logits: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    """(N,h,w,C) float logits -> (N,oh,ow) int32 class map.

    On a CUDA tensor (contiguous NHWC, bf16 or fp32) this launches the
    walk on `plan`'s blocks, or the direct kernel where the plan is None;
    on a CPU tensor it runs `upsample_argmax_plain`."""
    return upsample_argmax_rows(logits, out_hw, align_corners, None)


def upsample_argmax_rows(logits: torch.Tensor, out_hw, align_corners: bool,
                         rows: Rows | None) -> torch.Tensor:
    """`upsample_argmax` over the window `rows` (ops/resize.Rows; None:
    the whole image): (N,h,w,C) logits, h local source rows, -> the
    window's (N,oh,ow) int32 class map, the rows that the whole image's map
    holds there. Raises ValueError where the window's taps leave the h
    rows. A CUDA tensor launches the windowed kernel, a CPU tensor runs
    the plain version."""
    global launches, window_launches
    if logits.device.type == "cpu":
        return upsample_argmax_plain(logits, out_hw, align_corners, rows)
    if logits.device.type != "cuda":
        raise ValueError(f"upsample_argmax: unsupported device {logits.device}")
    if logits.dim() != 4:
        raise ValueError(f"upsample_argmax: expected (N,h,w,C) logits, got {tuple(logits.shape)}")
    if logits.dtype not in _SUFFIX:
        raise TypeError(f"upsample_argmax: dtype {logits.dtype} not in (bfloat16, float32)")
    if not logits.is_contiguous():
        raise ValueError("upsample_argmax: logits must be contiguous NHWC")
    n, h, w, c = logits.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if min(n, h, w, c, oh, ow) < 1:
        raise ValueError(f"upsample_argmax: empty shape {tuple(logits.shape)} -> {(oh, ow)}")
    align = int(bool(align_corners))
    window = None
    if rows is None:
        rows = (h, 0, oh, 0)
    else:
        rows = Rows(*(int(v) for v in rows))
        check_rows(rows, h, oh, bool(align_corners))
        window = None if rows == Rows.whole(h, oh) else rows
    p = plan(n, h, w, c, oh, ow, bool(align_corners), window)
    suffix = _SUFFIX[logits.dtype]
    # switch devices only where needed: the switch's host time shows in
    # back-to-back launches
    on = (contextlib.nullcontext() if logits.device.index == torch.cuda.current_device()
          else torch.cuda.device(logits.device))
    with on:
        out = torch.empty((n, oh, ow), dtype=torch.int32, device=logits.device)
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        if p is None:
            err = _kernel_fn(f"upsample_argmax_direct_{suffix}")(
                logits.data_ptr(), out.data_ptr(), n, h, w, c, oh, ow, *rows, align, stream)
        else:
            err = _kernel_fn(f"upsample_argmax_{suffix}")(
                logits.data_ptr(), out.data_ptr(), n, h, w, c, oh, ow, *rows, align, p.band,
                p.tile, p.lpp, p.window, p.threads, stream)
    if err != 0:
        raise RuntimeError(f"upsample_argmax kernel launch failed: cudaError {err}")
    launches += 1
    window_launches += window is not None
    return out


@torch.library.custom_op("pidnet_tpu_torch::upsample_argmax", mutates_args=())
def upsample_argmax_op(logits: torch.Tensor, oh: int, ow: int,
                       align_corners: bool) -> torch.Tensor:
    """`upsample_argmax` as a custom operator (see the module docstring)."""
    return upsample_argmax(logits, (oh, ow), align_corners)


@upsample_argmax_op.register_fake
def _upsample_argmax_fake(logits, oh, ow, align_corners):
    return logits.new_empty((logits.shape[0], oh, ow), dtype=torch.int32)
