"""Fused loss front: bilinear upsample + log-softmax + NLL, differentiable
in the logits (counterpart of pidnet_tpu/ops/ce_front.py).

The training objective evaluates cross-entropy at label resolution on
logits made at 1/8 resolution. Upsampling first writes an (N,H,W,C) tensor
to device memory and reads it back for the log-softmax, forward and
backward. The CUDA kernels (csrc/ce_front.cu) compute the per-pixel
ingredients straight from the low-resolution logits:

    forward:  nll = logsumexp_c(z) - z[label],  w = cw[label]
    backward: dL = A^T (g * (softmax(z) - onehot(label))) B

where z is the bilinear upsample of the logits (A, B the 1-D operators of
ops/resize.py) and g the gradient of the nll map. A pixel whose label is
the ignore label or outside [0, C) has nll = 0, w = 0 and no gradient, as
in the JAX package's XLA path (`_per_pixel_ce`). The weight map carries no
gradient.

`ce_maps` runs `ce_front_fwd` / `ce_front_bwd` inside a
`torch.autograd.Function`. Each launches its kernel for a CUDA tensor
(bf16 or fp32 logits, both align_corners modes, up to 1024 classes; fp32
arithmetic) and raises on what the kernel does not take; for a CPU tensor
it runs the plain version, `ce_front_fwd_plain` / `ce_front_bwd_plain`.
`fwd_launches` and `bwd_launches` count kernel launches. Both kernels write
each output element once, without atomics, so their outputs are the same
bit for bit from run to run; `forward_plan` and `backward_plan` cut the
work into their blocks.

Under H-sharding (parallel/spatial.py) every function here takes `rows`
(ops/resize.Rows, None for the whole image): the labels and maps are a
window of output rows of a taller image, the logits a slice of its rows
with their halo, and the taps the whole image's; the backward's gradient
covers the slice's rows, the halo rows included. `fwd_window_launches` and
`bwd_window_launches` count the launches over a window other than the
whole image.
"""

from __future__ import annotations

import contextlib
import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from pidnet_tpu_torch.ops._walk import (MIN_BLOCKS, SMEM_OPT_IN, THREADS, WalkPlan,
                                        class_slice, lanes_per_pixel, stage_bytes,
                                        walk_plan)
from pidnet_tpu_torch.ops.resize import (Rows, _interp_matrix, check_rows, interpolate,
                                         source_taps, window_matrix, window_taps)

fwd_launches = 0
bwd_launches = 0
# the launches over a window other than the whole image
fwd_window_launches = 0
bwd_window_launches = 0

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_SMEM_TARGET = 113 * 1024  # two backward blocks an SM
BWD_THREADS = 256  # the most threads of a backward block (kBwdThreads)
FWD_THREADS = THREADS  # the most threads of a forward block (kFwdThreads)
_FWD_SMEM_TARGET = 72 * 1024  # three forward blocks an SM
_fns: dict = {}


def class_weights_on(class_weights, c: int, device) -> torch.Tensor:
    """(C,) fp32 class weights on `device`; None means ones. A tensor that
    is already there is returned as it is; anything else is copied from
    the host, a copy that waits for the device."""
    if class_weights is None:
        return torch.ones(c, dtype=torch.float32, device=device)
    return torch.as_tensor(class_weights, dtype=torch.float32, device=device)


def _z(logits: torch.Tensor, out_hw, align_corners: bool, rows: Rows | None = None):
    """(N,OH,OW,C) fp32 bilinear upsample of NHWC logits (F.interpolate);
    for a window `rows` other than the whole image, the window's rows of
    the dense operators (ops/resize.window_matrix)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    x = logits.permute(0, 3, 1, 2).float()
    if rows is None or rows == Rows.whole(x.shape[2], oh):
        return interpolate(x, (oh, ow), align_corners).permute(0, 2, 3, 1)
    a = torch.from_numpy(window_matrix(rows, x.shape[2], oh, align_corners)).to(x.device)
    b = torch.from_numpy(_interp_matrix(x.shape[3], ow, align_corners)).to(x.device)
    return torch.einsum("yi,ncij,xj->nyxc", a, x, b)


def ce_front_fwd_plain(logits, labels, class_weights, ignore_label: int, out_hw,
                       align_corners: bool, rows: Rows | None = None):
    """(nll, w), each (N,OH,OW) fp32: F.interpolate in fp32 (`_z`), then
    the one-hot CE maps of losses.criterion._per_pixel_ce (the counterpart
    of the JAX package's `_xla_ce_maps`)."""
    from pidnet_tpu_torch.losses.criterion import _per_pixel_ce

    cw = class_weights_on(class_weights, logits.shape[-1], logits.device)
    nll, w, valid = _per_pixel_ce(_z(logits, out_hw, align_corners, rows), labels, cw,
                                  ignore_label)
    return torch.where(valid, nll, 0.0), w


def ce_front_bwd_plain(logits, labels, ignore_label: int, out_hw, align_corners: bool, g,
                       rows: Rows | None = None):
    """dL (N,h,w,C) in the logits' dtype: the explicit formula
    A^T (g * (softmax(z) - onehot)) B with the dense operators of
    ops/resize._interp_matrix (A the window's rows of it), g zeroed where
    the label is ignore or outside [0, C)."""
    n, h, w, c = logits.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    p = torch.softmax(_z(logits, (oh, ow), align_corners, rows), dim=-1)
    labels = labels.long()
    counted = (labels != ignore_label) & (labels >= 0) & (labels < c)
    onehot = torch.where(counted, labels, 0)[..., None] == torch.arange(c, device=labels.device)
    dz = torch.where(counted, g.float(), 0.0)[..., None] * (p - onehot.float())
    a = _interp_matrix(h, oh, align_corners) if rows is None else window_matrix(
        rows, h, oh, align_corners)
    a = torch.from_numpy(a).to(logits.device)
    b = torch.from_numpy(_interp_matrix(w, ow, align_corners)).to(logits.device)
    return torch.einsum("yi,nyxc,xj->nijc", a, dz, b).to(logits.dtype)


def _kernel_fn(kind: str, dtype: torch.dtype):
    name = f"ce_{kind}_{_SUFFIX[dtype]}"
    if name not in _fns:
        from pidnet_tpu_torch.ops._build import library

        fn = getattr(library("ce_front"), name)
        n_ptrs = 5 if kind == "fwd" else 4
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 17 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _rows(rows, h: int, oh: int, align_corners: bool):
    """(the kernels' four row arguments, the plans' window): the whole
    image's for None, else `rows` checked against the h local source rows
    (ops/resize.check_rows)."""
    if rows is None:
        return (h, 0, oh, 0), None
    rows = Rows(*(int(v) for v in rows))
    check_rows(rows, h, oh, bool(align_corners))
    return rows, None if rows == Rows.whole(h, oh) else rows


def _check(fn_name: str, logits, labels, out_hw, g=None):
    """Raise on what the kernels do not take; returns (n, h, w, c, oh, ow)."""
    if logits.device.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {logits.device}")
    if logits.dim() != 4:
        raise ValueError(f"{fn_name}: expected (N,h,w,C) logits, got {tuple(logits.shape)}")
    if logits.dtype not in _SUFFIX:
        raise TypeError(f"{fn_name}: dtype {logits.dtype} not in (bfloat16, float32)")
    n, h, w, c = logits.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if min(n, h, w, c, oh, ow) < 1:
        raise ValueError(f"{fn_name}: empty shape {tuple(logits.shape)} -> {(oh, ow)}")
    for name, t, dtype in (("labels", labels, torch.int32), ("g", g, torch.float32)):
        if t is None:
            continue
        if tuple(t.shape) != (n, oh, ow) or t.dtype != dtype or t.device != logits.device:
            raise ValueError(f"{fn_name}: {name} must be {dtype} (N,OH,OW)={(n, oh, ow)} on "
                             f"{logits.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("logits", logits), ("labels", labels), ("g", g)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{fn_name}: {name} must be contiguous")
    return n, h, w, c, oh, ow


def ce_front_fwd(logits, labels, class_weights, ignore_label: int, out_hw,
                 align_corners: bool, rows: Rows | None = None):
    """(nll, w), each (N,OH,OW) fp32, from (N,h,w,C) logits and (N,OH,OW)
    labels, over the window `rows` (None: the whole image). On a CUDA
    tensor (contiguous NHWC bf16/fp32 logits, contiguous int32 labels,
    C <= 1024) this launches the forward kernel on `forward_plan`'s blocks,
    which writes each pixel once; on a CPU tensor it runs
    `ce_front_fwd_plain`."""
    global fwd_launches, fwd_window_launches
    if logits.device.type == "cpu":
        return ce_front_fwd_plain(logits, labels, class_weights, ignore_label, out_hw,
                                  align_corners, rows)
    n, h, w, c, oh, ow = _check("ce_front_fwd", logits, labels, out_hw)
    args, window = _rows(rows, h, oh, align_corners)
    plan = forward_plan(n, h, w, c, oh, ow, bool(align_corners), logits.element_size(), window)
    fn = _kernel_fn("fwd", logits.dtype)
    # switch devices only where needed: the switch's host time shows in
    # back-to-back launches
    on = (contextlib.nullcontext() if logits.device.index == torch.cuda.current_device()
          else torch.cuda.device(logits.device))
    with on:
        cw = class_weights_on(class_weights, c, logits.device)
        nll = torch.empty((n, oh, ow), dtype=torch.float32, device=logits.device)
        wmap = torch.empty_like(nll)
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), labels.data_ptr(), cw.data_ptr(), nll.data_ptr(),
                 wmap.data_ptr(), n, h, w, c, oh, ow, *args, int(ignore_label),
                 int(bool(align_corners)), plan.band, plan.tile, plan.lpp, plan.window,
                 plan.threads, stream)
    if err != 0:
        raise RuntimeError(f"ce_front_fwd kernel launch failed: cudaError {err}")
    fwd_launches += 1
    fwd_window_launches += window is not None
    return nll, wmap


def forward_smem_bytes(c: int, window: int, lpp: int, itemsize: int) -> int:
    """Shared memory of one forward block (FwdLayout in csrc/ce_front.cu):
    `window` staged pixels of lpp slices of `class_slice` classes each,
    then the C fp32 class weights."""
    return stage_bytes(c, window, lpp, itemsize) + 4 * c


@lru_cache(maxsize=64)
def forward_plan(n: int, h: int, w: int, c: int, oh: int, ow: int, align_corners: bool,
                 itemsize: int, rows: Rows | None = None) -> WalkPlan:
    """The forward kernel's blocks (ops/_walk.walk_plan), lpp lanes a pixel
    (`lanes_per_pixel`), with bands whose block fits in 72 KB of shared
    memory (three blocks an SM); raises above 1024 classes or where a
    block would need more than the opt-in. `rows`: the window of output
    rows (default the whole image)."""
    lpp = lanes_per_pixel(c, "ce_front_fwd")
    plan = walk_plan(n, h, w, oh, ow, align_corners, lpp,
                     lambda window: forward_smem_bytes(c, window, lpp, itemsize),
                     _FWD_SMEM_TARGET, rows)
    if plan.smem > SMEM_OPT_IN:
        raise ValueError(f"ce_front_fwd: a block needs {plan.smem} bytes of shared memory")
    return plan


def tap_ranges(in_size: int, out_size: int, tile: int, align_corners: bool,
               rows: Rows | None = None) -> np.ndarray:
    """(tiles, 2) output ranges [a, b) of source tiles [s, s + tile): the
    output indices with a tap in the tile, i0 in [s, s + tile), or i0 ==
    s - 1 with lambda1 > 0 (the halo, whose lambda1 lands on s). The
    kernel's rule (first_reaching in csrc/ce_front.cu) on `source_taps`.
    With `rows`, the window's `out_size` output rows and its `in_size`
    local source rows, the taps the whole image's (`window_taps`)."""
    if rows is None:
        i0, _, l1 = source_taps(in_size, out_size, align_corners)
    else:
        i0, _, l1 = window_taps(rows, out_size, align_corners)
    out = []
    for s in range(0, in_size, tile):
        reach = np.flatnonzero((i0 >= s) | ((i0 == s - 1) & (l1 > 0)))
        a = int(reach[0]) if reach.size else out_size
        out.append((a, int(np.searchsorted(i0, min(s + tile, in_size)))))
    return np.array(out, np.int64).reshape(-1, 2)


def backward_smem_bytes(c: int, band: int, tile: int, xw: int, lpp: int, itemsize: int) -> int:
    """Shared memory of one backward block (BwdLayout in csrc/ce_front.cu):
    the staged (band+2) x (tile+2) logits, each pixel's classes padded to
    lpp slices of `class_slice` classes; the fp32 H-adjoint sums, band x xw
    x (C|1); each output column's lambda1; the columns' output ranges."""
    stage = -(-(band + 2) * (tile + 2) * lpp * class_slice(c, lpp) * itemsize // 16) * 16
    sums = -(-band * xw * (c | 1) * 4 // 16) * 16
    return stage + sums + 4 * (xw + tile + 2)


class BackwardPlan(NamedTuple):
    band: int  # BH, source rows of a block
    tile: int  # BW, source columns of a block
    lpp: int  # lanes that share a pixel, each with a slice of its classes
    rows: np.ndarray  # (bands, 2) output rows [a, b) each band walks
    cols: np.ndarray  # (tiles, 2) output columns [a, b) each tile walks
    xw: int  # output columns a block holds: the widest tile's and two more
    threads: int
    smem: int  # shared-memory bytes a block
    blocks: int


@lru_cache(maxsize=64)
def backward_plan(n: int, h: int, w: int, c: int, oh: int, ow: int, align_corners: bool,
                  itemsize: int, rows: Rows | None = None) -> BackwardPlan:
    """The backward kernel's blocks: one per image, band of BH source rows
    and tile of BW source columns; lpp lanes to each of the tile's output
    columns (the fewest, a power of two, that hold C in slices of at most
    32 classes). BW is the widest tile whose output columns, and two more
    (the device's float32 source index may round by one ulp the other way
    at a tile's edge), fit 256 threads, then evened out over the tiles. BH
    is the largest of 8, 4, 2 whose block fits in 113 KB of shared memory
    (two blocks an SM) and which still gives two blocks to each of the
    card's 132 SMs, else 1. `rows`: the window of output rows (default the
    whole image); the bands are of local source rows."""
    lpp = lanes_per_pixel(c, "ce_front_bwd")
    columns = BWD_THREADS // lpp

    def widest(tile):
        cols = tap_ranges(w, ow, tile, align_corners)
        return cols, int((cols[:, 1] - cols[:, 0]).max()) + 2

    lo, hi = 1, w
    if widest(1)[1] > columns:
        raise ValueError(f"ce_front_bwd: one source column of {w} spans more than {columns - 2} "
                         f"of {ow} output columns")
    while lo < hi:  # the widest tile that fits
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if widest(mid)[1] <= columns else (lo, mid - 1)
    tile = -(-w // -(-w // lo))
    cols, xw = widest(tile)
    band = 1
    for cand in (8, 4, 2):
        if (backward_smem_bytes(c, cand, tile, xw, lpp, itemsize) <= _SMEM_TARGET
                and n * -(-h // cand) * len(cols) >= MIN_BLOCKS):
            band = cand
            break
    smem = backward_smem_bytes(c, band, tile, xw, lpp, itemsize)
    if smem > SMEM_OPT_IN:
        raise ValueError(f"ce_front_bwd: a block needs {smem} bytes of shared memory")
    spans = tap_ranges(h, oh, band, align_corners, rows)
    threads = -(-xw * lpp // 32) * 32
    return BackwardPlan(band, tile, lpp, spans, cols, xw, threads, smem,
                        n * len(spans) * len(cols))


def ce_front_bwd(logits, labels, ignore_label: int, out_hw, align_corners: bool, g,
                 rows: Rows | None = None):
    """dL (N,h,w,C) in the logits' dtype from the nll map's gradient g
    (N,OH,OW), over the window `rows` (None: the whole image). On a CUDA
    tensor this launches the backward kernel, which sums in fp32 in a fixed
    order and writes each element of dL once; on a CPU tensor it runs
    `ce_front_bwd_plain`."""
    global bwd_launches, bwd_window_launches
    if logits.device.type == "cpu":
        return ce_front_bwd_plain(logits, labels, ignore_label, out_hw, align_corners, g, rows)
    n, h, w, c, oh, ow = _check("ce_front_bwd", logits, labels, out_hw, g)
    args, window = _rows(rows, h, oh, align_corners)
    plan = backward_plan(n, h, w, c, oh, ow, bool(align_corners), logits.element_size(), window)
    fn = _kernel_fn("bwd", logits.dtype)
    with torch.cuda.device(logits.device):
        dl = torch.empty_like(logits)
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), labels.data_ptr(), g.data_ptr(), dl.data_ptr(), n, h, w, c,
                 oh, ow, *args, int(ignore_label), int(bool(align_corners)), plan.band, plan.tile,
                 plan.xw, plan.lpp, plan.threads, stream)
    if err != 0:
        raise RuntimeError(f"ce_front_bwd kernel launch failed: cudaError {err}")
    bwd_launches += 1
    bwd_window_launches += window is not None
    return dl


class _CEFront(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, class_weights, ignore_label, out_hw, align_corners, rows):
        nll, w = ce_front_fwd(logits, labels, class_weights, ignore_label, out_hw,
                              align_corners, rows)
        ctx.save_for_backward(logits, labels)
        ctx.args = (ignore_label, out_hw, align_corners, rows)
        ctx.mark_non_differentiable(w)
        return nll, w

    @staticmethod
    def backward(ctx, g_nll, g_w):
        logits, labels = ctx.saved_tensors
        ignore_label, out_hw, align_corners, rows = ctx.args
        dl = ce_front_bwd(logits, labels, ignore_label, out_hw, align_corners,
                          g_nll.float().contiguous(), rows)
        return dl, None, None, None, None, None, None


def ce_maps(logits, labels, class_weights, ignore_label: int, out_hw, align_corners: bool,
            rows: Rows | None = None):
    """(per-pixel nll, per-pixel class weight), each (N,OH,OW) fp32, from
    (N,h,w,C) logits and (N,OH,OW) int labels, over the window `rows`
    (None: the whole image); differentiable in `logits` (the weight map is
    not). Ignored pixels, and labels outside [0, C), give (0, 0)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if logits.device.type != "cpu":
        labels = labels.to(torch.int32)
    return _CEFront.apply(logits.contiguous(), labels.contiguous(), class_weights,
                          int(ignore_label), (oh, ow), bool(align_corners), rows)
