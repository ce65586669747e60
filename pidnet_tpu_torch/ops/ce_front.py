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
"""

from __future__ import annotations

import contextlib
import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from pidnet_tpu_torch.ops.resize import _interp_matrix, interpolate, source_taps

fwd_launches = 0
bwd_launches = 0

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
SMEM_OPT_IN = 232448  # 227 KB: the most shared memory an H100 block can opt in to
_SMEM_TARGET = 113 * 1024  # two backward blocks an SM
_MIN_BLOCKS = 2 * 132  # two blocks on each of the H100's SMs
BWD_THREADS = 256  # the most threads of a backward block (kBwdThreads)
FWD_THREADS = 256  # the most threads of a forward block (kFwdThreads)
_FWD_SMEM_TARGET = 72 * 1024  # three forward blocks an SM
MAX_CLASSES = 32 * 32  # 32 lanes a pixel, 32 classes a lane
_fns: dict = {}


def class_weights_on(class_weights, c: int, device) -> torch.Tensor:
    """(C,) fp32 class weights on `device`; None means ones. A tensor that
    is already there is returned as it is; anything else is copied from
    the host, a copy that waits for the device."""
    if class_weights is None:
        return torch.ones(c, dtype=torch.float32, device=device)
    return torch.as_tensor(class_weights, dtype=torch.float32, device=device)


def _z(logits: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    """(N,OH,OW,C) fp32 bilinear upsample of NHWC logits (F.interpolate)."""
    x = logits.permute(0, 3, 1, 2).float()
    return interpolate(x, out_hw, align_corners).permute(0, 2, 3, 1)


def ce_front_fwd_plain(logits, labels, class_weights, ignore_label: int, out_hw,
                       align_corners: bool):
    """(nll, w), each (N,OH,OW) fp32: F.interpolate in fp32, then the
    one-hot CE maps of losses.criterion._per_pixel_ce (the counterpart of
    the JAX package's `_xla_ce_maps`)."""
    from pidnet_tpu_torch.losses.criterion import _per_pixel_ce

    cw = class_weights_on(class_weights, logits.shape[-1], logits.device)
    nll, w, valid = _per_pixel_ce(_z(logits, out_hw, align_corners), labels, cw, ignore_label)
    return torch.where(valid, nll, 0.0), w


def ce_front_bwd_plain(logits, labels, ignore_label: int, out_hw, align_corners: bool, g):
    """dL (N,h,w,C) in the logits' dtype: the explicit formula
    A^T (g * (softmax(z) - onehot)) B with the dense operators of
    ops/resize._interp_matrix, g zeroed where the label is ignore or
    outside [0, C)."""
    n, h, w, c = logits.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    p = torch.softmax(_z(logits, (oh, ow), align_corners), dim=-1)
    labels = labels.long()
    counted = (labels != ignore_label) & (labels >= 0) & (labels < c)
    onehot = torch.where(counted, labels, 0)[..., None] == torch.arange(c, device=labels.device)
    dz = torch.where(counted, g.float(), 0.0)[..., None] * (p - onehot.float())
    a = torch.from_numpy(_interp_matrix(h, oh, align_corners)).to(logits.device)
    b = torch.from_numpy(_interp_matrix(w, ow, align_corners)).to(logits.device)
    return torch.einsum("yi,nyxc,xj->nijc", a, dz, b).to(logits.dtype)


def _kernel_fn(kind: str, dtype: torch.dtype):
    name = f"ce_{kind}_{_SUFFIX[dtype]}"
    if name not in _fns:
        from pidnet_tpu_torch.ops._build import library

        fn = getattr(library("ce_front"), name)
        n_ptrs = 5 if kind == "fwd" else 4
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


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
                 align_corners: bool):
    """(nll, w), each (N,OH,OW) fp32, from (N,h,w,C) logits and (N,OH,OW)
    labels. On a CUDA tensor (contiguous NHWC bf16/fp32 logits, contiguous
    int32 labels, C <= 1024) this launches the forward kernel on
    `forward_plan`'s blocks, which writes each pixel once; on a CPU tensor
    it runs `ce_front_fwd_plain`."""
    global fwd_launches
    if logits.device.type == "cpu":
        return ce_front_fwd_plain(logits, labels, class_weights, ignore_label, out_hw,
                                  align_corners)
    n, h, w, c, oh, ow = _check("ce_front_fwd", logits, labels, out_hw)
    plan = forward_plan(n, h, w, c, oh, ow, bool(align_corners), logits.element_size())
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
                 wmap.data_ptr(), n, h, w, c, oh, ow, int(ignore_label),
                 int(bool(align_corners)), plan.band, plan.tile, plan.lpp, plan.window,
                 plan.threads, stream)
    if err != 0:
        raise RuntimeError(f"ce_front_fwd kernel launch failed: cudaError {err}")
    fwd_launches += 1
    return nll, wmap


def lanes_per_pixel(c: int, fn_name: str) -> int:
    """The fewest lanes, a power of two, that hold C classes in slices of
    at most 32; raises above 1024 classes."""
    if c > MAX_CLASSES:
        raise ValueError(f"{fn_name}: {c} classes, more than {MAX_CLASSES}")
    lpp = 1
    while -(-c // lpp) > 32:
        lpp *= 2
    return lpp


def forward_smem_bytes(c: int, window: int, lpp: int, itemsize: int) -> int:
    """Shared memory of one forward block (FwdLayout in csrc/ce_front.cu):
    `window` staged pixels of lpp slices of `class_slice` classes each,
    then the C fp32 class weights."""
    return -(-window * lpp * class_slice(c, lpp) * itemsize // 16) * 16 + 4 * c


def _spans(in_size: int, out_size: int, step: int, align_corners: bool):
    """(spans, 2) output ranges [a, b) of `step` indices each, and (spans,
    2) the source ranges [i0(a), i1(b-1) + 1) their taps read."""
    i0, i1, _ = source_taps(in_size, out_size, align_corners)
    a = np.arange(0, out_size, step)
    b = np.minimum(a + step, out_size)
    return np.stack([a, b], 1), np.stack([i0[a], i1[b - 1] + 1], 1)


class ForwardPlan(NamedTuple):
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


@lru_cache(maxsize=64)
def forward_plan(n: int, h: int, w: int, c: int, oh: int, ow: int, align_corners: bool,
                 itemsize: int) -> ForwardPlan:
    """The forward kernel's blocks: one per image, band of output rows and
    tile of output columns, each pixel owned by one block; lpp lanes to
    each of the tile's columns (`lanes_per_pixel`). The tile is the widest
    that fits 256 threads, evened out over the tiles. A block stages the
    source pixels under its taps, `src_rows` x `src_cols`; the kernel finds
    its own from the device's float32 taps, which may round by one ulp the
    other way at either end, so the window leaves room for two more rows
    and two more columns. The band is the largest of 64, 32, ..., 2 whose
    block fits in 72 KB of shared memory (three blocks an SM) and which
    still gives two blocks to each of the card's 132 SMs, else 1."""
    lpp = lanes_per_pixel(c, "ce_front_fwd")
    tile = -(-ow // -(-ow // (FWD_THREADS // lpp)))
    cols, src_cols = _spans(w, ow, tile, align_corners)
    nq = min(int((src_cols[:, 1] - src_cols[:, 0]).max()) + 2, w)

    def window_of(band):
        rows, src_rows = _spans(h, oh, band, align_corners)
        return rows, src_rows, min(int((src_rows[:, 1] - src_rows[:, 0]).max()) + 2, h) * nq

    band = 1
    for cand in (64, 32, 16, 8, 4, 2):
        rows, _, window = window_of(cand)
        if (forward_smem_bytes(c, window, lpp, itemsize) <= _FWD_SMEM_TARGET
                and n * len(rows) * len(cols) >= _MIN_BLOCKS):
            band = cand
            break
    rows, src_rows, window = window_of(band)
    smem = forward_smem_bytes(c, window, lpp, itemsize)
    if smem > SMEM_OPT_IN:
        raise ValueError(f"ce_front_fwd: a block needs {smem} bytes of shared memory")
    threads = -(-tile * lpp // 32) * 32
    return ForwardPlan(band, tile, lpp, rows, cols, src_rows, src_cols, window, threads, smem,
                       n * len(rows) * len(cols))


def tap_ranges(in_size: int, out_size: int, tile: int, align_corners: bool) -> np.ndarray:
    """(tiles, 2) output ranges [a, b) of source tiles [s, s + tile): the
    output indices with a tap in the tile, i0 in [s, s + tile), or i0 ==
    s - 1 with lambda1 > 0 (the halo, whose lambda1 lands on s). The
    kernel's rule (first_reaching in csrc/ce_front.cu) on `source_taps`."""
    i0, _, l1 = source_taps(in_size, out_size, align_corners)
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


def class_slice(c: int, lpp: int) -> int:
    """The classes of one lane: ceil(C / lpp) rounded up to 4."""
    return (-(-c // lpp) + 3) // 4 * 4


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
                  itemsize: int) -> BackwardPlan:
    """The backward kernel's blocks: one per image, band of BH source rows
    and tile of BW source columns; lpp lanes to each of the tile's output
    columns (the fewest, a power of two, that hold C in slices of at most
    32 classes). BW is the widest tile whose output columns, and two more
    (the device's float32 source index may round by one ulp the other way
    at a tile's edge), fit 256 threads, then evened out over the tiles. BH
    is the largest of 8, 4, 2 whose block fits in 113 KB of shared memory
    (two blocks an SM) and which still gives two blocks to each of the
    card's 132 SMs, else 1."""
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
                and n * -(-h // cand) * len(cols) >= _MIN_BLOCKS):
            band = cand
            break
    smem = backward_smem_bytes(c, band, tile, xw, lpp, itemsize)
    if smem > SMEM_OPT_IN:
        raise ValueError(f"ce_front_bwd: a block needs {smem} bytes of shared memory")
    rows = tap_ranges(h, oh, band, align_corners)
    threads = -(-xw * lpp // 32) * 32
    return BackwardPlan(band, tile, lpp, rows, cols, xw, threads, smem,
                        n * len(rows) * len(cols))


def ce_front_bwd(logits, labels, ignore_label: int, out_hw, align_corners: bool, g):
    """dL (N,h,w,C) in the logits' dtype from the nll map's gradient g
    (N,OH,OW). On a CUDA tensor this launches the backward kernel, which
    sums in fp32 in a fixed order and writes each element of dL once; on a
    CPU tensor it runs `ce_front_bwd_plain`."""
    global bwd_launches
    if logits.device.type == "cpu":
        return ce_front_bwd_plain(logits, labels, ignore_label, out_hw, align_corners, g)
    n, h, w, c, oh, ow = _check("ce_front_bwd", logits, labels, out_hw, g)
    plan = backward_plan(n, h, w, c, oh, ow, bool(align_corners), logits.element_size())
    fn = _kernel_fn("bwd", logits.dtype)
    with torch.cuda.device(logits.device):
        dl = torch.empty_like(logits)
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), labels.data_ptr(), g.data_ptr(), dl.data_ptr(), n, h, w, c,
                 oh, ow, int(ignore_label), int(bool(align_corners)), plan.band, plan.tile,
                 plan.xw, plan.lpp, plan.threads, stream)
    if err != 0:
        raise RuntimeError(f"ce_front_bwd kernel launch failed: cudaError {err}")
    bwd_launches += 1
    return dl


class _CEFront(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, class_weights, ignore_label, out_hw, align_corners):
        nll, w = ce_front_fwd(logits, labels, class_weights, ignore_label, out_hw,
                              align_corners)
        ctx.save_for_backward(logits, labels)
        ctx.args = (ignore_label, out_hw, align_corners)
        ctx.mark_non_differentiable(w)
        return nll, w

    @staticmethod
    def backward(ctx, g_nll, g_w):
        logits, labels = ctx.saved_tensors
        ignore_label, out_hw, align_corners = ctx.args
        dl = ce_front_bwd(logits, labels, ignore_label, out_hw, align_corners,
                          g_nll.float().contiguous())
        return dl, None, None, None, None, None


def ce_maps(logits, labels, class_weights, ignore_label: int, out_hw, align_corners: bool):
    """(per-pixel nll, per-pixel class weight), each (N,OH,OW) fp32, from
    (N,h,w,C) logits and (N,OH,OW) int labels; differentiable in `logits`
    (the weight map is not). Ignored pixels, and labels outside [0, C),
    give (0, 0)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if logits.device.type != "cpu":
        labels = labels.to(torch.int32)
    return _CEFront.apply(logits.contiguous(), labels.contiguous(), class_weights,
                          int(ignore_label), (oh, ow), bool(align_corners))
