"""Fused 3x3 stride-1 SAME convolution with a bias/ReLU/statistics epilogue
(counterpart of pidnet_tpu/ops/conv3x3.py):

    y = conv3x3(x, w) [+ b] [relu]
    stats = [sum y, sum y^2] over N, H, W   (on the fp32 values before the cast)

It replaces the JAX package's Pallas TPU kernel `_kernel`
(pidnet_tpu/ops/conv3x3.py:41). No production path calls it, in the JAX
package or here: its one entry point is the A/B against the library conv,
`python -m pidnet_tpu_torch.tools.conv_ab` (the JAX `scripts/conv_ab.py`).
The JAX docstring also names a "+ residual" epilogue and a serving-path
caller; the kernel never took a residual input and no serving code calls
it, so neither is ported.

Layouts are the JAX function's: x (N,H,W,Cin) NHWC, w (3,3,Cin,Cout) HWIO
(taps dy*3+dx), b (Cout,). x and w are rounded to bf16, products are
summed in fp32, b is added in fp32 before the ReLU, and y is written in
`out_dtype` (bf16 rounded to nearest even, or fp32). The JAX `tile_h`
argument is the TPU grid's row tile, as is its padding of W to a multiple
of 8 (a Mosaic DMA constraint); neither is part of the function, so
`tile_h` is dropped and H needs no divisor.

`conv3x3` launches the CUDA kernel (csrc/conv3x3.cu) for a CUDA tensor and
raises on what it does not take (Cin a multiple of 64, Cout of 128, which
covers the JAX contract of multiples of 128); for a CPU tensor it runs
`conv3x3_plain`, the same function as 9 shifted fp32 matmuls. It never
falls back to a library convolution. `launches` counts kernel launches.

The kernel is an implicit GEMM for Hopper, bound by the bf16 tensor cores
(38.65 GFLOP, 39.1 us at 989 TFLOP/s, at (8,128,128,128)): `wgmma` on
operands that TMA loads into a ring of shared-memory stages, a producer
warpgroup apart from the two that multiply, mbarriers between them (the
design note is in the source). The wrapper makes the tile plan (`_plan`:
a TH x TW = 128 pixel rectangle and BN output channels per block) and
passes w as it is: the kernel reads it MN-major. It keeps its own host
work to a few tensor allocations and one ctypes call, so that back-to-back
calls keep the card busy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

launches = 0

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_fns: dict = {}

BM = 128  # output pixels per block: a TH x TW rectangle of one image
STAGES = 5  # K steps in flight in the kernel's shared-memory ring
SMS = 132  # streaming multiprocessors of an H100 SXM


@functools.lru_cache(maxsize=256)
def _plan(n: int, h: int, w: int, cin: int, cout: int):
    """The kernel's tile plan: (TH, TW, BN, STAGES, grid).

    A block owns TH x TW = 128 output pixels of one image, TW the smallest
    of 16, 32, 64, 128 that covers W (128 above), and BN output channels:
    128, or 64 where 128 would leave fewer blocks than the card has SMs.
    grid = (N * ceil(H/TH) * ceil(W/TW), Cout / BN); block x takes column
    tile x % tiles_x, row tile (x // tiles_x) % tiles_y, image x // (tiles_x
    * tiles_y). `cin` enters only through the kernel's contract."""
    del cin
    tw = next((t for t in (16, 32, 64, 128) if t >= w), 128)
    th = BM // tw
    tiles = n * -(-h // th) * -(-w // tw)
    bn = 128 if tiles * (cout // 128) >= SMS else 64
    return th, tw, bn, STAGES, (tiles, cout // bn)


def smem_bytes(bn: int) -> int:
    """Dynamic shared memory of one block of the kernel with BN output
    channels, as the library computes it (builds it on first use)."""
    from pidnet_tpu_torch.ops._build import library

    fn = library("conv3x3").conv3x3_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(bn)


def _epilogue(a: torch.Tensor, b, relu: bool, stats: bool, out_dtype):
    """fp32 (..., Cout) conv sums -> (y, stats) or y."""
    if b is not None:
        a = a + b.to(device=a.device, dtype=torch.float32)
    if relu:
        a = torch.clamp(a, min=0.0)
    y = a.to(out_dtype)
    if not stats:
        return y
    flat = a.reshape(-1, a.shape[-1])
    return y, torch.stack([flat.sum(0), (flat * flat).sum(0)])


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b=None, *, relu: bool = False,
                  stats: bool = False, out_dtype=torch.bfloat16):
    """The kernel's arithmetic in plain PyTorch: x and w rounded to bf16,
    then 9 shifted (N*H*W, Cin) x (Cin, Cout) fp32 matmuls, tap (dy, dx)
    reading x at (h+dy-1, w+dx-1) with zeros outside the image."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    xp = torch.nn.functional.pad(x.to(torch.bfloat16).float(), (0, 0, 1, 1, 1, 1))
    wf = w.to(torch.bfloat16).float().reshape(9, cin, cout)
    a = torch.zeros((n * h * wd, cout), dtype=torch.float32, device=x.device)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        a += xp[:, dy:dy + h, dx:dx + wd].reshape(-1, cin) @ wf[tap]
    return _epilogue(a.reshape(n, h, wd, cout), b, relu, stats, out_dtype)


def _kernel_fn(out_dtype: torch.dtype):
    fn = _fns.get(out_dtype)
    if fn is None:
        from pidnet_tpu_torch.ops._build import library

        fn = getattr(library("conv3x3"), f"conv3x3_{_SUFFIX[out_dtype]}")
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[out_dtype] = fn
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, b, out_dtype):
    """Raise on what the kernel does not take; returns (n, h, w, cin, cout)."""
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    xs, ws = x.shape, w.shape
    if len(xs) != 4 or len(ws) != 4 or ws[:3] != (3, 3, xs[3]):
        raise ValueError(f"conv3x3: expected x (N,H,W,Cin) and w (3,3,Cin,Cout), got "
                         f"{tuple(xs)} and {tuple(ws)}")
    n, h, wd, cin = xs
    cout = ws[3]
    if min(n, h, wd) < 1 or cin % 64 or cout % 128 or cin < 64:
        raise ValueError(f"conv3x3: needs N, H, W >= 1, Cin a multiple of 64 and Cout of 128, "
                         f"got x {tuple(x.shape)}, Cout {cout}")
    if out_dtype not in _SUFFIX:
        raise TypeError(f"conv3x3: out_dtype {out_dtype} not in (bfloat16, float32)")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"conv3x3: {name} must be contiguous, 16-byte aligned and on "
                             f"{x.device}")
    if b is not None and (tuple(b.shape) != (cout,) or b.device != x.device):
        raise ValueError(f"conv3x3: b must be ({cout},) on {x.device}, got {tuple(b.shape)} "
                         f"on {b.device}")
    return n, h, wd, cin, cout


def conv3x3(x: torch.Tensor, w: torch.Tensor, b=None, *, relu: bool = False,
            stats: bool = False, out_dtype=torch.bfloat16):
    """Fused 3x3/s1/SAME conv [+b] [+ReLU] [+BN statistics].

    x (N,H,W,Cin), w (3,3,Cin,Cout), b (Cout,) or None. Returns y
    (N,H,W,Cout) in `out_dtype`; with stats=True also the (2,Cout) fp32
    [sum(y), sum(y^2)] over N, H, W of the post-epilogue fp32 values. On a
    CUDA tensor this launches the kernel on x and w cast to bf16 (its
    statistics are summed with fp32 atomics, in an order that changes from
    run to run); on a CPU tensor it runs `conv3x3_plain`."""
    global launches
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu=relu, stats=stats, out_dtype=out_dtype)
    # the JAX function's casts
    if x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)
    if w.dtype != torch.bfloat16:
        w = w.to(torch.bfloat16)
    n, h, wd, cin, cout = _check(x, w, b, out_dtype)
    fn = _kernel_fn(out_dtype)
    th, tw, bn, stages, (grid_x, grid_y) = _plan(n, h, wd, cin, cout)
    dev = x.device.index
    bias = b
    if b is not None and (b.dtype != torch.float32 or not b.is_contiguous()):
        bias = b.to(torch.float32).contiguous()
    y = torch.empty((n, h, wd, cout), dtype=out_dtype, device=x.device)
    st = torch.empty((2, cout), dtype=torch.float32, device=x.device) if stats else None
    # the kernel launches on x's device (the C side makes it current) and on
    # its current stream; the statistics are zeroed there
    err = fn(dev, x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
             y.data_ptr(), None if st is None else st.data_ptr(), n, h, wd, cin, cout,
             int(bool(relu)), th, tw, bn, stages, grid_x, grid_y,
             torch._C._cuda_getCurrentRawStream(dev))
    if err >= 10000:
        raise RuntimeError(f"conv3x3: cuTensorMapEncodeTiled failed: CUresult {err - 10000}")
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: cudaError {err}")
    launches += 1
    return (y, st) if stats else y
