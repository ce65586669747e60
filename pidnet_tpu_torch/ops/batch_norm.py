"""Train-mode BatchNorm as hand-written CUDA kernels, differentiable in x,
gamma and beta (the one-device path of nn/functional.batch_norm_train).

The function is the JAX package's batch_norm_train: per channel of NCHW
`x`, mean = E[x] and mean_sq = E[x^2] in fp32 over N, H, W, var =
max(mean_sq - mean^2, 0), scale = gamma / sqrt(var + eps), shift = beta -
mean * scale, y = x * scale + shift; the running statistics blend with the
momentum, the variance unbiased by n / (n - 1). y is formed in fp32 and
rounded once to x's dtype. The backward recomputes xh = (x - mean) * rstd
from x:

    dgamma = sum(dy * xh),  dbeta = sum(dy),
    dx = scale * (dy - sum(dy) / M - xh * sum(dy * xh) / M)

with the last term 0 in a channel whose mean_sq - mean^2 < 0, where the
clamp is active and the eager graph passes no gradient through the
variance.

The kernels (csrc/batch_norm.cu, whose note gives the bound) replace no
Pallas kernel: the JAX package's BN is XLA ops. They were added because the
port's eager BN took 125.5 ms of PIDNet-L's 185.6 ms training step on the
H100. They work on the NHWC view [M = N*H*W, C] of a channels_last tensor
(an N x C x 1 x 1 map qualifies), bf16 or fp32, with fp32 gamma, beta and
running statistics. `bn_forward` is two passes over x (the sums, then y)
with a small launch between them that forms the per-channel numbers;
`bn_backward` is two passes over x and dy (the sums, then dx) with the same
launch between. `plan` cuts [M, C] into the blocks of every pass. No
atomics: two launches give the same bits.

For a CUDA tensor each function launches its kernels or raises; for a CPU
tensor it runs its plain version (`bn_forward_plain`, `bn_backward_plain`),
the same function in tensor ops. `fwd_launches` and `bwd_launches` count
the kernels' forward and backward calls, one each a BN.
"""

from __future__ import annotations

import contextlib
import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from pidnet_tpu_torch.utils import spans

fwd_launches = 0
bwd_launches = 0

EPS = 1e-5  # nn/functional.BN_EPS
MOMENTUM = 0.1  # nn/functional.BN_MOMENTUM
THREADS = 256  # the most threads of a block (kThreads)
SMS = 132  # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 4  # blocks of 256 threads an SM holds at once (kBlocksPerSM)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# rows of the forward's per-channel numbers (`ws`, csrc/batch_norm.cu)
MEAN, RSTD, SCALE, SHIFT, NEW_MEAN, NEW_VAR, VAR_MASK = range(7)
_fns: dict = {}


class Plan(NamedTuple):
    """The blocks of every pass over [M, C]: block (tile, chunk) takes rows
    [chunk * rpc, min(M, (chunk + 1) * rpc)) and channels [tile * lanes *
    vec, ...); its thread (tx, ty) takes channels tile * lanes * vec + tx *
    vec + [0, vec) (those below C) of rows chunk * rpc + ty + k * rows."""

    vec: int  # channels a thread loads at once
    lanes: int  # threads along C
    rows: int  # threads along M
    ctiles: int  # blocks along C
    chunks: int  # blocks along M
    rpc: int  # rows a chunk, a multiple of `rows`


@lru_cache(maxsize=512)
def plan(m: int, c: int, itemsize: int, align: int = 16) -> Plan:
    """The plan for M rows of C channels of `itemsize` bytes whose
    pointers are `align`-byte aligned: 16-byte loads where C and the
    pointers allow (else 8, 4, one element); at most 32 lanes, the channel
    tiles evened out; 256 // lanes rows; chunks of whole thread rows that
    give about 4 blocks to each of the 132 SMs, one wave."""
    if m < 1 or c < 1:
        raise ValueError(f"batch_norm: empty [M, C] = [{m}, {c}]")
    vec = 16 // itemsize
    while c % vec or align % (vec * itemsize):
        vec //= 2
    groups = c // vec
    ctiles = -(-groups // 32)
    lanes = -(-groups // ctiles)
    rows = THREADS // lanes
    want = max(1, SMS * BLOCKS_PER_SM // ctiles)
    rpc = -(-m // want)
    rpc = -(-rpc // rows) * rows
    return Plan(vec, lanes, rows, ctiles, -(-m // rpc), rpc)


def _align(*tensors) -> int:
    """The largest power of two up to 16 that divides every data pointer."""
    a = 16
    for t in tensors:
        p = t.data_ptr()
        a = min(a, p & -p) if p else a
    return a


def _m_c(x: torch.Tensor) -> tuple[int, int]:
    return x.numel() // x.shape[1], x.shape[1]


def _v(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


def bn_forward_plain(x, gamma, beta, running_mean, running_var, momentum: float):
    """(y, ws) of the forward's three launches: ws (7, C) fp32 holds, by
    row, mean, rstd, scale, shift, the new running mean and variance, and
    1 where the clamp passes the variance's gradient (mean_sq - mean^2 >=
    0), else 0."""
    n, _ = _m_c(x)
    mean = torch.mean(x, dim=(0, 2, 3), dtype=torch.float32)
    mean_sq = torch.mean(torch.square(x.float()), dim=(0, 2, 3))
    var_raw = mean_sq - torch.square(mean)
    var = torch.clamp(var_raw, min=0.0)
    rstd = torch.rsqrt(var + EPS)
    scale = rstd * gamma
    shift = beta - mean * scale
    new_mean = (1.0 - momentum) * running_mean + momentum * mean
    new_var = (1.0 - momentum) * running_var + momentum * (var * (n / max(n - 1, 1)))
    ws = torch.stack([mean, rstd, scale, shift, new_mean, new_var, (var_raw >= 0).float()])
    y = (x.float() * _v(scale) + _v(shift)).to(x.dtype)
    return y, ws


def bn_backward_plain(x, dy, ws):
    """(dx, dgamma, dbeta) of the backward's three launches from the
    forward's `ws`: dx in x's dtype, dgamma and dbeta fp32."""
    m, _ = _m_c(x)
    xh = (x.float() - _v(ws[MEAN])) * _v(ws[RSTD])
    g = dy.float()
    dbeta = g.sum(dim=(0, 2, 3))
    dgamma = (g * xh).sum(dim=(0, 2, 3))
    dx = _v(ws[SCALE]) * (g - _v(dbeta / m) - xh * _v(ws[VAR_MASK] * dgamma / m))
    return dx.to(x.dtype), dgamma, dbeta


def _kernel_fn(kind: str, dtype: torch.dtype):
    name = f"bn_{kind}_{_SUFFIX[dtype]}"
    if name not in _fns:
        from pidnet_tpu_torch.ops._build import library

        fn = getattr(library("batch_norm"), name)
        ptr, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        plan_args = [ll, i, i, i, i, i, i, ll]  # m, c, vec, lanes, rows, ctiles, chunks, rpc
        if kind == "fwd":
            fn.argtypes = [ptr] * 8 + plan_args + [f] * 4 + [ptr]
        else:
            fn.argtypes = [ptr] * 6 + plan_args + [ptr]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(fn_name: str, x: torch.Tensor, *channel: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
    if not x.is_cuda:
        raise ValueError(f"{fn_name}: unsupported device {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{fn_name}: dtype {x.dtype} not in (bfloat16, float32)")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{fn_name}: expected a non-empty NCHW tensor, got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{fn_name}: x must be channels_last and contiguous")
    c, dev = x.shape[1], x.get_device()
    for t in channel:
        if (t.dtype != torch.float32 or t.shape != (c,) or t.get_device() != dev
                or not t.is_contiguous()):
            raise ValueError(f"{fn_name}: per-channel tensors must be contiguous float32 ({c},) "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _on(x: torch.Tensor):
    """Switch devices only where needed: the switch's host time shows in
    back-to-back launches."""
    if x.get_device() == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def _stream(x: torch.Tensor) -> int:
    """The current CUDA stream of x's device, as the launch takes it."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _plan_args(m: int, c: int, p: Plan) -> tuple:
    return (m, c, p.vec, p.lanes, p.rows, p.ctiles, p.chunks, p.rpc)


def bn_forward(x, gamma, beta, running_mean, running_var, momentum: float):
    """(y, ws) as `bn_forward_plain` gives them. On a CUDA tensor
    (channels_last bf16 or fp32 x, contiguous fp32 (C,) gamma, beta and
    running statistics) this launches the sums, the per-channel numbers and
    y; on a CPU tensor it runs `bn_forward_plain`."""
    global fwd_launches
    if x.device.type == "cpu":
        return bn_forward_plain(x, gamma, beta, running_mean, running_var, momentum)
    _check("bn_forward", x, gamma, beta, running_mean, running_var)
    m, c = _m_c(x)
    p = plan(m, c, x.element_size(), _align(x))
    fn = _kernel_fn("fwd", x.dtype)
    with _on(x):
        y = torch.empty_like(x)
        part = torch.empty(2 * p.chunks * c, dtype=torch.float32, device=x.device)
        ws = torch.empty((7, c), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), running_mean.data_ptr(),
                 running_var.data_ptr(), y.data_ptr(), part.data_ptr(), ws.data_ptr(),
                 *_plan_args(m, c, p), EPS, 1.0 - momentum, momentum, m / max(m - 1, 1),
                 _stream(x))
    if err != 0:
        raise RuntimeError(f"bn_forward kernel launch failed: cudaError {err}")
    fwd_launches += 1
    return y, ws


def bn_backward(x, dy, ws):
    """(dx, dgamma, dbeta) as `bn_backward_plain` gives them. On a CUDA
    tensor (x and dy channels_last of one dtype, ws the forward's) this
    launches the sums, the per-channel numbers and dx; on a CPU tensor it
    runs `bn_backward_plain`."""
    global bwd_launches
    if x.device.type == "cpu":
        return bn_backward_plain(x, dy, ws)
    _check("bn_backward", x)
    _check("bn_backward", dy)
    m, c = _m_c(x)
    if dy.shape != x.shape or dy.dtype != x.dtype or ws.shape != (7, c):
        raise ValueError(f"bn_backward: dy {dy.dtype} {tuple(dy.shape)} and ws "
                         f"{tuple(ws.shape)} do not match x {x.dtype} {tuple(x.shape)}")
    p = plan(m, c, x.element_size(), _align(x, dy))
    fn = _kernel_fn("bwd", x.dtype)
    with _on(x):
        dx = torch.empty_like(x)
        # dgamma, dbeta, dx's two coefficients, then the partial rows
        buf = torch.empty((4 + 2 * p.chunks) * c, dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), dy.data_ptr(), ws.data_ptr(), dx.data_ptr(),
                 buf.data_ptr() + 4 * 4 * c, buf.data_ptr(), *_plan_args(m, c, p), _stream(x))
    if err != 0:
        raise RuntimeError(f"bn_backward kernel launch failed: cudaError {err}")
    bwd_launches += 1
    return dx, buf[:c], buf[c:2 * c]


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, running_mean, running_var, momentum):
        y, ws = bn_forward(x, gamma, beta, running_mean, running_var, momentum)
        ctx.save_for_backward(x, ws)
        new_mean, new_var = ws[NEW_MEAN], ws[NEW_VAR]
        ctx.mark_non_differentiable(new_mean, new_var)
        return y, new_mean, new_var

    @staticmethod
    def backward(ctx, dy, _d_mean, _d_var):
        x, ws = ctx.saved_tensors
        with spans.span("bn.backward"):
            dx, dgamma, dbeta = bn_backward(
                x, dy.contiguous(memory_format=torch.channels_last), ws)
        return dx, dgamma, dbeta, None, None, None


def bn_train(x, gamma, beta, running_mean, running_var, momentum: float = MOMENTUM):
    """(y, new_running_mean, new_running_var) of train-mode BN over N, H, W
    of NCHW `x`, differentiable in x, gamma and beta; the running
    statistics carry no gradient."""
    return _BatchNormTrain.apply(x, gamma, beta, running_mean, running_var, float(momentum))
