"""The control's precision: the reference computed in float8 where the
program computes in bfloat16, the step below it that would tempt a later
change (`with float8(): forward(...)`).

Inside `float8()`, every floating-point tensor that an operation returns
(a conv, a BN, a resize, a pool, a sum, a product, an activation, a
concatenation; not a view, a copy or a shape) is held as float8 e4m3 with
one scale for the tensor: scaled so that its largest magnitude lands on
e4m3's largest finite value (448), rounded, and scaled back. The gradient
that reaches such a tensor in the backward is rounded the same way to
e5m2 (largest finite 57344), the usual float8 training recipe. Each
operation itself computes in float32 from its float8 inputs, as float8
tensor cores accumulate. The loss, which the program computes in float32,
stays outside.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

# operations that make no new values: their outputs are left as they are
_KEEP = {"clone", "detach", "contiguous", "permute", "view", "reshape", "__getitem__", "expand",
         "to", "float", "size", "dim", "numel", "__get__", "unbind", "split", "chunk", "t",
         "transpose", "squeeze", "unsqueeze", "flatten", "copy_", "requires_grad_"}


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (x.float() * scale).clamp(-top, top).to(dtype).float() / scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` held as float8 e4m3, its gradient as e5m2."""
    return _FP8.apply(x)


def _held(out):
    if isinstance(out, torch.Tensor) and out.is_floating_point() and out.numel():
        return fp8(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_held(o) for o in out)
    return out


class float8(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "") in _KEEP:
            return out
        return _held(out)
