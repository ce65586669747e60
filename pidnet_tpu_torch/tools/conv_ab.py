"""A/B of the hand-written 3x3 conv (ops/conv3x3.py, the CUDA kernel
csrc/conv3x3.cu) against cuDNN on PIDNet's hot 3x3 shapes (counterpart of
the JAX package's scripts/conv_ab.py).

Three comparisons per shape, each through the kernel and through cuDNN
(`F.conv2d`, bf16, channels_last):

  plain    conv only
  fused    conv + bias + ReLU
  stats    conv + per-channel sum and sum of squares (BN statistics)

Each time is the median over 10 windows of 20 back-to-back calls, from
CUDA events, printed beside its share of the H100's 989 TFLOP/s dense bf16
peak and the card's name and power limit. TF32 is switched off for
matmuls and cuDNN, and both flags are printed. On the CPU (`--device cpu`)
the kernel's plain version and the CPU convolution run instead, timed on
the host clock, with no peak share.

    python -m pidnet_tpu_torch.tools.conv_ab [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from pidnet_tpu_torch import resolve_device
from pidnet_tpu_torch.ops import conv3x3 as K
from pidnet_tpu_torch.utils.timing import card_line, time_ms

BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores

# (name, N, H, W, C): stride-1 3x3 C->C; the 1/8-resolution P/D stages at
# 128 channels, layer4 and layer5 at 256 and 512
SHAPES = [
    ("P/D 3x3 C128 @128", 8, 128, 128, 128),
    ("layer4 3x3 C256 @32", 8, 32, 32, 256),
    ("layer5 3x3 C512 @16", 8, 16, 16, 512),
]
MODES = ("plain", "fused", "stats")


def inputs(n: int, h: int, w: int, c: int, device, seed: int = 0):
    """Seeded x (N,H,W,C) bf16, w (3,3,C,C) bf16 (scale 0.02) and b (C,) fp32."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, c), dtype=np.float32))
    wt = torch.from_numpy(rng.standard_normal((3, 3, c, c), dtype=np.float32) * 0.02)
    b = torch.from_numpy(rng.standard_normal(c, dtype=np.float32))
    return x.to(device, torch.bfloat16), wt.to(device, torch.bfloat16), b.to(device)


def kernel_fn(mode: str, x, w, b):
    """The mode through ops/conv3x3."""
    if mode == "plain":
        return lambda: K.conv3x3(x, w)
    if mode == "fused":
        return lambda: K.conv3x3(x, w, b, relu=True)
    return lambda: K.conv3x3(x, w, stats=True)


def library_fn(mode: str, x, w, b):
    """The mode through F.conv2d on NCHW views of the NHWC tensors
    (channels_last), in bf16; stats sum the bf16 output in fp32."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bc = b.to(x.dtype)
    if mode == "plain":
        return lambda: F.conv2d(xc, wc, padding=1)
    if mode == "fused":
        return lambda: F.relu(F.conv2d(xc, wc, bc, padding=1))

    def stats():
        y = F.conv2d(xc, wc, padding=1).float()
        return torch.stack([y.sum((0, 2, 3)), (y * y).sum((0, 2, 3))])

    return stats


def run(device, shapes=SHAPES, batches: int = 10, per_batch: int = 20) -> tuple[list, int]:
    """Time every shape and mode through the kernel and the library;
    returns (rows, kernel calls made). A row is (name, shape, mode,
    kernel_ms, library_ms, gflop, max |kernel y - library y|)."""
    device = torch.device(device)
    rows, calls = [], 0
    per_timing = 3 + batches * per_batch
    for name, n, h, w, c in shapes:
        x, wt, b = inputs(n, h, w, c, device)
        gflop = 2 * n * h * w * 9 * c * c / 1e9
        ref = {mode: library_fn(mode, x, wt, b)().permute(0, 2, 3, 1).float()
               for mode in ("plain", "fused")}
        for mode in MODES:
            kern, lib = kernel_fn(mode, x, wt, b), library_fn(mode, x, wt, b)
            got = kern()
            calls += 1
            y = got[0] if mode == "stats" else got
            want = ref["fused" if mode == "fused" else "plain"]
            err = (y.float() - want).abs().max().item()
            t_kernel = time_ms(kern, device, batches, per_batch)
            calls += per_timing
            t_lib = time_ms(lib, device, batches, per_batch)
            rows.append((name, (n, h, w, c), mode, t_kernel, t_lib, gflop, err))
    return rows, calls


def format_row(row, device: torch.device) -> str:
    name, shape, mode, t_kernel, t_lib, gflop, err = row
    lib = "cudnn" if device.type == "cuda" else "F.conv2d"
    if device.type == "cuda":
        def share(t):
            return f" ({gflop * 1e9 / (t * 1e-3) / BF16_PEAK_FLOPS:6.1%} of bf16 peak)"
    else:
        def share(t):
            return ""
    return (f"{name} {shape} {mode:5s}: {lib} {t_lib * 1e3:9.1f} us{share(t_lib)}   kernel "
            f"{t_kernel * 1e3:9.1f} us{share(t_kernel)}   kernel/{lib} {t_kernel / t_lib:5.2f}x"
            f"   max |dy| {err:.3e}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="hand 3x3 conv kernel vs cuDNN")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        print(f"card: {card_line()}; device {torch.cuda.get_device_name(device)}")
    print(f"device {device}; cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    rows, _ = run(device)
    for row in rows:
        print(format_row(row, device))


if __name__ == "__main__":
    main()
