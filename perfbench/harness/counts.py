"""The work a cell asks of the card, counted from shapes, and the card's
peaks: the yardstick of the roofline and utilisation readings.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, at 700 W). The
kernel bounds are a frozen copy of `chip_smoke.py`'s
(`upsample_argmax_bound_ms`, `ce_bound_ms`), in seconds: the least time is
the larger of the bytes the function needs (each input read once, each
output written once) over the memory bandwidth and its operations over
their rate, and each says which of the two binds.
"""

from __future__ import annotations

from functools import lru_cache

from perfbench.harness.inputs import reference

BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
FP32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# exp/log/reciprocal on the special-function units: 16 results per SM per
# clock (compute capability 9.0), 132 SMs, at the 1.98 GHz boost clock
SFU_OPS_PER_S = 132 * 16 * 1.98e9


@lru_cache(maxsize=16)
def _macs(family: str, spec_items: tuple, n: int, h: int, w: int):
    config = {"family": family, **dict(spec_items)}
    return tuple(reference(config).describe(config, n, h, w).macs)


def conv_macs(config: dict, augment: bool, n: int, h: int, w: int):
    """[(conv, MACs, its input is the image)] of the network at (n, 3, h, w)."""
    items = tuple(sorted((k, v) for k, v in config.items()
                         if k != "family" and isinstance(v, (int, float, str, bool))))
    items += (("augment", augment),)
    return _macs(config["family"], items, n, h, w)


def forward_flops(config: dict, augment: bool, n: int, h: int, w: int) -> int:
    """2 x the convs' multiply-accumulates of one forward pass."""
    return 2 * sum(m for _, m, _ in conv_macs(config, augment, n, h, w))


def train_flops(config: dict, n: int, h: int, w: int) -> int:
    """The convs of one training step: the forward, and the backward's two
    products of each conv (its input's gradient and its weight's), but the
    image's, whose gradient no one needs."""
    macs = conv_macs(config, True, n, h, w)
    return 2 * sum(m * (2 if first else 3) for _, m, first in macs)


def upsample_argmax_bound_s(shape, out_hw, itemsize: int) -> tuple[float, str]:
    """K1: (N,h,w,C) logits -> (N,oh,ow) int32 class map. Bytes: the
    logits once, the map once. Operations, fp32, the separable form: a
    W-lerp (3) per source row, output column and class; an H-lerp (3) and
    a compare per output pixel and class."""
    n, h, w, c = shape
    oh, ow = out_hw
    nbytes = n * h * w * c * itemsize + n * oh * ow * 4
    ops = n * h * ow * c * 3 + n * oh * ow * c * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ce_bound_s(shape, out_hw, itemsize: int, counted: int, backward: bool) -> tuple[float, str]:
    """K2 (forward) and K3 (backward) of the loss front on this launch's
    data. `counted`: the pixels that need the softmax (label in [0, C) and,
    backward, a gradient that is not 0). Bytes: logits, labels and,
    backward, g read once; the two fp32 maps, or dL in the logits' dtype,
    written once. Operations: a W-lerp (3) per source row, output column
    and class, an H-lerp (3) per counted pixel and class; forward the
    logsumexp (3 per class, one exp and one log a pixel); backward the
    softmax and dz (4 per class, one exp and one reciprocal a pixel) and
    the two adjoint lerps (4 each); the exps, logs and reciprocals on the
    special-function units."""
    n, h, w, c = shape
    oh, ow = out_hw
    pixels = n * oh * ow
    logits = n * h * w * c * itemsize
    if backward:
        nbytes = 2 * logits + 2 * pixels * 4
        flops = 7 * n * h * ow * c + 11 * counted * c
    else:
        nbytes = logits + pixels * 4 + c * 4 + 2 * pixels * 4
        flops = 3 * n * h * ow * c + 6 * counted * c
    special = counted * (c + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / FP32_FLOPS, special / SFU_OPS_PER_S)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
