"""Functional primitives on NCHW tensors (counterpart of
pidnet_tpu/nn/functional.py).

Tensors are NCHW, usually in `torch.channels_last` memory format, so the
NHWC views at the public boundary cost no copy. Weights are OIHW. The dtype
of the activation is the compute dtype: a bf16 input runs bf16 convs
(fp32 accumulation inside cuDNN) and yields bf16 outputs. BatchNorm follows
torch's semantics: momentum 0.1 running statistics, the biased variance to
normalise and the unbiased one in running_var, eps 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pidnet_tpu_torch.ops.batch_norm import bn_train

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # reference models/pidnet.py:12 (bn_mom)


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` in `dtype`, with no op at all where it already has it: a
    `torch.export` trace records each `.to`, even one that changes
    nothing, and a serving program pays for it on every call."""
    return t if t.dtype == dtype else t.to(dtype)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int = 1,
    groups: int = 1,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """2-D conv with padding k//2 (every PIDNet conv has k in {1, 3}).

    With `compute_dtype`, input, weight and bias are cast to it and the
    output has it; otherwise the weight follows the input's dtype."""
    if compute_dtype is not None:
        x = cast(x, compute_dtype)
    w = cast(w, x.dtype)
    if b is not None:
        b = cast(b, x.dtype)
    return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2, groups=groups)


def batch_norm_infer(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
) -> torch.Tensor:
    """Inference BN: the affine is formed in fp32, then applied in x's dtype."""
    scale = gamma * torch.rsqrt(var + BN_EPS)
    shift = beta - mean * scale
    return affine(x, scale, shift)


def batch_norm_train(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    *,
    momentum: float = BN_MOMENTUM,
    sync=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BN over N, H, W of NCHW `x`. Returns (y,
    new_running_mean, new_running_var); the running statistics carry no
    gradient.

    The statistics reduce in fp32 as mean and mean of squares, var =
    max(mean_sq - mean^2, 0), and the normalisation runs in x's dtype as
    x*scale + shift, as the JAX package's batch_norm_train does (cuDNN's
    bf16 BN normalises in fp32 and forms the variance another way, so
    F.batch_norm is not the same function, nor is nn.SyncBatchNorm).

    Without `sync` this is `ops.batch_norm.bn_train`: hand-written CUDA
    kernels for a CUDA tensor (channels_last bf16 or fp32), its plain
    version for a CPU tensor; y is then formed in fp32 and rounded once.
    With `sync` (a `parallel.mesh.Mesh`) the batch statistics are those of
    the mesh's global batch, sync BN as the JAX function's `axis_name`
    computes it: (mean, mean_sq) are pmean'd across the ranks and the
    unbiased variance counts n x the mesh's size values; these eager ops
    are that path's own."""
    if sync is None:
        return bn_train(x, gamma, beta, running_mean, running_var, momentum)
    n = x.numel() // x.shape[1]
    mean = torch.mean(x, dim=(0, 2, 3), dtype=torch.float32)
    mean_sq = torch.mean(torch.square(x.float()), dim=(0, 2, 3))
    mean, mean_sq = sync.pmean(torch.stack([mean, mean_sq])).unbind(0)
    n *= sync.size
    var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
    scale = torch.rsqrt(var + BN_EPS) * gamma
    shift = beta - mean * scale
    y = affine(x, scale, shift)
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1.0 - momentum) * running_mean + momentum * mean
        new_var = (1.0 - momentum) * running_var + momentum * unbiased
    return y, new_mean, new_var


def affine(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-channel x * scale + shift (a folded standalone BN)."""
    c = x.shape[1]
    return x * cast(scale, x.dtype).view(1, c, 1, 1) + cast(shift, x.dtype).view(1, c, 1, 1)


def avg_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """AvgPool2d with count_include_pad=True, summed in fp32."""
    y = F.avg_pool2d(x.float(), kernel, stride, padding, count_include_pad=True)
    return y.to(x.dtype)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """MaxPool2d with torch's semantics: the padding never wins (the JAX
    package pads with -inf). BiSeNet's ResNet-18 stem uses it."""
    return F.max_pool2d(x, kernel, stride, padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1, 1)) in fp32: NCHW -> NC11."""
    return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)
