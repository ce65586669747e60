"""Plain float32 PIDNet (Xu et al., "PIDNet: A Real-time Semantic
Segmentation Network Inspired by PID Controllers", CVPR 2023; the
published code's models/pidnet.py), written as functions over a dict of
tensors keyed with the published state-dict names (`layer3_.0.conv1.weight`,
`spp.scale1.1.running_var`, ...).

It is the yardstick the benchmark holds the program to, so it imports
nothing but torch: no kernel, no cache, no batching, no reduced precision
(the control runs it under `reference/quant.float8`).

- `Net(weights, train=...)` carries the weights and the mode. In eval mode
  every conv+BN pair is folded here, from the unfolded weights, into one
  biased conv (w * g/sqrt(v+eps), beta - m*g/sqrt(v+eps) + b*g/sqrt(v+eps)),
  and each standalone BN is its per-channel affine; in training mode each
  BN normalises with the batch statistics and its new running statistics
  (momentum 0.1, unbiased variance) land in `Net.new_stats`.
- `Net(..., record=True)` on an empty batch makes every missing
  tensor as it is first asked for and records its shape (`specs`) and each
  conv's multiply-accumulates (`macs`) and the last BN of each residual
  branch (`branch_ends`): the harness takes the parameter list and the
  FLOP count from this one description of the network.
- `forward(net, images, spec)` takes NCHW float32 images and returns NCHW
  logits at 1/8 resolution: `[p_logits, logits, d_logits]` with `augment`,
  else `logits`. Interior resizes use align_corners=False.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class Net:
    def __init__(self, weights: dict, *, train: bool = False, record: bool = False):
        self.w = weights
        self.train = train
        self.record = record
        self.specs: dict[str, tuple[tuple[int, ...], str]] = {}
        self.macs: list[tuple[str, int, bool]] = []  # (conv, MACs, input is the image)
        self.new_stats: dict[str, torch.Tensor] = {}
        self.image = None
        self.momentum = BN_MOMENTUM
        self.branch_ends: list[str] = []  # the last BN of each residual branch

    def _get(self, name: str, shape, kind: str) -> torch.Tensor:
        if self.record and name not in self.w:
            self.w[name] = torch.zeros(shape)
            self.specs[name] = (tuple(shape), kind)
        return self.w[name]

    def _bn_params(self, name: str, ch: int):
        return tuple(self._get(f"{name}.{k}", (ch,), kind) for k, kind in
                     (("weight", "bn_weight"), ("bias", "bn_bias"),
                      ("running_mean", "bn_mean"), ("running_var", "bn_var")))

    def bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """A BN over NCHW `x`: batch statistics in training mode, the
        running ones as an affine otherwise."""
        g, b, m, v = self._bn_params(name, x.shape[1])
        if self.train:
            rm, rv = m.clone(), v.clone()
            y = F.batch_norm(x, rm, rv, g, b, training=True, momentum=self.momentum, eps=BN_EPS)
            self.new_stats[f"{name}.running_mean"] = rm
            self.new_stats[f"{name}.running_var"] = rv
            return y
        scale = g / torch.sqrt(v + BN_EPS)
        return x * scale.view(1, -1, 1, 1) + (b - m * scale).view(1, -1, 1, 1)

    def conv(self, x, name: str, cout: int, k: int, stride: int = 1, groups: int = 1,
             bias: bool = False, bn: str | None = None) -> torch.Tensor:
        """A k x k conv, padding k//2, then the BN `bn` if given (folded
        into the conv in eval mode)."""
        cin = x.shape[1]
        w = self._get(f"{name}.weight", (cout, cin // groups, k, k), "conv_weight")
        b = self._get(f"{name}.bias", (cout,), "conv_bias") if bias else None
        if bn is not None:
            g, beta, m, v = self._bn_params(bn, cout)
            if not self.train:
                scale = g / torch.sqrt(v + BN_EPS)
                w = w * scale.view(-1, 1, 1, 1)
                b = beta - m * scale + (0.0 if b is None else b * scale)
        y = F.conv2d(x, w, b, stride=stride, padding=k // 2, groups=groups)
        if self.record:  # a sample's multiply-accumulates
            self.macs.append((name, math.prod(y.shape[1:]) * (cin // groups) * k * k,
                              x is self.image))
        if bn is not None and self.train:
            y = self.bn(y, bn)
        return y


def _resize(x, hw, align_corners: bool = False):
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=align_corners)


def basic_block(net, x, name, planes, stride=1, no_relu=False):
    out = F.relu(net.conv(x, f"{name}.conv1", planes, 3, stride, bn=f"{name}.bn1"))
    out = net.conv(out, f"{name}.conv2", planes, 3, bn=f"{name}.bn2")
    net.branch_ends.append(f"{name}.bn2")
    if stride != 1 or x.shape[1] != planes:
        x = net.conv(x, f"{name}.downsample.0", planes, 1, stride, bn=f"{name}.downsample.1")
    out = out + x
    return out if no_relu else F.relu(out)


def bottleneck(net, x, name, planes, stride=1, no_relu=True):
    cout = planes * 2
    out = F.relu(net.conv(x, f"{name}.conv1", planes, 1, bn=f"{name}.bn1"))
    out = F.relu(net.conv(out, f"{name}.conv2", planes, 3, stride, bn=f"{name}.bn2"))
    out = net.conv(out, f"{name}.conv3", cout, 1, bn=f"{name}.bn3")
    net.branch_ends.append(f"{name}.bn3")
    if stride != 1 or x.shape[1] != cout:
        x = net.conv(x, f"{name}.downsample.0", cout, 1, stride, bn=f"{name}.downsample.1")
    out = out + x
    return out if no_relu else F.relu(out)


def layer(net, x, name, block, planes, blocks, stride=1):
    """A residual stage: the first block keeps the block's default no_relu
    (bottleneck True, basic False); later blocks relu but the last."""
    for i in range(blocks):
        no_relu = (block is bottleneck) if i == 0 else i == blocks - 1
        x = block(net, x, f"{name}.{i}", planes, stride if i == 0 else 1, no_relu)
    return x


def bn_relu_conv(net, x, name, cout, k, groups=1, pool=None):
    """[pool] -> BN -> ReLU -> conv; keys .0/.2, or .1/.3 after a pool."""
    i = 0
    if pool is not None:
        x, i = pool(x), 1
    return net.conv(F.relu(net.bn(x, f"{name}.{i}")), f"{name}.{i + 2}", cout, k, groups=groups)


def seg_head(net, x, name, inter, out):
    y = net.conv(F.relu(net.bn(x, f"{name}.bn1")), f"{name}.conv1", inter, 3)
    return net.conv(F.relu(net.bn(y, f"{name}.bn2")), f"{name}.conv2", out, 1, bias=True)


def pag_fm(net, name, x, y, mid):
    hw = x.shape[2:]
    y_q = _resize(net.conv(y, f"{name}.f_y.0", mid, 1, bn=f"{name}.f_y.1"), hw)
    x_k = net.conv(x, f"{name}.f_x.0", mid, 1, bn=f"{name}.f_x.1")
    sim = torch.sigmoid(torch.sum(x_k * y_q, dim=1, keepdim=True))
    return (1 - sim) * x + sim * _resize(y, hw)


POOLS = (
    lambda x: F.avg_pool2d(x, 5, 2, 2, count_include_pad=True),
    lambda x: F.avg_pool2d(x, 9, 4, 4, count_include_pad=True),
    lambda x: F.avg_pool2d(x, 17, 8, 8, count_include_pad=True),
    lambda x: x.mean(dim=(2, 3), keepdim=True),
)


def pappm(net, x, bp, out):
    hw = x.shape[2:]
    x0 = bn_relu_conv(net, x, "spp.scale0", bp, 1)
    scales = [_resize(bn_relu_conv(net, x, f"spp.scale{i}", bp, 1, pool=pool), hw) + x0
              for i, pool in enumerate(POOLS, start=1)]
    scale_out = bn_relu_conv(net, torch.cat(scales, 1), "spp.scale_process", bp * 4, 3, groups=4)
    y = bn_relu_conv(net, torch.cat([x0, scale_out], 1), "spp.compression", out, 1)
    return y + bn_relu_conv(net, x, "spp.shortcut", out, 1)


def dappm(net, x, bp, out):
    hw = x.shape[2:]
    feats = [bn_relu_conv(net, x, "spp.scale0", bp, 1)]
    for i, pool in enumerate(POOLS, start=1):
        up = _resize(bn_relu_conv(net, x, f"spp.scale{i}", bp, 1, pool=pool), hw)
        feats.append(bn_relu_conv(net, up + feats[-1], f"spp.process{i}", bp, 3))
    y = bn_relu_conv(net, torch.cat(feats, 1), "spp.compression", out, 1)
    return y + bn_relu_conv(net, x, "spp.shortcut", out, 1)


def forward(net: Net, images: torch.Tensor, spec: dict):
    """NCHW images (N,3,H,W), H and W multiples of 64 -> NCHW logits at
    1/8 resolution. `spec`: m, n, planes, ppm_planes, head_planes,
    num_classes, augment (the configuration file's keys)."""
    p, m, n = spec["planes"], spec["m"], spec["n"]
    net.image = images
    hw8 = (images.shape[2] // 8, images.shape[3] // 8)
    x = F.relu(net.conv(images, "conv1.0", p, 3, 2, bias=True, bn="conv1.1"))
    x = F.relu(net.conv(x, "conv1.3", p, 3, 2, bias=True, bn="conv1.4"))
    x = layer(net, x, "layer1", basic_block, p, m)
    x = F.relu(layer(net, F.relu(x), "layer2", basic_block, p * 2, m, 2))
    x_ = layer(net, x, "layer3_", basic_block, p * 2, m)
    d3 = p if m == 2 else p * 2
    x_d = basic_block(net, x, "layer3_d", d3, no_relu=True)
    x = F.relu(layer(net, x, "layer3", basic_block, p * 4, n, 2))
    x_ = F.relu(pag_fm(net, "pag3", x_, net.conv(x, "compression3.0", p * 2, 1,
                                                  bn="compression3.1"), p))
    temp_p = x_
    x_d = x_d + _resize(net.conv(x, "diff3.0", d3, 3, bn="diff3.1"), hw8)
    x = F.relu(layer(net, x, "layer4", basic_block, p * 8, n, 2))
    x_ = layer(net, x_, "layer4_", basic_block, p * 2, m)
    if m == 2:
        x_d = layer(net, F.relu(x_d), "layer4_d", bottleneck, p, 1)
    else:
        x_d = basic_block(net, F.relu(x_d), "layer4_d", p * 2, no_relu=True)
    x_ = pag_fm(net, "pag4", x_, net.conv(x, "compression4.0", p * 2, 1, bn="compression4.1"), p)
    x_d = F.relu(x_d + _resize(net.conv(x, "diff4.0", p * 2, 3, bn="diff4.1"), hw8))
    temp_d = x_d
    x_ = layer(net, F.relu(x_), "layer5_", bottleneck, p * 2, 1)
    x_d = layer(net, x_d, "layer5_d", bottleneck, p * 2, 1)
    x = layer(net, x, "layer5", bottleneck, p * 8, 2, 2)
    x = (pappm if m == 2 else dappm)(net, x, spec["ppm_planes"], p * 4)
    x = _resize(x, (8 * x.shape[2], 8 * x.shape[3]))
    att = torch.sigmoid(x_d)
    if m == 2:
        fused = (net.conv((1 - att) * x + x_, "dfm.conv_p.0", p * 4, 1, bn="dfm.conv_p.1")
                 + net.conv(x + att * x_, "dfm.conv_i.0", p * 4, 1, bn="dfm.conv_i.1"))
    else:
        fused = bn_relu_conv(net, att * x_ + (1 - att) * x, "dfm.conv", p * 4, 3)
    out = seg_head(net, fused, "final_layer", spec["head_planes"], spec["num_classes"])
    if not spec["augment"]:
        return out
    return [seg_head(net, temp_p, "seghead_p", spec["head_planes"], spec["num_classes"]), out,
            seg_head(net, temp_d, "seghead_d", p, 1)]


def describe(spec: dict, n: int, h: int, w: int) -> Net:
    """The network of `spec` traced on an empty batch of (3, h, w) images
    on the CPU, which computes shapes and no values: its `specs` (every
    tensor's shape and kind, in first-use order) and `macs` (each conv's
    multiply-accumulates for n images)."""
    net = Net({}, record=True)
    forward(net, torch.zeros((0, 3, h, w)), spec)
    net.macs = [(name, n * m, first) for name, m, first in net.macs]
    return net
