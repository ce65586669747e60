"""Plain float32 BiSeNetV1 + ADB + Light_Bag, the second ablation of the
PIDNet paper (the published code's models/others/bisenet_adb_bag.py, its
ResNet-18 trunk models/others/resnet.py; BiSeNet: Yu et al., ECCV 2018,
arXiv 1808.00897), written as functions over a dict of tensors keyed with
the published state-dict names (`cp.resnet.layer3.0.downsample.1.weight`,
`cp.arm16.bn_atten.running_var`, `conv_out32.conv_out.bias`, ...).

It shares `Net` and the residual blocks with `reference/pidnet.py`, which
is plain torch too, and imports nothing else: `Net`'s eval mode folds
each conv+BN pair into one biased conv, and each standalone BN (ARM's
`bn_atten`, FFM's `bn`) is its per-channel affine; in training mode each
BN normalises with the batch statistics, those after a global pool over
the batch's (N, C, 1, 1) pooled vectors.

- Context path: the ResNet-18 trunk (7x7/s2 conv+BN+ReLU, 3x3/s2 max
  pool, layers 1-4 of two basic blocks each, every block ending in a
  ReLU), an attention refinement module (ARM) on feat16 and on feat32
  (3x3 conv+BN+ReLU, then the sigmoid of BN(1x1 conv(global average
  pool)) as a gate), `conv_avg` (1x1 conv+BN+ReLU) on feat32's global
  pool, each sum resized x2 and through `conv_head32`/`conv_head16`
  (3x3 conv+BN+ReLU).
- ADB, the derivative branch at 1/8: `convD1` and `convD2` (basic blocks
  without their last ReLU) with the `diff3`/`diff4` conv+BNs of feat16
  and feat32 resized and added, a ReLU, then `convD3` (a bottleneck
  without its last ReLU).
- Spatial path: 7x7/s2, 3x3/s2, 3x3/s2 and 1x1 conv+BN+ReLUs.
- Light_Bag over (spatial, context 1/8, derivative out): with att =
  sigmoid(d), conv_p((1 - att) * i + p) + conv_i(i + att * p), each a 1x1
  conv+BN.
- FFM: a 1x1 conv+BN+ReLU gated by sigmoid(BN(1x1 conv(global pool)))
  plus itself.
- Heads: 3x3 conv+BN+ReLU, a biased 1x1 conv, a bilinear resize x8 (x16
  for `conv_out32`) to the input's resolution.

`forward(net, images, spec)` takes NCHW float32 images (H and W multiples
of 32) and returns NCHW logits at the input's resolution: `[out16, out32,
out, outd]` with `augment` (the final head last but one, the boundary
head last), else `out`. Every resize uses align_corners=False.

Departures from the published file, none of them in the arithmetic:
- The published context path applies its ReLU to `feat_d` in place, so
  `convD3` and the boundary head `conv_outd` both read the ReLU'd
  `feat_d` (the port and the JAX package read it so too); here the ReLU
  is computed once and both read its result.
- The published heads upsample with a scale factor; here to the size
  (h * up, w * up), which gives the same source coordinates for an
  integer factor.
- No `aux_mode` other than training's four heads and inference's one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.pidnet import Net, _resize, basic_block, bottleneck


def cbr(net, x, name, cout, k, stride=1):
    """ConvBNReLU: `name.conv` (no bias), `name.bn`, ReLU."""
    return F.relu(net.conv(x, f"{name}.conv", cout, k, stride, bn=f"{name}.bn"))


def _pool(x):
    return x.mean(dim=(2, 3), keepdim=True)


def resnet18(net, x):
    """(feat8, feat16, feat32) of the ResNet-18 trunk."""
    x = F.relu(net.conv(x, "cp.resnet.conv1", 64, 7, 2, bn="cp.resnet.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    feats = []
    for i, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2)), start=1):
        x = basic_block(net, x, f"cp.resnet.layer{i}.0", planes, stride)
        x = basic_block(net, x, f"cp.resnet.layer{i}.1", planes)
        feats.append(x)
    return feats[1], feats[2], feats[3]


def arm(net, x, name, cout):
    feat = cbr(net, x, f"{name}.conv", cout, 3)
    atten = net.bn(net.conv(_pool(feat), f"{name}.conv_atten", cout, 1), f"{name}.bn_atten")
    return feat * torch.sigmoid(atten)


def context_path(net, x):
    """(feat_cp8 @1/8, feat_cp16 @1/16, feat_d_out, feat_d)."""
    feat8, feat16, feat32 = resnet18(net, x)
    hw8 = feat8.shape[2:]
    avg = cbr(net, _pool(feat32), "cp.conv_avg", 128, 1)
    feat32_sum = arm(net, feat32, "cp.arm32", 128) + avg
    feat32_up = _resize(feat32_sum, (2 * feat32.shape[2], 2 * feat32.shape[3]))
    feat32_up = cbr(net, feat32_up, "cp.conv_head32", 128, 3)
    feat16_sum = arm(net, feat16, "cp.arm16", 128) + feat32_up
    feat16_up = _resize(feat16_sum, (2 * feat16.shape[2], 2 * feat16.shape[3]))
    feat16_up = cbr(net, feat16_up, "cp.conv_head16", 128, 3)
    feat_d = basic_block(net, feat8, "cp.convD1", 64, no_relu=True)
    feat_d = feat_d + _resize(net.conv(feat16, "cp.diff3.0", 64, 3, bn="cp.diff3.1"), hw8)
    feat_d = basic_block(net, F.relu(feat_d), "cp.convD2", 64, no_relu=True)
    feat_d = feat_d + _resize(net.conv(feat32, "cp.diff4.0", 64, 3, bn="cp.diff4.1"), hw8)
    feat_d = F.relu(feat_d)
    feat_d_out = bottleneck(net, feat_d, "cp.convD3", 64, no_relu=True)
    return feat16_up, feat32_up, feat_d_out, feat_d


def spatial_path(net, x):
    x = cbr(net, x, "sp.conv1", 64, 7, 2)
    x = cbr(net, x, "sp.conv2", 64, 3, 2)
    x = cbr(net, x, "sp.conv3", 64, 3, 2)
    return cbr(net, x, "sp.conv_out", 128, 1)


def light_bag(net, p, i, d, out):
    att = torch.sigmoid(d)
    return (net.conv((1 - att) * i + p, "dfm.conv_p.0", out, 1, bn="dfm.conv_p.1")
            + net.conv(i + att * p, "dfm.conv_i.0", out, 1, bn="dfm.conv_i.1"))


def ffm(net, x, cout):
    feat = cbr(net, x, "ffm.convblk", cout, 1)
    atten = net.bn(net.conv(_pool(feat), "ffm.conv", cout, 1), "ffm.bn")
    return feat * torch.sigmoid(atten) + feat


def head(net, x, name, mid, n_out, up):
    y = net.conv(cbr(net, x, f"{name}.conv", mid, 3), f"{name}.conv_out", n_out, 1, bias=True)
    return _resize(y, (up * y.shape[2], up * y.shape[3]))


def forward(net: Net, images: torch.Tensor, spec: dict):
    """NCHW images (N,3,H,W) -> NCHW logits at (H, W). `spec`:
    num_classes, augment (the configuration file's keys)."""
    nc = spec["num_classes"]
    net.image = images
    feat_cp8, feat_cp16, feat_d_out, feat_d = context_path(net, images)
    feat_sp = spatial_path(net, images)
    feat_fuse = ffm(net, light_bag(net, feat_sp, feat_cp8, feat_d_out, 256), 256)
    out = head(net, feat_fuse, "conv_out", 256, nc, 8)
    if not spec["augment"]:
        return out
    return [head(net, feat_cp8, "conv_out16", 64, nc, 8),
            head(net, feat_cp16, "conv_out32", 64, nc, 16), out,
            head(net, feat_d, "conv_outd", 64, 1, 8)]


def describe(spec: dict, n: int, h: int, w: int) -> Net:
    """The network of `spec` traced on an empty batch of (3, h, w) images
    on the CPU: its `specs`, `macs` (for n images; both image convs, the
    trunk's stem and the spatial path's first, flagged) and
    `branch_ends`, as `reference.pidnet.describe` gives them."""
    net = Net({}, record=True)
    forward(net, torch.zeros((0, 3, h, w)), spec)
    net.macs = [(name, n * m, first) for name, m, first in net.macs]
    return net
