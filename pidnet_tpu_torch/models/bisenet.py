"""BiSeNetV1 + ADB + Light_Bag, the reference's second paper ablation, as
an `nn.Module` (counterpart of pidnet_tpu/models/bisenet.py), built from
the block library of models/pidnet.py and reached through
`models.pidnet.module_for`.

The context path is a ResNet-18 trunk with attention refinement modules;
the spatial path three stride-2 conv+BN+ReLUs; PIDNet's derivative branch
(ADB: convD1-3 with the diff3/diff4 adds) rides on the context features;
`LightBag` fuses (spatial, context, derivative) and a feature fusion module
gates the result.

- Every interior resize uses align_corners=False, and the heads upsample
  to the input's resolution inside the model (unlike PIDNet's 1/8
  logits).
- ARM's `conv_atten`/`bn_atten` and FFM's `conv`/`bn` are a plain conv
  and a standalone BN, not a fold pair: folded, the BN is a
  `scale`/`shift`, as the JAX fold makes it.
- The context path's ReLU is in place, so the boundary head reads the
  relu'd `feat_d`.
- `augment=True` returns `[out16, out32, out, outd]`: the final head last
  but one and the boundary head last, as FullLoss takes them with three
  balance weights (`seg_heads` 3).
- Under `models.pidnet.spatial_sharding` the stem's max pool, the three
  global pools and every resize compute the rank's rows of the whole
  image's (`parallel.spatial.max_pool_rows`, `global_pool_rows`,
  `resize_sharded`); the 1x1 convs and BNs after each global pool run on
  the pooled vector, replicated over the row (`replicated`). There is no
  1/64 stage and no gather: the 1/32 maps stay sharded.
- Spans (utils/spans.py): `model.context` (the trunk, ARMs, `conv_avg`,
  the `conv_head`s and ADB), `model.spatial`, `model.bag` (Light_Bag),
  `model.ffm`, `model.head` (the heads with their upsample) and, while
  recording, `model.head.backward`, one backward span per head from its
  output to its input.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from pidnet_tpu_torch.models.pidnet import (
    CBR,
    BasicBlock,
    Bottleneck,
    Conv2d,
    ConvBN,
    LightBag,
    Network,
    _norm,
    _paired_norm,
    _resize,
)
from pidnet_tpu_torch.nn.functional import global_avg_pool, max_pool2d, relu, sigmoid
from pidnet_tpu_torch.parallel import spatial as SP
from pidnet_tpu_torch.utils import spans


@dataclass(frozen=True)
class BiSeNetSpec:
    num_classes: int = 19
    augment: bool = True  # the reference's aux_mode


def spec_for(name: str, num_classes: int, augment: bool) -> BiSeNetSpec:
    if "bisenet" not in name:
        raise ValueError(f"{name!r} is not a BiSeNet name")
    return BiSeNetSpec(num_classes=num_classes, augment=augment)


def _global_pool(mod: nn.Module, x):
    """The global average pool of NCHW `x`; under `spatial_sharding`
    (`mod.spatial` set) the whole image's, from the rank's rows."""
    if mod.spatial is None:
        return global_avg_pool(x)
    return SP.global_pool_rows(x, mod.spatial)


class ResNet18(nn.Module):
    """The ResNet-18 trunk: (feat8, feat16, feat32). Its basic blocks
    always end in a ReLU."""

    fold_pairs = (("conv1", "bn1"),)

    def __init__(self, *, folded):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, bias=folded)
        self.bn1 = _paired_norm(64, folded)
        cin = 64
        for i, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2)), start=1):
            blocks = [BasicBlock(cin, planes, stride, folded=folded),
                      BasicBlock(planes, planes, folded=folded)]
            setattr(self, f"layer{i}", nn.Sequential(*blocks))
            cin = planes
        self.spatial = None

    def forward(self, x):
        x = relu(self.bn1(self.conv1(x)))
        if self.spatial is None:
            x = max_pool2d(x, 3, 2, 1)
        else:
            x = SP.max_pool_rows(x, 3, 2, 1, self.spatial)
        feat8 = self.layer2(self.layer1(x))
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class ARM(nn.Module):
    """Attention refinement: a 3x3 CBR gated by the sigmoid of its global
    context through `conv_atten` and the standalone BN `bn_atten`."""

    def __init__(self, cin, cout, *, folded):
        super().__init__()
        self.conv = CBR(cin, cout, 3, folded=folded)
        self.conv_atten = Conv2d(cout, cout, 1)
        self.bn_atten = _norm(cout, folded)
        self.spatial = None

    def forward(self, x):
        feat = self.conv(x)
        return feat * sigmoid(self.bn_atten(self.conv_atten(_global_pool(self, feat))))


class FFM(nn.Module):
    """Feature fusion: a 1x1 CBR gated by the sigmoid of its global context
    through `conv` and the standalone BN `bn`, plus itself."""

    def __init__(self, cin, cout, *, folded):
        super().__init__()
        self.convblk = CBR(cin, cout, 1, folded=folded)
        self.conv = Conv2d(cout, cout, 1)
        self.bn = _norm(cout, folded)
        self.spatial = None

    def forward(self, x):
        feat = self.convblk(x)
        return feat * sigmoid(self.bn(self.conv(_global_pool(self, feat)))) + feat


class ContextPath(nn.Module):
    """ResNet-18 with ARMs and the grafted derivative branch; returns
    (feat_cp8 @1/8, feat_cp16 @1/16, feat_d_out, feat_d)."""

    def __init__(self, *, folded):
        super().__init__()
        kw = {"folded": folded}
        self.resnet = ResNet18(**kw)
        self.arm16 = ARM(256, 128, **kw)
        self.arm32 = ARM(512, 128, **kw)
        self.conv_head32 = CBR(128, 128, 3, **kw)
        self.conv_head16 = CBR(128, 128, 3, **kw)
        self.conv_avg = CBR(512, 128, 1, **kw)
        self.convD1 = BasicBlock(128, 64, no_relu=True, **kw)
        self.convD2 = BasicBlock(64, 64, no_relu=True, **kw)
        self.convD3 = Bottleneck(64, 64, no_relu=True, **kw)
        self.diff3 = ConvBN(256, 64, 3, **kw)
        self.diff4 = ConvBN(512, 64, 3, **kw)
        self.spatial = None

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        hw8 = (feat8.shape[2], feat8.shape[3])
        avg = self.conv_avg(_global_pool(self, feat32))
        feat32_sum = self.arm32(feat32) + avg
        feat32_up = _resize(self, feat32_sum, (feat32.shape[2] * 2, feat32.shape[3] * 2), False)
        feat32_up = self.conv_head32(feat32_up)
        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = _resize(self, feat16_sum, (feat16.shape[2] * 2, feat16.shape[3] * 2), False)
        feat16_up = self.conv_head16(feat16_up)
        feat_d = self.convD1(feat8) + _resize(self, self.diff3(feat16), hw8, False)
        feat_d = self.convD2(relu(feat_d)) + _resize(self, self.diff4(feat32), hw8, False)
        feat_d = relu(feat_d)  # the boundary head reads this (in-place ReLU)
        return feat16_up, feat32_up, self.convD3(feat_d), feat_d


class SpatialPath(nn.Sequential):
    """/8 high-detail features."""

    def __init__(self, *, folded):
        super().__init__()
        self.conv1 = CBR(3, 64, 7, 2, folded=folded)
        self.conv2 = CBR(64, 64, 3, 2, folded=folded)
        self.conv3 = CBR(64, 64, 3, 2, folded=folded)
        self.conv_out = CBR(64, 128, 1, folded=folded)


class Head(nn.Module):
    """BiSeNetOutput: 3x3 CBR, biased 1x1 conv, upsampled by `up` with
    align_corners=False."""

    def __init__(self, cin, mid, n_out, up, *, folded):
        super().__init__()
        self.up = up
        self.conv = CBR(cin, mid, 3, folded=folded)
        self.conv_out = Conv2d(mid, n_out, 1, bias=True)
        self.spatial = None

    def forward(self, x):
        y = self.conv_out(self.conv(x))
        return _resize(self, y, (y.shape[2] * self.up, y.shape[3] * self.up), False)


class BiSeNet(Network):
    seg_heads = 3  # out16, out32, out
    # the 1x1 convs and BNs after each global pool: on the pooled vector
    replicated = ("cp.conv_avg", "cp.arm16.conv_atten", "cp.arm16.bn_atten",
                  "cp.arm32.conv_atten", "cp.arm32.bn_atten", "ffm.conv", "ffm.bn")

    def __init__(self, spec: BiSeNetSpec, *, folded: bool = False):
        super().__init__()
        self.spec, self.folded = spec, folded
        kw = {"folded": folded}
        nc = spec.num_classes
        self.cp = ContextPath(**kw)
        self.sp = SpatialPath(**kw)
        self.dfm = LightBag(128, 256, **kw)
        self.ffm = FFM(256, 256, **kw)
        self.conv_out = Head(256, 256, nc, 8, **kw)
        if spec.augment:
            self.conv_out16 = Head(128, 64, nc, 8, **kw)
            self.conv_out32 = Head(128, 64, nc, 16, **kw)
            self.conv_outd = Head(64, 64, 1, 8, **kw)

    def forward(self, x):
        """NHWC image (N,H,W,3), H and W multiples of 64 -> NHWC logits at
        the input's resolution (a list of four with `augment`)."""
        x = x.permute(0, 3, 1, 2)
        with spans.span("model.context"):
            feat_cp8, feat_cp16, feat_d_out, feat_d = self.cp(x)
        with spans.span("model.spatial"):
            feat_sp = self.sp(x)
        with spans.span("model.bag"):
            feat_bg = self.dfm(feat_sp, feat_cp8, feat_d_out)
        with spans.span("model.ffm"):
            feat_fuse = self.ffm(feat_bg)
        with spans.span("model.head"):
            out = self.conv_out(feat_fuse)
            heads, inputs = [out], [feat_fuse]
            if self.spec.augment:
                heads = [self.conv_out16(feat_cp8), self.conv_out32(feat_cp16), out,
                         self.conv_outd(feat_d)]
                inputs = [feat_cp8, feat_cp16, feat_fuse, feat_d]
            heads = [h.permute(0, 2, 3, 1) for h in heads]
        for h, i in zip(heads, inputs):  # while recording: each head's output to its input
            spans.backward_span("model.head.backward", h, [i])
        return heads if self.spec.augment else heads[0]
