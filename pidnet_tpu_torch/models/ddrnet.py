"""DDRNet-23 + ADB + Bag, the reference's first paper ablation, as an
`nn.Module` (counterpart of pidnet_tpu/models/ddrnet.py), built from the
block library of models/pidnet.py and reached through
`models.pidnet.module_for`, so that `build`, `init`, BN folding, the train
and eval steps and the engine take it unchanged.

Two-branch DDRNet trunk with PIDNet's derivative (boundary) branch:

- bidirectional fusion: the I branch receives the P branch back
  (`x + down3(relu(x_))`, `x + down4(relu(x_))`) while P receives plain
  compression adds, no PagFM;
- compression3/diff3 read layer3's pre-fusion output `l3`, and
  compression4/diff4 layer4's `l4`;
- the ReLU is not in place, so the aux heads read the pre-activation
  `temp_p`/`temp_d`;
- the fusion is `Bag` (the reference's `DFM3` does not exist);
- `augment=True` returns `[x_extra, out, x_bd]`, NHWC at 1/8 resolution;
- under `models.pidnet.spatial_sharding` it runs as PIDNet does: the 1/32
  map gathered before layer5 and the DAPPM, their output resized to 8x the
  1/64 map and scattered back. The JAX forward has no such points, so its
  GSPMD partitioner splits the DAPPM's pools, which gives wrong gradients
  on a (2, 2) mesh (scripts/spatial_quirk.py; ROADMAP.md, reference
  quirks); the gather is a layout choice here, the numerics those of the
  global program.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from pidnet_tpu_torch.models.pidnet import (
    ALGC,
    DAPPM,
    Bag,
    BasicBlock,
    Bottleneck,
    Conv2d,
    ConvBN,
    Network,
    SegHead,
    Stem,
    _layer,
    _paired_norm,
    _resize,
)
from pidnet_tpu_torch.nn.functional import relu
from pidnet_tpu_torch.ops.resize import interpolate


@dataclass(frozen=True)
class DDRNetSpec:
    num_classes: int = 19
    planes: int = 64
    spp_planes: int = 128
    head_planes: int = 128
    m: int = 2  # trunk blocks per stage (DDRNet-23: layers=[2,2,2,2])
    augment: bool = True


def spec_for(name: str, num_classes: int, augment: bool) -> DDRNetSpec:
    """The reference's DualResNet_imagenet configuration."""
    if "ddrnet" not in name:
        raise ValueError(f"{name!r} is not a DDRNet name")
    return DDRNetSpec(num_classes=num_classes, augment=augment)


class Down4(nn.Sequential):
    """The two-step /4 descent of the P branch into the I branch:
    conv+BN (.0/.1), ReLU, conv+BN (.3/.4)."""

    fold_pairs = (("0", "1"), ("3", "4"))

    def __init__(self, cin, mid, cout, *, folded):
        super().__init__(
            Conv2d(cin, mid, 3, 2, bias=folded), _paired_norm(mid, folded), nn.ReLU(),
            Conv2d(mid, cout, 3, 2, bias=folded), _paired_norm(cout, folded),
        )


class DDRNet(Network):
    replicated = ("layer5", "spp")  # the 1/64 stage, on the gathered 1/32 map

    def __init__(self, spec: DDRNetSpec, *, folded: bool = False):
        super().__init__()
        self.spec, self.folded = spec, folded
        p, m = spec.planes, spec.m
        hr = p * 2  # the high-resolution branch's planes
        kw = {"folded": folded}
        self.conv1 = Stem(p, **kw)
        self.layer1 = _layer(BasicBlock, p, p, m, **kw)
        self.layer2 = _layer(BasicBlock, p, p * 2, m, 2, **kw)
        self.layer3 = _layer(BasicBlock, p * 2, p * 4, m, 2, **kw)
        self.layer4 = _layer(BasicBlock, p * 4, p * 8, m, 2, **kw)
        self.layer5 = _layer(Bottleneck, p * 8, p * 8, 1, 2, **kw)
        self.layer3_ = _layer(BasicBlock, hr, hr, 2, **kw)
        self.layer4_ = _layer(BasicBlock, hr, hr, 2, **kw)
        self.layer5_ = _layer(Bottleneck, hr, hr, 1, **kw)
        self.layer3_d = BasicBlock(hr, hr, no_relu=True, **kw)
        self.layer4_d = BasicBlock(hr, hr, no_relu=True, **kw)
        self.layer5_d = _layer(Bottleneck, hr, hr, 1, **kw)
        self.down3 = ConvBN(hr, p * 4, 3, 2, **kw)
        self.down4 = Down4(hr, p * 4, p * 8, **kw)
        self.compression3 = ConvBN(p * 4, hr, 1, **kw)
        self.compression4 = ConvBN(p * 8, hr, 1, **kw)
        self.diff3 = ConvBN(p * 4, hr, 3, **kw)
        self.diff4 = ConvBN(p * 8, hr, 3, **kw)
        self.spp = DAPPM(p * 16, spec.spp_planes, p * 4, **kw)
        self.dfm = Bag(p * 4, p * 4, **kw)
        if spec.augment:
            self.seghead_extra = SegHead(hr, spec.head_planes, spec.num_classes, **kw)
            self.seghead_bd = SegHead(hr, hr // 2, 1, **kw)
        self.final_layer = SegHead(p * 4, spec.head_planes, spec.num_classes, **kw)

    def forward(self, x):
        """NHWC image (N,H,W,3), H and W multiples of 64 -> NHWC logits at
        1/8 resolution (a list of three with `augment`)."""
        x = x.permute(0, 3, 1, 2)
        hw8 = (x.shape[2] // 8, x.shape[3] // 8)
        x = self.layer1(self.conv1(x))
        l2 = self.layer2(relu(x))
        l3 = self.layer3(relu(l2))  # the pre-fusion snapshot
        x_ = self.layer3_(relu(l2))
        x_d = self.layer3_d(relu(l2))
        x = l3 + self.down3(relu(x_))
        x_ = x_ + _resize(self, self.compression3(relu(l3)), hw8, ALGC)
        x_d = x_d + _resize(self, self.diff3(relu(l3)), hw8, ALGC)
        temp_p = x_  # pre-activation: the ReLU is not in place
        l4 = self.layer4(relu(x))
        x_ = self.layer4_(relu(x_))
        x_d = self.layer4_d(relu(x_d))
        x = l4 + self.down4(relu(x_))
        x_ = x_ + _resize(self, self.compression4(relu(l4)), hw8, ALGC)
        x_d = x_d + _resize(self, self.diff4(relu(l4)), hw8, ALGC)
        temp_d = x_d
        x_ = self.layer5_(relu(x_))
        x_d = self.layer5_d(relu(x_d))
        x = self.spp(self.layer5(self._hint("pre_spp", relu(x))))  # I @1/64
        # to 8x the 1/64 map, the input's 1/8: under H-sharding the map is the
        # whole image's and hw8 only a shard's (PIDNet's partitioning points)
        x = self._hint("post_spp", interpolate(x, (8 * x.shape[2], 8 * x.shape[3]), ALGC))
        out = self.final_layer(self.dfm(x_, x, x_d))
        if self.spec.augment:
            heads = [self.seghead_extra(temp_p), out, self.seghead_bd(temp_d)]
            return [h.permute(0, 2, 3, 1) for h in heads]
        return out.permute(0, 2, 3, 1)
