"""PIDNet — three-branch (P=detail, I=context, D=boundary) real-time
semantic segmentation network as `nn.Module`s (counterpart of
pidnet_tpu/models/pidnet.py, whose canonical `_forward` this mirrors).

- `state_dict()` keys equal the JAX package's parameter and state names
  (`layer3_.0.conv1.weight`, `spp.scale1.1.running_var`, ...); conv
  weights are OIHW;
- `folded=True` builds the BN-folded inference form: each conv+BN pair is
  one biased conv (the BN slot holds no parameters) and each standalone BN
  is a per-channel `scale`/`shift` (convert/fold.py produces its weights);
- the forward takes an NHWC image batch and returns NHWC logits at 1/8
  resolution; inside, tensors are NCHW views (channels_last when the
  input and weights are), and the activation dtype is the compute dtype;
- every interior bilinear resize uses align_corners=False;
- `augment=True` returns `[p_logits, logits, d_logits]`;
- `module_for(spec)` maps a spec to its family's network: PIDNet here,
  DDRNet-23 (models/ddrnet.py) and BiSeNetV1 (models/bisenet.py) built
  from this file's blocks; `build`, `init` and convert/fold.py take any of
  the three;
- in training mode (`build(..., train=True)`) each BN normalises with its
  batch statistics and updates its running buffers in place; a bf16 input
  runs every conv in bf16 on fp32 weights cast at the conv (the JAX
  `compute_dtype=bfloat16` contract);
- `spatial_sharding(model, mesh)` runs a network of any family on this
  rank's H rows of an H-sharded batch (parallel/spatial.py): its k > 1
  convs exchange halo rows, its interior resizes and pools compute the
  rank's rows of the whole image's, its BNs take the global batch's
  statistics, and `_hint` gathers the 1/32 map for layer5 and the PPM
  ("pre_spp") and scatters their 1/8 output back ("post_spp"), the JAX
  package's two partitioning points.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
from torch import nn

from pidnet_tpu_torch import resolve_device
from pidnet_tpu_torch.nn.functional import (
    affine,
    avg_pool2d,
    batch_norm_infer,
    batch_norm_train,
    conv2d,
    global_avg_pool,
    relu,
    sigmoid,
)
from pidnet_tpu_torch.ops.resize import interpolate
from pidnet_tpu_torch.parallel import spatial as SP
from pidnet_tpu_torch.utils import spans

ALGC = False  # align_corners for all interior resizes


@dataclass(frozen=True)
class PIDNetSpec:
    m: int = 2
    n: int = 3
    num_classes: int = 19
    planes: int = 64
    ppm_planes: int = 96
    head_planes: int = 128
    augment: bool = True


def spec_for(name: str, num_classes: int, augment: bool) -> PIDNetSpec:
    """Variant selection by substring ('s' wins over 'm', else L)."""
    if "s" in name:
        return PIDNetSpec(2, 3, num_classes, 32, 96, 128, augment)
    if "m" in name:
        return PIDNetSpec(2, 3, num_classes, 64, 96, 128, augment)
    return PIDNetSpec(3, 4, num_classes, 64, 112, 256, augment)


# ---------------------------------------------------------------------------
# Leaf modules
# ---------------------------------------------------------------------------


class Conv2d(nn.Module):
    """k x k conv, padding k//2, OIHW weight; runs in the input's dtype.
    With `spatial` set (a `parallel.spatial.SpatialMesh`, see
    `spatial_sharding`) it is this rank's rows of the whole image's conv."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.spatial = None

    def forward(self, x):
        if self.spatial is not None:
            return SP.conv_rows(x, self.weight, self.bias, self.stride, self.groups, self.spatial)
        return conv2d(x, self.weight, self.bias, stride=self.stride, groups=self.groups)


class BatchNorm(nn.Module):
    """BatchNorm, eps 1e-5; keys weight/bias/running_mean/running_var. In
    training mode it normalises with the batch statistics and updates the
    running buffers in place (momentum 0.1, unbiased variance), as the span
    `bn` (utils/spans.py); with `sync` set (a `parallel.mesh.Mesh`, see
    `sync_batch_norm`, or a `parallel.spatial.ReplicatedSync`, see
    `spatial_sharding`) the statistics are the mesh's global batch's."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))
        self.register_buffer("running_mean", torch.empty(ch))
        self.register_buffer("running_var", torch.empty(ch))
        self.sync = None

    def forward(self, x):
        if not self.training:
            return batch_norm_infer(x, self.weight, self.bias, self.running_mean,
                                    self.running_var)
        with spans.span("bn"):
            y, mean, var = batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                            self.running_var, sync=self.sync)
            with torch.no_grad():
                torch._foreach_copy_((self.running_mean, self.running_var), (mean, var))
            return y


@contextlib.contextmanager
def sync_batch_norm(model: nn.Module, mesh):
    """Inside, every BatchNorm of `model` in training mode takes the batch
    statistics of `mesh`'s global batch (None: its own); the train step's
    sync BN. Each family builds its BNs from this module's BatchNorm."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.sync = mesh
    try:
        yield
    finally:
        for bn in bns:
            bn.sync = None


def _resize(mod: nn.Module, x, hw, align_corners: bool):
    """An interior bilinear resize of NCHW `x` to `hw`; under
    `spatial_sharding` (`mod.spatial` set) this rank's rows of the whole
    image's resize, `x` and `hw` the rank's shares."""
    if mod.spatial is None:
        return interpolate(x, hw, align_corners)
    return SP.resize_sharded(x, hw, align_corners, mod.spatial)


class Affine(nn.Module):
    """A standalone BN after folding: per-channel `scale`, `shift`."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(ch))
        self.shift = nn.Parameter(torch.empty(ch))

    def forward(self, x):
        return affine(x, self.scale, self.shift)


class AvgPool(nn.Module):
    def __init__(self, kernel: int, stride: int, padding: int):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, x):
        return avg_pool2d(x, self.kernel, self.stride, self.padding)


class GlobalAvgPool(nn.Module):
    def forward(self, x):
        return global_avg_pool(x)


def _norm(ch: int, folded: bool) -> nn.Module:
    """A standalone (pre-activation) BN."""
    return Affine(ch) if folded else BatchNorm(ch)


def _paired_norm(ch: int, folded: bool) -> nn.Module:
    """The BN of a conv+BN pair: folded into the conv when `folded`."""
    return nn.Identity() if folded else BatchNorm(ch)


class CBR(nn.Module):
    """Conv then BN then ReLU, children named `conv`/`bn` (BiSeNet's
    ConvBNReLU) — one foldable pair."""

    fold_pairs = (("conv", "bn"),)

    def __init__(self, cin, cout, k, stride=1, *, folded):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride, bias=folded)
        self.bn = _paired_norm(cout, folded)

    def forward(self, x):
        return relu(self.bn(self.conv(x)))


class ConvBN(nn.Sequential):
    """Conv (key .0) then BN (key .1) — one foldable pair."""

    fold_pairs = (("0", "1"),)

    def __init__(self, cin, cout, k, stride=1, *, folded):
        super().__init__(Conv2d(cin, cout, k, stride, bias=folded), _paired_norm(cout, folded))


def _bn_relu_conv(cin, cout, k, *, folded, groups=1, pool=None) -> nn.Sequential:
    """Pre-activation branch [pool] -> BN -> ReLU -> conv."""
    mods = [] if pool is None else [pool]
    return nn.Sequential(*mods, _norm(cin, folded), nn.ReLU(), Conv2d(cin, cout, k, groups=groups))


class Stem(nn.Sequential):
    """Two stride-2 3x3 conv+BN+ReLU (keys .0/.1, .3/.4); both convs keep a
    bias, the only biased convs outside the heads."""

    fold_pairs = (("0", "1"), ("3", "4"))

    def __init__(self, planes, *, folded):
        super().__init__(
            Conv2d(3, planes, 3, 2, bias=True), _paired_norm(planes, folded), nn.ReLU(),
            Conv2d(planes, planes, 3, 2, bias=True), _paired_norm(planes, folded), nn.ReLU(),
        )


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class BasicBlock(nn.Module):
    """ResNet basic block, expansion 1."""

    expansion = 1

    def __init__(self, cin, planes, stride=1, no_relu=False, *, folded):
        super().__init__()
        self.no_relu = no_relu
        self.conv1 = Conv2d(cin, planes, 3, stride, bias=folded)
        self.bn1 = _paired_norm(planes, folded)
        self.conv2 = Conv2d(planes, planes, 3, bias=folded)
        self.bn2 = _paired_norm(planes, folded)
        self.fold_pairs = [("conv1", "bn1"), ("conv2", "bn2")]
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = ConvBN(cin, planes, 1, stride, folded=folded)

    def forward(self, x):
        out = relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        out = out + (x if self.downsample is None else self.downsample(x))
        return out if self.no_relu else relu(out)


class Bottleneck(nn.Module):
    """Bottleneck, expansion 2."""

    expansion = 2

    def __init__(self, cin, planes, stride=1, no_relu=True, *, folded):
        super().__init__()
        self.no_relu = no_relu
        cout = planes * 2
        self.conv1 = Conv2d(cin, planes, 1, bias=folded)
        self.bn1 = _paired_norm(planes, folded)
        self.conv2 = Conv2d(planes, planes, 3, stride, bias=folded)
        self.bn2 = _paired_norm(planes, folded)
        self.conv3 = Conv2d(planes, cout, 1, bias=folded)
        self.bn3 = _paired_norm(cout, folded)
        self.fold_pairs = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = ConvBN(cin, cout, 1, stride, folded=folded)

    def forward(self, x):
        out = relu(self.bn1(self.conv1(x)))
        out = relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        out = out + (x if self.downsample is None else self.downsample(x))
        return out if self.no_relu else relu(out)


def _layer(block, cin, planes, blocks, stride=1, *, folded) -> nn.Sequential:
    """Sequential residual stage: the first block keeps the block type's
    default no_relu (Bottleneck: True, BasicBlock: False), later blocks
    relu except the stage's last."""
    default_no_relu = block is Bottleneck
    mods = []
    for i in range(blocks):
        no_relu = default_no_relu if i == 0 else i == blocks - 1
        mods.append(block(cin, planes, stride if i == 0 else 1, no_relu, folded=folded))
        cin = planes * block.expansion
    return nn.Sequential(*mods)


class SegHead(nn.Module):
    """Pre-activation segmentation head."""

    def __init__(self, cin, interplanes, outplanes, scale_factor=None, *, folded):
        super().__init__()
        self.scale_factor = scale_factor
        self.bn1 = _norm(cin, folded)
        self.conv1 = Conv2d(cin, interplanes, 3)
        self.bn2 = _norm(interplanes, folded)
        self.conv2 = Conv2d(interplanes, outplanes, 1, bias=True)

    def forward(self, x):
        y = self.conv1(relu(self.bn1(x)))
        out = self.conv2(relu(self.bn2(y)))
        if self.scale_factor is not None:
            hw = (y.shape[2] * self.scale_factor, y.shape[3] * self.scale_factor)
            out = interpolate(out, hw, ALGC)
        return out


class PagFM(nn.Module):
    """Pixel-attention-guided fusion; its resizes use align_corners=False."""

    def __init__(self, cin, mid, after_relu=False, with_channel=False, *, folded):
        super().__init__()
        self.after_relu, self.with_channel = after_relu, with_channel
        self.f_x = ConvBN(cin, mid, 1, folded=folded)
        self.f_y = ConvBN(cin, mid, 1, folded=folded)
        if with_channel:
            self.up = ConvBN(mid, cin, 1, folded=folded)
        self.spatial = None

    def forward(self, x, y):
        hw = (x.shape[2], x.shape[3])
        if self.after_relu:
            x, y = relu(x), relu(y)
        y_q = _resize(self, self.f_y(y), hw, False)
        x_k = self.f_x(x)
        if self.with_channel:
            sim = sigmoid(self.up(x_k * y_q))
        else:
            sim = sigmoid(torch.sum(x_k * y_q, dim=1, keepdim=True))
        y_up = _resize(self, y, hw, False)
        return (1 - sim) * x + sim * y_up


def _pools():
    return [AvgPool(5, 2, 2), AvgPool(9, 4, 4), AvgPool(17, 8, 8), GlobalAvgPool()]


class PAPPM(nn.Module):
    """Parallel aggregation PPM (S/M)."""

    def __init__(self, cin, branch_planes, outplanes, *, folded):
        super().__init__()
        bp = branch_planes
        self.scale0 = _bn_relu_conv(cin, bp, 1, folded=folded)
        for i, pool in enumerate(_pools(), start=1):
            setattr(self, f"scale{i}", _bn_relu_conv(cin, bp, 1, folded=folded, pool=pool))
        self.scale_process = _bn_relu_conv(bp * 4, bp * 4, 3, folded=folded, groups=4)
        self.compression = _bn_relu_conv(bp * 5, outplanes, 1, folded=folded)
        self.shortcut = _bn_relu_conv(cin, outplanes, 1, folded=folded)

    def forward(self, x):
        hw = (x.shape[2], x.shape[3])
        x0 = self.scale0(x)
        scales = [
            interpolate(getattr(self, f"scale{i}")(x), hw, ALGC) + x0 for i in range(1, 5)
        ]
        scale_out = self.scale_process(torch.cat(scales, dim=1))
        out = self.compression(torch.cat([x0, scale_out], dim=1))
        return out + self.shortcut(x)


class DAPPM(nn.Module):
    """Deep aggregation PPM (L): sequential refinement across scales."""

    def __init__(self, cin, branch_planes, outplanes, *, folded):
        super().__init__()
        bp = branch_planes
        self.scale0 = _bn_relu_conv(cin, bp, 1, folded=folded)
        for i, pool in enumerate(_pools(), start=1):
            setattr(self, f"scale{i}", _bn_relu_conv(cin, bp, 1, folded=folded, pool=pool))
            setattr(self, f"process{i}", _bn_relu_conv(bp, bp, 3, folded=folded))
        self.compression = _bn_relu_conv(bp * 5, outplanes, 1, folded=folded)
        self.shortcut = _bn_relu_conv(cin, outplanes, 1, folded=folded)

    def forward(self, x):
        hw = (x.shape[2], x.shape[3])
        feats = [self.scale0(x)]
        for i in range(1, 5):
            up = interpolate(getattr(self, f"scale{i}")(x), hw, ALGC)
            feats.append(getattr(self, f"process{i}")(up + feats[-1]))
        out = self.compression(torch.cat(feats, dim=1))
        return out + self.shortcut(x)


class LightBag(nn.Module):
    """S/M fusion of the P, I and D branches."""

    def __init__(self, cin, outplanes, *, folded):
        super().__init__()
        self.conv_p = ConvBN(cin, outplanes, 1, folded=folded)
        self.conv_i = ConvBN(cin, outplanes, 1, folded=folded)

    def forward(self, p, i, d):
        att = sigmoid(d)
        return self.conv_p((1 - att) * i + p) + self.conv_i(i + att * p)


class Bag(nn.Module):
    """L fusion of the P, I and D branches."""

    def __init__(self, cin, outplanes, *, folded):
        super().__init__()
        self.conv = _bn_relu_conv(cin, outplanes, 3, folded=folded)

    def forward(self, p, i, d):
        att = sigmoid(d)
        return self.conv(att * p + (1 - att) * i)


# ---------------------------------------------------------------------------
# Full network
# ---------------------------------------------------------------------------


class Network(nn.Module):
    """A whole network of one family: NHWC image in, NHWC logits out.
    `seg_heads` is the number of segmentation heads an augment model
    returns before its boundary head, which is last: the number of
    FullLoss balance weights (`balance_weights`).

    H-sharding (`spatial_sharding`) reads two declarations of a family:
    `replicated`, the dotted names of the submodules that run on a map
    replicated over the S ranks of a spatial row (None: the family does
    not run H-sharded), and, in each module class that computes across
    rows other than through a k > 1 conv, a `spatial` attribute."""

    seg_heads = 2
    replicated: tuple[str, ...] | None = None
    spatial = None

    def _hint(self, name: str, x):
        """The JAX package's partitioning points, "pre_spp" and "post_spp";
        identity unless `spatial_sharding` set `spatial`
        (parallel/spatial.hint)."""
        return x if self.spatial is None else SP.hint(name, x, self.spatial)

    def conv_bn_pairs(self) -> list[tuple[str, str]]:
        """(conv, bn) module names of every conv+BN pair, gathered from
        each submodule's `fold_pairs`."""
        return [
            (f"{name}.{conv}", f"{name}.{bn}")
            for name, mod in self.named_modules()
            for conv, bn in getattr(mod, "fold_pairs", ())
        ]


class PIDNet(Network):
    replicated = ("layer5", "spp")  # the 1/64 stage, on the gathered 1/32 map

    def __init__(self, spec: PIDNetSpec, *, folded: bool = False):
        super().__init__()
        self.spec, self.folded = spec, folded
        p, m, n = spec.planes, spec.m, spec.n
        kw = {"folded": folded}
        d3_planes = p if m == 2 else p * 2
        # I branch
        self.conv1 = Stem(p, **kw)
        self.layer1 = _layer(BasicBlock, p, p, m, **kw)
        self.layer2 = _layer(BasicBlock, p, p * 2, m, 2, **kw)
        self.layer3 = _layer(BasicBlock, p * 2, p * 4, n, 2, **kw)
        self.layer4 = _layer(BasicBlock, p * 4, p * 8, n, 2, **kw)
        self.layer5 = _layer(Bottleneck, p * 8, p * 8, 2, 2, **kw)
        # P branch
        self.compression3 = ConvBN(p * 4, p * 2, 1, **kw)
        self.compression4 = ConvBN(p * 8, p * 2, 1, **kw)
        self.pag3 = PagFM(p * 2, p, **kw)
        self.pag4 = PagFM(p * 2, p, **kw)
        self.layer3_ = _layer(BasicBlock, p * 2, p * 2, m, **kw)
        self.layer4_ = _layer(BasicBlock, p * 2, p * 2, m, **kw)
        self.layer5_ = _layer(Bottleneck, p * 2, p * 2, 1, **kw)
        # D branch
        self.layer3_d = BasicBlock(p * 2, d3_planes, no_relu=True, **kw)
        self.diff3 = ConvBN(p * 4, d3_planes, 3, **kw)
        self.diff4 = ConvBN(p * 8, p * 2, 3, **kw)
        if m == 2:
            self.layer4_d = _layer(Bottleneck, p, p, 1, **kw)
            self.spp = PAPPM(p * 16, spec.ppm_planes, p * 4, **kw)
            self.dfm = LightBag(p * 4, p * 4, **kw)
        else:
            self.layer4_d = BasicBlock(p * 2, p * 2, no_relu=True, **kw)
            self.spp = DAPPM(p * 16, spec.ppm_planes, p * 4, **kw)
            self.dfm = Bag(p * 4, p * 4, **kw)
        self.layer5_d = _layer(Bottleneck, p * 2, p * 2, 1, **kw)
        if spec.augment:
            self.seghead_p = SegHead(p * 2, spec.head_planes, spec.num_classes, **kw)
            self.seghead_d = SegHead(p * 2, p, 1, **kw)
        self.final_layer = SegHead(p * 4, spec.head_planes, spec.num_classes, **kw)

    def forward(self, x):
        """NHWC image (N,H,W,3), H and W multiples of 64 -> NHWC logits at
        1/8 resolution (a list of three with `augment`)."""
        x = x.permute(0, 3, 1, 2)
        hw8 = (x.shape[2] // 8, x.shape[3] // 8)
        x = self.layer1(self.conv1(x))
        x = relu(self.layer2(relu(x)))
        x_ = self.layer3_(x)
        x_d = self.layer3_d(x)
        x = relu(self.layer3(x))  # I @1/16
        # The reference's inplace ReLU mutates the saved temp_p after pag3,
        # so seghead_p reads relu(pag3 output); the same holds for temp_d.
        y = self.compression3(x)
        with spans.span("model.pag"):
            x_ = self.pag3(x_, y)
        x_ = relu(x_)
        temp_p = x_
        x_d = x_d + _resize(self, self.diff3(x), hw8, ALGC)
        x = relu(self.layer4(x))  # I @1/32
        x_ = self.layer4_(x_)
        x_d = self.layer4_d(relu(x_d))
        y = self.compression4(x)
        with spans.span("model.pag"):
            x_ = self.pag4(x_, y)
        x_d = relu(x_d + _resize(self, self.diff4(x), hw8, ALGC))
        temp_d = x_d
        x_ = self.layer5_(relu(x_))
        x_d = self.layer5_d(x_d)
        x = self.layer5(self._hint("pre_spp", x))
        with spans.span("model.ppm"):
            x = self.spp(x)  # I @1/64
        # to 8x the 1/64 map, the input's 1/8 (H and W multiples of 64): under
        # H-sharding the map is the whole image's and hw8 only a shard's
        x = self._hint("post_spp", interpolate(x, (8 * x.shape[2], 8 * x.shape[3]), ALGC))
        with spans.span("model.bag"):
            x = self.dfm(x_, x, x_d)
        with spans.span("model.head"):
            out = self.final_layer(x)
            if self.spec.augment:
                heads = [self.seghead_p(temp_p), out, self.seghead_d(temp_d)]
                return [h.permute(0, 2, 3, 1) for h in heads]
            return out.permute(0, 2, 3, 1)


@contextlib.contextmanager
def spatial_sharding(model: Network, mesh):
    """Inside, `model` runs on this rank's H rows of a batch sharded over
    `mesh` (`parallel.spatial.SpatialMesh`; `shard_rows` places the batch)
    and returns the rank's rows of the whole batch's heads: each k > 1 conv
    exchanges its halo rows (`conv_rows`), and each module that carries a
    `spatial` attribute (its resizes, pools and partitioning points) takes
    the mesh: a resize computes the rank's rows of the whole image's
    (`resize_sharded`), a max pool its rows (`max_pool_rows`), a global
    pool the whole image's (`global_pool_rows`), and `_hint` gathers the
    1/32 map before the 1/64 stage and scatters its 1/8 output. Each BN in
    training mode takes the global batch's statistics: over the mesh
    outside the family's `replicated` submodules, and inside them, where
    the S ranks of a row hold the same map, with the global count of
    n_data ranks' (`parallel.spatial.replicated_sync`). A network that
    declares no `replicated` parts raises TypeError: it never runs
    unsharded."""
    if getattr(model, "replicated", None) is None:
        raise TypeError(f"{type(model).__name__} declares no spatial parts (Network.replicated): "
                        "it cannot run H-sharded")
    gathered = {id(m) for name in model.replicated for m in model.get_submodule(name).modules()}
    replicated = SP.replicated_sync(mesh)
    touched = []
    for m in model.modules():
        inside = id(m) in gathered
        if isinstance(m, BatchNorm):
            m.sync = replicated if inside else mesh.world
        elif (hasattr(m, "spatial") and not inside
              and not (isinstance(m, Conv2d) and m.weight.shape[-1] == 1)):
            m.spatial = mesh
        else:
            continue
        touched.append(m)
    try:
        yield
    finally:
        for m in touched:
            if isinstance(m, BatchNorm):
                m.sync = None
            else:
                m.spatial = None


def module_for(spec) -> type[Network]:
    """The network class of a spec's family: PIDNetSpec -> PIDNet,
    DDRNetSpec -> DDRNet, BiSeNetSpec -> BiSeNet (the JAX package's
    `forward_fn` extension point, keyed on the spec's type)."""
    from pidnet_tpu_torch.models import bisenet, ddrnet  # they import this module

    families = {PIDNetSpec: PIDNet, ddrnet.DDRNetSpec: ddrnet.DDRNet,
                bisenet.BiSeNetSpec: bisenet.BiSeNet}
    if type(spec) not in families:
        raise TypeError(f"no network for spec {spec!r}")
    return families[type(spec)]


def balance_weights(spec) -> tuple[float, ...]:
    """The reference recipe's LOSS.BALANCE_WEIGHTS for `spec`'s family:
    0.4 for each auxiliary segmentation head, 1.0 for the final one."""
    return (0.4,) * (module_for(spec).seg_heads - 1) + (1.0,)


def build(spec, state_dict: dict, *, folded: bool = False,
          device=None, train: bool = False) -> Network:
    """The network of `spec`'s family (`module_for`) on `device`
    (`resolve_device`: the card unless the caller names another) holding
    `state_dict`'s tensors as fp32: in eval mode, or with `train=True` an
    unfolded model in training mode, in channels_last, whose parameters
    take gradients. Keys the model lacks, such as the aux heads of an
    augment=False model, are ignored; a key the model needs and
    `state_dict` lacks raises."""
    if train and folded:
        raise ValueError("a folded model has no BN to train")
    device = resolve_device(device)
    with torch.device("meta"):
        model = module_for(spec)(spec, folded=folded)
    model = model.to_empty(device=device)
    want = model.state_dict().keys()
    missing = [k for k in want if k not in state_dict]
    if missing:
        raise KeyError(f"state_dict lacks {len(missing)} tensors, e.g. {missing[:3]}")
    model.load_state_dict({k: state_dict[k] for k in want})
    if train:
        return model.to(memory_format=torch.channels_last).train()
    return model.eval()


def init(spec, generator: torch.Generator | None = None) -> dict:
    """Random unfolded weights of `spec`'s network on the CPU:
    kaiming-normal (fan_out, relu) conv weights, uniform(+-1/sqrt(fan_in))
    conv biases, BN gamma 1, beta 0, running mean 0, var 1. Draws follow
    module order and differ from the JAX package's for the same seed."""
    with torch.device("meta"):
        model = module_for(spec)(spec)
    sd = {}
    for name, mod in model.named_modules():
        prefix = name + "."
        if isinstance(mod, Conv2d):
            cout, cin_g, k, _ = mod.weight.shape
            std = math.sqrt(2.0 / (cout * k * k))
            sd[prefix + "weight"] = torch.randn(mod.weight.shape, generator=generator) * std
            if mod.bias is not None:
                bound = 1.0 / math.sqrt(cin_g * k * k)
                u = torch.rand(cout, generator=generator)
                sd[prefix + "bias"] = (u * 2 - 1) * bound
        elif isinstance(mod, BatchNorm):
            ch = mod.weight.shape[0]
            sd[prefix + "weight"] = torch.ones(ch)
            sd[prefix + "bias"] = torch.zeros(ch)
            sd[prefix + "running_mean"] = torch.zeros(ch)
            sd[prefix + "running_var"] = torch.ones(ch)
    return sd
