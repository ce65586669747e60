"""Weights and inputs made from the seed, on the device, in a few large
calls of one `torch.Generator` there: the same seed gives the same tensors,
and every seed gives the same shapes.

- `weights`: every tensor of the configuration's network (its reference's
  own list of names and shapes, `describe`), float32:
  conv weights kaiming-normal (fan_out, relu), conv biases
  uniform(+-1/sqrt(fan_in)), BN gamma in [0.5, 1.5) (a tenth of that on
  the last BN of each residual branch, as trained residual networks have
  them small: a network of random branches at full scale amplifies any
  rounding tenfold and more, and so tells bfloat16 from float8 poorly)
  and beta in [-0.1, 0.1); the BN running statistics are then those of one
  training-mode forward of the reference (`calibrate`) over seeded normal
  images, as a trained network's match its activations: a network whose
  statistics do not grows its activations with depth and is no fair test
  of a precision.
- `frames`: batches of NHWC float32 frames, standard normal.
- `crops`: training batches (NHWC float32 images, (N,H,W) int32 labels,
  (N,H,W) float32 edges). The labels are seeded regions: each pixel takes
  the class of its nearest of `regions` seeded sites, and a share of the
  sites is the ignore label. The edges are the region boundaries, dilated:
  a pixel is an edge where its `edge_width` x `edge_width` neighbourhood
  holds two labels. The images are each class's seeded colour plus
  `noise` times standard normal noise, so the loss sees regions that a
  model can tell apart.
"""

from __future__ import annotations

import importlib
import math

import torch
import torch.nn.functional as F

from perfbench.reference import float32


def reference(config: dict):
    """The plain reference of the configuration's family,
    perfbench/reference/<family>.py."""
    return importlib.import_module(f"perfbench.reference.{config['family']}")


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator of its own for each use of one seed."""
    return torch.Generator(device=device).manual_seed(int(seed) * 8 + stream)


def weights(config: dict, device, seed: int) -> dict:
    net = reference(config).describe({**config, "augment": True}, 1, 64, 64)
    gen = generator(device, seed, 0)
    by_kind: dict[str, list] = {}
    for name, (shape, kind) in net.specs.items():
        by_kind.setdefault(kind, []).append((name, shape))
    out = {}

    def draw(kind, fn):
        items = by_kind.get(kind, [])
        total = sum(math.prod(s) for _, s in items)
        flat = fn(total)
        for (name, shape), part in zip(items, torch.split(flat, [math.prod(s) for _, s in items])):
            out[name] = part.view(shape)
        return items

    normal = lambda n: torch.randn(n, generator=gen, device=device)  # noqa: E731
    uniform = lambda n: torch.rand(n, generator=gen, device=device)  # noqa: E731
    for name, shape in draw("conv_weight", normal):
        out[name] *= math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    conv_shapes = {n: s for n, s in net.specs.items()}
    for name, _ in draw("conv_bias", uniform):
        cout, cin_g, k, _ = conv_shapes[name[: -len("bias")] + "weight"][0]
        out[name] = (out[name] * 2 - 1) / math.sqrt(cin_g * k * k)
    for kind, lo, hi in (("bn_weight", 0.5, 1.5), ("bn_bias", -0.1, 0.1),
                         ("bn_mean", 0.0, 0.0), ("bn_var", 1.0, 1.0)):
        for name, _ in draw(kind, uniform):
            out[name] = lo + (hi - lo) * out[name]
    for bn in net.branch_ends:
        out[bn + ".weight"] *= BRANCH_END_GAMMA
    calibrate(config, out, normal(CALIBRATION_NUMEL).view(CALIBRATION_SHAPE))
    return out


BRANCH_END_GAMMA = 0.1
CALIBRATION_SHAPE = (4, 3, 256, 512)
CALIBRATION_NUMEL = math.prod(CALIBRATION_SHAPE)


@torch.no_grad()
def calibrate(config: dict, weights: dict, images: torch.Tensor) -> None:
    """Set every BN's running statistics, in place, to its batch statistics
    in one training-mode forward of the reference over NCHW `images`
    (momentum 1; float32 products, no TF32)."""
    ref = reference(config)
    net = ref.Net(weights, train=True)
    net.momentum = 1.0
    with float32():
        ref.forward(net, images, {**config, "augment": True})
    for name, value in net.new_stats.items():
        weights[name].copy_(value)


def frames(traffic: dict, device, seed: int) -> list[torch.Tensor]:
    gen = generator(device, seed, 1)
    shape = (traffic["batch"], traffic["height"], traffic["width"], 3)
    return [torch.randn(shape, generator=gen, device=device) for _ in range(traffic["batches"])]


def _regions(n, h, w, sites, classes, ignore_share, ignore_label, gen, device):
    """(n, h, w) int32: the class of each pixel's nearest seeded site."""
    pos = torch.rand((n, sites, 2), generator=gen, device=device) * torch.tensor(
        [h, w], device=device, dtype=torch.float32)
    cls = torch.randint(0, classes, (n, sites), generator=gen, device=device)
    ignored = torch.rand((n, sites), generator=gen, device=device) < ignore_share
    cls = torch.where(ignored, ignore_label, cls).to(torch.int32)
    ys = torch.arange(h, device=device, dtype=torch.float32)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    out = torch.empty((n, h, w), dtype=torch.int32, device=device)
    for i in range(n):  # one crop at a time: (h, w, sites) distances
        d = ((ys[:, None, None] - pos[i, None, None, :, 0]) ** 2
             + (xs[None, :, None] - pos[i, None, None, :, 1]) ** 2)
        out[i] = cls[i][d.argmin(-1)]
    return out


def edges_of(labels: torch.Tensor, width: int) -> torch.Tensor:
    """(n, h, w) float32 1.0 where a width x width window holds two labels."""
    x = labels[:, None].float()
    pad = width // 2
    hi = F.max_pool2d(x, width, 1, pad)
    lo = -F.max_pool2d(-x, width, 1, pad)
    return (hi != lo)[:, 0].float()


def crops(traffic: dict, config: dict, device, seed: int) -> list[tuple]:
    gen = generator(device, seed, 2)
    n, h, w = traffic["batch"], traffic["height"], traffic["width"]
    classes = config["num_classes"]
    ignore = config["train"]["ignore_label"]
    out = []
    for _ in range(traffic["batches"]):
        labels = _regions(n, h, w, traffic["regions"], classes, traffic["ignore_share"], ignore,
                          gen, device)
        colours = torch.randn((classes + 1, 3), generator=gen, device=device)
        index = torch.where(labels == ignore, classes, labels).long()
        images = colours[index] + traffic["noise"] * torch.randn(
            (n, h, w, 3), generator=gen, device=device)
        out.append((images, labels, edges_of(labels, traffic["edge_width"])))
    return out
