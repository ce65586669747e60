"""The port's BiSeNetV1 + ADB + Light_Bag (models/bisenet.py) against the
benchmark's plain float32 reference (perfbench/reference/bisenet.py) on the
CPU, on the benchmark's seeded weights (perfbench.harness.inputs.weights):
the four heads in training and eval mode, unfolded; the folded serving
forward; one float32 training step through `make_train_step` and FullLoss
against `reference.train.sgd_steps`; and the reference's conv MACs against
the port's convs counted by forward hooks.

Tolerances, with their reasons:
- Heads and the folded forward: rtol 1e-4 and atol 1e-4 of the largest
  logit, those of perfbench/tests/test_perfbench_reference.py. Both sides
  are float32 with the same operations in another order (the reference
  folds conv+BN in eval mode from the unfolded weights, the port keeps
  them apart), and the seeded logits reach 150: float32 rounding of such
  sums is near 1e-5 of the largest, a tenth of the limit.
- The training step, at the recipe's 12 samples (at 64 x 128): the loss
  to rel 1e-5, and each leaf's update direction and change to 5e-3 of
  the larger of the reference's norm of that leaf and of the median leaf.
  Two float32 computations of this step lie farther apart than PIDNet's
  (perfbench/tests/test_perfbench_reference.py holds it to 1e-4): the
  BNs after the three global pools normalise over only N pooled vectors,
  and the image convs' weight gradients (`cp.resnet.conv1`, `sp.conv1`)
  come through train-mode BNs over region-constant colours, both of which
  amplify rounding. Over 16 seeds the port and the float32 reference
  departed by up to 1.8e-3 of a leaf at 12 samples and up to 1.1e-2 at 4
  samples, which no limit that tells float32 from bfloat16 could hold; the
  losses by up to 2.2e-7. Against a float64 run of the reference (8 seeds
  at 12 samples) the port departed by up to 1.8e-3 and the float32
  reference by up to 3.4e-4: the port's BN sums in float32, as its CUDA
  kernels do, where torch's CPU BN accumulates in float64. A bfloat16
  step departs by 2.6e-2 to 4.8e-2 of a leaf and 1.1e-4 to 6.2e-4 of the
  loss (3 seeds), so both limits fail it.
- MACs: equal, as integers.
"""

import math

import pytest
import torch

from perfbench.harness import inputs, manifest
from perfbench.harness.program import spec_of
from perfbench.reference import bisenet as ref
from perfbench.reference import train as R
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.train.step import TrainState, make_train_step

torch.set_num_threads(2)

CONFIG = manifest.config("bisenetv1")
SIZE = (4, 64, 128)  # N, H, W of the forward tests
TRAIN_SIZE = (12, 64, 128)  # the training step's: the recipe's batch
HEADS = ["out16", "out32", "out", "outd"]


@pytest.fixture(scope="module")
def weights():
    return inputs.weights(CONFIG, "cpu", 22)


@pytest.fixture(scope="module")
def images():
    n, h, w = SIZE
    return torch.randn((n, h, w, 3), generator=torch.Generator().manual_seed(3))


def _close(mine, theirs):
    return torch.allclose(mine, theirs, rtol=1e-4, atol=1e-4 * float(theirs.abs().max()))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_each_head_matches_the_reference(weights, images, train):
    """The unfolded port, in eval mode (running statistics) and in training
    mode (batch statistics, over the 4 pooled vectors after each global
    pool too), against the reference in the same mode: the four heads at
    the input's resolution, and in training mode every new running
    statistic."""
    spec = spec_of(CONFIG, augment=True)
    model = M.build(spec, weights, device="cpu", train=train)
    net = ref.Net({k: v.clone() for k, v in weights.items()}, train=train)
    with torch.no_grad():
        mine = [o.permute(0, 3, 1, 2) for o in model(images)]
        theirs = ref.forward(net, images.permute(0, 3, 1, 2), {**CONFIG, "augment": True})
    assert len(mine) == len(theirs) == len(HEADS)
    for name, a, b in zip(HEADS, mine, theirs):
        assert a.shape == b.shape and a.shape[2:] == images.shape[1:3], name
        assert _close(a, b), (name, float((a - b).abs().max()), float(b.abs().max()))
    if train:
        buffers = dict(model.named_buffers())
        assert set(net.new_stats) <= set(buffers)
        for k, v in net.new_stats.items():
            assert torch.allclose(buffers[k], v, rtol=1e-4, atol=1e-5 * float(v.abs().max())), k


def test_folded_serving_forward_matches_the_reference(weights, images):
    spec = spec_of(CONFIG, augment=False)
    model = M.build(spec, fold_state_dict(weights, spec), folded=True, device="cpu")
    with torch.no_grad():
        mine = model(images).permute(0, 3, 1, 2)
        theirs = ref.forward(ref.Net(weights), images.permute(0, 3, 1, 2),
                             {**CONFIG, "augment": False})
    assert mine.shape == (SIZE[0], CONFIG["num_classes"], *SIZE[1:])
    assert _close(mine, theirs), float((mine - theirs).abs().max())


def test_one_float32_train_step_matches_the_reference(weights):
    n, h, w = TRAIN_SIZE
    traffic = {**manifest.traffic("train_b12"), "batch": n, "height": h, "width": w,
               "batches": 1}
    rec = {**CONFIG["train"], "min_kept": 20000}
    batch = inputs.crops(traffic, CONFIG, "cpu", 22)[0]
    ts = TrainState.create(M.build(spec_of(CONFIG, augment=True), weights, device="cpu",
                                   train=True))
    loss_fn = FullLoss(num_outputs=len(rec["balance_weights"]),
                       align_corners=rec["align_corners"], ignore_label=rec["ignore_label"],
                       class_weights=torch.tensor(rec["class_weights"]),
                       ohem_thres=rec["ohem_thres"], ohem_kept=rec["min_kept"],
                       balance_weights=rec["balance_weights"], sb_weights=rec["sb_weights"],
                       bd_coeff=rec["bd_coeff"])
    step = make_train_step(ts, loss_fn, momentum=rec["momentum"],
                           weight_decay=rec["weight_decay"])
    loss = float(step(*batch, rec["lr"])["loss"])
    got = R.sgd_steps(ref, weights, [batch], {**CONFIG, "augment": True}, rec, 1)
    assert loss == pytest.approx(got["losses"][0], rel=1e-5)
    leaves = dict(ts.model.named_parameters())
    leaves.update({k: v for k, v in ts.model.named_buffers() if k.endswith(R.STAT_SUFFIXES)})
    assert set(leaves) == set(got["change"])
    dir1, change = got["dir1"], got["change"]
    med_dir = sorted(dir1.values())[len(dir1) // 2]
    med_change = sorted(change.values())[len(change) // 2]
    for k, v in leaves.items():
        if k in ts.momentum:
            mine = float(ts.momentum[k].norm())
            assert abs(mine - dir1[k]) <= 5e-3 * max(dir1[k], med_dir), k
        moved = float((v.detach() - weights[k]).norm())
        assert abs(moved - change[k]) <= 5e-3 * max(change[k], med_change), k


def test_reference_macs_are_the_ports_convs():
    """At 1 x 256 x 256: every conv of the port, counted by a forward hook
    on its output's shape, against the reference's `describe().macs`
    (4.2116 GMACs), conv by conv; the two image convs flagged."""
    spec = spec_of(CONFIG, augment=True)
    model = M.build(spec, M.init(spec), device="cpu")
    counted = {}

    def hook(name):
        def count(mod, args, out):
            cout, cin_g, k, _ = mod.weight.shape
            counted[name] = math.prod(out.shape[1:]) * cin_g * k * k
        return count

    for name, mod in model.named_modules():
        if isinstance(mod, M.Conv2d):
            mod.register_forward_hook(hook(name))
    with torch.no_grad():
        model(torch.zeros((1, 256, 256, 3)))
    described = ref.describe({**CONFIG, "augment": True}, 1, 256, 256)
    assert {name: m for name, m, _ in described.macs} == counted
    assert sum(counted.values()) == 4_211_556_352
    assert sorted(name for name, _, first in described.macs if first) == [
        "cp.resnet.conv1", "sp.conv1.conv"]
