"""The plain reference against the port on the CPU, at a small size, where
the port runs its kernels' plain versions: the folded serving forward, and
a float32 training step's loss, update and BN statistics."""

import pkgutil
import sys
from contextlib import contextmanager

import pytest
import torch

from perfbench.harness import inputs, manifest
from perfbench.harness.program import spec_of
from perfbench.reference import train as R

# The training comparison's thread count. The CPU's float32 convs sum in an
# order that follows the count, and a few of the step's millions of ReLU
# inputs lie within that rounding of 0: where one changes sign on one side,
# every leaf before it takes or loses that pixel's gradient through the
# train-mode BNs, up to 2.6e-3 of its norm against the 1e-4 limit. On an
# x86 CPU with AVX-512, the float32 reference flips one such input against
# its own float64 run at 1, 2 and 3 threads on PIDNet-L and at 1 and 3 on
# PIDNet-S, and the comparison fails exactly there; at 4 and 8 it flips
# none, and the port agrees to 0.06 of the limit. So the count is pinned.
THREADS = 4


@pytest.fixture(params=[c["name"] for c in manifest.benchmark()["configs"]])
def config(request):
    return manifest.config(request.param)


def test_reference_imports_nothing_of_the_program():
    import subprocess

    names = [f"perfbench.reference.{m.name}"
             for m in pkgutil.iter_modules([str(manifest.PERFBENCH / "reference")])]
    assert "perfbench.reference.train" in names
    code = (f"import sys; import {', '.join(names)}; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'pidnet_tpu_torch', 'pidnet_tpu', 'jax', 'jaxlib', 'flax'}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=manifest.ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_folded_forward_matches_the_port(config):
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.models import pidnet as M

    spec = spec_of(config, augment=False)
    w = inputs.weights(config, "cpu", 7)
    x = torch.randn((1, 64, 128, 3), generator=torch.Generator().manual_seed(1))
    model = M.build(spec, fold_state_dict(w, spec), folded=True, device="cpu")
    ref = inputs.reference(config)
    with torch.no_grad():
        mine = model(x).permute(0, 3, 1, 2)
        theirs = ref.forward(ref.Net(w), x.permute(0, 3, 1, 2), {**config, "augment": False})
    assert torch.allclose(mine, theirs, rtol=1e-4, atol=1e-4 * float(theirs.abs().max()))


@contextmanager
def torch_threads(n: int):
    """Run at `n` threads, and give the process its count back after."""
    around = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(around)


def test_train_step_matches_the_port(config):
    """One float32 step of the port's `make_train_step` with FullLoss on
    the recipe against `sgd_steps`: the loss, every leaf's update direction
    and change, BN running statistics included; at `THREADS` threads."""
    with torch_threads(THREADS):
        _compare_one_train_step(config)


def test_torch_threads_pins_the_count_and_gives_it_back():
    """In a process at 2 threads, as the repository's tests set, the pin
    runs at `THREADS` and leaves the 2 threads as they were."""
    with torch_threads(2):
        with torch_threads(THREADS):
            assert torch.get_num_threads() == THREADS
        assert torch.get_num_threads() == 2


def _compare_one_train_step(config):
    from pidnet_tpu_torch.losses.criterion import FullLoss
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.train.step import TrainState, make_train_step

    traffic = {**manifest.traffic("train_b12"), "batch": 4, "height": 64, "width": 128,
               "batches": 1}
    rec = {**config["train"], "min_kept": 20000}
    spec = spec_of(config, augment=True)
    w = inputs.weights(config, "cpu", 8)
    batch = inputs.crops(traffic, config, "cpu", 8)[0]
    ts = TrainState.create(M.build(spec, w, device="cpu", train=True))
    loss_fn = FullLoss(num_outputs=len(rec["balance_weights"]),
                       align_corners=rec["align_corners"], ignore_label=rec["ignore_label"],
                       class_weights=torch.tensor(rec["class_weights"]),
                       ohem_thres=rec["ohem_thres"], ohem_kept=rec["min_kept"], balance_weights=rec["balance_weights"],
                       sb_weights=rec["sb_weights"], bd_coeff=rec["bd_coeff"])
    step = make_train_step(ts, loss_fn, momentum=rec["momentum"],
                           weight_decay=rec["weight_decay"])
    loss = float(step(*batch, rec["lr"])["loss"])
    ref = R.sgd_steps(inputs.reference(config), w, [batch], {**config, "augment": True}, rec, 1)
    assert loss == pytest.approx(ref["losses"][0], rel=1e-5)
    leaves = dict(ts.model.named_parameters())
    leaves.update({k: v for k, v in ts.model.named_buffers() if k.endswith(R.STAT_SUFFIXES)})
    dir1, change = ref["dir1"], ref["change"]
    med_dir = sorted(dir1.values())[len(dir1) // 2]
    med_change = sorted(change.values())[len(change) // 2]
    for k, v in leaves.items():
        if k in ts.momentum:
            mine = float(ts.momentum[k].norm())
            assert abs(mine - dir1[k]) <= 1e-4 * max(dir1[k], med_dir), k
        moved = float((v.detach() - w[k]).norm())
        assert abs(moved - change[k]) <= 1e-4 * max(change[k], med_change), k
