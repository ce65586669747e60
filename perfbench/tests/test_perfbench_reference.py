"""The plain reference against the port on the CPU, at a small size, where
the port runs its kernels' plain versions: the folded serving forward, and
a float32 training step's loss, update and BN statistics."""

import sys

import pytest
import torch

from perfbench.harness import inputs, manifest
from perfbench.harness.program import spec_of
from perfbench.reference import train as R


@pytest.fixture(params=["pidnet_s", "pidnet_l"])
def config(request):
    return manifest.config(request.param)


def test_reference_imports_nothing_of_the_program():
    import subprocess

    code = ("import sys; import perfbench.reference.pidnet, perfbench.reference.train, "
            "perfbench.reference.quant; "
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


def test_train_step_matches_the_port(config):
    """One float32 step of the port's `make_train_step` with FullLoss on
    the recipe against `sgd_steps`: the loss, every leaf's update direction
    and change, BN running statistics included."""
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
    loss_fn = FullLoss(num_outputs=2, align_corners=rec["align_corners"],
                       ignore_label=rec["ignore_label"],
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
