"""PyTorch port, the DDRNet-23 and BiSeNetV1 ablations (models/ddrnet.py,
models/bisenet.py) against the JAX package on the CPU, at their published
widths on a 1x64x128 input. The weights are JAX `init(PRNGKey(0))` with
numpy-seeded BN statistics, carried across with `convert.weights.from_jax`.
Tolerances are the JAX tests': tests/test_ddrnet.py:97 (rtol 1e-4, atol
5e-4) and tests/test_bisenet.py:90 (rtol 2e-4, atol 1e-3) for the heads,
tests/test_bisenet.py:107 (1e-3) for the folded forward."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from pidnet_tpu.config import load_config as jload_config
from pidnet_tpu.convert import fold_params
from pidnet_tpu.losses import FullLoss as JFullLoss
from pidnet_tpu.models import bisenet as JB
from pidnet_tpu.models import ddrnet as JD
from pidnet_tpu.models import pidnet as JM
from pidnet_tpu.nn.functional import max_pool2d as jmax_pool2d
from pidnet_tpu.tools import common as jcommon
from pidnet_tpu_torch.config import load_config
from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import bisenet, ddrnet
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.nn.functional import max_pool2d
from pidnet_tpu_torch.tools import common
from pidnet_tpu_torch.train.step import TrainState, make_train_step

torch.set_num_threads(2)

FAMILIES = {  # name: (JAX module, port module, heads' (rtol, atol))
    "ddrnet_23_adb_bag": (JD, ddrnet, (1e-4, 5e-4)),
    "bisenet_adb_bag": (JB, bisenet, (2e-4, 1e-3)),
}
IDS = ["ddrnet", "bisenet"]
YAML = os.path.join(os.path.dirname(__file__), "..", "configs", "cityscapes",
                    "pidnet_small_cityscapes.yaml")


@pytest.fixture(scope="module", params=list(FAMILIES), ids=IDS)
def family(request):
    """(name, JAX spec, params, state, port spec, port state dict, x, JAX
    fp32 heads) with augment=True."""
    name = request.param
    jmod, mod, _ = FAMILIES[name]
    rng = np.random.default_rng(5)
    jspec = jmod.spec_for(name, 19, augment=True)
    params, state = JM.init(jax.random.PRNGKey(0), jspec)
    state = {k: ((0.5 + rng.random(v.shape)) if k.endswith("var")
                 else rng.standard_normal(v.shape) * 0.2).astype(np.float32)
             for k, v in state.items()}
    x = rng.standard_normal((1, 64, 128, 3)).astype(np.float32)
    want = [np.asarray(o) for o in JM.apply(params, state, x, jspec)]
    return (name, jspec, params, state, mod.spec_for(name, 19, augment=True),
            W.from_jax(params, state), x, want)


def _run(spec, sd, x, folded=False):
    model = M.build(spec, sd, folded=folded, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return [o.numpy() for o in out] if isinstance(out, list) else out.numpy()


def test_all_heads_match_jax(family):
    name, _, _, _, spec, sd, x, want = family
    rtol, atol = FAMILIES[name][2]
    got = _run(spec, sd, x)
    # seg_heads (the balance weights' count) and the boundary head, as JAX returns them
    assert len(got) == len(want) == M.module_for(spec).seg_heads + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_single_head_matches_jax(family):
    name, jspec, params, state, spec, sd, x, _ = family
    rtol, atol = FAMILIES[name][2]
    jspec1 = dataclasses.replace(jspec, augment=False)
    want = np.asarray(JM.apply(params, state, x, jspec1))
    got = _run(dataclasses.replace(spec, augment=False), sd, x)
    hw = (8, 16) if name.startswith("ddrnet") else (64, 128)  # BiSeNet: input size
    assert got.shape == want.shape == (1, *hw, 19)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_folded_matches_jax_folded(family):
    _, jspec, params, state, spec, sd, x, _ = family
    want = [np.asarray(o) for o in JM.apply(fold_params(params, state, jspec), {}, x, jspec,
                                             folded=True)]
    got = _run(spec, fold_state_dict(sd, spec), x, folded=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


def test_folded_keys_equal_jax_minus_s2d(family):
    """conv+BN pairs fold into the conv; ARM's bn_atten, FFM's bn and the
    heads' pre-activation BNs become scale/shift, as the JAX fold makes
    them (it records only `ops.convbn` pairs); the port has no s2d stem."""
    name, jspec, params, state, spec, sd, _, _ = family
    want = {k for k in fold_params(params, state, jspec) if not k.startswith("s2d.")}
    got = set(fold_state_dict(sd, spec))
    assert got == want
    if name.startswith("bisenet"):
        assert {"cp.arm32.bn_atten.scale", "ffm.bn.shift", "cp.arm16.conv.conv.bias"} <= got
        assert "cp.arm32.conv_atten.bias" not in got
    with torch.device("meta"):
        folded_model = M.module_for(spec)(spec, folded=True)
    assert set(folded_model.state_dict()) == got


def test_state_dict_keys_and_round_trip(family):
    _, _, params, state, spec, sd, _, _ = family
    with torch.device("meta"):
        model = M.module_for(spec)(spec)
    assert set(model.state_dict()) == set(params) | set(state)
    assert set(M.init(spec, torch.Generator().manual_seed(0))) == set(sd)
    p2, s2 = W.to_jax(sd)
    assert p2.keys() == params.keys() and s2.keys() == state.keys()
    for k in params:
        np.testing.assert_array_equal(p2[k], np.asarray(params[k], np.float32), err_msg=k)
    for k in state:
        np.testing.assert_array_equal(s2[k], state[k], err_msg=k)
    back = W.from_jax(p2, s2)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("name", ["ddrnet_23_adb_bag", "bisenet_adb_bag"])
def test_build_spec_builds_the_family(name):
    opts = ["MODEL.NAME", name, "DATASET.NUM_CLASSES", "11"]
    for augment in (True, False):
        got = common.build_spec(load_config(YAML, opts), augment)
        want = jcommon.build_spec(jload_config(YAML, opts), augment)
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(want).items()
                                           if k != "forward_fn"}
        assert M.module_for(got) is (ddrnet.DDRNet if "ddrnet" in name else bisenet.BiSeNet)


@pytest.mark.parametrize("shape, k, s, p", [((2, 9, 13, 5), 3, 2, 1), ((1, 8, 8, 3), 3, 2, 1),
                                           ((1, 7, 6, 4), 2, 2, 1)])
def test_max_pool2d_matches_jax(rng, shape, k, s, p):
    # negative values everywhere: a zero pad would win if it were counted
    x = -np.abs(rng.standard_normal(shape)).astype(np.float32) - 1.0
    want = np.asarray(jmax_pool2d(x, k, s, p))
    got = max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), k, s, p).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_train_step_on_the_cpu(family):
    """One port train step (fp32, FullLoss with the family's balance
    weights): a finite loss, moved weights and BN statistics; for BiSeNet
    the step-0 loss on the port's 4 outputs equals JAX FullLoss on JAX's
    training-mode outputs."""
    name, jspec, params, state, spec, sd, _, _ = family
    balance = M.balance_weights(spec)
    seg = len(balance)
    kw = dict(num_outputs=seg, balance_weights=balance, ignore_label=255, ohem_kept=500)
    rng = np.random.default_rng(11)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    lab = rng.integers(0, 19, (2, 64, 64)).astype(np.int32)
    edge = (rng.random((2, 64, 64)) < 0.1).astype(np.float32)

    model = M.build(spec, sd, device="cpu", train=True)
    first = "sp.conv1.conv.weight" if name.startswith("bisenet") else "conv1.0.weight"
    before = model.state_dict()[first].clone()
    mean_key = next(k for k in sd if k.endswith("running_mean"))
    mean_before = sd[mean_key].clone()
    outputs = []
    loss_fn = FullLoss(**kw)

    def recording_loss(outs, labels, edges):
        outputs.append([o.detach() for o in outs])
        return loss_fn(outs, labels, edges)

    step = make_train_step(TrainState.create(model), recording_loss)
    metrics = step(*(torch.from_numpy(a) for a in (img, lab, edge)), 0.01)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(model.state_dict()[first], before)
    assert not torch.equal(model.state_dict()[mean_key], mean_before)
    assert len(outputs[0]) == seg + 1
    if name.startswith("bisenet"):
        jloss_fn = JFullLoss(**kw)
        # jitted, forward and loss only: 4 s where eager ops take 16
        jloss = jax.jit(lambda p, s, *batch: jloss_fn(
            JM.apply(p, s, batch[0], jspec, train=True)[0], *batch[1:])[0])(
            params, state, img, lab, edge)
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-4)
