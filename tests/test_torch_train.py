"""PyTorch port, slice 2 as a whole on the CPU: train-mode BatchNorm, one
PIDNet-S train step against the JAX package's, the LR schedule, BN
calibration, checkpoints, the training epoch and `speed --train`."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pidnet_tpu.convert.fold import calibrate_bn as jax_calibrate_bn
from pidnet_tpu.losses import FullLoss as JaxFullLoss
from pidnet_tpu.models import pidnet as JM
from pidnet_tpu.nn import functional as JF
from pidnet_tpu.parallel import make_mesh, shard_batch
from pidnet_tpu.train import TrainState as JaxTrainState
from pidnet_tpu.train import make_train_step as jax_make_train_step
from pidnet_tpu.train import poly_lr as jax_poly_lr
from pidnet_tpu.train.step import _sgd as jax_sgd
from pidnet_tpu_torch import engine
from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.convert.fold import calibrate_bn
from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS
from pidnet_tpu_torch.data.synthetic import synthetic_epoch
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.nn import functional as TF
from pidnet_tpu_torch.train import checkpoint as C
from pidnet_tpu_torch.train.lr import poly_lr
from pidnet_tpu_torch.train.step import TrainState, _sgd, make_train_step
from pidnet_tpu_torch.utils.logging import TBWriter

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPEC = M.spec_for("pidnet_s", 19, augment=True)
JSPEC = JM.spec_for("pidnet_s", 19, augment=True)
LOSS_KW = dict(ignore_label=255, class_weights=CLASS_WEIGHTS, ohem_thres=0.9, ohem_kept=131072)


def _batch(rng, n=2, h=64, w=64):
    img = rng.standard_normal((n, h, w, 3), dtype=np.float32)
    lab = rng.integers(0, 19, (n, h, w)).astype(np.int32)
    lab[rng.random((n, h, w)) < 0.1] = 255
    edge = (rng.random((n, h, w)) < 0.1).astype(np.float32)
    return img, lab, edge


@pytest.fixture(scope="module")
def jax_weights():
    params, state = JM.init(jax.random.PRNGKey(0), JSPEC)
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in state.items()})


@pytest.mark.parametrize("shape", [(4, 6, 5, 3), (2, 8, 3, 7)])
def test_batch_norm_train_matches_jax(rng, shape):
    """y, the new running mean and the new (unbiased) running var, fp32."""
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)  # NHWC
    c = shape[-1]
    gamma, beta = rng.standard_normal(c).astype(np.float32), rng.standard_normal(c).astype(
        np.float32)
    rm, rv = rng.standard_normal(c).astype(np.float32), (0.5 + rng.random(c)).astype(np.float32)
    want = JF.batch_norm_train(*(jnp.asarray(a) for a in (x, gamma, beta, rm, rv)))
    got = TF.batch_norm_train(torch.from_numpy(x).permute(0, 3, 1, 2),
                              *(torch.from_numpy(a) for a in (gamma, beta, rm, rv)))
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_batch_norm_module_follows_training_mode(rng):
    bn = M.BatchNorm(3)
    bn.load_state_dict({"weight": torch.ones(3), "bias": torch.zeros(3),
                        "running_mean": torch.zeros(3), "running_var": torch.ones(3)})
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 4)).astype(np.float32) * 2 + 1)
    bn.eval()
    np.testing.assert_allclose(bn(x).detach().numpy(), x.numpy() / np.sqrt(1 + TF.BN_EPS),
                               rtol=1e-6)
    assert float(bn.running_mean.abs().max()) == 0
    bn.train()
    y = bn(x)
    np.testing.assert_allclose(y.mean(dim=(0, 2, 3)).detach().numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * x.mean(dim=(0, 2, 3)).numpy(),
                               rtol=1e-5)


def test_one_train_step_matches_jax(rng, jax_weights):
    """One fp32 PIDNet-S (augment) step at 4x128x128 from the same weights:
    the JAX step (1-device mesh, no batch padding, its s2d and W-folded
    layouts) against the port's.

    Loss, metrics and the BN running statistics hold test_train_step.py's
    s2d-layout bound (rtol 1e-3, atol 1e-4). The gradient cannot hold it
    per element, any more than the JAX package's own s2d and plain layouts
    hold it against each other (test_train_step.py:109-113 compares their
    updates by norm): batch statistics over the few pixels of the
    1/64-resolution stages amplify fp32 rounding. So the update and the
    momentum are held as test_train_step.py holds s2d against the plain
    layout: relative L2 error per tensor < 0.08, and a global cosine >
    0.999; a tensor whose gradient is rounding noise (the biases that a BN
    follows, |g| <= 1e-3) within atol 1e-4. Over five seeds of weights and
    batch the largest per-tensor error read 0.0404 and the lowest cosine
    0.99960. The last conv of each head sees no BN between it and the
    loss: its gradient read at most 5.9e-4 over those seeds and is held
    to 1.2e-3, so a loss term whose gradient is off by 1% fails here."""
    params, state = jax_weights
    img, lab, edge = _batch(rng, n=4, h=128, w=128)
    mesh = make_mesh(1)
    jstep = jax_make_train_step(JSPEC, JaxFullLoss(**LOSS_KW), mesh, pad_batch=False)
    jts = JaxTrainState.create({k: jnp.asarray(v) for k, v in params.items()},
                               {k: jnp.asarray(v) for k, v in state.items()})
    jts, jm = jstep(jts, *shard_batch(mesh, img, lab, edge), 0.01)

    model = M.build(SPEC, W.from_jax(params, state), device="cpu", train=True)
    ts = TrainState.create(model)
    tm = make_train_step(ts, FullLoss(**LOSS_KW))(
        *(torch.from_numpy(a) for a in (img, lab, edge)), 0.01)

    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, err_msg=k)
    got_p, got_s, got_m = W.train_state_to_jax({**ts.params(), **ts.state()}, ts.momentum)
    assert set(got_s) == set(jts.state)
    for k in jts.state:
        np.testing.assert_allclose(got_s[k], np.asarray(jts.state[k]), rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    assert set(got_p) == set(got_m) == set(jts.params) == set(params)
    update = ({k: got_p[k] - params[k] for k in params},
              {k: np.asarray(jts.params[k]) - params[k] for k in params}, 0.01)
    momentum = (got_m, {k: np.asarray(v) for k, v in jts.momentum.items()}, 1.0)
    for k in (f"{head}.conv2.{p}" for head in ("seghead_p", "final_layer", "seghead_d")
              for p in ("weight", "bias")):
        rel = np.linalg.norm(got_m[k] - momentum[1][k]) / np.linalg.norm(momentum[1][k])
        assert rel < 1.2e-3, (k, rel)
    for got, want, scale in (update, momentum):  # the update is lr * momentum
        a = np.concatenate([got[k].ravel() for k in sorted(want)])
        b = np.concatenate([want[k].ravel() for k in sorted(want)])
        assert float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)) > 0.999
        for k, w in want.items():
            if np.abs(w).max() <= 1e-3 * scale:
                np.testing.assert_allclose(got[k], w, atol=1e-4 * scale, err_msg=k)
            else:
                rel = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
                assert rel < 0.08, (k, rel)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_jax_and_torch_optim(rng, nesterov):
    shapes = [(3, 2, 3, 3), (5,)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    bs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(lr=0.01, momentum=0.9, weight_decay=5e-4, nesterov=nesterov)
    jp, jb = jax_sgd({i: jnp.asarray(p) for i, p in enumerate(ps)},
                     {i: jnp.asarray(g) for i, g in enumerate(gs)},
                     {i: jnp.asarray(b) for i, b in enumerate(bs)}, **kw)
    tp = [torch.from_numpy(p.copy()) for p in ps]
    tb = [torch.from_numpy(b.copy()) for b in bs]
    _sgd(tp, [torch.from_numpy(g) for g in gs], tb, **kw)
    # torch.optim.SGD from zero momentum: its first step sets buf = d
    op = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in ps]
    for p, g in zip(op, gs):
        p.grad = torch.from_numpy(g)
    torch.optim.SGD(op, dampening=0, **kw).step()
    zp = [torch.from_numpy(p.copy()) for p in ps]
    _sgd(zp, [torch.from_numpy(g) for g in gs], [torch.zeros(s) for s in shapes], **kw)
    for i in range(len(shapes)):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[i]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tb[i].numpy(), np.asarray(jb[i]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(zp[i].numpy(), op[i].detach().numpy(), rtol=1e-6, atol=1e-7)


def test_poly_lr_matches_jax():
    for it in (0, 1, 50, 99, 100, 150):
        assert poly_lr(0.01, 100, it) == jax_poly_lr(0.01, 100, it)
    assert poly_lr(0.01, 100, 150) == 0.0


def test_calibrate_bn_matches_jax(rng, jax_weights):
    params, state = jax_weights
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = jax_calibrate_bn({k: jnp.asarray(v) for k, v in params.items()},
                            {k: jnp.asarray(v) for k, v in state.items()}, JSPEC,
                            jnp.asarray(x), iters=2)
    got = calibrate_bn(W.from_jax(params, state), SPEC, torch.from_numpy(x), iters=2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_train_state_carries_to_and_from_jax(rng, jax_weights):
    params, state = jax_weights
    momentum = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    sd, mom = W.train_state_from_jax(params, state, momentum)
    assert mom["conv1.0.weight"].shape == sd["conv1.0.weight"].shape == (32, 3, 3, 3)
    back = W.train_state_to_jax(sd, mom)
    for got, want in zip(back, (params, state, momentum)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def _tiny_state(seed=0):
    sd = M.init(SPEC, torch.Generator().manual_seed(seed))
    return TrainState.create(M.build(SPEC, sd, device="cpu", train=True))


def test_checkpoint_round_trip(tmp_path, rng):
    ts = _tiny_state(0)
    for v in ts.momentum.values():
        v.copy_(torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32)))
    path = C.save_train_checkpoint(str(tmp_path), 3, 0.5, ts, it=7)
    assert path.endswith("checkpoint.pt") and os.listdir(tmp_path) == ["checkpoint.pt"]
    payload = C.load_train_checkpoint(str(tmp_path))
    assert (payload["epoch"], payload["iter"], payload["best_mIoU"]) == (3, 7, 0.5)
    fresh = C.restore_train_state(_tiny_state(1), payload)
    for got, want in ((fresh.params(), ts.params()), (fresh.state(), ts.state()),
                      (fresh.momentum, ts.momentum)):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    C.save_model(str(tmp_path / "best.pt"), ts.params(), ts.state())
    p, s = C.load_model(str(tmp_path / "best.pt"))
    assert torch.equal(p["final_layer.conv2.bias"], ts.params()["final_layer.conv2.bias"])
    assert set(s) == set(ts.state())
    assert C.load_train_checkpoint(str(tmp_path / "none")) is None


class _Loader(list):
    def skip_batches(self, k):
        del self[:k]


def test_train_one_epoch_schedule_and_divergence(rng, tmp_path):
    """3 real steps at 2x64x64: the update at global iteration g uses
    poly(g-1); the meters see every step; a NaN loss raises."""
    ts = _tiny_state(0)
    step = make_train_step(ts, FullLoss(**LOSS_KW), compute_dtype=torch.bfloat16)
    seen = []

    def recording_step(images, labels, edges, lr):
        assert images.dtype == edges.dtype == torch.float32 and labels.dtype == torch.int32
        seen.append(lr)
        return step(images, labels, edges, lr)

    loader = _Loader((*_batch(rng), None, None) for _ in range(3))
    writer = {"writer": TBWriter(str(tmp_path)), "train_global_steps": 0}
    cfg = engine.config(print_freq=2)
    epoch, epoch_iters, num_iters = 1, 3, 6
    before = {k: v.clone() for k, v in ts.params().items()}
    ts2, done = engine.train_one_epoch(cfg, epoch, epoch_iters, num_iters, 0.01, loader,
                                       recording_step, ts, writer)
    assert ts2 is ts and done == 3 and writer["train_global_steps"] == 1
    assert seen == [poly_lr(0.01, num_iters, g - 1) for g in (3, 4, 5)]
    assert not torch.equal(before["conv1.0.weight"], ts.params()["conv1.0.weight"])

    seen.clear()
    _, done = engine.train_one_epoch(cfg, 0, 3, 6, 0.01, _Loader((*_batch(rng), None, None)
                                                                 for _ in range(3)),
                                     recording_step, ts, writer, start_iter=1,
                                     should_stop=lambda: len(seen) >= 1)
    assert done == 2 and seen == [poly_lr(0.01, 6, 0)]

    def nan_step(*args):
        return {k: torch.tensor(float("nan")) for k in ("loss", "acc", "sem_loss", "bce_loss")}

    with pytest.raises(FloatingPointError, match="non-finite"):
        engine.train_one_epoch(cfg, 0, 3, 6, 0.01, _Loader([(*_batch(rng), None, None)]),
                               nan_step, ts, writer)
    with pytest.raises(ValueError, match="skip_batches"):
        engine.train_one_epoch(cfg, 0, 3, 6, 0.01, [], step, ts, writer, start_iter=1)


def test_synthetic_epoch_is_the_artifact_scripts():
    path = os.path.join(ROOT, "scripts", "train_run_artifact.py")
    spec = importlib.util.spec_from_file_location("train_run_artifact", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    want = script.synthetic_epoch(np.random.default_rng(304), 2, 128)
    got = synthetic_epoch(np.random.default_rng(304), 2, 128)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_speed_train_cli_on_cpu():
    """`python -m pidnet_tpu_torch.tools.speed --train` at a tiny size."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "pidnet_tpu_torch.tools.speed", "--train", "--device", "cpu",
         "--r", "64", "64", "--batch", "2", "--profile", "1"],
        cwd=os.path.abspath(ROOT), env={**env, "OMP_NUM_THREADS": "2"}, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    line = [s for s in res.stdout.splitlines() if "ms/step" in s][0]
    assert "train bf16 64x64 batch=2 on cpu" in line and "img/s" in line
    assert "profile over 1 steps" in res.stdout


def test_training_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    from pidnet_tpu_torch.tools import speed

    with pytest.raises(RuntimeError, match="CUDA"):
        speed.main(["--train"])
