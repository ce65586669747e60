"""PyTorch port, data parallelism on the CPU (parallel/mesh.py and the mesh,
sync_bn and accum_steps parts of train/step.py): two gloo ranks, spawned
by parallel/launch.py, held against the JAX package's steps on two of the
conftest's virtual CPU devices, and gradient accumulation held against
the port's own two ranks.

The JAX steps run their plain layouts (stem_s2d=False, wfold=False,
pad_batch=False): the same function as their default s2d and W-folded
layouts, compiled in half the time. Both packages take PIDNet-S (augment)
with the JAX package's seeded weights at 8x64x64, 4 samples a rank, fp32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pidnet_tpu.losses import FullLoss as JaxFullLoss
from pidnet_tpu.models import pidnet as JM
from pidnet_tpu.parallel import make_mesh as jax_make_mesh
from pidnet_tpu.parallel import shard_batch as jax_shard_batch
from pidnet_tpu.train import TrainState as JaxTrainState
from pidnet_tpu.train import make_train_step as jax_make_train_step
from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.parallel import launch
from pidnet_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_microbatches
from pidnet_tpu_torch.train.step import TrainState, make_train_step

torch.set_num_threads(2)

SPEC = M.spec_for("pidnet_s", 19, augment=True)
JSPEC = JM.spec_for("pidnet_s", 19, augment=True)
LOSS_KW = dict(ignore_label=255, class_weights=CLASS_WEIGHTS, ohem_thres=0.9, ohem_kept=131072)
JAX_PLAIN = dict(pad_batch=False, stem_s2d=False, wfold=False)
WORLD, PER_RANK = 2, 4
MODES = {"per-replica": {}, "sync": {"sync_bn": True}}


def _batch(rng, n, h=64, w=64):
    img = rng.standard_normal((n, h, w, 3), dtype=np.float32)
    lab = rng.integers(0, 19, (n, h, w)).astype(np.int32)
    lab[rng.random((n, h, w)) < 0.1] = 255
    edge = (rng.random((n, h, w)) < 0.1).astype(np.float32)
    return img, lab, edge


def _state(ts):
    """(params, BN state, momentum) in the JAX package's names and layouts."""
    return W.train_state_to_jax({**ts.params(), **ts.state()}, ts.momentum)


def _port_step(params, state, mesh, batch, **kw):
    """One fp32 step of the port from the JAX weights; (metrics, state)."""
    ts = TrainState.create(M.build(SPEC, W.from_jax(params, state), device="cpu", train=True))
    metrics = make_train_step(ts, FullLoss(**LOSS_KW), mesh, **kw)(*batch, 0.01)
    return {k: float(v) for k, v in metrics.items()}, _state(ts)


def _rank(rank, params, state, batch):
    """One of the two ranks: each mode's step on the rank's 4 samples, and
    pmean's forward and backward on rank-dependent values."""
    torch.set_num_threads(2)
    mesh = make_mesh(-1, "cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (WORLD, rank, "gloo")
    share = [torch.from_numpy(a[rank * PER_RANK:(rank + 1) * PER_RANK]) for a in batch]
    out = {mode: _port_step(params, state, mesh, shard_batch(mesh, *share), **kw)
           for mode, kw in MODES.items()}
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = mesh.pmean(x)
    (g,) = torch.autograd.grad((y * (10.0 ** rank)).sum(), x)
    out["pmean"] = (y.detach().numpy(), g.numpy())
    return out


@pytest.fixture(scope="module")
def weights():
    params, state = JM.init(jax.random.PRNGKey(0), JSPEC)
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in state.items()})


@pytest.fixture(scope="module")
def batch():
    """8 samples; rank 1's images are scaled by 3 and shifted by 1, so the
    ranks' batch statistics differ as sync BN needs to show."""
    img, lab, edge = _batch(np.random.default_rng(304), WORLD * PER_RANK)
    img[PER_RANK:] = img[PER_RANK:] * 3 + 1
    return img, lab, edge


@pytest.fixture(scope="module")
def ranks(weights, batch):
    """The two gloo ranks' results, in rank order."""
    return launch.spawn(_rank, WORLD, *weights, batch, backend="gloo", timeout=600)


@pytest.fixture(scope="module")
def jax_steps(weights, batch):
    """The JAX step on a 2-device mesh in each mode: (metrics, state)."""
    params, state = weights
    mesh = jax_make_mesh(WORLD)
    out = {}
    for mode, kw in MODES.items():
        step = jax_make_train_step(JSPEC, JaxFullLoss(**LOSS_KW), mesh, **JAX_PLAIN, **kw)
        ts = JaxTrainState.create({k: jnp.asarray(v) for k, v in params.items()},
                                  {k: jnp.asarray(v) for k, v in state.items()})
        ts, m = step(ts, *jax_shard_batch(mesh, *batch), 0.01)
        out[mode] = ({k: float(v) for k, v in m.items()},
                     tuple({k: np.asarray(v) for k, v in d.items()}
                           for d in (ts.params, ts.state, ts.momentum)))
    return out


def _close_to_jax(got, want, params):
    """test_torch_train.py's bound for one step: loss, metrics and BN state
    at rtol 1e-3 (atol 1e-4), the update and the momentum at relative L2
    < 0.08 per tensor and a global cosine > 0.999, a tensor whose gradient
    is rounding noise (|g| <= 1e-3) within atol 1e-4."""
    (got_m, (got_p, got_s, got_mom)), (want_m, (want_p, want_s, want_mom)) = got, want
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-3, err_msg=k)
    assert set(got_s) == set(want_s)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-3, atol=1e-4, err_msg=k)
    update = ({k: got_p[k] - params[k] for k in params},
              {k: want_p[k] - params[k] for k in params}, 0.01)
    for got_t, want_t, scale in (update, (got_mom, want_mom, 1.0)):
        a = np.concatenate([got_t[k].ravel() for k in sorted(want_t)])
        b = np.concatenate([want_t[k].ravel() for k in sorted(want_t)])
        assert float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)) > 0.999
        for k, w in want_t.items():
            if np.abs(w).max() <= 1e-3 * scale:
                np.testing.assert_allclose(got_t[k], w, atol=1e-4 * scale, err_msg=k)
            else:
                rel = np.linalg.norm(got_t[k] - w) / np.linalg.norm(w)
                assert rel < 0.08, (k, rel)


def test_make_mesh_in_one_process():
    """No process group: a mesh of this process alone, whose collectives
    leave their inputs as they are; more devices than ranks raise."""
    mesh = make_mesh(-1, "cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.backend) == (1, 0, None, None)
    assert make_mesh(1, "cpu").size == 1
    t = [torch.ones(2, 3), torch.arange(4.0)]
    assert all(a is b for a, b in zip(mesh.all_reduce_mean(t), t))
    assert mesh.pmean(t[1]) is t[1] and mesh.all_reduce_sum(t[0]) is t[0]
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, "cpu")
    x, lab = shard_batch(mesh, np.zeros((2, 3), np.float32), np.ones(2, np.int32))
    assert x.dtype == torch.float32 and lab.dtype == torch.int32 and x.device.type == "cpu"


def test_shard_microbatches_layout():
    """(A*G, ...) batches become (A, G, ...) stacks, consecutive G-chunks
    the microbatches (tests/test_accum.py:112-122)."""
    mesh = make_mesh(-1, "cpu")
    x = np.arange(24, dtype=np.float32).reshape(24, 1)
    y = shard_microbatches(mesh, 2, x)
    assert tuple(y.shape) == (2, 12, 1)
    np.testing.assert_array_equal(y[0, :, 0].numpy(), np.arange(12))
    np.testing.assert_array_equal(y[1, :, 0].numpy(), np.arange(12, 24))
    with pytest.raises(ValueError, match="does not split into 5"):
        shard_microbatches(mesh, 5, x)


def test_accum_rejects_sync_bn(weights):
    ts = TrainState.create(M.build(SPEC, W.from_jax(*weights), device="cpu", train=True))
    with pytest.raises(ValueError, match="sync_bn"):
        make_train_step(ts, FullLoss(**LOSS_KW), make_mesh(-1, "cpu"), accum_steps=2,
                        sync_bn=True)


def test_pmean_is_its_own_transpose(ranks):
    """Forward: the mean of the ranks' values (1 and 2). Backward: the
    mean of the ranks' cotangents (1 and 10), lax.pmean's transpose."""
    for y, g in (r["pmean"] for r in ranks):
        np.testing.assert_array_equal(y, [1.5] * 3)
        np.testing.assert_array_equal(g, [5.5] * 3)


@pytest.mark.parametrize("mode", MODES)
def test_ranks_end_the_step_identical(ranks, mode):
    """Both ranks report the same metrics and hold the same weights, BN
    state and momentum, bit for bit, after the all-reduce."""
    (m0, s0), (m1, s1) = (r[mode] for r in ranks)
    assert m0 == m1
    for a, b in zip(s0, s1):
        assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_jax_on_the_2_device_mesh(ranks, jax_steps, weights, mode):
    """World 2 (per-replica BN and OHEM, or sync BN) against the JAX
    make_train_step on make_mesh(2) on the same 8 samples."""
    _close_to_jax(ranks[0][mode], jax_steps[mode], weights[0])


def test_sync_bn_differs_from_per_replica(ranks):
    """Different data on the two ranks: sync BN's global statistics give
    another running variance and another update than per-replica BN
    (tests/test_sync_bn_export.py:25-49)."""
    (_, (p_dp, s_dp, _)), (m_sync, (p_sync, s_sync, _)) = (ranks[0][m] for m in MODES)
    assert not np.allclose(s_dp["conv1.1.running_var"], s_sync["conv1.1.running_var"])
    assert not np.allclose(p_dp["conv1.1.weight"], p_sync["conv1.1.weight"])
    assert np.isfinite(m_sync["loss"])


def test_accum_2_on_one_process_equals_two_ranks(ranks, weights, batch):
    """accum_steps=2 at world 1 on the same 8 samples as two microbatches
    of 4, against the two ranks' per-replica step, at tests/test_accum.py's
    tolerances (loss rtol 1e-5, acc atol 2e-3, update cosine > 0.9999,
    params atol 1e-4, BN state rtol 1e-3 / atol 1e-5)."""
    params, state = weights
    mesh = make_mesh(-1, "cpu")
    got_m, (got_p, got_s, _) = _port_step(params, state, mesh,
                                          shard_microbatches(mesh, 2, *batch), accum_steps=2)
    want_m, (want_p, want_s, _) = ranks[0]["per-replica"]
    np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=1e-5)
    np.testing.assert_allclose(got_m["acc"], want_m["acc"], atol=2e-3)
    a = np.concatenate([(got_p[k] - params[k]).ravel() for k in sorted(params)])
    b = np.concatenate([(want_p[k] - params[k]).ravel() for k in sorted(params)])
    assert float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)) > 0.9999
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], atol=1e-4, err_msg=k)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-3, atol=1e-5, err_msg=k)
