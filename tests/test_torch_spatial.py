"""PyTorch port, spatial partitioning on the CPU (parallel/spatial.py, the
windowed plain versions of K1-K3, models/pidnet.spatial_sharding, FullLoss
over a mesh, train/step.make_spatial_{train,eval}_step, the engine's
sharded closures and the CLIs' --spatial), held against the JAX package's
spatial functions (pidnet_tpu/parallel/spatial.py) on the conftest's
virtual CPU devices.

The port's ranks are gloo processes spawned by parallel/launch.py; they
import this module, so JAX is imported only inside the oracle helpers,
which run in the parent. The JAX steps run their plain layouts
(stem_s2d=False, wfold=False). The weights are the port's seeded init,
carried to the JAX package by convert.weights.to_jax. Tolerances are
tests/test_spatial.py's unless a test says it tightens one.
"""

import glob
import hashlib
import os

import numpy as np
import pytest
import torch

from pidnet_tpu_torch import engine
from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.data.png import write_png
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.ops import ce_front as TC
from pidnet_tpu_torch.ops import resize as TR
from pidnet_tpu_torch.ops import upsample_argmax as TU
from pidnet_tpu_torch.parallel import launch
from pidnet_tpu_torch.parallel import spatial as SP
from pidnet_tpu_torch.train.step import (TrainState, make_spatial_eval_step,
                                         make_spatial_train_step)

torch.set_num_threads(2)

H = 128  # the crops: 1/32 is 4 rows, 2 a shard on (1, 2), 1 on (2, 4)-like cuts
SPEC_S = M.spec_for("pidnet_s", 19, augment=True)
SPEC_L = M.spec_for("pidnet_l", 19, augment=True)
LOSS_KW = dict(ignore_label=255, ohem_thres=0.9, ohem_kept=500)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WEIGHTS = os.path.join(REPO, "runs", "train2k", "weights_f16.npz")


def _weights(spec, seed=7) -> dict:
    return M.init(spec, torch.Generator().manual_seed(seed))


def _batch(n=2, seed=11):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, H, H, 3)).astype(np.float32)
    lab = rng.integers(0, 19, (n, H, H)).astype(np.int32)
    lab[0, :8] = 255
    edge = (rng.random((n, H, H)) < 0.1).astype(np.float32)
    return img, lab, edge


# ---------------------------------------------------------------------------
# The windowed plain versions of K1-K3 and the windowed resize, no ranks
# ---------------------------------------------------------------------------

# (logits (N, h, w, C), output (OH, OW), spatial ranks): the training
# shape's x8, and a ratio of 10/3 whose taps fall between rows
WINDOW_CASES = [((2, 16, 12, 19), (128, 96), 4), ((1, 12, 10, 11), (40, 40), 2)]


def _windows():
    for shape, out_hw, ranks in WINDOW_CASES:
        for s in range(ranks):
            for align in (True, False):
                yield pytest.param(shape, out_hw, ranks, s, align,
                                   id=f"{shape[1]}to{out_hw[0]}-S{ranks}-s{s}-ac{int(align)}")


class _Row:
    """The spatial coordinates of rank s of S, as halo_for_resize reads them."""

    def __init__(self, ranks, s):
        self.n_spatial, self.spatial_index = ranks, s


def _window_case(shape, out_hw, ranks, s, align, seed=304):
    """Whole-image inputs, and rank s's halo'd slice of the logits with its
    window (`halo_rows`'s margin of one row)."""
    rng = np.random.default_rng(seed)
    n, h, _, c = shape
    logits = (rng.standard_normal(shape) * 2).astype(np.float32)
    labels = np.where(rng.random((n, *out_hw)) < 0.1, 255,
                      rng.integers(0, c, (n, *out_hw))).astype(np.int32)
    cw = (0.8 + rng.random(c)).astype(np.float32)
    g = rng.random((n, *out_hw)).astype(np.float32)
    top, bottom, rows = SP.halo_for_resize(h // ranks, out_hw[0] // ranks, align,
                                           _Row(ranks, s), margin=1)
    padded = np.pad(logits, ((0, 0), (h, h), (0, 0), (0, 0)))
    local = padded[:, h + rows.src_start:h + rows.src_start + h // ranks + top + bottom]
    oy = slice(rows.out_start, rows.out_start + out_hw[0] // ranks)
    return logits, labels, cw, g, local, rows, oy


def _jax_whole(logits, labels, cw, g, out_hw, align):
    """The JAX package's whole-image class map, CE maps, the gradient of
    sum(g * nll) in the logits, and the fp32 resize."""
    import jax
    import jax.numpy as jnp

    from pidnet_tpu.ops import ce_front as JC
    from pidnet_tpu.ops import resize as JR
    from pidnet_tpu.ops import upsample_argmax as JU

    x = jnp.asarray(logits)
    classes = np.asarray(JU.upsample_argmax(x, out_hw, align))
    nll, w = JC.ce_maps(x, labels, cw, 255, out_hw, align)
    grad = jax.grad(lambda lg: jnp.sum(g * JC.ce_maps(lg, labels, cw, 255, out_hw, align)[0]))(x)
    up = np.asarray(JR.resize_bilinear(x, out_hw, align))
    return classes, np.asarray(nll), np.asarray(w), np.asarray(grad), up


@pytest.mark.parametrize("shape,out_hw,ranks,s,align", _windows())
def test_windowed_plain_kernels_match_jax_rows(shape, out_hw, ranks, s, align):
    """Rank s's window, from its halo'd slice of the logits: the plain K1
    map equals the JAX map's rows (but where the JAX top-2 margin is below
    1e-5), K2's nll and w, the windowed resize, and K3's gradient into the
    slice's rows (the window's pixels' share: g is zero outside it) match
    the JAX whole-image functions' rows at rtol/atol 1e-5."""
    logits, labels, cw, g, local, rows, oy = _window_case(shape, out_hw, ranks, s, align)
    g_win = np.zeros_like(g)
    g_win[:, oy] = g[:, oy]
    classes, nll, w, grad, up = _jax_whole(logits, labels, cw, g_win, out_hw, align)
    n_out = out_hw[0] // ranks
    win_hw = (n_out, out_hw[1])
    lab = torch.from_numpy(labels[:, oy].copy())

    got = TU.upsample_argmax_rows(torch.from_numpy(local), win_hw, align, rows).numpy()
    top2 = np.sort(up[:, oy], -1)[..., -2:]
    differ = got != classes[:, oy]
    assert got.dtype == np.int32 and got.shape == classes[:, oy].shape
    assert not differ[(top2[..., 1] - top2[..., 0]) > 1e-5].any()

    x = torch.from_numpy(local).requires_grad_()
    got_nll, got_w = TC.ce_maps(x, lab, cw, 255, win_hw, align, rows)
    np.testing.assert_allclose(got_nll.detach().numpy(), nll[:, oy], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_w.numpy(), w[:, oy])
    (torch.from_numpy(g[:, oy].copy()) * got_nll).sum().backward()
    h = shape[1]
    want_grad = np.pad(grad, ((0, 0), (h, h), (0, 0), (0, 0)))[
        :, h + rows.src_start:h + rows.src_start + local.shape[1]]
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-5, atol=1e-5)

    resized = TR.resize_rows(torch.from_numpy(local).permute(0, 3, 1, 2), win_hw, align, rows)
    np.testing.assert_allclose(resized.permute(0, 2, 3, 1).numpy(), up[:, oy], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape,out_hw", [(c[0], c[1]) for c in WINDOW_CASES])
def test_whole_window_is_the_unwindowed_function(shape, out_hw):
    """The whole image's window runs the unwindowed plain versions: equal
    bit for bit, and the plans equal the unwindowed ones."""
    logits, labels, cw, g, _, _, _ = _window_case(shape, out_hw, 1, 0, True)
    x = torch.from_numpy(logits)
    whole = TR.Rows.whole(shape[1], out_hw[0])
    assert torch.equal(TU.upsample_argmax_rows(x, out_hw, True, whole),
                       TU.upsample_argmax(x, out_hw, True))
    for a, b in zip(TC.ce_front_fwd(x, torch.from_numpy(labels), cw, 255, out_hw, True, whole),
                    TC.ce_front_fwd(x, torch.from_numpy(labels), cw, 255, out_hw, True)):
        assert torch.equal(a, b)
    n, h, w, c = shape
    for plain, windowed in ((TU.plan(n, h, w, c, *out_hw, True),
                             TU.plan(n, h, w, c, *out_hw, True, whole)),
                            (TC.forward_plan(n, h, w, c, *out_hw, True, 4),
                             TC.forward_plan(n, h, w, c, *out_hw, True, 4, whole)),
                            (TC.backward_plan(n, h, w, c, *out_hw, True, 4),
                             TC.backward_plan(n, h, w, c, *out_hw, True, 4, whole))):
        for a, b in zip(plain, windowed):
            assert np.array_equal(a, b)


def test_window_without_its_halo_raises():
    """A slice that lacks the rows its window's taps read is refused."""
    rows = TR.Rows(16, 4, 128, 32)  # rows 4..7 of 16 serve output rows 32..63: reads row 3
    x = torch.zeros(1, 4, 8, 19)
    with pytest.raises(ValueError, match="lacks halo rows"):
        TU.upsample_argmax_rows(x, (32, 64), True, rows)
    with pytest.raises(ValueError, match="lacks halo rows"):
        TC.ce_maps(x, torch.zeros(1, 32, 64, dtype=torch.int32), None, 255, (32, 64), True,
                   rows)


@pytest.mark.parametrize("h,ranks,ok", [(128, 2, True), (128, 4, True), (96, 3, False),
                                       (64, 4, False), (192, 3, True)])
def test_shard_rows_rule(h, ranks, ok):
    """H must be a multiple of 32 x S (each shard halves evenly down to the
    1/32 stage) and of 64."""
    if ok:
        SP.check_split(h, ranks)
    else:
        with pytest.raises(ValueError, match=f"multiple of {32} x {ranks}"):
            SP.check_split(h, ranks)


def test_mesh_2d_in_one_process():
    """No process group: the (1, 1) mesh; more devices than ranks raise."""
    mesh = SP.make_mesh_2d(1, 1, "cpu")
    assert (mesh.size, mesh.rank, mesh.data_index, mesh.spatial_index) == (1, 0, 0, 0)
    assert mesh.row_group is None and mesh.world.group is None
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        SP.make_mesh_2d(1, 2, "cpu")
    x = np.zeros((2, 64, 64, 3), np.float32)
    assert tuple(SP.shard_rows(mesh, x).shape) == (2, 64, 64, 3)


# ---------------------------------------------------------------------------
# Ranks: the collectives, the sharded model and the steps
# ---------------------------------------------------------------------------


def _collectives(mesh):
    """halo_exchange and gather_rows on rank-dependent fp64 rows: forward
    against slicing the whole tensor, backward against autograd of that
    slicing, and gradcheck of the sharded function of the whole tensor
    (pmean'd first, so that each rank's gradient is the mesh's)."""
    s, big_s = mesh.spatial_index, mesh.n_spatial
    rng = np.random.default_rng(5)
    whole = torch.from_numpy(rng.standard_normal((2, 3, 4 * big_s, 5)))
    cots = [torch.from_numpy(rng.standard_normal((2, 3, 4 + 3, 5))) for _ in range(big_s)]
    top, bottom = 2, 1
    padded = torch.nn.functional.pad(whole, (0, 0, top, bottom))
    out = {}

    x = whole[:, :, 4 * s:4 * s + 4].clone().requires_grad_()
    y = SP.halo_exchange(x, top, bottom, mesh)
    out["halo_fwd"] = torch.equal(y.detach(), padded[:, :, 4 * s:4 * s + 4 + top + bottom])
    (gx,) = torch.autograd.grad(y, x, cots[s])
    ref = whole.clone().requires_grad_()
    ref_pad = torch.nn.functional.pad(ref, (0, 0, top, bottom))
    total = sum((ref_pad[:, :, 4 * r:4 * r + 7] * cots[r]).sum() for r in range(big_s))
    (gref,) = torch.autograd.grad(total, ref)
    out["halo_bwd"] = float((gx - gref[:, :, 4 * s:4 * s + 4]).abs().max())

    x = whole[:, :, 4 * s:4 * s + 4].clone().requires_grad_()
    y = SP.gather_rows(x, mesh)
    out["gather_fwd"] = torch.equal(y.detach(), whole)
    (gx,) = torch.autograd.grad(y, x, cots[s][:, :, :4].repeat(1, 1, big_s, 1) * (s + 1))
    want = sum((r + 1) * cots[r][:, :, :4] for r in range(big_s))
    out["gather_bwd"] = float((gx - want).abs().max())

    def sharded(t):
        t = mesh.world.pmean(t)
        return SP.gather_rows(SP.halo_exchange(t[:, :, 4 * s:4 * s + 4], top, bottom, mesh),
                              mesh)

    out["gradcheck"] = torch.autograd.gradcheck(
        sharded, (whole[:1, :1].clone().requires_grad_(),), eps=1e-6, atol=1e-8)
    return out


def _outputs(model, mesh, x):
    """The heads of `model` on this rank's rows, gathered whole, NHWC."""
    with M.spatial_sharding(model, mesh):
        heads = model(SP.shard_rows(mesh, x))
    return [SP.gather_rows(o, mesh, dim=1).detach().numpy() for o in heads]


def _train(mesh, sd, batch, spec=SPEC_S):
    """One fp32 spatial train step from `sd` on this rank's share: metrics,
    params, BN state."""
    ts = TrainState.create(M.build(spec, sd, device="cpu", train=True))
    step = make_spatial_train_step(ts, FullLoss(**LOSS_KW), mesh, momentum=0.9,
                                   weight_decay=5e-4)
    metrics = step(*SP.shard_rows(mesh, *batch), 0.01)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy().copy() for k, v in ts.params().items()},
            {k: v.numpy().copy() for k, v in ts.state().items()})


def _rank_12(rank, sd_s, sd_l, batch):
    """A rank of the (1, 2) mesh: the collectives, PIDNet-S's and -L's
    sharded heads, the engine's sharded class map, the eval step (the
    second sample masked) and the train step."""
    torch.set_num_threads(2)
    mesh = SP.make_mesh_2d(1, 2, "cpu")
    out = {"mesh": (mesh.size, mesh.rank, mesh.spatial_index, mesh.backend)}
    out["collectives"] = _collectives(mesh)
    img, lab, edge = batch
    out["heads_s"] = _outputs(M.build(SPEC_S, sd_s, device="cpu"), mesh, img)
    out["heads_l"] = _outputs(M.build(SPEC_L, sd_l, device="cpu"), mesh, img)
    cfg = engine.config(num_outputs=2, align_corners=True, output_index=1)
    out["classmap"] = engine.make_inference_classmap(cfg, SPEC_S, sd_s, device="cpu",
                                                     spatial_mesh=mesh)(img).numpy()
    evaluate = make_spatial_eval_step(M.build(SPEC_S, sd_s, device="cpu"), FullLoss(**LOSS_KW),
                                      mesh, num_classes=19)
    metrics, cms = evaluate(*SP.shard_rows(mesh, img, lab, edge, np.array([1.0, 0.0],
                                                                           np.float32)))
    out["eval"] = ({k: float(v) for k, v in metrics.items()}, cms.numpy())
    out["train"] = _train(mesh, sd_s, batch)
    return out


def _rank_22(rank, sd, batch):
    """A rank of the (2, 2) mesh: the train step on its data row's sample."""
    torch.set_num_threads(1)
    mesh = SP.make_mesh_2d(2, 2, "cpu")
    d = mesh.data_index
    return (mesh.data_index, mesh.spatial_index), _train(mesh, sd, [a[d:d + 1] for a in batch])


@pytest.fixture(scope="module")
def weights():
    return _weights(SPEC_S), _weights(SPEC_L, seed=8)


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def ranks_12(weights, batch):
    return launch.spawn(_rank_12, 2, *weights, batch, backend="gloo", timeout=600)


@pytest.fixture(scope="module")
def ranks_22(weights, batch):
    return launch.spawn(_rank_22, 4, weights[0], batch, backend="gloo", timeout=600)


def _jax_state(sd):
    import jax.numpy as jnp

    params, state = W.to_jax(sd)
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in state.items()})


@pytest.fixture(scope="module")
def jax_spatial(weights, batch):
    """The JAX package's spatial functions on (1, 2) meshes of the virtual
    CPU devices (and the train step on (2, 2)): heads of S and L, the eval
    step, the train steps; each as numpy."""
    import jax

    from pidnet_tpu.losses import FullLoss as JaxFullLoss
    from pidnet_tpu.models import pidnet as JM
    from pidnet_tpu.parallel import spatial as JS
    from pidnet_tpu.train import TrainState as JaxTrainState

    img, lab, edge = batch
    plain = dict(stem_s2d=False, wfold=False)
    mesh = JS.make_mesh_2d(1, 2)
    out = {}
    for key, spec, sd in (("heads_s", JM.spec_for("pidnet_s", 19, True), weights[0]),
                          ("heads_l", JM.spec_for("pidnet_l", 19, True), weights[1])):
        heads = JS.make_spatial_infer(spec, mesh, **plain)(*_jax_state(sd),
                                                           JS.put_batch(mesh, img))
        out[key] = [np.asarray(h) for h in heads]
    spec = JM.spec_for("pidnet_s", 19, True)
    loss = JaxFullLoss(**LOSS_KW)
    m, cms = JS.make_spatial_eval_step(spec, loss, mesh, num_classes=19, **plain)(
        JaxTrainState.create(*_jax_state(weights[0])),
        *JS.put_batch(mesh, img, lab, edge, np.array([1.0, 0.0], np.float32)))
    out["eval"] = ({k: float(v) for k, v in m.items()}, np.asarray(cms))
    for key, shape in (("train_12", (1, 2)), ("train_22", (2, 2))):
        tmesh = JS.make_mesh_2d(*shape)
        step = JS.make_spatial_train_step(spec, loss, tmesh, weight_decay=5e-4, **plain)
        ts, m = step(JaxTrainState.create(*_jax_state(weights[0])),
                     *JS.put_batch(tmesh, img, lab, edge), 0.01)
        ts = jax.device_get(ts)
        out[key] = ({k: float(v) for k, v in m.items()},
                    {k: np.asarray(v) for k, v in ts.params.items()},
                    {k: np.asarray(v) for k, v in ts.state.items()})
    return out


def test_ranks_form_the_mesh(ranks_12, ranks_22):
    assert [r["mesh"] for r in ranks_12] == [(2, 0, 0, "gloo"), (2, 1, 1, "gloo")]
    assert [r[0] for r in ranks_22] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_halo_exchange_and_gather_rows(ranks_12):
    """Forward equal to slicing the whole (zero-padded) tensor, bit for bit;
    backward equal to autograd of that slicing (1e-12, fp64); gradcheck
    passes on both ranks."""
    for r in ranks_12:
        c = r["collectives"]
        assert c["halo_fwd"] and c["gather_fwd"] and c["gradcheck"]
        assert c["halo_bwd"] < 1e-12 and c["gather_bwd"] < 1e-12


@pytest.mark.parametrize("key", ["heads_s", "heads_l"])
def test_sharded_heads_match_jax_spatial_infer(ranks_12, jax_spatial, key):
    """PIDNet-S's and PIDNet-L's (DAPPM, Bag) three heads, sharded over
    (1, 2) and gathered, against make_spatial_infer on (1, 2): rtol/atol
    2e-2, tightened to 1e-3 relative to each head's largest |logit|, and
    >= 0.999 of the argmaxes equal; both ranks hold the same heads."""
    got, want = ranks_12[0][key], jax_spatial[key]
    assert len(got) == len(want) == 3
    for g, g1, w in zip(got, ranks_12[1][key], want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, g1)
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2)
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()
        if w.shape[-1] > 1:
            assert (np.argmax(g, -1) == np.argmax(w, -1)).mean() >= 0.999


def test_sharded_classmap_matches_one_device(ranks_12, weights, batch):
    """engine.make_inference_classmap over (1, 2): every rank returns the
    whole (N, H, W) int32 map, >= 0.999 equal to the one-device closure's."""
    cfg = engine.config(num_outputs=2, align_corners=True, output_index=1)
    want = engine.make_inference_classmap(cfg, SPEC_S, weights[0], device="cpu")(
        batch[0]).numpy()
    got = [r["classmap"] for r in ranks_12]
    assert got[0].dtype == np.int32 and got[0].shape == want.shape
    np.testing.assert_array_equal(got[0], got[1])
    assert (got[0] == want).mean() >= 0.999


def test_eval_step_matches_jax_spatial(ranks_12, jax_spatial):
    """make_spatial_eval_step on (1, 2), OHEM on, the second sample masked:
    metrics rtol 2e-2 / atol 1e-3 (the global weight exact), matrices with
    equal totals and < 5e-3 of the pixels moved, the same on both ranks."""
    (got_m, got_cm), (want_m, want_cm) = ranks_12[0]["eval"], jax_spatial["eval"]
    assert ranks_12[1]["eval"][0] == got_m
    np.testing.assert_array_equal(ranks_12[1]["eval"][1], got_cm)
    assert got_m["weight"] == want_m["weight"] == 1.0
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=2e-2, atol=1e-3, err_msg=k)
    assert got_cm.shape == want_cm.shape == (2, 19, 19)
    assert got_cm.sum() == want_cm.sum() > 0
    assert np.abs(got_cm - want_cm).sum() / want_cm.sum() < 5e-3


def _close_step(got, want, weights):
    """tests/test_spatial.py's train-step bound: loss rtol 1e-4 (atol
    1e-5), update cosine > 0.995, params atol 5e-2, BN state rtol 1e-2
    (atol 1e-4)."""
    (got_m, got_p, got_s), (want_m, want_p, want_s) = got, want
    p0 = W.to_jax(weights)[0]
    assert np.isfinite(got_m["loss"])
    np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=1e-4, atol=1e-5)
    got_p = W.to_jax({k: torch.from_numpy(v) for k, v in got_p.items()})[0]
    a = np.concatenate([(got_p[k] - p0[k]).ravel() for k in sorted(want_p)])
    b = np.concatenate([(want_p[k] - p0[k]).ravel() for k in sorted(want_p)])
    assert float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)) > 0.995
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], atol=5e-2, err_msg=k)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-2, atol=1e-4, err_msg=k)


def test_train_step_matches_jax_spatial_12(ranks_12, jax_spatial, weights):
    """make_spatial_train_step on (1, 2) against the JAX package's on (1,
    2); both ranks end the step with the same weights and BN state."""
    got = ranks_12[0]["train"]
    _close_step(got, jax_spatial["train_12"], weights[0])
    other = ranks_12[1]["train"]
    assert other[0] == got[0]
    for a, b in ((got[1], other[1]), (got[2], other[2])):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_train_step_matches_jax_spatial_22(ranks_22, jax_spatial, weights):
    """(2, 2): one sample a data row, rows over two spatial ranks, against
    the JAX package's (2, 2) step; every rank holds the same weights."""
    got = ranks_22[0][1]
    _close_step(got, jax_spatial["train_22"], weights[0])
    for _, other in ranks_22[1:]:
        assert all(np.array_equal(got[1][k], other[1][k]) for k in got[1])


def test_one_spatial_rank_is_the_one_device_step(weights, batch):
    """A (1, 1) mesh runs the plain leaves (no halo, no window): its train
    step's loss equals the one-device data step's within 1e-6 relative
    (FullLoss sums its terms in another order) and its update cosine is >
    0.99999."""
    from pidnet_tpu_torch.train.step import make_train_step

    mesh = SP.make_mesh_2d(1, 1, "cpu")
    got_m, got_p, _ = _train(mesh, weights[0], batch)
    ts = TrainState.create(M.build(SPEC_S, weights[0], device="cpu", train=True))
    want_m = make_train_step(ts, FullLoss(**LOSS_KW), momentum=0.9, weight_decay=5e-4)(
        *(torch.from_numpy(a) for a in batch), 0.01)
    np.testing.assert_allclose(got_m["loss"], float(want_m["loss"]), rtol=1e-6)
    want_p = {k: v.numpy() for k, v in ts.params().items()}
    a = np.concatenate([(got_p[k] - weights[0][k].numpy()).ravel() for k in sorted(want_p)])
    b = np.concatenate([(want_p[k] - weights[0][k].numpy()).ravel() for k in sorted(want_p)])
    assert float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)) > 0.99999


# ---------------------------------------------------------------------------
# The CLIs: tools.train --spatial 2 and tools.eval --spatial 2 on two ranks
# ---------------------------------------------------------------------------

YAML = """
DATASET:
  DATASET: cityscapes
  ROOT: {root}/data/
  TRAIN_SET: 'list/cityscapes/train.lst'
  TEST_SET: 'list/cityscapes/val.lst'
  NUM_CLASSES: 19
MODEL:
  NAME: pidnet_s
  PRETRAINED: '{weights}'
LOSS:
  OHEMKEEP: 500
TRAIN:
  IMAGE_SIZE: [128, 128]
  BASE_SIZE: 128
  LR: 0.001
  BATCH_SIZE_PER_GPU: 1
  END_EPOCH: 1
  IGNORE_LABEL: 255
TEST:
  IMAGE_SIZE: [128, 128]
  BASE_SIZE: 128
  OUTPUT_INDEX: 1
WORKERS: 1
PRINT_FREQ: 1
"""


class _Writer:
    """TBWriter's interface, without torch.utils.tensorboard's imports."""

    def __init__(self, log_dir):
        pass

    def add_scalar(self, tag, value, step):
        pass

    def close(self):
        pass


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One train frame and one val frame, random 128x128."""
    root = tmp_path_factory.mktemp("sp_cli")
    rng = np.random.default_rng(23)
    for d in ("data/cityscapes/img", "data/cityscapes/gt", "data/list/cityscapes"):
        (root / d).mkdir(parents=True)
    lines = []
    for i in range(2):
        write_png(str(root / f"data/cityscapes/img/{i}.png"),
                  rng.integers(0, 256, (128, 128, 3), dtype=np.uint8))
        write_png(str(root / f"data/cityscapes/gt/{i}_gtFine_labelIds.png"),
                  rng.integers(0, 34, (128, 128), dtype=np.uint8))
        lines.append(f"img/{i}.png\tgt/{i}_gtFine_labelIds.png")
    (root / "data/list/cityscapes/train.lst").write_text(lines[0])
    (root / "data/list/cityscapes/val.lst").write_text(lines[1])
    (root / "sp.yaml").write_text(YAML.format(root=root, weights=WEIGHTS))
    return root


def _argv(tree, *flags, opts=()):
    return ["--cfg", str(tree / "sp.yaml"), "--device", "cpu", *flags, "OUTPUT_DIR",
            str(tree / "output"), "LOG_DIR", str(tree / "log"), *opts]


def _cli_rank(rank, tool, argv):
    """One rank of `tools.<tool> --spatial 2`: what it returns, and a
    digest of every whole batch it sharded (its data row's samples)."""
    from pidnet_tpu_torch.tools import eval as eval_cli
    from pidnet_tpu_torch.tools import train

    torch.set_num_threads(2)
    train.TBWriter = _Writer
    seen = []
    shard = SP.shard_rows

    def recording(mesh, *arrays):
        seen.append(hashlib.sha256(np.asarray(arrays[0]).tobytes()).hexdigest())
        return shard(mesh, *arrays)

    SP.shard_rows = recording
    try:
        result = (train if tool == "train" else eval_cli).main(argv)
    finally:
        SP.shard_rows = shard
    return result, seen


@pytest.fixture(scope="module")
def cli_runs(tree):
    trained = launch.spawn(_cli_rank, 2, "train", _argv(tree, "--multihost", "--spatial", "2"),
                           backend=None, timeout=600)
    model = str(tree / "output" / "cityscapes" / "sp" / "final_state.pt")
    evaluated = launch.spawn(_cli_rank, 2, "eval",
                             _argv(tree, "--spatial", "2", opts=("TEST.MODEL_FILE", model)),
                             backend=None, timeout=600)
    return trained, evaluated, model


def test_cli_train_spatial(cli_runs, tree):
    """tools.train --multihost --spatial 2: one step and one val frame;
    both ranks of the spatial row sharded the same whole batches (one
    train batch, one val batch); finite logged losses; rank 0 wrote the
    artifacts."""
    trained, _, model = cli_runs
    (_, seen0), (_, seen1) = trained
    assert len(seen0) == 2 and seen0 == seen1
    run = os.path.dirname(model)
    (log,) = glob.glob(os.path.join(run, "sp_*_train.log"))
    with open(log) as f:
        losses = [float(v.split(",")[0]) for v in f.read().split("Loss: ")[1:]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert {"checkpoint.pt", "best.pt", "final_state.pt"} <= set(os.listdir(run))


def test_cli_eval_spatial(cli_runs, tree):
    """tools.eval --spatial 2 of the trained weights: both ranks read the
    val frame and return the same scores, within 1e-2 of one process's
    tools.eval (class maps of the sharded and the whole image may differ at
    pixels whose top-2 margin is rounding noise)."""
    from pidnet_tpu_torch.tools import eval as eval_cli

    _, evaluated, model = cli_runs
    (got0, seen0), (got1, seen1) = evaluated
    assert len(seen0) == 1 and seen0 == seen1
    assert got0[0] == got1[0] and np.array_equal(got0[1], got1[1])
    want = eval_cli.main(_argv(tree, opts=("TEST.MODEL_FILE", model)))
    assert abs(got0[0] - want[0]) < 1e-2 and abs(got0[2] - want[2]) < 1e-2


def test_cli_spatial_refusals(tree):
    """--spatial with TRAIN.ACCUM_STEPS 2, and a --spatial that does not
    divide the processes, raise; so does the eval TTA."""
    from pidnet_tpu_torch.tools import eval as eval_cli
    from pidnet_tpu_torch.tools import train

    with pytest.raises(RuntimeError, match="ACCUM_STEPS > 1 does not compose with --spatial"):
        train.main(_argv(tree, "--spatial", "2", opts=("TRAIN.ACCUM_STEPS", "2")))
    with pytest.raises(RuntimeError, match="--spatial 2 must divide the process count 1"):
        train.main(_argv(tree, "--spatial", "2"))
    with pytest.raises(SystemExit, match="TTA"):
        eval_cli.main(_argv(tree, "--spatial", "2", opts=("TEST.FLIP_TEST", "true")))
