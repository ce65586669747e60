"""PyTorch port, slice 3's evaluation path on the CPU: the metrics, the eval
step against the JAX package's on its 8-device CPU mesh, `validate` with a
partial batch and wrap-pad duplicates (as tests/test_engine.py holds the
JAX one), and `testval` / `test` against the JAX loops."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pidnet_tpu import engine as jengine
from pidnet_tpu import metrics as jmetrics
from pidnet_tpu.config import default_config
from pidnet_tpu.losses import FullLoss as JaxFullLoss
from pidnet_tpu.models import pidnet as JM
from pidnet_tpu.parallel import make_mesh, shard_batch
from pidnet_tpu.train import TrainState as JaxTrainState
from pidnet_tpu.train import make_eval_step as jax_make_eval_step
from pidnet_tpu_torch import engine, metrics
from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.train.step import make_eval_step

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "runs", "train2k", "weights_f16.npz")
SPEC = M.spec_for("pidnet_s", 19, augment=True)
JSPEC = JM.spec_for("pidnet_s", 19, augment=True)
LOSS_KW = dict(ignore_label=255, class_weights=CLASS_WEIGHTS, ohem_thres=0.9, ohem_kept=131072)


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))


def _writer_dict():
    return {"writer": _Writer(), "valid_global_steps": 0}


def _batch(rng, n, h=64, w=64, ignore=0.1):
    img = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    lab = rng.integers(0, 19, (n, h, w)).astype(np.int32)
    lab[rng.random((n, h, w)) < ignore] = 255
    edge = (rng.random((n, h, w)) < 0.1).astype(np.float32)
    return img, lab, edge


@pytest.fixture(scope="module")
def weights():
    params, state = JM.init(jax.random.PRNGKey(0), JSPEC)
    params = {k: np.asarray(v) for k, v in params.items()}
    state = {k: np.asarray(v) for k, v in state.items()}
    return params, state, W.from_jax(params, state)


@pytest.fixture(scope="module")
def batch8():
    """8x64x64, 5 real samples; the padding samples carry ignore labels."""
    img, lab, edge = _batch(np.random.default_rng(5), 8)
    mask = (np.arange(8) < 5).astype(np.float32)
    lab[5:] = 255
    return img, lab, edge, mask


@pytest.fixture(scope="module")
def jax_eval(weights, batch8):
    """The JAX eval step on the 8-device mesh (one sample per shard): its
    (metrics, cms) on batch8."""
    params, state, _ = weights
    mesh = make_mesh(8)
    step = jax_make_eval_step(JSPEC, JaxFullLoss(**LOSS_KW), mesh, num_classes=19)
    ts = JaxTrainState.create({k: jnp.asarray(v) for k, v in params.items()},
                              {k: jnp.asarray(v) for k, v in state.items()})
    m, cms = step(ts, *shard_batch(mesh, *batch8))
    return {k: float(v) for k, v in m.items()}, np.asarray(cms)


def test_confusion_matrix_and_scores_match_jax(rng):
    logits = rng.standard_normal((2, 9, 7, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 9, 7)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.2] = 255
    preds = logits.argmax(-1).astype(np.int32)
    for inp in (logits, preds):
        want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(inp), jnp.asarray(labels), 5, 255))
        got = metrics.confusion_matrix(torch.from_numpy(inp), torch.from_numpy(labels), 5, 255)
        assert got.dtype == torch.int64 and tuple(got.shape) == (5, 5)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == int((labels != 255).sum())
    cm = got.numpy()
    for port_fn, jax_fn in ((metrics.iou_from_cm, jmetrics.iou_from_cm),
                            (metrics.acc_from_cm, jmetrics.acc_from_cm)):
        for a, b in zip(port_fn(cm), jax_fn(want)):
            np.testing.assert_array_equal(a, b)
    assert metrics.iou_from_cm(np.zeros((3, 3)))[1] == 0.0


def test_eval_step_matches_jax_on_the_8_device_mesh(weights, batch8, jax_eval):
    """fp32: the port's step on each shard's sample, its metrics combined as
    the JAX step's psum does (sum of value x weight over the real-sample
    count), and on the whole batch for the matrices (which add over
    shards). Loss and metrics at rtol 1e-3 / atol 1e-4 (the JAX step runs
    its s2d stem and W-folded layouts, test_torch_train.py's bound);
    matrices within 0.1% of the counted pixels (fp32 argmax near-ties)."""
    want_m, want_cms = jax_eval
    img, lab, edge, mask = batch8
    step = make_eval_step(M.build(SPEC, weights[2], device="cpu"), FullLoss(**LOSS_KW),
                          num_classes=19)
    sums, weight = {}, 0.0
    for i in range(8):
        m, _ = step(*(a[i:i + 1] for a in batch8))
        weight += float(m["weight"])
        for k, v in m.items():
            if k != "weight":
                sums[k] = sums.get(k, 0.0) + float(v) * float(m["weight"])
    got_m = {k: v / max(weight, 1.0) for k, v in sums.items()}
    got_m["weight"] = weight
    assert set(got_m) == set(want_m) and weight == want_m["weight"] == 5.0
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-3, atol=1e-4, err_msg=k)

    _, cms = step(img, lab, edge, mask)
    counted = int((lab[:5] != 255).sum())
    assert cms.shape == (2, 19, 19) and want_cms.shape == (2, 19, 19)
    for got, want in zip(cms.numpy(), want_cms):
        assert got.sum() == want.sum() == counted
        assert np.abs(got - want).sum() / 2 <= 1e-3 * counted


def test_bf16_eval_step_counts_only_real_pixels(weights, batch8, jax_eval):
    """The bf16 path (matrices through upsample_argmax) counts exactly the
    labelled pixels of the 5 real samples, here with labels left on the
    padding samples so that the mask alone must drop them, and stays close
    to fp32's, as tests/test_engine.py holds the JAX bf16 path."""
    img, lab, edge, mask = batch8
    lab = lab.copy()
    lab[5:] = np.random.default_rng(6).integers(0, 19, lab[5:].shape)
    step = make_eval_step(M.build(SPEC, weights[2], device="cpu"), FullLoss(**LOSS_KW),
                          num_classes=19, compute_dtype=torch.bfloat16)
    m, cms = step(img, lab, edge, mask)
    counted = int((lab[:5] != 255).sum())
    assert [int(c.sum()) for c in cms] == [counted, counted]
    assert float(m["weight"]) == 5.0 and np.isfinite(float(m["loss"]))
    agree = 1.0 - np.abs(cms.numpy() - jax_eval[1]).sum() / (2 * jax_eval[1].sum())
    assert agree > 0.9, agree


class _Loader:
    def __init__(self, batches, batch_size, samples_per_epoch=None):
        self.batches, self.batch_size = batches, batch_size
        if samples_per_epoch is not None:
            self.samples_per_epoch = samples_per_epoch

    def __iter__(self):
        return iter(self.batches)


def test_validate_pads_the_partial_batch(weights):
    """A loader of 4 + 3 samples at batch 4: the partial batch's metrics and
    matrices equal an unpadded run of its 3 samples, the loss meter is
    weighted by the real-sample count, and the matrices count every
    labelled pixel once."""
    rng = np.random.default_rng(11)
    b1, b2 = _batch(rng, 4), _batch(rng, 3)
    step = make_eval_step(M.build(SPEC, weights[2], device="cpu"),
                          FullLoss(ignore_label=255, ohem_kept=100), num_classes=19)
    seen = []

    def recording_step(*batch):
        out = step(*batch)
        seen.append((batch[3], *out))
        return out

    wd = _writer_dict()
    cfg = engine.config(ignore_label=255)
    ave_loss, mean_iou, iou = engine.validate(
        cfg, _Loader([(*b1, None, None), (*b2, None, None)], 4), recording_step, wd)
    np.testing.assert_array_equal(seen[1][0], [1, 1, 1, 0])
    m_u, cms_u = step(*b2, np.ones(3, np.float32))
    for k in m_u:
        np.testing.assert_allclose(float(seen[1][1][k]), float(m_u[k]), rtol=1e-5, err_msg=k)
    assert torch.equal(seen[1][2], cms_u)
    l1, l2 = float(seen[0][1]["loss"]), float(m_u["loss"])
    np.testing.assert_allclose(ave_loss, (4 * l1 + 3 * l2) / 7, rtol=1e-6)
    cm = (seen[0][2] + seen[1][2]).numpy()
    assert cm[1].sum() == int((b1[1] != 255).sum() + (b2[1] != 255).sum())
    iou_want, miou_want = metrics.iou_from_cm(cm[-1])
    assert mean_iou == miou_want and np.array_equal(iou, iou_want) and iou.shape == (19,)
    assert [t for t, _, _ in wd["writer"].scalars] == ["valid_loss", "valid_mIoU"]
    assert wd["valid_global_steps"] == 1


def test_validate_masks_wrap_pad_duplicates():
    """3 yielded samples of which the last is a rank's wrap-pad duplicate, as
    one batch of 2 and a partial batch of 1: the duplicate is masked out of
    the loss and the matrices (tests/test_engine.py:130)."""
    rng = np.random.default_rng(2)
    img, lab, edge = _batch(rng, 3)
    loader = _Loader([(img[:2], lab[:2], edge[:2], None, None),
                      (img[2:], lab[2:], edge[2:], None, None)], 2, samples_per_epoch=2)
    masks = []

    def fake_eval_step(images, labels, edges, mask):
        masks.append(np.asarray(mask))
        assert images.shape[0] == 2 and labels.dtype == np.int32
        cm = np.zeros((2, 19, 19), np.float32)
        cm[:, 0, 0] = float(mask.sum()) * 64 * 64
        return {"loss": 1.0, "weight": float(mask.sum())}, cm

    ave_loss, _, _ = engine.validate(engine.config(ignore_label=255), loader, fake_eval_step,
                                     _writer_dict())
    np.testing.assert_array_equal(masks[0], [1.0, 1.0])
    np.testing.assert_array_equal(masks[1], [0.0, 0.0])
    assert ave_loss == 1.0


def test_validate_stops_early_without_writing():
    rng = np.random.default_rng(3)
    loader = _Loader([(*_batch(rng, 2), None, None)] * 3, 2)
    calls = []

    def fake_eval_step(*batch):
        calls.append(1)
        return {"loss": 2.0, "weight": 2.0}, np.zeros((2, 19, 19))

    wd = _writer_dict()
    ave_loss, _, _ = engine.validate(engine.config(ignore_label=255), loader, fake_eval_step, wd,
                                     should_stop=lambda: len(calls) >= 2)
    assert len(calls) == 2 and ave_loss == 2.0
    assert wd["writer"].scalars == [] and wd["valid_global_steps"] == 0


class _SavingDataset:
    def __init__(self):
        self.saved = []

    def save_pred(self, preds, sv_path, names):
        self.saved.append((np.asarray(preds), os.path.basename(sv_path), list(names)))


@pytest.fixture(scope="module")
def trained():
    return W.load_npz(WEIGHTS)


def _eval_cfgs():
    jcfg = default_config()
    jcfg.DATASET.NUM_CLASSES = 19
    jcfg.TRAIN.IGNORE_LABEL = 255
    jcfg.MODEL.NUM_OUTPUTS = 2
    jcfg.TEST.OUTPUT_INDEX = 1
    return engine.config(output_index=1, ignore_label=255), jcfg.freeze()


def test_testval_and_test_match_jax(tmp_path, trained):
    """Two 64x128 frames, trained weights, fp32: the port's testval through
    its probability closure and through its class-map closure, against the
    JAX testval through its probability closure; the saved predictions;
    and `test` with a batch padded to a multiple of 2."""
    cfg, jcfg = _eval_cfgs()
    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 64, 128, 3)).astype(np.float32)
    lab = rng.integers(0, 19, (2, 64, 128)).astype(np.int32)
    lab[:, :8] = 255
    loader = [(img[:1], lab[:1], None, None, ["a"]), (img[1:], lab[1:], None, None, ["b"])]
    params, state = W.to_jax(trained)
    jinfer = jengine.make_inference(jcfg, JSPEC, params, state)
    jds, ds, ds_cm = _SavingDataset(), _SavingDataset(), _SavingDataset()
    want = jengine.testval(jcfg, jds, loader, jinfer, sv_dir=str(tmp_path), sv_pred=True)
    infer = engine.make_inference(cfg, SPEC, trained, device="cpu")
    got = engine.testval(cfg, ds, loader, infer, sv_dir=str(tmp_path), sv_pred=True)
    got_cm = engine.testval(cfg, ds_cm, loader,
                            engine.make_inference_classmap(cfg, SPEC, trained, device="cpu"),
                            sv_dir=str(tmp_path), sv_pred=True, batch_pad=2)
    for g in (got, got_cm):
        np.testing.assert_allclose(g[0], want[0], atol=1e-3)
        np.testing.assert_allclose(g[1], want[1], atol=1e-2)
        np.testing.assert_allclose(g[2:], want[2:], atol=1e-3)
    assert [(d[1], d[2]) for d in ds.saved] == [(d[1], d[2]) for d in jds.saved] == [
        ("val_results", ["a"]), ("val_results", ["b"])]
    for (p, _, _), (q, _, _), (c, _, _) in zip(ds.saved, jds.saved, ds_cm.saved):
        assert p.shape == q.shape == (1, 64, 128, 19) and c.shape == (1, 64, 128)
        assert (p.argmax(-1) == q.argmax(-1)).mean() >= 0.999
        assert (c == p.argmax(-1)).mean() >= 0.999

    test_loader = [(img[[0, 1, 0]], None, ["x", "y", "z"])]
    jds, ds = _SavingDataset(), _SavingDataset()
    jengine.test(jcfg, jds, test_loader, jinfer, sv_dir=str(tmp_path), batch_pad=2)
    engine.test(cfg, ds, test_loader, infer, sv_dir=str(tmp_path), batch_pad=2)
    (p, sub, names), (q, _, _) = ds.saved[0], jds.saved[0]
    assert sub == "test_results" and names == ["x", "y", "z"] and p.shape == q.shape
    assert (p.argmax(-1) == q.argmax(-1)).mean() >= 0.999
    assert os.path.isdir(tmp_path / "test_results") and os.path.isdir(tmp_path / "val_results")


def test_pad_rows():
    x = np.arange(3)[:, None] * np.ones((3, 2))
    padded, n = engine._pad_rows(x, 4)
    assert n == 3 and padded.shape == (4, 2) and np.array_equal(padded[3], x[2])
    same, n = engine._pad_rows(x, 1)
    assert n == 3 and same is x
