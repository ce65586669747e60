"""PyTorch port: every training loss (losses/criterion.py) on the CPU
against the JAX package's, from the same seeded numpy logits and labels:
values within rtol 1e-5, logits gradients within rtol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pidnet_tpu.losses import criterion as JL
from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS
from pidnet_tpu_torch.losses import criterion as TL

torch.set_num_threads(2)

IGNORE = 255


def _logits_labels(rng, n=2, h=32, w=48, c=19, ignore_frac=0.2):
    logits = (rng.standard_normal((n, h, w, c)) * 2).astype(np.float32)
    labels = rng.integers(0, c, (n, h, w))
    labels = np.where(rng.random((n, h, w)) < ignore_frac, IGNORE, labels).astype(np.int32)
    return logits, labels


def _grad_jax(fn, logits, *args):
    val, g = jax.value_and_grad(lambda lg: fn(lg, *args))(jnp.asarray(logits))
    return float(val), np.asarray(g)


def _grad_torch(fn, logits, *args):
    x = torch.from_numpy(logits).requires_grad_()
    val = fn(x, *args)
    (g,) = torch.autograd.grad(val, x)
    return float(val.detach()), g.numpy()


def _close(jax_pair, torch_pair):
    (vj, gj), (vt, gt) = jax_pair, torch_pair
    np.testing.assert_allclose(vt, vj, rtol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-6 * np.abs(gj).max())


@pytest.mark.parametrize("weighted", [False, True])
def test_per_pixel_ce_matches_jax(rng, weighted):
    logits, labels = _logits_labels(rng)
    labels[0, 0, :3] = [19, 40, -2]  # outside [0, C), not ignore
    cw = CLASS_WEIGHTS if weighted else None
    want = JL._per_pixel_ce(jnp.asarray(logits), jnp.asarray(labels), cw, IGNORE)
    got = TL._per_pixel_ce(torch.from_numpy(logits), torch.from_numpy(labels), cw, IGNORE)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("divide_by,numel", [("weights", None), ("numel", None),
                                             ("numel", 2000.0), ("numel", 0.0)])
def test_cross_entropy_matches_jax(rng, divide_by, numel):
    logits, labels = _logits_labels(rng)
    args = (labels, CLASS_WEIGHTS, IGNORE, divide_by)
    _close(_grad_jax(lambda lg: JL.cross_entropy(lg, *args, numel=numel), logits),
           _grad_torch(lambda x: TL.cross_entropy(x, torch.from_numpy(labels), *args[1:],
                                                  numel=numel), logits))


def test_ce_from_maps_matches_jax(rng):
    nll = rng.random((2, 16, 16)).astype(np.float32) * 3
    w = rng.random((2, 16, 16)).astype(np.float32)
    for divide_by, numel in (("weights", None), ("numel", None), ("numel", 100.0)):
        want = float(JL._ce_from_maps(jnp.asarray(nll), jnp.asarray(w), divide_by, numel))
        got = float(TL._ce_from_maps(torch.from_numpy(nll), torch.from_numpy(w), divide_by,
                                     numel))
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("min_kept,thres,ignore_frac", [
    (100, 0.7, 0.2), (5000, 0.9, 0.2), (1, 0.5, 0.2),
    (131072, 0.9, 0.2),   # min_kept > nvalid: k clamps to nvalid - 1
    (1000, 0.9, 0.999),   # almost every pixel ignored
    (1000, 0.9, 1.0),     # every pixel ignored
])
def test_ohem_matches_jax(rng, min_kept, thres, ignore_frac):
    logits, labels = _logits_labels(rng, ignore_frac=ignore_frac)
    args = (CLASS_WEIGHTS, IGNORE, thres, min_kept)
    _close(_grad_jax(lambda lg: JL.ohem_cross_entropy(lg, labels, *args), logits),
           _grad_torch(lambda x: TL.ohem_cross_entropy(x, torch.from_numpy(labels), *args),
                       logits))


@pytest.mark.parametrize("numel", [None, 5000.0])
def test_weighted_bce_and_boundary_loss_match_jax(rng, numel):
    """Targets outside {0,1} (here -1 and 2) get weight 0."""
    bd = (rng.standard_normal((2, 32, 48, 1)) * 3).astype(np.float32)
    t = (rng.random((2, 32, 48)) < 0.1).astype(np.float32)
    t[0, :2] = -1.0
    t[1, :1] = 2.0
    _close(_grad_jax(lambda lg: JL.weighted_bce(lg, t, numel), bd),
           _grad_torch(lambda x: TL.weighted_bce(x, torch.from_numpy(t), numel), bd))
    _close(_grad_jax(lambda lg: JL.boundary_loss(lg, t), bd),
           _grad_torch(lambda x: TL.boundary_loss(x, torch.from_numpy(t)), bd))


@pytest.mark.parametrize("use_ohem", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_full_loss_matches_jax(rng, use_ohem, masked):
    """FullLoss on 1/8-resolution heads against labels at full size: the
    loss, every metric, and the gradient of each head."""
    n, h, w = 2, 64, 96
    heads = [(rng.standard_normal((n, h // 8, w // 8, c)) * 2).astype(np.float32)
             for c in (19, 19, 1)]
    labels = rng.integers(0, 19, (n, h, w))
    labels = np.where(rng.random((n, h, w)) < 0.1, IGNORE, labels).astype(np.int32)
    edges = (rng.random((n, h, w)) < 0.1).astype(np.float32)
    mask = np.array([1.0, 0.0], np.float32) if masked else None
    kw = dict(ignore_label=IGNORE, class_weights=CLASS_WEIGHTS, use_ohem=use_ohem,
              ohem_kept=3000)

    jloss = JL.FullLoss(**kw)
    jmask = None if mask is None else jnp.asarray(mask)
    (lj, mj), gj = jax.value_and_grad(
        lambda hs: jloss(hs, jnp.asarray(labels), jnp.asarray(edges), sample_mask=jmask),
        has_aux=True)([jnp.asarray(x) for x in heads])

    tloss = TL.FullLoss(**kw)
    xs = [torch.from_numpy(x).requires_grad_() for x in heads]
    tmask = None if mask is None else torch.from_numpy(mask)
    lt, mt = tloss(xs, torch.from_numpy(labels), torch.from_numpy(edges), sample_mask=tmask)
    gt = torch.autograd.grad(lt, xs)

    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * np.abs(b).max())


def test_full_loss_rejects_mismatched_heads():
    with pytest.raises(ValueError):
        TL.FullLoss(num_outputs=3)
    loss = TL.FullLoss(balance_weights=(1.0,), num_outputs=1)
    with pytest.raises(ValueError, match="not identical"):
        loss.sem_loss([torch.zeros(1, 2, 2, 3)] * 2, torch.zeros(1, 16, 16, dtype=torch.int32))
