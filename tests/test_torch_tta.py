"""PyTorch port: multi-scale + flip test-time augmentation
(`engine.make_ms_flip_inference`) against the JAX package's closure on the
same weights, and its identities. The inputs are seeded normal images,
which are not W-symmetric, so flipping the wrong axis fails."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pidnet_tpu import engine as jengine
from pidnet_tpu.config import default_config
from pidnet_tpu.models import pidnet as JM
from pidnet_tpu_torch import engine
from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.models import pidnet as M

torch.set_num_threads(2)

SPEC = M.spec_for("pidnet_s", 19, augment=True)
JSPEC = JM.spec_for("pidnet_s", 19, augment=True)


def _cfgs(crop_hw, base, *, flip=False, ms=False, scales=(1.0,)):
    jcfg = default_config()
    jcfg.TEST.IMAGE_SIZE = [crop_hw[1], crop_hw[0]]  # width, height
    jcfg.TEST.BASE_SIZE = base
    jcfg.TEST.FLIP_TEST = flip
    jcfg.TEST.MULTI_SCALE = ms
    jcfg.TEST.SCALE_LIST = list(scales)
    jcfg.MODEL.NUM_OUTPUTS = 2
    jcfg.TEST.OUTPUT_INDEX = 1
    cfg = engine.config(output_index=1, image_size=(crop_hw[1], crop_hw[0]), base_size=base,
                        flip_test=flip, multi_scale=ms, scale_list=scales)
    return cfg, jcfg.freeze()


def _assert_probs_match(got, want, tol=0.01):
    """Exp'd probabilities compared as clipped log-probabilities: random-init
    logits pass |z| > 88, where fp32 exp saturates (tests/test_tta.py)."""
    lg = np.log(np.clip(np.asarray(got, np.float64), 1e-30, 1e38))
    lw = np.log(np.clip(np.asarray(want, np.float64), 1e-30, 1e38))
    np.testing.assert_allclose(lg, lw, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def net():
    params, state = JM.init(jax.random.PRNGKey(3), JSPEC)
    params = {k: np.asarray(v) for k, v in params.items()}
    state = {k: np.asarray(v) for k, v in state.items()}
    return params, state, W.from_jax(params, state)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(304).standard_normal((1, 64, 128, 3)).astype(np.float32)


@pytest.mark.parametrize(
    "crop_hw,base,kw",
    [
        # flip without rescaling, 3 sliding 64x64 windows at stride 42 (6 model runs)
        ((64, 64), 128, dict(flip=True)),
        # scales 0.5 (32x64, zero-padded into the crop) and 1.0, each resized back
        ((64, 128), 128, dict(ms=True, scales=(0.5, 1.0))),
    ],
)
def test_ms_flip_matches_jax(net, image, crop_hw, base, kw):
    params, state, sd = net
    cfg, jcfg = _cfgs(crop_hw, base, **kw)
    want = jengine.make_ms_flip_inference(jcfg, JSPEC, params, state)(jnp.asarray(image))
    got = engine.make_ms_flip_inference(cfg, SPEC, sd, device="cpu")(image)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 64, 128, 19)
    _assert_probs_match(got.numpy(), np.asarray(want))


def test_identity_tta_is_make_inference(net, image):
    """Scale 1, no flip, crop = image: exactly the single-scale closure."""
    cfg, _ = _cfgs((64, 128), 128)
    got = engine.make_ms_flip_inference(cfg, SPEC, net[2], device="cpu")(image)
    want = engine.make_inference(cfg, SPEC, net[2], device="cpu")(image)
    _assert_probs_match(got.numpy(), want.numpy())


def test_flip_tta_is_flip_equivariant(net, image):
    """With one window covering the image, flip TTA of the mirrored image is
    the mirror of flip TTA of the image; without flip it is not (the
    network is not mirror-symmetric), so the check can fail."""
    for flip in (True, False):
        cfg, _ = _cfgs((64, 128), 128, flip=flip)
        tta = engine.make_ms_flip_inference(cfg, SPEC, net[2], device="cpu")
        a = tta(image).numpy()
        b = tta(np.ascontiguousarray(image[:, :, ::-1])).numpy()[:, :, ::-1]
        if flip:
            _assert_probs_match(b, a, tol=1e-4)
        else:
            with pytest.raises(AssertionError):
                _assert_probs_match(b, a)


def test_overlap_count():
    cnt = engine._overlap_count(1, 3, 42, 42, 64, 64, 64, 148)
    assert cnt.shape == (1, 64, 148, 1)
    np.testing.assert_array_equal(cnt[0, 0, [0, 41, 42, 63, 64, 84, 105, 106, 147], 0],
                                  [1, 1, 2, 2, 1, 2, 2, 1, 1])
    assert engine._overlap_count.cache_info().maxsize == 8
