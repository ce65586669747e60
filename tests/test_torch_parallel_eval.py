"""PyTorch port, data-parallel evaluation on the CPU: the mesh's eval step
on two gloo ranks against the JAX package's `make_eval_step` on two of
the conftest's virtual CPU devices, `engine._data_parallel_infer` over two
CPU replicas against one, and `tools.eval` with DEVICES 2 against
`engine.testval`."""

import os

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
from pidnet_tpu.train import make_eval_step as jax_make_eval_step
from pidnet_tpu_torch import engine
from pidnet_tpu_torch.config import load_config
from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.data import Loader, build_dataset
from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS
from pidnet_tpu_torch.data.png import write_png
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.parallel import launch
from pidnet_tpu_torch.parallel.mesh import make_mesh, shard_batch
from pidnet_tpu_torch.tools import common
from pidnet_tpu_torch.tools import eval as eval_tool
from pidnet_tpu_torch.train.step import make_eval_step

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WEIGHTS = os.path.join(REPO, "runs", "train2k", "weights_f16.npz")
SPEC = M.spec_for("pidnet_s", 19, augment=True)
JSPEC = JM.spec_for("pidnet_s", 19, augment=True)
LOSS_KW = dict(ignore_label=255, class_weights=CLASS_WEIGHTS, ohem_thres=0.9, ohem_kept=131072)
WORLD, PER_RANK = 2, 2
MASK = np.array([1, 1, 1, 0], np.float32)  # the last sample pads the batch
YAML = """
OUTPUT_DIR: {root}/output
LOG_DIR: {root}/log
DATASET:
  DATASET: cityscapes
  ROOT: {root}/data/
  TEST_SET: 'list/cityscapes/val.lst'
  NUM_CLASSES: 19
MODEL:
  NAME: pidnet_s
  PRETRAINED: ''
TRAIN:
  IGNORE_LABEL: 255
TEST:
  IMAGE_SIZE: [128, 128]
  BASE_SIZE: 128
  OUTPUT_INDEX: 1
WORKERS: 1
"""


@pytest.fixture(scope="module")
def weights():
    params, state = JM.init(jax.random.PRNGKey(0), JSPEC)
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in state.items()})


@pytest.fixture(scope="module")
def batch():
    """4x64x64; the padding sample (mask 0) carries labels, which the mask
    alone must drop."""
    rng = np.random.default_rng(8)
    img = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    lab = rng.integers(0, 19, (4, 64, 64)).astype(np.int32)
    lab[rng.random(lab.shape) < 0.1] = 255
    edge = (rng.random((4, 64, 64)) < 0.1).astype(np.float32)
    return img, lab, edge, MASK


def _eval_rank(rank, params, state, batch):
    """One rank's eval step on its 2 samples: (metrics, cms)."""
    torch.set_num_threads(2)
    mesh = make_mesh(-1, "cpu")
    share = [a[rank * PER_RANK:(rank + 1) * PER_RANK] for a in batch]
    step = make_eval_step(M.build(SPEC, W.from_jax(params, state), device="cpu"),
                          FullLoss(**LOSS_KW), mesh, num_classes=19)
    metrics, cms = step(*shard_batch(mesh, *share))
    return {k: float(v) for k, v in metrics.items()}, cms.numpy()


def test_eval_step_matches_jax_on_the_2_device_mesh(weights, batch):
    """World 2, one padding sample masked, fp32, against the JAX
    make_eval_step on make_mesh(2) (its plain layouts, no batch padding):
    metrics within 5e-5 relative, the global weight 3 on both ranks, the
    confusion matrices equal and the same on both ranks."""
    params, state = weights
    mesh = jax_make_mesh(WORLD)
    step = jax_make_eval_step(JSPEC, JaxFullLoss(**LOSS_KW), mesh, num_classes=19,
                              pad_batch=False, stem_s2d=False, wfold=False)
    ts = JaxTrainState.create({k: jnp.asarray(v) for k, v in params.items()},
                              {k: jnp.asarray(v) for k, v in state.items()})
    want_m, want_cms = step(ts, *jax_shard_batch(mesh, *batch))
    want_m = {k: float(v) for k, v in want_m.items()}
    ranks = launch.spawn(_eval_rank, WORLD, params, state, batch, timeout=600)
    (m0, cms0), (m1, cms1) = ranks
    assert m0 == m1 and np.array_equal(cms0, cms1)
    assert set(m0) == set(want_m) and m0["weight"] == want_m["weight"] == 3.0
    for k in want_m:
        np.testing.assert_allclose(m0[k], want_m[k], rtol=5e-5, err_msg=k)
    counted = int((batch[1][:3] != 255).sum())
    assert cms0.dtype == np.int64 and [int(c.sum()) for c in cms0] == [counted, counted]
    np.testing.assert_array_equal(cms0, np.asarray(want_cms))


@pytest.fixture(scope="module")
def trained():
    return W.load_npz(WEIGHTS)


@pytest.mark.parametrize("classmap", [True, False], ids=["classmap", "probabilities"])
def test_data_parallel_infer_equals_one_device(trained, classmap):
    """Two CPU replicas on a batch of 2 give, bit for bit, what one device
    gives each frame; a batch that does not split raises."""
    cfg = engine.config()
    if classmap:
        make, sd, kw = engine.make_inference_classmap, fold_state_dict(trained, SPEC), dict(
            folded=True, compute_dtype=torch.bfloat16)
    else:
        make, sd, kw = engine.make_inference, trained, {}
    x = np.random.default_rng(3).standard_normal((2, 64, 128, 3)).astype(np.float32)
    one = make(cfg, SPEC, sd, device="cpu", **kw)
    dp = make(cfg, SPEC, sd, data_devices=["cpu", "cpu"], **kw)
    got = dp(x)
    want = torch.cat([one(x[i:i + 1]) for i in range(2)])
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not split over 2"):
        dp(x[:1])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Cityscapes val list of 3 random 128x128 frames (an odd count, so
    the last batch of 2 is padded) and its YAML."""
    root = tmp_path_factory.mktemp("dp_eval")
    rng = np.random.default_rng(12)
    for d in ("data/cityscapes/img", "data/cityscapes/gt", "data/list/cityscapes"):
        (root / d).mkdir(parents=True)
    lines = []
    for i in range(3):
        write_png(str(root / f"data/cityscapes/img/{i}.png"),
                  rng.integers(0, 256, (128, 128, 3), dtype=np.uint8))
        write_png(str(root / f"data/cityscapes/gt/{i}_gtFine_labelIds.png"),
                  rng.integers(0, 34, (128, 128), dtype=np.uint8))
        lines.append(f"img/{i}.png\tgt/{i}_gtFine_labelIds.png")
    (root / "data/list/cityscapes/val.lst").write_text("\n".join(lines))
    (root / "dp.yaml").write_text(YAML.format(root=root))
    return root


@pytest.mark.parametrize("fold", [False, True], ids=["fp32", "fold-bn"])
def test_eval_cli_data_parallel_gives_testval_scores(tree, fold):
    """tools.eval with DEVICES 2 --device cpu (two replicas, batches of 2,
    the last padded) gives the scores of engine.testval with a one-device
    closure and batches of 1."""
    cfg_path = str(tree / "dp.yaml")
    flags = ["--fold-bn"] if fold else []
    got = eval_tool.main(["--cfg", cfg_path, "--device", "cpu", *flags, "DEVICES", "2",
                          "TEST.MODEL_FILE", WEIGHTS])
    cfg = load_config(cfg_path, [])
    sd = common.load_weights(WEIGHTS, common.init_model(cfg, SPEC))[0]
    make = engine.make_inference_classmap if fold else engine.make_inference
    infer = make(cfg, SPEC, fold_state_dict(sd, SPEC) if fold else sd, folded=fold,
                 compute_dtype=torch.bfloat16 if fold else None, device="cpu")
    ds = build_dataset("cityscapes", root=cfg.DATASET.ROOT, list_path=cfg.DATASET.TEST_SET,
                       num_classes=19, multi_scale=False, flip=False, ignore_label=255,
                       base_size=128, crop_size=(128, 128))
    want = engine.testval(cfg, ds, Loader(ds, 1, num_workers=0), infer)
    assert got[0] == want[0] and got[2:] == want[2:] and np.array_equal(got[1], want[1])


def test_eval_cli_refuses_more_cards_than_the_machine_has(tree, monkeypatch):
    """DEVICES above torch.cuda.device_count() raises instead of running on
    fewer devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="DEVICES 2: this machine has 1 CUDA device"):
        eval_tool.main(["--cfg", str(tree / "dp.yaml"), "DEVICES", "2",
                        "TEST.MODEL_FILE", WEIGHTS])
