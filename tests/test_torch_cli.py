"""PyTorch port, the CLI layer on the CPU: create_logger, tools/common.py,
tools/train.py, tools/eval.py and tools/convert.py, held against the JAX
package's functions where it has them, over a small Cityscapes tree
(128x128 frames, batch 2) with PIDNet-S at full width.

The train crops are 128x128, not 64x64: at 64x64 PIDNet's 1/64 stage is
1x1, so its batch-norm statistics over a batch of 2 are degenerate; the
bf16 gradients reached 350 in the first step and the validation loss was
NaN after four."""

import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pidnet_tpu import engine as jengine
from pidnet_tpu.config import load_config as jload_config
from pidnet_tpu.convert import export_state_dict as jexport_state_dict
from pidnet_tpu.convert import load_torch_checkpoint
from pidnet_tpu.data import Loader as JLoader
from pidnet_tpu.data import build_dataset as jbuild_dataset
from pidnet_tpu.data import native as jnative
from pidnet_tpu.models import pidnet as JM
from pidnet_tpu.tools import common as jcommon
from pidnet_tpu.utils import create_logger as jcreate_logger
from pidnet_tpu_torch import engine
from pidnet_tpu_torch.config import load_config
from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.data.png import read_png, write_png
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.tools import common, convert, train
from pidnet_tpu_torch.tools import eval as eval_tool
from pidnet_tpu_torch.train import checkpoint as ckpt
from pidnet_tpu_torch.utils.logging import create_logger

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WEIGHTS = os.path.join(REPO, "runs", "train2k", "weights_f16.npz")
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))
N_TRAIN, N_VAL = 4, 2
TINY_YAML = """
OUTPUT_DIR: {root}/output
LOG_DIR: {root}/log
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
  BATCH_SIZE_PER_GPU: 2
  END_EPOCH: 2
  IGNORE_LABEL: 255
TEST:
  IMAGE_SIZE: [128, 128]
  BASE_SIZE: 128
  OUTPUT_INDEX: 1
DEVICES: 1
WORKERS: 1
PRINT_FREQ: 1
"""


@pytest.fixture
def numpy_jax(monkeypatch):
    """The JAX package's data pipeline with its numpy fallbacks (as in
    test_torch_data.py): its host library normalises through a float32 LUT,
    which rounds differently from numpy's (v / 255 - mean) / std."""
    monkeypatch.setattr(jnative, "_lib", None)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Cityscapes tree of 6 random 128x128 frames (4 train, 2 val, the
    2 val images also as a test list), raw label ids 0-33 written as
    greyscale PNGs by the port; returns the directory holding tiny.yaml."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(304)
    for d in ("data/cityscapes/img", "data/cityscapes/gt", "data/list/cityscapes"):
        (root / d).mkdir(parents=True)
    lines = []
    for i in range(N_TRAIN + N_VAL):
        write_png(str(root / f"data/cityscapes/img/{i}.png"),
                  rng.integers(0, 256, (128, 128, 3), dtype=np.uint8))
        write_png(str(root / f"data/cityscapes/gt/{i}_gtFine_labelIds.png"),
                  rng.integers(0, 34, (128, 128), dtype=np.uint8))
        lines.append(f"img/{i}.png\tgt/{i}_gtFine_labelIds.png")
    lists = root / "data/list/cityscapes"
    (lists / "train.lst").write_text("\n".join(lines[:N_TRAIN]))
    (lists / "val.lst").write_text("\n".join(lines[N_TRAIN:]))
    (lists / "test.lst").write_text("\n".join(ln.split("\t")[0] for ln in lines[N_TRAIN:]))
    (root / "tiny.yaml").write_text(TINY_YAML.format(root=root, weights=WEIGHTS))
    return root


def _cfg_path(tree):
    return str(tree / "tiny.yaml")


# --- create_logger, build_spec, weights ---------------------------------------------------


def test_create_logger_layout_equals_jax(tree, tmp_path, monkeypatch):
    real = time.strftime  # the run's timestamp fixed; the log records' own left alone
    monkeypatch.setattr(time, "strftime",
                        lambda fmt, *t: real(fmt, *t) if t else "2026-01-02-03-04")
    opts = ["OUTPUT_DIR", str(tmp_path / "out"), "LOG_DIR", str(tmp_path / "tb")]
    got, want = [], []
    for load, make, out in ((load_config, create_logger, got),
                            (jload_config, jcreate_logger, want)):
        cfg = load(_cfg_path(tree), opts)
        logger, final_dir, tb_dir = make(cfg, _cfg_path(tree), "train")
        logger.info("hello")
        for h in logger.handlers:
            h.flush()
        out.append((final_dir, tb_dir, sorted(os.listdir(final_dir)), logger.name))
    assert got[0][:3] == want[0][:3]
    assert got[0][2] == ["tiny_2026-01-02-03-04_train.log"]
    assert got[0][3] == "pidnet_tpu_torch" and want[0][3] == "pidnet_tpu"
    assert os.path.isdir(got[0][1])
    with open(os.path.join(got[0][0], got[0][2][0])) as f:
        assert "hello" in f.read()


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.basename(p))
def test_build_spec_equals_jax(path):
    for augment in (True, False):
        got = common.build_spec(load_config(path), augment)
        want = jcommon.build_spec(jload_config(path), augment)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", ["ddrnet_23_slim", "bisenetv2"])
def test_build_spec_rejects_unported_models(name):
    """DDRNet and BiSeNet names were refused until the ablations were
    ported (ROADMAP.md Queue 1 item 7), whence the name; now they build
    the JAX package's spec of the same family (its `forward_fn` has no
    counterpart)."""
    for augment in (True, False):
        got = common.build_spec(load_config(CONFIGS[0], ["MODEL.NAME", name]), augment)
        want = jcommon.build_spec(jload_config(CONFIGS[0], ["MODEL.NAME", name]), augment)
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == {
            k: v for k, v in dataclasses.asdict(want).items() if k != "forward_fn"}


def test_init_model_is_seeded():
    spec = M.spec_for("pidnet_s", 19, True)
    a, b = common.init_model(None, spec, 3), common.init_model(None, spec, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.0.weight"], common.init_model(None, spec, 4)["conv1.0.weight"])


@pytest.fixture(scope="module")
def train2k():
    """The train2k weights as the JAX package's float32 (params, state)."""
    with np.load(WEIGHTS) as z:
        params = {k[2:]: z[k].astype(np.float32) for k in z.files if k.startswith("p.")}
        state = {k[2:]: z[k].astype(np.float32) for k in z.files if k.startswith("s.")}
    return params, state


def test_merge_state_dict_equals_jax(train2k, tmp_path):
    """A reference-layout checkpoint (the JAX package's export of the train2k
    weights under `state_dict`, 5 keys dropped, 2 unknown keys, 1 of another
    shape and a BN counter) through load_weights/merge_state_dict and
    through the JAX package's load_torch_checkpoint, into zero templates:
    the same count and the same tensors, exactly."""
    params, state = train2k
    ref = {k: torch.from_numpy(v) for k, v in jexport_state_dict(params, state).items()}
    keys = sorted(ref)
    for k in keys[::len(keys) // 5][:5]:
        del ref[k]
    ref["model.unknown.weight"] = torch.ones(3)
    ref["aux.head.bias"] = torch.ones(19)
    ref["model.final_layer.conv2.weight"] = torch.ones(7, 128, 1, 1)
    ref["model.bn1.num_batches_tracked"] = torch.tensor(5)
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"state_dict": ref, "epoch": 3}, path)

    jp0 = {k: np.zeros_like(v) for k, v in params.items()}
    js0 = {k: np.zeros_like(v) for k, v in state.items()}
    jp, js, jn = load_torch_checkpoint(path, jp0, js0)
    want = W.from_jax(jp, js)
    template = W.from_jax(jp0, js0)
    for merged, n in (common.load_weights(path, template), W.merge_state_dict(ref, template)):
        assert n == jn == len(template) - 6
        assert sorted(merged) == sorted(want)
        for k in want:
            assert torch.equal(merged[k], want[k]), k
    assert torch.equal(merged["final_layer.conv2.weight"],
                       torch.zeros_like(merged["final_layer.conv2.weight"]))


def test_convert_export_equals_jax(train2k, tmp_path):
    """tools.convert --export of the train2k npz gives the JAX package's
    export_state_dict tensors, exactly; the default output loads back
    whole."""
    dst = str(tmp_path / "ref.pt")
    convert.main([WEIGHTS, dst, "--export"])
    got = torch.load(dst, weights_only=True)
    want = jexport_state_dict(*train2k)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)

    port = str(tmp_path / "port.pt")
    convert.main([WEIGHTS, port])
    spec = M.spec_for("pidnet_s", 19, True)
    template = common.init_model(None, spec)
    sd, n = common.load_weights(port, template)
    trained = W.load_npz(WEIGHTS)
    assert n == len(template) and all(torch.equal(sd[k], trained[k]) for k in template)
    assert not common.is_folded_checkpoint(port)
    # the reference layout goes back in through the same loader
    sd2, n2 = common.load_weights(dst, template)
    assert n2 == n and all(torch.equal(sd2[k], sd[k]) for k in sd)


def test_convert_fold_and_loader_routing(tmp_path):
    spec = M.spec_for("pidnet_s", 19, True)
    template = common.init_model(None, spec)
    folded = str(tmp_path / "folded.pt")
    convert.main([WEIGHTS, folded, "--fold"])
    assert common.is_folded_checkpoint(folded) and ckpt.is_folded(folded)
    want = fold_state_dict(W.load_npz(WEIGHTS), spec)
    got = common.load_folded(folded, spec, template)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(SystemExit, match="BN-folded"):
        common.load_weights(folded, template)
    with pytest.raises(SystemExit, match="missing"):
        common.load_folded(folded, M.spec_for("pidnet_l", 19, True),
                           common.init_model(None, M.spec_for("pidnet_l", 19, True)))
    with pytest.raises(SystemExit, match="flax"):
        common.load_weights(str(tmp_path / "x.msgpack"), template)
    with pytest.raises(SystemExit, match="drop --fold"):
        convert.main([WEIGHTS, str(tmp_path / "y.pt"), "--fold", "--export"])


def test_convert_refuses_a_mismatched_architecture(tmp_path, capsys):
    dst = str(tmp_path / "l.pt")
    with pytest.raises(SystemExit, match="matched only"):
        convert.main([WEIGHTS, dst, "--a", "pidnet-l"])
    assert not os.path.exists(dst)
    convert.main([WEIGHTS, dst, "--a", "pidnet-l", "--force"])
    assert os.path.isfile(dst) and "loaded" in capsys.readouterr().out


def test_maybe_load_pretrained(tree, caplog):
    spec = M.spec_for("pidnet_s", 19, True)
    template = common.init_model(None, spec)
    cfg = load_config(_cfg_path(tree), ["MODEL.PRETRAINED", str(tree / "absent.pt")])
    with caplog.at_level("WARNING", logger="pidnet_tpu_torch"):
        assert common.maybe_load_pretrained(cfg, template) is template
    assert "not found" in caplog.text
    sd = common.maybe_load_pretrained(load_config(_cfg_path(tree)), template)
    trained = W.load_npz(WEIGHTS)
    assert all(torch.equal(sd[k], trained[k]) for k in template)


# --- the train CLI ---------------------------------------------------------------------------


def test_train_data_equals_jax(tree, numpy_jax):
    """train.build_data's first train batch (epoch 1, as train_one_epoch
    sets it) and first val batch equal the JAX package's tools/train.py
    construction on one process, bit for bit."""
    seed = 7
    cfg = load_config(_cfg_path(tree))
    _, trainloader, testloader = train.build_data(cfg, seed)

    jcfg = jload_config(_cfg_path(tree))  # pidnet_tpu/tools/train.py:183-231, n_proc = 1
    crop_size = (jcfg.TRAIN.IMAGE_SIZE[1], jcfg.TRAIN.IMAGE_SIZE[0])
    jtrain = jbuild_dataset(
        jcfg.DATASET.DATASET, root=jcfg.DATASET.ROOT, list_path=jcfg.DATASET.TRAIN_SET,
        num_classes=jcfg.DATASET.NUM_CLASSES, multi_scale=jcfg.TRAIN.MULTI_SCALE,
        flip=jcfg.TRAIN.FLIP, ignore_label=jcfg.TRAIN.IGNORE_LABEL,
        base_size=jcfg.TRAIN.BASE_SIZE, crop_size=crop_size,
        scale_factor=jcfg.TRAIN.SCALE_FACTOR, seed=seed, cache=jcfg.DATASET.CACHE,
        cache_gb=jcfg.DATASET.CACHE_GB)
    jtrainloader = JLoader(jtrain, jcfg.TRAIN.BATCH_SIZE_PER_GPU, shuffle=jcfg.TRAIN.SHUFFLE,
                           drop_last=True, num_workers=jcfg.WORKERS, seed=seed, num_shards=1,
                           shard_index=0)
    test_size = (jcfg.TEST.IMAGE_SIZE[1], jcfg.TEST.IMAGE_SIZE[0])
    jtest = jbuild_dataset(
        jcfg.DATASET.DATASET, root=jcfg.DATASET.ROOT, list_path=jcfg.DATASET.TEST_SET,
        num_classes=jcfg.DATASET.NUM_CLASSES, multi_scale=False, flip=False,
        ignore_label=jcfg.TRAIN.IGNORE_LABEL, base_size=jcfg.TEST.BASE_SIZE,
        crop_size=test_size, seed=seed)
    jtestloader = JLoader(jtest, 1, shuffle=False, drop_last=False, num_workers=jcfg.WORKERS,
                          num_shards=1, shard_index=0)

    assert len(trainloader) == len(jtrainloader) == N_TRAIN // 2
    assert len(testloader) == len(jtestloader) == N_VAL
    for ours, theirs in ((trainloader, jtrainloader), (testloader, jtestloader)):
        if ours is trainloader:
            ours.set_epoch(1)
            theirs.set_epoch(1)
        a, b = next(iter(ours)), next(iter(theirs))
        assert a[-1] == b[-1]
        for x, y in zip(a[:-1], b[:-1]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def _argv(tree, out, *opts, flags=()):
    """CLI arguments: the tiny config on the CPU, outputs under `out`, then
    `flags` and the KEY VALUE `opts` (which take the rest of the line)."""
    return ["--cfg", _cfg_path(tree), "--device", "cpu", *flags, "OUTPUT_DIR", str(out),
            "LOG_DIR", str(out) + "_tb", *opts]


def _run_dir(out):
    return os.path.join(str(out), "cityscapes", "tiny")


class _Writer:
    """TBWriter's interface, keeping the scalars: torch.utils.tensorboard
    imports tensorflow where it is installed, which takes seconds."""

    scalars: list = []

    def __init__(self, log_dir):
        assert os.path.isdir(log_dir)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        pass


@pytest.fixture(scope="module", autouse=True)
def recording_writer():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "TBWriter", _Writer)
        yield _Writer.scalars


@pytest.fixture(scope="module")
def full_run(tree, recording_writer):
    """tools.train to END_EPOCH 2 (2 steps an epoch), with a first-epoch
    profile; returns its output directory and the scalars it wrote."""
    out = tree / "full"
    recording_writer.clear()
    train.main(_argv(tree, out, "XLA.PROFILE_DIR", str(tree / "prof")))
    return _run_dir(out), list(recording_writer)


def test_train_cli_writes_its_artifacts(tree, full_run):
    full_run, scalars = full_run
    assert [(tag, step) for tag, _, step in scalars] == [
        ("train_loss", 0), ("valid_loss", 0), ("valid_mIoU", 0),
        ("train_loss", 1), ("valid_loss", 1), ("valid_mIoU", 1)]
    for name in ("checkpoint.pt", "best.pt", "final_state.pt"):
        assert os.path.isfile(os.path.join(full_run, name)), name
    payload = ckpt.load(os.path.join(full_run, "checkpoint.pt"))
    assert payload["epoch"] == 2 and payload["iter"] == 0
    assert set(payload) == {"epoch", "iter", "best_mIoU", "params", "state", "momentum"}
    assert 0 < payload["best_mIoU"] <= 1
    (log,) = glob.glob(os.path.join(full_run, "tiny_*_train.log"))
    text = open(log).read()
    losses = [float(v.split(",")[0]) for v in text.split("Loss: ")[1:]]
    assert len(losses) == 2 * 2 + 2 and all(np.isfinite(losses))  # 4 steps, 2 validations
    assert "Done" in text and "training on cpu" in text
    with open(os.path.join(tree, "prof", train.TRACE_FILE)) as f:
        assert json.load(f)["traceEvents"]
    # the final weights load back through the CLIs' loader
    spec = M.spec_for("pidnet_s", 19, True)
    _, n = common.load_weights(os.path.join(full_run, "final_state.pt"),
                               common.init_model(None, spec))
    assert n == len(M.init(spec))


def test_train_resume_after_sigterm_is_bit_exact(tree, full_run, monkeypatch):
    """The same command stopped by SIGTERM after step 3 of 4 (in-process,
    from a wrapped train step), then resumed with TRAIN.RESUME true, ends
    with final_state.pt equal bit for bit to the uninterrupted run's. Both
    runs keep END_EPOCH 2: the poly LR's length is END_EPOCH x epoch
    iterations."""
    out = tree / "resumed"
    steps = []
    make = train.make_train_step

    def stopping_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrapped(*a):
            metrics = step(*a)
            steps.append(1)
            if len(steps) == 3:
                signal.raise_signal(signal.SIGTERM)
            return metrics

        return wrapped

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(train, "make_train_step", stopping_make)
    train.main(_argv(tree, out))
    monkeypatch.undo()
    assert signal.getsignal(signal.SIGTERM) is before
    run = _run_dir(out)
    payload = ckpt.load(os.path.join(run, "checkpoint.pt"))
    assert (payload["epoch"], payload["iter"], len(steps)) == (1, 1, 3)
    assert not os.path.exists(os.path.join(run, "final_state.pt"))
    (log,) = glob.glob(os.path.join(run, "tiny_*_train.log"))
    assert "exiting on SIGTERM; resume with TRAIN.RESUME true" in open(log).read()

    train.main(_argv(tree, out, "TRAIN.RESUME", "true"))
    got = ckpt.load(os.path.join(run, "final_state.pt"))
    want = ckpt.load(os.path.join(full_run[0], "final_state.pt"))
    for part in ("params", "state"):
        assert sorted(got[part]) == sorted(want[part])
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), k
    assert ckpt.load(os.path.join(run, "checkpoint.pt"))["epoch"] == 2


REJECTIONS = [  # (flags, KEY VALUE opts, what the run must do)
    (["--multihost"], [], (RuntimeError, "torchrun")),  # no torchrun environment
    # item 6, ported: one process cannot hold two spatial ranks
    (["--spatial", "2"], [], (RuntimeError, "must divide the process count 1.*torchrun")),
    ([], ["DEVICES", "2"], (RuntimeError, "torchrun")),  # one process, two devices
    ([], ["TRAIN.ACCUM_STEPS", "2"], "accum_steps=2"),  # item 5, ported
    ([], ["MODEL.NAME", "ddrnet_23"], "DDRNet"),  # item 7, ported
]


class _Built(Exception):
    """Stops tools.train once the train step is being made."""


@pytest.mark.parametrize("flags, opts, want", REJECTIONS,
                         ids=["multihost", "spatial", "devices", "accum", "ddrnet"])
def test_train_rejects_what_is_not_ported(tree, tmp_path, flags, opts, want, monkeypatch):
    """What the port cannot run as asked raises: a data-parallel or spatial
    request that one process cannot meet (--multihost without torchrun's
    environment, --spatial 2, DEVICES 2) naming torchrun. The names predate
    the ports of items 5, 6 and 7: `spatial` once raised naming item 6, the
    `accum` case now builds an accumulating train step and the `ddrnet` case a
    DDRNet."""
    for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    if isinstance(want, tuple):
        with pytest.raises(want[0], match=want[1]):
            train.main(_argv(tree, tmp_path, *opts, flags=flags))
        return

    def stop(ts, loss_fn, mesh, **kwargs):
        raise _Built(f"{type(ts.model).__name__} accum_steps={kwargs['accum_steps']}")

    monkeypatch.setattr(train, "make_train_step", stop)
    with pytest.raises(_Built, match=want):
        train.main(_argv(tree, tmp_path, *opts, flags=flags))


def test_tbwriter_is_a_no_op_when_tensorboard_is_broken(tmp_path, monkeypatch):
    """A tensorboard install whose import raises something other than
    ImportError gives the no-op writer, as the JAX package's TBWriter
    (`except Exception`) does, and the train CLI trains on."""
    import builtins

    from pidnet_tpu_torch.utils import logging as port_logging

    real_import = builtins.__import__

    def broken_import(name, *args, **kwargs):
        if name == "torch.utils.tensorboard":
            raise RuntimeError("a broken tensorboard install")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", broken_import)
    writer = port_logging.TBWriter(str(tmp_path / "tb"))
    assert writer._w is None
    writer.add_scalar("train_loss", 1.0, 0)
    writer.close()


def test_train_subprocess_exits_cleanly_on_sigterm(tree):
    """python -m pidnet_tpu_torch.tools.train in a subprocess at END_EPOCH
    5000: SIGTERM once checkpoint.pt exists gives exit code 0, a
    preemption checkpoint inside an epoch, no final_state.pt, and no JAX
    module imported (-X importtime lists every import).

    tensorflow is hidden from the subprocess (the GPU machine has none):
    where it is installed, torch.utils.tensorboard (TBWriter) imports it,
    and it imports jax itself. tensorboard then takes its own stub."""
    out = tree / "preempt"
    shim = tree / "no_tensorflow" / "tensorflow"
    shim.mkdir(parents=True, exist_ok=True)
    (shim / "__init__.py").write_text("raise ImportError('tensorflow is hidden')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(shim.parent), REPO]))
    log_path = tree / "preempt.out"
    run = _run_dir(out)
    # the output goes to a file: -X importtime alone overfills a pipe
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "pidnet_tpu_torch.tools.train",
             *_argv(tree, out, "TRAIN.END_EPOCH", "5000")],
            cwd=str(tree), env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 120
            while not os.path.exists(os.path.join(run, "checkpoint.pt")):
                assert proc.poll() is None, log_path.read_text()
                assert time.time() < deadline, "no checkpoint within 120 s"
                time.sleep(0.2)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=max(1.0, deadline - time.time()))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    output = log_path.read_text()
    assert proc.returncode == 0, output
    assert "exiting on SIGTERM" in output, output
    assert not os.path.exists(os.path.join(run, "final_state.pt"))
    payload = ckpt.load(os.path.join(run, "checkpoint.pt"))
    assert 0 <= payload["epoch"] < 5000 and 0 <= payload["iter"] < N_TRAIN // 2
    imported = [ln.rsplit("|", 1)[-1].strip() for ln in output.splitlines()
                if ln.startswith("import time:")]
    assert "pidnet_tpu_torch.tools.train" in imported or "pidnet_tpu_torch.engine" in imported
    assert not [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "pidnet_tpu")]


# --- the eval CLI ----------------------------------------------------------------------------


def test_eval_cli_fp32_equals_jax_testval(tree, tmp_path, train2k, numpy_jax):
    """The eval CLI's fp32 scores on the train2k weights against JAX
    engine.testval with JAX make_inference on the same weights and frames.
    Found: the same scores to the last bit, the class maps equal on every
    pixel, the log-probabilities within 2.6e-5. Tolerance: 1e-12 on mIoU,
    pixel and mean accuracy; where the maps differ at all, the pixels must
    have an fp32 top-2 margin under 1e-3."""
    miou, iou, pixel_acc, mean_acc = eval_tool.main(
        _argv(tree, tmp_path, "TEST.MODEL_FILE", WEIGHTS))

    jcfg = jload_config(_cfg_path(tree))
    jspec = JM.spec_for(jcfg.MODEL.NAME, 19, True)
    jtest = jbuild_dataset(
        "cityscapes", root=jcfg.DATASET.ROOT, list_path=jcfg.DATASET.TEST_SET, num_classes=19,
        multi_scale=False, flip=False, ignore_label=255, base_size=128, crop_size=(128, 128))
    jinfer = jengine.make_inference(jcfg, jspec, *train2k)
    jmiou, jiou, jpixel, jmean = jengine.testval(jcfg, jtest, JLoader(jtest, 1, num_workers=0),
                                                 jinfer, sv_dir=str(tmp_path))
    assert abs(miou - jmiou) <= 1e-12 and abs(pixel_acc - jpixel) <= 1e-12
    assert abs(mean_acc - jmean) <= 1e-12
    np.testing.assert_allclose(iou, jiou, rtol=0, atol=1e-12)

    cfg = load_config(_cfg_path(tree))
    infer = engine.make_inference(cfg, M.spec_for("pidnet_s", 19, True), W.load_npz(WEIGHTS),
                                  device="cpu")
    for i in range(len(jtest)):
        image = jtest[i][0][None]
        ours = infer(image).numpy()
        theirs = np.asarray(jinfer(image))
        differ = ours.argmax(-1) != theirs.argmax(-1)
        top2 = np.sort(np.log(ours), axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0])[differ].max(initial=0.0) < 1e-3


def test_eval_cli_folded_routing(tree, tmp_path):
    """A folded .pt runs only with --fold-bn, and there gives the scores of
    folding the unfolded weights in the CLI; without it the CLI exits
    non-zero."""
    folded = str(tmp_path / "folded.pt")
    convert.main([WEIGHTS, folded, "--fold"])
    fold = ["--fold-bn"]
    want = eval_tool.main(_argv(tree, tmp_path, "TEST.MODEL_FILE", WEIGHTS, flags=fold))
    got = eval_tool.main(_argv(tree, tmp_path, "TEST.MODEL_FILE", folded, flags=fold))
    assert got[0] == want[0] and got[2:] == want[2:]
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(SystemExit, match="BN-folded") as exc:
        eval_tool.main(_argv(tree, tmp_path, "TEST.MODEL_FILE", folded))
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize("flags, opts, calls", [
    ([], (), {"serve.call": 2, "serve.input": 2, "serve.model": 2, "serve.classmap": 2}),
    (["--fold-bn"], ("DEVICES", "2"),
     {"serve.call": 3, "serve.input": 2, "serve.model": 2, "serve.classmap": 2}),
], ids=["fp32", "folded-data-parallel"])
def test_eval_cli_profile_shows_the_serving_spans(tree, tmp_path, flags, opts, calls):
    """XLA.PROFILE_DIR writes the evaluation's trace with the serving spans:
    a call for each of the 2 frames, or, data-parallel, one call of both
    holding one call of each replica."""
    prof = tmp_path / "prof"
    eval_tool.main(_argv(tree, tmp_path, "TEST.MODEL_FILE", WEIGHTS, *opts, "XLA.PROFILE_DIR",
                         str(prof), flags=flags))
    with open(prof / eval_tool.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert {n: names.count(n) for n in calls} == calls
    assert "model.pag" in names


def test_eval_cli_test_list_writes_predictions(tree, tmp_path):
    out = eval_tool.main(_argv(tree, tmp_path, "TEST.MODEL_FILE", WEIGHTS, "DATASET.TEST_SET",
                               "list/cityscapes/test.lst", flags=["--fold-bn"]))
    assert out is None
    pngs = sorted(glob.glob(str(tmp_path / "cityscapes" / "tiny" / "test_results" / "*.png")))
    assert [os.path.basename(p) for p in pngs] == [f"{i}.png" for i in range(N_TRAIN, 6)]
    for p in pngs:
        pred = read_png(p)
        assert pred.shape == (128, 128) and pred.dtype == np.uint8


def test_eval_cli_default_model_file_and_tta(tree, tmp_path, full_run):
    """Without TEST.MODEL_FILE the CLI reads <final_output_dir>/best.pt (the
    train CLI's); TEST.FLIP_TEST takes the TTA closure."""
    full_run = full_run[0]
    out = os.path.dirname(os.path.dirname(full_run))
    scores = eval_tool.main(_argv(tree, out))
    assert 0 <= scores[0] <= 1 and np.isfinite(scores[2])
    flip = eval_tool.main(_argv(tree, out, "TEST.FLIP_TEST", "true"))
    assert all(np.isfinite(v) for v in (flip[0], flip[2], flip[3]))
    assert glob.glob(os.path.join(full_run, "tiny_*_test.log"))


@pytest.mark.parametrize("flags, opts, item", [(["--spatial", "2"], [], "torchrun"),
                                               ([], ["DEVICES", "4"], None)],
                         ids=["spatial", "devices"])
def test_eval_rejects_what_is_not_ported(tree, tmp_path, flags, opts, item, monkeypatch):
    """--spatial 2 in one process without torchrun's environment raises
    naming torchrun (it raised naming item 6 until that was ported). The
    `devices` case, refused until item 5 was ported, now evaluates over 4
    CPU replicas and gives the one-device run's scores."""
    if item is not None:
        for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(key, raising=False)
        with pytest.raises(RuntimeError, match=item):
            eval_tool.main(_argv(tree, tmp_path, *opts, flags=flags))
        return
    got = eval_tool.main(_argv(tree, tmp_path, "TEST.MODEL_FILE", WEIGHTS, *opts, flags=flags))
    want = eval_tool.main(_argv(tree, tmp_path, "TEST.MODEL_FILE", WEIGHTS, flags=flags))
    assert got[0] == want[0] and got[2:] == want[2:] and np.array_equal(got[1], want[1])
