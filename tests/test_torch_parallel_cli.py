"""PyTorch port, the data-parallel train CLI on the CPU: `tools.train
--multihost --device cpu` in two gloo ranks under torchrun's environment
(spawned by parallel/launch.py) against one process with
TRAIN.ACCUM_STEPS 2 on the same tree.

With one crop per rank the two runs put the same samples in the same
virtual shards: the loader gives rank r the samples r, r+2, ... of the
shared order, and the accumulating process's microbatch r of a batch of 2
is sample r. So the logged losses agree (rtol 1e-4) and the final weights
too (tests/test_accum.py's bound, atol 1e-4). The crops are 128x128, as
tests/test_torch_cli.py's are: at 64x64 the 1/64 stage is one pixel."""

import glob
import os

import numpy as np
import pytest
import torch

from pidnet_tpu_torch.data.png import write_png
from pidnet_tpu_torch.parallel import launch
from pidnet_tpu_torch.tools import train
from pidnet_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WEIGHTS = os.path.join(REPO, "runs", "train2k", "weights_f16.npz")
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
ARTIFACTS = ["checkpoint.pt", "best.pt", "final_state.pt"]


class _Writer:
    """TBWriter's interface: torch.utils.tensorboard imports tensorflow
    where it is installed, which takes seconds. Counts the writers made."""

    made = 0

    def __init__(self, log_dir):
        _Writer.made += 1

    def add_scalar(self, tag, value, step):
        pass

    def close(self):
        pass


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 train frames (one step of one crop a rank) and 3 val frames (rank
    1's second is a wrap-pad duplicate, masked), random 128x128."""
    root = tmp_path_factory.mktemp("dp_cli")
    rng = np.random.default_rng(21)
    for d in ("data/cityscapes/img", "data/cityscapes/gt", "data/list/cityscapes"):
        (root / d).mkdir(parents=True)
    lines = []
    for i in range(5):
        write_png(str(root / f"data/cityscapes/img/{i}.png"),
                  rng.integers(0, 256, (128, 128, 3), dtype=np.uint8))
        write_png(str(root / f"data/cityscapes/gt/{i}_gtFine_labelIds.png"),
                  rng.integers(0, 34, (128, 128), dtype=np.uint8))
        lines.append(f"img/{i}.png\tgt/{i}_gtFine_labelIds.png")
    (root / "data/list/cityscapes/train.lst").write_text("\n".join(lines[:2]))
    (root / "data/list/cityscapes/val.lst").write_text("\n".join(lines[2:]))
    (root / "dp.yaml").write_text(YAML.format(root=root, weights=WEIGHTS))
    return root


def _argv(tree, out, *opts, flags=()):
    return ["--cfg", str(tree / "dp.yaml"), "--device", "cpu", *flags, "OUTPUT_DIR",
            str(out / "output"), "LOG_DIR", str(out / "log"), *opts]


def _cli_rank(rank, argv):
    """One rank of `tools.train --multihost`: (TensorBoard writers made,
    the process group's backend as the train step saw it)."""
    torch.set_num_threads(2)
    train.TBWriter = _Writer
    seen = {}
    make = train.make_train_step

    def recording_make(ts, loss_fn, mesh, **kwargs):
        seen.update(backend=mesh.backend, size=mesh.size, rank=mesh.rank)
        return make(ts, loss_fn, mesh, **kwargs)

    train.make_train_step = recording_make
    train.main(argv)
    return _Writer.made, seen


def _run(out):
    """The run's directory, its logged losses (the train meter's and the
    validation's) and its final weights."""
    run = os.path.join(str(out), "output", "cityscapes", "dp")
    (log,) = glob.glob(os.path.join(run, "dp_*_train.log"))
    with open(log) as f:
        text = f.read()
    losses = [float(v.split(",")[0]) for v in text.split("Loss: ")[1:]]
    return run, losses, ckpt.load_model(os.path.join(run, "final_state.pt"))


@pytest.fixture(scope="module")
def two_ranks(tree):
    out = tree / "ranks"
    prof = str(tree / "prof")
    results = launch.spawn(_cli_rank, 2,
                           _argv(tree, out, "XLA.PROFILE_DIR", prof, flags=["--multihost"]),
                           backend=None, timeout=600)
    return out, results, prof


@pytest.fixture(scope="module")
def accumulating(tree):
    out = tree / "accum"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "TBWriter", _Writer)
        train.main(_argv(tree, out, "TRAIN.ACCUM_STEPS", "2"))
    return out


def test_two_ranks_equal_one_process_accumulating(two_ranks, accumulating):
    """The train meter's and the validation's logged losses within rtol
    1e-4, and the final weights and BN state within atol 1e-4."""
    _, got_losses, (got_p, got_s) = _run(two_ranks[0])
    _, want_losses, (want_p, want_s) = _run(accumulating)
    assert len(got_losses) == len(want_losses) == 2 and all(np.isfinite(got_losses))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    for got, want in ((got_p, want_p), (got_s, want_s)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-4, err_msg=k)


def test_only_rank_0_writes(two_ranks):
    """Both ranks joined one gloo group of 2; rank 0 alone made a
    TensorBoard writer, wrote the checkpoints, the log file and the trace."""
    out, results, prof = two_ranks
    assert [seen for _, seen in results] == [dict(backend="gloo", size=2, rank=r) for r in (0, 1)]
    assert [made for made, _ in results] == [1, 0]
    run = _run(out)[0]
    names = os.listdir(run)
    logs = [n for n in names if n.endswith("_train.log")]
    assert len(logs) == 1 and sorted(set(names) - set(logs)) == sorted(ARTIFACTS)
    assert os.listdir(prof) == [train.TRACE_FILE]


def test_one_process_refuses_all_cards_of_a_multi_card_machine(tree, tmp_path, monkeypatch):
    """DEVICES -1 (all cards) in one process on a machine with two cards
    raises, naming torchrun, before anything runs on a card; DEVICES 1
    would train on one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    argv = _argv(tree, tmp_path, "DEVICES", "-1")
    argv.remove("--device")
    argv.remove("cpu")
    with pytest.raises(RuntimeError, match="asks for all 2 cards.*torchrun"):
        train.main(argv)
