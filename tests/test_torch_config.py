"""PyTorch port, the config loader on the CPU: every YAML under configs/
and the `KEY VALUE` overrides give the JAX package's tree, and the
engine's functions read the result as they read `engine.config(...)`."""

import glob
import os

import pytest
import torch

from pidnet_tpu import config as jconfig
from pidnet_tpu_torch import config, engine

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
OVERRIDES = [
    [],
    ["TRAIN.LR", "0.02", "MODEL.NAME", "pidnet_l", "DATASET.ROOT", "/data/city/"],
    ["TRAIN.IMAGE_SIZE", "[512, 256]", "TRAIN.FLIP", "false", "TRAIN.END_EPOCH", "3",
     "DATASET.CACHE", "yes", "DATASET.CACHE_GB", "4", "TEST.SCALE_LIST", "(1.0, 1.5)",
     "GPUS", "(0, 1)", "TEST.MODEL_FILE", "7", "LOSS.OHEMTHRES", "1"],
]


def test_there_are_8_yamls():
    assert len(YAMLS) == 8


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.basename(p))
@pytest.mark.parametrize("opts", range(len(OVERRIDES)))
def test_load_config_equals_jax(path, opts):
    got = config.load_config(path, OVERRIDES[opts]).to_dict()
    want = jconfig.load_config(path, OVERRIDES[opts]).to_dict()
    assert got == want
    # the same types, not only equal values (True == 1, 4 == 4.0)
    assert repr(got) == repr(want)


def test_defaults_and_errors_equal_jax(tmp_path):
    assert config.default_config().to_dict() == jconfig.default_config().to_dict()
    bad = tmp_path / "bad.yaml"
    bad.write_text("NOT_A_KEY: 1\n")
    for package in (config, jconfig):
        with pytest.raises(KeyError):
            package.load_config(str(bad))
        with pytest.raises(KeyError, match="Unknown config key"):
            package.load_config(YAMLS[0], ["TRAIN.NOPE", "1"])
        with pytest.raises(ValueError, match="KEY VALUE"):
            package.load_config(YAMLS[0], ["TRAIN.LR"])
        with pytest.raises(TypeError, match="mapping"):
            package.default_config().merge_dict({"TRAIN": 3})
        cfg = package.load_config(YAMLS[0])
        with pytest.raises(AttributeError):
            cfg.TRAIN.LR = 1.0  # frozen
    clone = config.default_config().clone()
    clone.TRAIN.LR = 5.0
    assert config.default_config().TRAIN.LR == 0.01 and "TRAIN" in clone


def test_engine_reads_the_loaded_config():
    """Every key the engine's functions read, as `engine.config(...)` gives
    it for the same settings."""
    path = os.path.join(ROOT, "configs", "cityscapes", "pidnet_small_cityscapes.yaml")
    cfg = config.load_config(path)
    same = engine.config(num_outputs=2, output_index=1, print_freq=10, end_epoch=484,
                         num_classes=19, ignore_label=255)
    for key in ("MODEL.NUM_OUTPUTS", "MODEL.ALIGN_CORNERS", "TEST.OUTPUT_INDEX", "PRINT_FREQ",
                "TRAIN.END_EPOCH", "DATASET.NUM_CLASSES", "TRAIN.IGNORE_LABEL",
                "TEST.IMAGE_SIZE", "TEST.BASE_SIZE", "TEST.SCALE_LIST", "TEST.MULTI_SCALE",
                "TEST.FLIP_TEST"):
        a, b = cfg, same
        for part in key.split("."):
            a, b = getattr(a, part), getattr(b, part)
        assert a == b, key
