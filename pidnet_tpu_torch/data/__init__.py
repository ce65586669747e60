"""The data layer (counterpart of pidnet_tpu/data/), numpy only: datasets
over list files, the augmentation pipeline and the prefetching loader."""

from pidnet_tpu_torch.data.base import SegDataset  # noqa: F401
from pidnet_tpu_torch.data.cityscapes import Cityscapes  # noqa: F401
from pidnet_tpu_torch.data.camvid import CamVid  # noqa: F401
from pidnet_tpu_torch.data.loader import Loader  # noqa: F401

DATASETS = {"cityscapes": Cityscapes, "camvid": CamVid}


def build_dataset(name: str, **kwargs):
    """Instantiate a dataset by config name (the reference's
    `eval('datasets.'+name)` at tools/train.py:85)."""
    try:
        cls = DATASETS[name]
    except KeyError:
        raise ValueError(f"Unknown dataset {name!r}; known: {sorted(DATASETS)}")
    return cls(**kwargs)
