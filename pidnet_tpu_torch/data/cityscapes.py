"""Cityscapes constants of the training objective (a copy of
pidnet_tpu/data/cityscapes.py's; the dataset loader is not ported yet)."""

import numpy as np

# per-class CE weights of the 19 train classes
CLASS_WEIGHTS = np.array(
    [0.8373, 0.918, 0.866, 1.0345, 1.0166, 0.9969, 0.9754, 1.0489,
     0.8786, 1.0023, 0.9539, 0.9843, 1.1116, 0.9037, 1.0865, 1.0955,
     1.0865, 1.1529, 1.0507],
    np.float32,
)
