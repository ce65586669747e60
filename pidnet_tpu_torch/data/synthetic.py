"""Seeded synthetic segmentation crops without a dataset (a copy of
scripts/train_run_artifact.py's `synthetic_epoch`): a class per block x
block tile, image = class colour + noise, boundary target = the label
changes dilated by 4 pixels (the reference's bd_dilate_size)."""

from __future__ import annotations

import numpy as np


def synthetic_epoch(rng: np.random.Generator, n: int, hw: int, num_classes: int = 19,
                    block: int = 64):
    """(images (n,hw,hw,3) float32, labels (n,hw,hw) int32, edges (n,hw,hw)
    float32) drawn from `rng`."""
    colors = rng.standard_normal((num_classes, 3)).astype(np.float32) * 1.5
    tiles = rng.integers(0, num_classes, (n, hw // block, hw // block))
    labels = tiles.repeat(block, 1).repeat(block, 2).astype(np.int32)
    images = colors[labels] + rng.standard_normal((n, hw, hw, 3)).astype(np.float32) * 0.15
    edge = np.zeros((n, hw, hw), bool)
    edge[:, 1:, :] |= labels[:, 1:, :] != labels[:, :-1, :]
    edge[:, :, 1:] |= labels[:, :, 1:] != labels[:, :, :-1]
    for _ in range(3):
        e = edge.copy()
        e[:, 1:, :] |= edge[:, :-1, :]
        e[:, :-1, :] |= edge[:, 1:, :]
        e[:, :, 1:] |= edge[:, :, :-1]
        e[:, :, :-1] |= edge[:, :, 1:]
        edge = e
    return images, labels, edge.astype(np.float32)
