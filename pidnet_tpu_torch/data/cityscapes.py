"""Cityscapes (19 classes): the dataset and the constants of the training
objective (counterpart of pidnet_tpu/data/cityscapes.py, numpy only).

Images are read in RGB by data/png.py, so `bgr_to_rgb` is False and the
float32 image equals the JAX package's, which reads BGR with cv2 and
reverses it. Labels are read as greyscale `*_labelIds.png` and remapped
with a 256-entry LUT; `save_pred` writes greyscale PNGs of raw ids.
"""

from __future__ import annotations

import os

import numpy as np

from pidnet_tpu_torch.data.base import SegDataset
from pidnet_tpu_torch.data.png import read_png, write_png

# 34 raw ids -> 19 train ids (reference cityscapes.py:43-54)
LABEL_MAPPING = {
    -1: 255, 0: 255, 1: 255, 2: 255, 3: 255, 4: 255, 5: 255, 6: 255,
    7: 0, 8: 1, 9: 255, 10: 255, 11: 2, 12: 3, 13: 4, 14: 255, 15: 255,
    16: 255, 17: 5, 18: 255, 19: 6, 20: 7, 21: 8, 22: 9, 23: 10, 24: 11,
    25: 12, 26: 13, 27: 14, 28: 15, 29: 255, 30: 255, 31: 16, 32: 17, 33: 18,
}

# per-class CE weights of the 19 train classes
CLASS_WEIGHTS = np.array(
    [0.8373, 0.918, 0.866, 1.0345, 1.0166, 0.9969, 0.9754, 1.0489,
     0.8786, 1.0023, 0.9539, 0.9843, 1.1116, 0.9037, 1.0865, 1.0955,
     1.0865, 1.1529, 1.0507],
    np.float32,
)


def _build_luts(ignore_label: int):
    fwd = np.full(256, ignore_label, np.uint8)
    inv = np.zeros(256, np.uint8)
    for k, v in LABEL_MAPPING.items():
        if k >= 0:
            fwd[k] = v if v != 255 else ignore_label
        if v != 255:
            inv[v] = k
    # inverse of ignore: the reference maps 255 back to the *last* raw id
    # whose value is ignore (dict order), i.e. 30 (cityscapes.py:87-88).
    last_ignore_key = max(k for k, v in LABEL_MAPPING.items() if v == 255 and k >= 0)
    inv[ignore_label] = last_ignore_key
    return fwd, inv


class Cityscapes(SegDataset):
    def __init__(
        self,
        root: str,
        list_path: str,
        num_classes: int = 19,
        multi_scale: bool = True,
        flip: bool = True,
        ignore_label: int = 255,
        base_size: int = 2048,
        crop_size: tuple[int, int] = (512, 1024),
        scale_factor: int = 16,
        bd_dilate_size: int = 4,
        seed: int = 304,
        cache: bool = False,
        cache_gb: float = 32.0,
    ):
        super().__init__(
            root, list_path, num_classes, multi_scale, flip, ignore_label,
            base_size, crop_size, scale_factor, bd_dilate_size, seed, cache,
            cache_gb,
        )
        self.class_weights = CLASS_WEIGHTS
        self._fwd_lut, self._inv_lut = _build_luts(ignore_label)

    def convert_label(self, label: np.ndarray, inverse: bool = False) -> np.ndarray:
        lut = self._inv_lut if inverse else self._fwd_lut
        return lut[label]

    def _load_image(self, path: str) -> np.ndarray:
        return read_png(os.path.join(self.root, "cityscapes", path))

    def _load_label(self, path: str) -> np.ndarray:
        raw = read_png(os.path.join(self.root, "cityscapes", path))
        if raw.ndim != 2:
            raise ValueError(f"{path}: expected a greyscale label PNG, got {raw.shape}")
        return self.convert_label(raw)

    def save_pred(self, preds: np.ndarray, sv_path: str, names) -> None:
        """Write submission-format PNGs (train ids -> raw label ids,
        reference cityscapes.py:122-127)."""
        # accepts (N,H,W,C) logits or an (N,H,W) class map (the fused
        # upsample+argmax inference path, engine.make_inference_classmap)
        if preds.ndim == 4:
            preds = np.argmax(preds, axis=-1)
        preds = np.asarray(preds, dtype=np.uint8)
        for i in range(preds.shape[0]):
            pred = self.convert_label(preds[i], inverse=True)
            write_png(os.path.join(sv_path, names[i] + ".png"), pred)
