"""CamVid (11 classes; counterpart of pidnet_tpu/data/camvid.py, numpy
only).

Labels ship as RGB colour maps; colour <-> id conversion is an exact match
against the 11-entry palette (reference camvid.py:43-46,66-78). Images and
colour maps are read and written as RGB PNGs by data/png.py.
"""

from __future__ import annotations

import os

import numpy as np

from pidnet_tpu_torch.data.base import SegDataset
from pidnet_tpu_torch.data.png import read_png, write_png

COLOR_LIST = [
    [0, 128, 192], [128, 0, 0], [64, 0, 128], [192, 192, 128],
    [64, 64, 128], [64, 64, 0], [128, 64, 128], [0, 0, 192],
    [192, 128, 128], [128, 128, 128], [128, 128, 0],
]


class CamVid(SegDataset):
    def __init__(
        self,
        root: str,
        list_path: str,
        num_classes: int = 11,
        multi_scale: bool = True,
        flip: bool = True,
        ignore_label: int = 255,
        base_size: int = 960,
        crop_size: tuple[int, int] = (720, 960),
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
        self.class_weights = None
        self.color_list = COLOR_LIST
        packed = [c[0] * 65536 + c[1] * 256 + c[2] for c in COLOR_LIST]
        self._color_to_id = dict(zip(packed, range(len(packed))))

    @property
    def edge_pad(self) -> bool:
        return False  # reference camvid.py:92 (edge_pad=False)

    def color2label(self, color_map: np.ndarray) -> np.ndarray:
        packed = (
            color_map[..., 0].astype(np.int32) * 65536
            + color_map[..., 1].astype(np.int32) * 256
            + color_map[..., 2].astype(np.int32)
        )
        label = np.full(packed.shape, self.ignore_label, np.uint8)
        for key, idx in self._color_to_id.items():
            label[packed == key] = idx
        return label

    def label2color(self, label: np.ndarray) -> np.ndarray:
        color_map = np.zeros(label.shape + (3,), np.uint8)
        for i, c in enumerate(self.color_list):
            color_map[label == i] = c
        return color_map

    def _load_image(self, path: str) -> np.ndarray:
        return read_png(os.path.join(self.root, "camvid", path))

    def _load_label(self, path: str) -> np.ndarray:
        return self.color2label(read_png(os.path.join(self.root, "camvid", path)))

    def save_pred(self, preds: np.ndarray, sv_path: str, names) -> None:
        # accepts (N,H,W,C) logits or an (N,H,W) class map (the fused
        # upsample+argmax inference path, engine.make_inference_classmap)
        if preds.ndim == 4:
            preds = np.argmax(preds, axis=-1)
        preds = np.asarray(preds, dtype=np.uint8)
        for i in range(preds.shape[0]):
            write_png(os.path.join(sv_path, names[i] + ".png"), self.label2color(preds[i]))

