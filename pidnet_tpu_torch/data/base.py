"""Dataset base: .lst file lists + sample generation on the host
(counterpart of pidnet_tpu/data/base.py, numpy only).

Samples come back NHWC-ready (HWC image), as the port's model takes them.
"""

from __future__ import annotations

import logging
import os
import threading
from collections import OrderedDict

import numpy as np

from pidnet_tpu_torch.data import transforms as T

log = logging.getLogger("pidnet_tpu_torch")


class _ByteLRU:
    """Byte-budgeted LRU for decoded samples (DATASET.CACHE).

    The budget makes host OOM impossible by construction: entries are
    evicted least-recently-used once the running byte total would exceed
    it, and an entry larger than the whole budget is never stored. Worker
    threads share one lock; the critical sections are dict moves only
    (the numpy payloads are built outside the lock)."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self._od: OrderedDict[int, tuple] = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._od)

    def get(self, key):
        with self._lock:
            hit = self._od.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._od.move_to_end(key)
            self.hits += 1
            return hit

    def put(self, key, value: tuple) -> None:
        nbytes = sum(a.nbytes for a in value)
        if nbytes > self.budget:
            return
        with self._lock:
            if key in self._od:
                return
            while self.bytes + nbytes > self.budget and self._od:
                _, old = self._od.popitem(last=False)
                self.bytes -= sum(a.nbytes for a in old)
            self._od[key] = value
            self.bytes += nbytes

    def stats(self) -> str:
        total = self.hits + self.misses
        rate = self.hits / total if total else 0.0
        return (
            f"{len(self._od)} entries, {self.bytes / 2**30:.2f} GiB / "
            f"{self.budget / 2**30:.2f} GiB budget, hit rate {rate:.1%} "
            f"({self.hits}/{total})"
        )


class SegDataset:
    def __init__(
        self,
        root: str,
        list_path: str,
        num_classes: int,
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
        self.root = root
        self.list_path = list_path
        self.num_classes = num_classes
        self.multi_scale = multi_scale
        self.flip = flip
        self.ignore_label = ignore_label
        self.base_size = base_size
        self.crop_size = tuple(crop_size)
        self.scale_factor = scale_factor
        self.bd_dilate_size = bd_dilate_size
        self.seed = seed
        # Opt-in (DATASET.CACHE): memoize the deterministic per-image
        # prefix of the pipeline — PNG decode, label decode/remap, and the
        # Canny+dilate edge GT — which repeats identically every epoch.
        # Only the random augmentation runs per sample after warm-up.
        # Memory: full Cityscapes train ≈ 2975 x (6.3 MB image u8 +
        # 2.1 MB label u8 + 2.1 MB edge u8) ≈ 31 GB. DATASET.CACHE_GB
        # byte-budgets it (LRU eviction) so a smaller host degrades to
        # partial caching instead of an OOM kill mid-epoch.
        self.cache = cache
        self._cache = _ByteLRU(int(cache_gb * 2**30)) if cache else None
        self._epoch = 0
        self.class_weights: np.ndarray | None = None

        self.is_test = "test" in list_path
        with open(os.path.join(root, list_path) if not os.path.isabs(list_path) else list_path) as f:
            self.img_list = [line.strip().split() for line in f if line.strip()]
        self.files = self._read_files()

    # subclass hooks -------------------------------------------------------
    def _read_files(self) -> list[dict]:
        files = []
        for item in self.img_list:
            if self.is_test:
                name = os.path.splitext(os.path.basename(item[0]))[0]
                files.append({"img": item[0], "name": name})
            else:
                image_path, label_path = item[:2]
                name = os.path.splitext(os.path.basename(label_path))[0]
                files.append({"img": image_path, "label": label_path, "name": name})
        return files

    def _load_image(self, path: str) -> np.ndarray:  # HWC uint8
        raise NotImplementedError

    def _load_label(self, path: str) -> np.ndarray:  # HW uint8 (class ids)
        raise NotImplementedError

    @property
    def bgr_to_rgb(self) -> bool:
        """True when _load_image returns BGR; data/png.py reads RGB."""
        return False

    @property
    def edge_pad(self) -> bool:
        return True

    # ----------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.files)

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation stream (the loader calls this per epoch
        — the hook the reference's DDP-ready sampler anticipated,
        tools/train.py:176-178)."""
        if self._cache is not None and epoch != self._epoch and self._epoch:
            log.info("decode cache: %s", self._cache.stats())
        self._epoch = epoch

    def _sample_rng(self, index: int) -> np.random.Generator:
        # per-(seed, epoch, index) generator: deterministic regardless of
        # worker-thread scheduling, and thread-safe (no shared stream)
        return np.random.default_rng((self.seed, self._epoch, index))

    def __getitem__(self, index: int):
        item = self.files[index]
        edge = None
        if self._cache is not None and not self.is_test:
            hit = self._cache.get(index)
            if hit is None:
                image = self._load_image(item["img"])
                label = self._load_label(item["label"])
                edge = T.gen_edge_gt(
                    label, edge_size=self.bd_dilate_size, edge_pad=self.edge_pad
                )
                self._cache.put(index, (image, label, edge))
            else:
                image, label, edge = hit
        else:
            image = self._load_image(item["img"])
            label = None if self.is_test else self._load_label(item["label"])
        size = np.array(image.shape)
        if self.is_test:
            img = T.input_transform(image, bgr_to_rgb=self.bgr_to_rgb)
            return np.ascontiguousarray(img), size, item["name"]

        image, label, edge = T.gen_sample(
            self._sample_rng(index),
            image,
            label,
            multi_scale=self.multi_scale,
            is_flip=self.flip,
            base_size=self.base_size,
            crop_size=self.crop_size,
            scale_factor=self.scale_factor,
            ignore_label=self.ignore_label,
            edge_pad=self.edge_pad,
            edge_size=self.bd_dilate_size,
            bgr_to_rgb=self.bgr_to_rgb,
            edge=edge,
        )
        return image, label, edge, size, item["name"]

    def save_pred(self, preds: np.ndarray, sv_path: str, names) -> None:
        raise NotImplementedError
