"""Segmentation metrics (counterpart of pidnet_tpu/metrics.py).

The C x C confusion matrix is one `torch.bincount` over `gt * C + pred` on
the device, with ignored pixels, and pixels whose label lies outside
[0, C), in one extra bin that is dropped; only the small matrix goes to the
host, where IoU and accuracy are taken in float64.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                     ignore_label: int = 255) -> torch.Tensor:
    """logits (N,H,W,C) (argmax over C) or a class map (N,H,W); labels
    (N,H,W) -> (C,C) int64 counts, rows the label, columns the
    prediction. int64 keeps every count exact, where the JAX package's
    float32 is exact below 2^24 per cell. A label that is the ignore label
    or lies outside [0, C) is dropped, as the JAX package drops every label
    >= C; a negative label is dropped too, where JAX's `jnp.bincount` clips
    its index into cell (0, 0) (the reference's numpy `bincount` raises)."""
    preds = torch.argmax(logits, dim=-1) if logits.dim() == labels.dim() + 1 else logits
    labels = labels.to(device=preds.device, dtype=torch.int64)
    valid = (labels != ignore_label) & (labels >= 0) & (labels < num_classes)
    idx = torch.where(valid, labels * num_classes + preds.to(torch.int64),
                      num_classes * num_classes)
    counts = torch.bincount(idx.reshape(-1), minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes)


def iou_from_cm(cm):
    """(IoU per class, mean IoU) — reference utils/function.py:114-121."""
    cm = np.asarray(cm, np.float64)
    pos = cm.sum(1)
    res = cm.sum(0)
    tp = np.diag(cm)
    iou = tp / np.maximum(1.0, pos + res - tp)
    return iou, float(iou.mean())


def acc_from_cm(cm):
    """(pixel acc, mean per-class acc) — reference utils/function.py:169-177."""
    cm = np.asarray(cm, np.float64)
    pos = cm.sum(1)
    tp = np.diag(cm)
    pixel_acc = float(tp.sum() / max(pos.sum(), 1.0))
    mean_acc = float((tp / np.maximum(1.0, pos)).mean())
    return pixel_acc, mean_acc
