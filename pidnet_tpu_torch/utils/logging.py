"""Running meters and an optional TensorBoard writer (counterpart of
pidnet_tpu/utils/logging.py)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0
        self.val = 0.0

    def update(self, val: float, weight: float = 1.0) -> None:
        self.val = val
        self.sum += val * weight
        self.count += weight

    def average(self) -> float:
        return self.sum / self.count if self.count else 0.0


class TBWriter:
    """torch.utils.tensorboard's SummaryWriter when `tensorboard` is
    installed, else a writer that does nothing."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(log_dir)
        except ImportError:
            self._w = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
