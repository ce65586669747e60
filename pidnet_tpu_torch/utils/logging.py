"""Run logging (counterpart of pidnet_tpu/utils/logging.py): the
timestamped file and console logger of a CLI run, running meters and an
optional TensorBoard writer."""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path


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
    installed and opens, else a writer that does nothing: any exception
    from importing or opening it (a broken install raises more than
    ImportError) means no TensorBoard, as in the JAX package."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(log_dir)
        except Exception as exc:  # the run goes on without TensorBoard
            logging.getLogger("pidnet_tpu_torch").warning(
                "no TensorBoard writer: %s: %s", type(exc).__name__, exc)
            self._w = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


def create_logger(cfg, cfg_path: str, phase: str = "train", rank: int = 0):
    """A file and console logger on `pidnet_tpu_torch` and the run's
    directories, in the reference's layout (utils/utils.py:95-127):
    OUTPUT_DIR/<dataset>/<cfg_name>/<cfg_name>_<time>_<phase>.log and
    TensorBoard events under LOG_DIR/<dataset>/<model>/<cfg_name>_<time>.
    Returns (logger, final_output_dir, tb_log_dir). For a `rank` other
    than 0 of a data-parallel run the logger writes no file and passes
    only warnings and errors to the console: rank 0 logs the run."""
    root = Path(cfg.OUTPUT_DIR or "output")
    dataset = cfg.DATASET.DATASET
    cfg_name = os.path.basename(cfg_path).split(".")[0]

    final_output_dir = root / dataset / cfg_name
    final_output_dir.mkdir(parents=True, exist_ok=True)

    time_str = time.strftime("%Y-%m-%d-%H-%M")
    log_file = final_output_dir / f"{cfg_name}_{time_str}_{phase}.log"

    logger = logging.getLogger("pidnet_tpu_torch")
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    handlers = [logging.StreamHandler()]
    if rank == 0:
        handlers.insert(0, logging.FileHandler(str(log_file)))
    for handler in handlers:
        handler.setFormatter(fmt)
        logger.addHandler(handler)

    tb_log_dir = Path(cfg.LOG_DIR or "log") / dataset / cfg.MODEL.NAME / f"{cfg_name}_{time_str}"
    tb_log_dir.mkdir(parents=True, exist_ok=True)
    return logger, str(final_output_dir), str(tb_log_dir)
