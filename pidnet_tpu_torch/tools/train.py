"""Training CLI (counterpart of pidnet_tpu/tools/train.py), the reference's
tools/train.py UX on one device:

    python -m pidnet_tpu_torch.tools.train --cfg configs/cityscapes/pidnet_small_cityscapes.yaml \
        [--device cpu] [--seed N] [KEY VALUE ...]

Each epoch trains through `engine.train_one_epoch`, validates (every 5
epochs until the last 100, then every epoch, and right after a resume) and
writes OUTPUT_DIR/<dataset>/<cfg_name>/checkpoint.pt; best.pt follows each
mIoU improvement and final_state.pt the end. TRAIN.RESUME true picks up
checkpoint.pt at the iteration it recorded. SIGTERM stops at the next step
(or validation batch), writes checkpoint.pt and returns with exit code 0.
XLA.PROFILE_DIR writes a Chrome trace of the first epoch there
(torch.profiler). XLA.BF16_TRAIN and XLA.BF16_EVAL pick the compute dtype
of the train and validation steps.

One device: DEVICES other than -1, 0 or 1, --multihost and
TRAIN.ACCUM_STEPS > 1 (data parallelism) and --spatial are not ported.
XLA.SYNC_BN is the same function on one device; XLA.PAD_BATCH, a TPU
layout device, is ignored.
"""

from __future__ import annotations

import argparse
import os
import signal
import timeit

import numpy as np
import torch

from pidnet_tpu_torch import engine, resolve_device
from pidnet_tpu_torch.config import load_config
from pidnet_tpu_torch.data import Loader, build_dataset
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.tools import common
from pidnet_tpu_torch.train import checkpoint as ckpt
from pidnet_tpu_torch.train.step import TrainState, make_eval_step, make_train_step
from pidnet_tpu_torch.utils.logging import TBWriter, create_logger

TRACE_FILE = "train_first_epoch.json"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train segmentation network")
    parser.add_argument("--cfg", default="configs/cityscapes/pidnet_small_cityscapes.yaml",
                        type=str, help="experiment configure file name")
    parser.add_argument("--seed", type=int, default=None,
                        help="RNG seed; default cfg.SEED (304, as the reference's "
                        "tools/train.py:37)")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-host training: not ported (ROADMAP.md Queue 1 item 5)")
    parser.add_argument("--spatial", type=int, default=0, metavar="N",
                        help="H-sharding over N devices: not ported (ROADMAP.md Queue 1 item 6)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return parser.parse_args(argv)


def build_data(cfg, seed: int):
    """(train dataset, train loader, val loader) as the JAX package's
    tools/train.py builds them on one process: train batches of
    TRAIN.BATCH_SIZE_PER_GPU crops (drop_last), val batches of 1, both
    with cfg.WORKERS threads, the train data and order seeded by `seed`."""
    common_kw = dict(root=cfg.DATASET.ROOT, num_classes=cfg.DATASET.NUM_CLASSES,
                     ignore_label=cfg.TRAIN.IGNORE_LABEL, seed=seed)
    train_dataset = build_dataset(
        cfg.DATASET.DATASET, list_path=cfg.DATASET.TRAIN_SET, multi_scale=cfg.TRAIN.MULTI_SCALE,
        flip=cfg.TRAIN.FLIP, base_size=cfg.TRAIN.BASE_SIZE,
        crop_size=(cfg.TRAIN.IMAGE_SIZE[1], cfg.TRAIN.IMAGE_SIZE[0]),
        scale_factor=cfg.TRAIN.SCALE_FACTOR, cache=cfg.DATASET.CACHE,
        cache_gb=cfg.DATASET.CACHE_GB, **common_kw)
    trainloader = Loader(train_dataset, cfg.TRAIN.BATCH_SIZE_PER_GPU, shuffle=cfg.TRAIN.SHUFFLE,
                         drop_last=True, num_workers=cfg.WORKERS, seed=seed)
    test_dataset = build_dataset(
        cfg.DATASET.DATASET, list_path=cfg.DATASET.TEST_SET, multi_scale=False, flip=False,
        base_size=cfg.TEST.BASE_SIZE, crop_size=(cfg.TEST.IMAGE_SIZE[1], cfg.TEST.IMAGE_SIZE[0]),
        **common_kw)
    testloader = Loader(test_dataset, 1, shuffle=False, drop_last=False,
                        num_workers=cfg.WORKERS)
    return train_dataset, trainloader, testloader


def _reject_unported(args, cfg) -> None:
    if args.multihost:
        raise NotImplementedError("--multihost is not ported yet (ROADMAP.md Queue 1 item 5)")
    if args.spatial:
        raise NotImplementedError("--spatial is not ported yet (ROADMAP.md Queue 1 item 6)")
    if cfg.DEVICES not in (-1, 0, 1):
        raise NotImplementedError(
            f"DEVICES {cfg.DEVICES}: data-parallel training is not ported yet (ROADMAP.md "
            "Queue 1 item 5); the port trains on one device")
    accum = int(cfg.TRAIN.ACCUM_STEPS)
    if accum < 1:
        raise RuntimeError(f"TRAIN.ACCUM_STEPS must be >= 1, got {accum}")
    if accum > 1:
        raise NotImplementedError(
            f"TRAIN.ACCUM_STEPS {accum}: gradient accumulation is not ported yet (ROADMAP.md "
            "Queue 1 item 5)")
    if cfg.TRAIN.OPTIMIZER != "sgd":
        raise ValueError("Only Support SGD optimizer")


class _FirstEpochProfile:
    """torch.profiler over the first epoch this run trains, written as a
    Chrome trace to XLA.PROFILE_DIR; does nothing without it."""

    def __init__(self, profile_dir: str, dev: torch.device):
        self.dir = profile_dir
        self.prof = None
        if profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()
            os.makedirs(self.dir, exist_ok=True)
            self.prof.export_chrome_trace(os.path.join(self.dir, TRACE_FILE))
            self.prof = None


def main(argv=None):
    args = parse_args(argv)
    # Preemption: install the flag-only handler first, so that a SIGTERM
    # landing while the data and model are built is not a hard kill; the
    # loops poll the flag at step and batch boundaries. The handler only
    # sets the flag: logging inside it could re-enter a stream mid-write.
    stop_requested = {"flag": False}

    def on_sigterm(signum, frame):
        stop_requested["flag"] = True

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:  # not the main thread (embedded use): no handler
        prev_sigterm = None
    try:
        _train(args, lambda: stop_requested["flag"])
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)


def _train(args, should_stop) -> None:
    dev = resolve_device(args.device)
    cfg = load_config(args.cfg, args.opts)
    _reject_unported(args, cfg)
    seed = args.seed if args.seed is not None else int(cfg.SEED)

    logger, final_output_dir, tb_log_dir = create_logger(cfg, args.cfg, "train")
    logger.info("%s", cfg)
    np.random.seed(seed)
    torch.manual_seed(seed)
    writer_dict = {"writer": TBWriter(tb_log_dir), "train_global_steps": 0,
                   "valid_global_steps": 0}
    logger.info("training on %s", dev)
    if cfg.XLA.SYNC_BN:
        logger.info("XLA.SYNC_BN on one device: the batch statistics are the device's own")

    spec = common.build_spec(cfg, augment=True)
    sd = common.maybe_load_pretrained(cfg, common.init_model(cfg, spec, seed=seed))
    ts = TrainState.create(M.build(spec, sd, device=dev, train=True))
    train_dataset, trainloader, testloader = build_data(cfg, seed)
    loss_fn = FullLoss(
        num_outputs=cfg.MODEL.NUM_OUTPUTS, align_corners=cfg.MODEL.ALIGN_CORNERS,
        ignore_label=cfg.TRAIN.IGNORE_LABEL, class_weights=train_dataset.class_weights,
        use_ohem=cfg.LOSS.USE_OHEM, ohem_thres=cfg.LOSS.OHEMTHRES, ohem_kept=cfg.LOSS.OHEMKEEP,
        balance_weights=cfg.LOSS.BALANCE_WEIGHTS, sb_weights=cfg.LOSS.SB_WEIGHTS)
    train_step = make_train_step(
        ts, loss_fn, momentum=cfg.TRAIN.MOMENTUM, weight_decay=cfg.TRAIN.WD,
        nesterov=cfg.TRAIN.NESTEROV,
        compute_dtype=torch.bfloat16 if cfg.XLA.BF16_TRAIN else None)
    eval_step = make_eval_step(ts.model, loss_fn, num_classes=cfg.DATASET.NUM_CLASSES,
                               compute_dtype=torch.bfloat16 if cfg.XLA.BF16_EVAL else None)

    epoch_iters = len(trainloader)
    best_miou, last_epoch, resume_iter = 0.0, 0, 0
    flag_rm = cfg.TRAIN.RESUME
    if cfg.TRAIN.RESUME:
        payload = ckpt.load_train_checkpoint(final_output_dir)
        if payload is not None:
            best_miou = payload["best_mIoU"]
            last_epoch = payload["epoch"]
            # steps completed within last_epoch (a mid-epoch preemption)
            resume_iter = int(payload.get("iter", 0))
            ckpt.restore_train_state(ts, payload)
            logger.info("=> loaded checkpoint (epoch %d, iter %d)", last_epoch, resume_iter)

    start = timeit.default_timer()
    num_iters = cfg.TRAIN.END_EPOCH * epoch_iters
    # CamVid trains 120 epochs whatever END_EPOCH says (reference tools/train.py:172)
    real_end = 120 + 1 if "camvid" in cfg.DATASET.TRAIN_SET else cfg.TRAIN.END_EPOCH
    profile = _FirstEpochProfile(cfg.XLA.PROFILE_DIR, dev)
    valid_loss, mean_iou, iou_array = float("nan"), 0.0, None
    try:
        for epoch in range(last_epoch, real_end):
            ts, done_iters = engine.train_one_epoch(
                cfg, epoch, epoch_iters, num_iters, cfg.TRAIN.LR, trainloader, train_step, ts,
                writer_dict, should_stop=should_stop,
                start_iter=resume_iter if epoch == last_epoch else 0)
            if should_stop():
                profile.stop()
                # iteration-exact resume: train_one_epoch(start_iter=...) replays
                # the epoch's (seed, epoch)-determined order and skips the steps
                # done; a stop at the epoch's end is the next epoch's start
                ck_epoch, ck_iter = ((epoch + 1, 0) if done_iters >= epoch_iters
                                     else (epoch, done_iters))
                logger.info("=> preemption checkpoint (epoch %d interrupted at iter %d) to %s",
                            ck_epoch, ck_iter, final_output_dir)
                ckpt.save_train_checkpoint(final_output_dir, ck_epoch, best_miou, ts, it=ck_iter)
                logger.info("exiting on SIGTERM; resume with TRAIN.RESUME true")
                return

            if flag_rm or (epoch % 5 == 0 and epoch < real_end - 100) or epoch >= real_end - 100:
                valid_loss, mean_iou, iou_array = engine.validate(
                    cfg, testloader, eval_step, writer_dict, num_outputs=cfg.MODEL.NUM_OUTPUTS,
                    should_stop=should_stop)
                if should_stop():
                    profile.stop()
                    # the epoch's training is complete: resume at the next one;
                    # a partial sweep makes no best-model decision
                    logger.info("=> preemption checkpoint (validation of epoch %d interrupted) "
                                "to %s", epoch, final_output_dir)
                    ckpt.save_train_checkpoint(final_output_dir, epoch + 1, best_miou, ts)
                    logger.info("exiting on SIGTERM; resume with TRAIN.RESUME true")
                    return
            flag_rm = False
            profile.stop()

            logger.info("=> saving checkpoint to %s", final_output_dir)
            ckpt.save_train_checkpoint(final_output_dir, epoch + 1, best_miou, ts)
            if mean_iou > best_miou:
                best_miou = mean_iou
                ckpt.save_model(os.path.join(final_output_dir, "best.pt"), ts.params(),
                                ts.state())
            logger.info("Loss: %.3f, MeanIU: %.4f, Best_mIoU: %.4f", valid_loss, mean_iou,
                        best_miou)
            if iou_array is not None:
                logger.info("%s", iou_array)

        ckpt.save_model(os.path.join(final_output_dir, "final_state.pt"), ts.params(), ts.state())
    finally:
        writer_dict["writer"].close()
    logger.info("Hours: %d", int((timeit.default_timer() - start) / 3600))
    logger.info("Done")


if __name__ == "__main__":
    main()
