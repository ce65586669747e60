"""Training CLI (counterpart of pidnet_tpu/tools/train.py), the reference's
tools/train.py UX on one device or, data-parallel, one process per device:

    python -m pidnet_tpu_torch.tools.train --cfg configs/cityscapes/pidnet_small_cityscapes.yaml \
        [--device cpu] [--seed N] [KEY VALUE ...]
    torchrun --nproc-per-node N -m pidnet_tpu_torch.tools.train --multihost --cfg ... [KEY VALUE]
    torchrun --nproc-per-node N -m pidnet_tpu_torch.tools.train --multihost --spatial S --cfg ...

Each epoch trains through `engine.train_one_epoch`, validates (every 5
epochs until the last 100, then every epoch, and right after a resume) and
writes OUTPUT_DIR/<dataset>/<cfg_name>/checkpoint.pt; best.pt follows each
mIoU improvement and final_state.pt the end. TRAIN.RESUME true picks up
checkpoint.pt at the iteration it recorded. SIGTERM stops at the next step
(or validation batch), writes checkpoint.pt and returns with exit code 0.
XLA.PROFILE_DIR writes a Chrome trace of the first epoch there
(torch.profiler), with the program's spans (utils/spans.py: `train.step`,
`train.forward`, `train.loss`, `train.backward`, `bn`, ...) above the
device lanes. XLA.BF16_TRAIN and XLA.BF16_EVAL pick the compute dtype
of the train and validation steps.

Data parallelism (parallel/mesh.py): --multihost joins the process group
from torchrun's environment (nccl on cuda:LOCAL_RANK, gloo with --device
cpu); DEVICES must be -1 (or 0) or the number of processes. The global
batch is TRAIN.BATCH_SIZE_PER_GPU x processes x TRAIN.ACCUM_STEPS; each
rank loads its 1/processes of every epoch, and TRAIN.ACCUM_STEPS A splits
a rank's batch into A microbatches run as virtual shards (the reference's
2 GPUs x 6 crops on one card: TRAIN.ACCUM_STEPS 2). Validation shards the
val list over the ranks one sample each. XLA.SYNC_BN takes BN statistics
over the global batch (not with TRAIN.ACCUM_STEPS > 1). Only rank 0 logs,
writes TensorBoard and the checkpoints; every rank reads a resume
checkpoint. A SIGTERM stops the rank that receives it: every rank must
receive it, as in the JAX package. XLA.PAD_BATCH, a TPU layout device, is
ignored.

--spatial S (parallel/spatial.py) shards each image's H rows over S ranks:
the processes form a (processes / S, S) mesh, S must divide them, and the
global batch is TRAIN.BATCH_SIZE_PER_GPU x processes / S. The S ranks of a
spatial row load the same samples (the loader's shard is the data row,
rank // S) and the steps are make_spatial_train_step and
make_spatial_eval_step: global BN statistics and one global OHEM pool of
LOSS.OHEMKEEP x processes / S pixels, for training and validation, for
every MODEL.NAME. It refuses TRAIN.ACCUM_STEPS > 1.
"""

from __future__ import annotations

import argparse
import os
import signal
import timeit

import numpy as np
import torch
import torch.distributed as dist

from pidnet_tpu_torch import engine, resolve_device
from pidnet_tpu_torch.config import load_config
from pidnet_tpu_torch.data import Loader, build_dataset
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.parallel.mesh import init_process_group, make_mesh, shard_microbatches
from pidnet_tpu_torch.parallel.spatial import SpatialMesh, make_mesh_2d
from pidnet_tpu_torch.tools import common
from pidnet_tpu_torch.train import checkpoint as ckpt
from pidnet_tpu_torch.train.step import (TrainState, make_eval_step, make_spatial_eval_step,
                                         make_spatial_train_step, make_train_step)
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
                        help="data-parallel training, one process per device: join the process "
                        "group from torchrun's environment")
    parser.add_argument("--spatial", type=int, default=0, metavar="N",
                        help="shard each image's H rows over N devices (parallel/spatial.py); N "
                        "must divide the process count")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return parser.parse_args(argv)


def build_data(cfg, seed: int, num_shards: int = 1, shard_index: int = 0):
    """(train dataset, train loader, val loader) as the JAX package's
    tools/train.py builds them for one process of `num_shards`: train
    batches of TRAIN.BATCH_SIZE_PER_GPU x TRAIN.ACCUM_STEPS crops
    (drop_last), val batches of 1, both with cfg.WORKERS threads and this
    process's `shard_index` share of each epoch, the train data and order
    seeded by `seed`."""
    common_kw = dict(root=cfg.DATASET.ROOT, num_classes=cfg.DATASET.NUM_CLASSES,
                     ignore_label=cfg.TRAIN.IGNORE_LABEL, seed=seed)
    shard_kw = dict(num_shards=num_shards, shard_index=shard_index)
    train_dataset = build_dataset(
        cfg.DATASET.DATASET, list_path=cfg.DATASET.TRAIN_SET, multi_scale=cfg.TRAIN.MULTI_SCALE,
        flip=cfg.TRAIN.FLIP, base_size=cfg.TRAIN.BASE_SIZE,
        crop_size=(cfg.TRAIN.IMAGE_SIZE[1], cfg.TRAIN.IMAGE_SIZE[0]),
        scale_factor=cfg.TRAIN.SCALE_FACTOR, cache=cfg.DATASET.CACHE,
        cache_gb=cfg.DATASET.CACHE_GB, **common_kw)
    trainloader = Loader(train_dataset, cfg.TRAIN.BATCH_SIZE_PER_GPU * int(cfg.TRAIN.ACCUM_STEPS),
                         shuffle=cfg.TRAIN.SHUFFLE, drop_last=True, num_workers=cfg.WORKERS,
                         seed=seed, **shard_kw)
    test_dataset = build_dataset(
        cfg.DATASET.DATASET, list_path=cfg.DATASET.TEST_SET, multi_scale=False, flip=False,
        base_size=cfg.TEST.BASE_SIZE, crop_size=(cfg.TEST.IMAGE_SIZE[1], cfg.TEST.IMAGE_SIZE[0]),
        **common_kw)
    testloader = Loader(test_dataset, 1, shuffle=False, drop_last=False,
                        num_workers=cfg.WORKERS, **shard_kw)
    return train_dataset, trainloader, testloader


def _check_request(args, cfg) -> int:
    """Refuses what cannot run as asked; returns TRAIN.ACCUM_STEPS."""
    accum = int(cfg.TRAIN.ACCUM_STEPS)
    if args.spatial < 0:
        raise ValueError(f"--spatial must be >= 1, got {args.spatial}")
    if args.spatial:
        if accum > 1:
            # the spatial step is one global-batch program (global OHEM pool,
            # global BN statistics): sequential virtual shards do not compose
            raise RuntimeError("TRAIN.ACCUM_STEPS > 1 does not compose with --spatial")
    if accum < 1:
        raise RuntimeError(f"TRAIN.ACCUM_STEPS must be >= 1, got {accum}")
    if accum > 1 and cfg.XLA.SYNC_BN:
        raise RuntimeError(
            "TRAIN.ACCUM_STEPS > 1 does not compose with XLA.SYNC_BN: microbatches run "
            "sequentially, so BN stats cannot sync across them; use per-shard BN (default) or "
            "more physical devices")
    if cfg.TRAIN.OPTIMIZER != "sgd":
        raise ValueError("Only Support SGD optimizer")
    return accum


def _join(args):
    """(this process's device, whether it joined a process group): with
    --multihost the group of torchrun's environment, on cuda:LOCAL_RANK
    unless --device names another."""
    dev = resolve_device(args.device)
    if not args.multihost:
        return dev, False
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    init_process_group(dev)
    return dev, True


def _mesh(cfg, dev, multihost: bool, spatial: int = 0):
    """The data mesh, one device per process: DEVICES -1 or 0 (every
    process) or the process count. Anything else raises, naming torchrun,
    and so does DEVICES -1 or 0 in one process on a machine with several
    cards, which would train on one of them. With `spatial` S, the
    (processes / S, S) mesh (`parallel.spatial.make_mesh_2d`); S must
    divide the process count."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    launch = ("start one process per card with torchrun --nproc-per-node N -m "
              "pidnet_tpu_torch.tools.train --multihost ...")
    if cfg.DEVICES not in (-1, 0, world):
        raise RuntimeError(f"DEVICES {cfg.DEVICES} with {world} process(es): {launch}, or set "
                           "DEVICES -1")
    if (not multihost and cfg.DEVICES in (-1, 0) and dev.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise RuntimeError(f"DEVICES {cfg.DEVICES} asks for all {torch.cuda.device_count()} "
                           f"cards, one process trains on one: {launch}, or set DEVICES 1")
    if spatial:
        if world % spatial:
            raise RuntimeError(f"--spatial {spatial} must divide the process count {world}: "
                               f"{launch}")
        return make_mesh_2d(world // spatial, spatial, dev)
    return make_mesh(cfg.DEVICES, dev)


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
    cfg = load_config(args.cfg, args.opts)
    accum = _check_request(args, cfg)
    dev, joined = _join(args)
    try:
        _train_on(args, cfg, accum, _mesh(cfg, dev, args.multihost, args.spatial), should_stop)
    finally:
        if joined:
            dist.destroy_process_group()


def _train_on(args, cfg, accum: int, mesh, should_stop) -> None:
    dev, primary = mesh.device, mesh.rank == 0
    seed = args.seed if args.seed is not None else int(cfg.SEED)

    logger, final_output_dir, tb_log_dir = create_logger(cfg, args.cfg, "train", rank=mesh.rank)
    logger.info("%s", cfg)
    np.random.seed(seed)
    torch.manual_seed(seed)
    writer_dict = {"writer": TBWriter(tb_log_dir) if primary else None, "train_global_steps": 0,
                   "valid_global_steps": 0}
    spatial = isinstance(mesh, SpatialMesh)
    if spatial:
        logger.info("training on %s: (%d data, %d spatial) mesh, H sharded, backend %s", dev,
                    mesh.n_data, mesh.n_spatial, mesh.backend)
    else:
        logger.info("training on %s: data mesh over %d device(s), backend %s", dev, mesh.size,
                    mesh.backend)
    if args.multihost and mesh.size == 1:
        logger.info("--multihost with a single process; continuing single-host")

    spec = common.build_spec(cfg, augment=True)
    sd = common.maybe_load_pretrained(cfg, common.init_model(cfg, spec, seed=seed))
    ts = TrainState.create(M.build(spec, sd, device=dev, train=True))
    # under --spatial the S ranks of a spatial row read the same samples: the
    # loader's shard is the data row
    n_data, shard = (mesh.n_data, mesh.data_index) if spatial else (mesh.size, mesh.rank)
    train_dataset, trainloader, testloader = build_data(cfg, seed, n_data, shard)
    # the spatial steps are one global program with one OHEM pool: its
    # budget is the per-replica OHEMKEEP x the data rows, for validation too
    loss_fn = FullLoss(
        num_outputs=cfg.MODEL.NUM_OUTPUTS, align_corners=cfg.MODEL.ALIGN_CORNERS,
        ignore_label=cfg.TRAIN.IGNORE_LABEL, class_weights=train_dataset.class_weights,
        use_ohem=cfg.LOSS.USE_OHEM, ohem_thres=cfg.LOSS.OHEMTHRES,
        ohem_kept=cfg.LOSS.OHEMKEEP * (n_data if spatial else 1),
        balance_weights=cfg.LOSS.BALANCE_WEIGHTS, sb_weights=cfg.LOSS.SB_WEIGHTS)
    sgd = dict(momentum=cfg.TRAIN.MOMENTUM, weight_decay=cfg.TRAIN.WD,
               nesterov=cfg.TRAIN.NESTEROV,
               compute_dtype=torch.bfloat16 if cfg.XLA.BF16_TRAIN else None)
    if spatial:
        train_step = make_spatial_train_step(ts, loss_fn, mesh, **sgd)
    else:
        train_step = make_train_step(ts, loss_fn, mesh, sync_bn=bool(cfg.XLA.SYNC_BN),
                                     accum_steps=accum, **sgd)
    place_batch = None
    if accum > 1:
        batch = cfg.TRAIN.BATCH_SIZE_PER_GPU * mesh.size * accum
        logger.info("gradient accumulation: %d microbatches of %d = global batch %d", accum,
                    batch // accum, batch)
        place_batch = lambda *arrays: shard_microbatches(mesh, accum, *arrays)  # noqa: E731
    make_eval = make_spatial_eval_step if spatial else make_eval_step
    eval_step = make_eval(ts.model, loss_fn, mesh, num_classes=cfg.DATASET.NUM_CLASSES,
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
    # the first epoch (and its validation), with the program's spans
    profile = common.ProfileTrace(cfg.XLA.PROFILE_DIR if primary else "", TRACE_FILE, dev)
    valid_loss, mean_iou, iou_array = float("nan"), 0.0, None
    try:
        for epoch in range(last_epoch, real_end):
            ts, done_iters = engine.train_one_epoch(
                cfg, epoch, epoch_iters, num_iters, cfg.TRAIN.LR, trainloader, train_step, ts,
                writer_dict, place_batch=place_batch, should_stop=should_stop,
                start_iter=resume_iter if epoch == last_epoch else 0, mesh=mesh)
            if should_stop():
                profile.stop()
                # iteration-exact resume: train_one_epoch(start_iter=...) replays
                # the epoch's (seed, epoch)-determined order and skips the steps
                # done; a stop at the epoch's end is the next epoch's start
                ck_epoch, ck_iter = ((epoch + 1, 0) if done_iters >= epoch_iters
                                     else (epoch, done_iters))
                logger.info("=> preemption checkpoint (epoch %d interrupted at iter %d) to %s",
                            ck_epoch, ck_iter, final_output_dir)
                if primary:
                    ckpt.save_train_checkpoint(final_output_dir, ck_epoch, best_miou, ts,
                                               it=ck_iter)
                logger.info("exiting on SIGTERM; resume with TRAIN.RESUME true")
                return

            if flag_rm or (epoch % 5 == 0 and epoch < real_end - 100) or epoch >= real_end - 100:
                valid_loss, mean_iou, iou_array = engine.validate(
                    cfg, testloader, eval_step, writer_dict, num_outputs=cfg.MODEL.NUM_OUTPUTS,
                    should_stop=should_stop, mesh=mesh)
                if should_stop():
                    profile.stop()
                    # the epoch's training is complete: resume at the next one;
                    # a partial sweep makes no best-model decision
                    logger.info("=> preemption checkpoint (validation of epoch %d interrupted) "
                                "to %s", epoch, final_output_dir)
                    if primary:
                        ckpt.save_train_checkpoint(final_output_dir, epoch + 1, best_miou, ts)
                    logger.info("exiting on SIGTERM; resume with TRAIN.RESUME true")
                    return
            flag_rm = False
            profile.stop()

            # the replicas hold the same weights: rank 0 writes them
            logger.info("=> saving checkpoint to %s", final_output_dir)
            if primary:
                ckpt.save_train_checkpoint(final_output_dir, epoch + 1, best_miou, ts)
            if mean_iou > best_miou:
                best_miou = mean_iou
                if primary:
                    ckpt.save_model(os.path.join(final_output_dir, "best.pt"), ts.params(),
                                    ts.state())
            logger.info("Loss: %.3f, MeanIU: %.4f, Best_mIoU: %.4f", valid_loss, mean_iou,
                        best_miou)
            if iou_array is not None:
                logger.info("%s", iou_array)

        if primary:
            ckpt.save_model(os.path.join(final_output_dir, "final_state.pt"), ts.params(),
                            ts.state())
    finally:
        profile.stop()
        if primary:
            writer_dict["writer"].close()
    logger.info("Hours: %d", int((timeit.default_timer() - start) / 3600))
    logger.info("Done")


if __name__ == "__main__":
    main()
