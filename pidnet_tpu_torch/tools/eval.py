"""Evaluation CLI (counterpart of pidnet_tpu/tools/eval.py), the reference's
tools/eval.py UX:

    python -m pidnet_tpu_torch.tools.eval --cfg configs/cityscapes/pidnet_small_cityscapes.yaml \
        [--fold-bn] [--device cpu] [TEST.MODEL_FILE path.{pt,npz}] [KEY VALUE ...]
    torchrun --nproc-per-node N -m pidnet_tpu_torch.tools.eval --spatial N --cfg ... [KEY VALUE]

The model file is TEST.MODEL_FILE, else <final_output_dir>/best.pt.
Dispatch (reference tools/eval.py:104): a Cityscapes test list goes to the
submission writer (test_results/*.png); any other list is evaluated
single-scale and its mIoU, per-class IoU, pixel accuracy and mean
accuracy are logged and returned. TEST.MULTI_SCALE / TEST.FLIP_TEST take
the test-time augmentation; otherwise --fold-bn takes the class-map
closure (bf16 under XLA.BF16_INFERENCE, the fused upsample+argmax kernel)
and its absence the fp32 probabilities.

DEVICES > 1 (or -1 on a machine with several cards) without the
test-time augmentation evaluates data-parallel: one model replica per card
(engine._data_parallel_infer), batches of one frame per replica, the last
padded; with --device cpu, that many replicas on the CPU. Asking for more
cards than the machine has raises.

--spatial N shards each frame's H rows over N processes (a (1, N) mesh,
parallel/spatial.py), which join the process group from torchrun's
environment (nccl on cuda:LOCAL_RANK, gloo with --device cpu): every rank
reads every frame, runs its rows and gathers the whole prediction, so the
scores are the same on every rank; rank 0 logs and writes. It takes every
MODEL.NAME and refuses the test-time augmentation.

XLA.PROFILE_DIR writes a Chrome trace of the evaluation there
(torch.profiler; rank 0's under --spatial), with the program's serving
spans (utils/spans.py: `serve.call`, `serve.input`, `serve.model`,
`serve.classmap`, and the model's `model.pag`, ...) above the device lanes.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from pidnet_tpu_torch import engine, resolve_device
from pidnet_tpu_torch.config import load_config
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.data import Loader, build_dataset
from pidnet_tpu_torch.parallel.mesh import init_process_group
from pidnet_tpu_torch.parallel.spatial import make_mesh_2d
from pidnet_tpu_torch.tools import common
from pidnet_tpu_torch.utils.logging import create_logger

TRACE_FILE = "eval.json"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Eval segmentation network")
    parser.add_argument("--cfg", default="configs/cityscapes/pidnet_small_cityscapes.yaml",
                        type=str)
    parser.add_argument("--fold-bn", action="store_true",
                        help="fold BatchNorm into the convs (speed path); the compute dtype is "
                        "then XLA.BF16_INFERENCE's (bf16 by default)")
    parser.add_argument("--spatial", type=int, default=0, metavar="N",
                        help="shard each frame's H rows over N processes started by torchrun "
                        "(parallel/spatial.py)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return parser.parse_args(argv)


def _data_devices(devices: int, dev: torch.device):
    """The replicas' devices for DEVICES (-1 or 0: every card, one on the
    CPU), or None for one device. Raises when the machine has fewer cards."""
    if devices in (-1, 0):
        devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    if devices <= 1:
        return None
    if dev.type == "cpu":
        return [dev] * devices
    if devices > torch.cuda.device_count():
        raise RuntimeError(f"DEVICES {devices}: this machine has {torch.cuda.device_count()} "
                           "CUDA device(s)")
    return [torch.device("cuda", i) for i in range(devices)]


def _spatial_mesh(n: int, dev: torch.device):
    """(the (1, n) mesh, this process's device, whether it joined a process
    group): n > 1 processes join torchrun's, on cuda:LOCAL_RANK for a
    CUDA device; n = 1 is this process alone."""
    joined = n > 1
    if joined:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        init_process_group(dev)
    try:
        return make_mesh_2d(1, n, dev), dev, joined
    except BaseException:
        if joined:
            dist.destroy_process_group()
        raise


def main(argv=None):
    """Returns (mean IoU, IoU array, pixel accuracy, mean accuracy) of a
    labelled list, None for a Cityscapes test list."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.cfg, args.opts)
    tta = bool(cfg.TEST.MULTI_SCALE or cfg.TEST.FLIP_TEST)
    if args.spatial:
        if tta:
            raise SystemExit("TEST.MULTI_SCALE/FLIP_TEST is a single-device TTA protocol; drop "
                             "--spatial or disable the TTA flags")
        mesh, dev, joined = _spatial_mesh(args.spatial, dev)
        try:
            return _evaluate(args, cfg, dev, tta, mesh)
        finally:
            if joined:
                dist.destroy_process_group()
    return _evaluate(args, cfg, dev, tta, None)


def _evaluate(args, cfg, dev, tta: bool, mesh):
    data_devices = None if tta or mesh is not None else _data_devices(cfg.DEVICES, dev)
    rank = 0 if mesh is None else mesh.rank
    logger, final_output_dir, _ = create_logger(cfg, args.cfg, "test", rank=rank)
    logger.info("%s", cfg)

    spec = common.build_spec(cfg, augment=True)
    sd = common.maybe_load_pretrained(cfg, common.init_model(cfg, spec))
    model_file = cfg.TEST.MODEL_FILE or os.path.join(final_output_dir, "best.pt")
    logger.info("=> loading model from %s", model_file)
    if common.is_folded_checkpoint(model_file):
        # its conv weights have BN baked in: only the folded model can take them
        if not args.fold_bn:
            raise SystemExit(
                f"{model_file} is BN-folded (inference-only); re-run with --fold-bn to use it, "
                "or point TEST.MODEL_FILE at an unfolded checkpoint.")
        sd = common.load_folded(model_file, spec, sd)
    else:
        sd = common.load_weights(model_file, sd)[0]
        if args.fold_bn:
            sd = fold_state_dict(sd, spec)

    test_size = (cfg.TEST.IMAGE_SIZE[1], cfg.TEST.IMAGE_SIZE[0])
    test_dataset = build_dataset(
        cfg.DATASET.DATASET, root=cfg.DATASET.ROOT, list_path=cfg.DATASET.TEST_SET,
        num_classes=cfg.DATASET.NUM_CLASSES, multi_scale=False, flip=False,
        ignore_label=cfg.TRAIN.IGNORE_LABEL, base_size=cfg.TEST.BASE_SIZE, crop_size=test_size)
    batch_pad = len(data_devices) if data_devices else 1
    testloader = Loader(test_dataset, batch_pad, shuffle=False, num_workers=0)

    compute_dtype = torch.bfloat16 if args.fold_bn and cfg.XLA.BF16_INFERENCE else None
    kw = {}
    if tta:
        # summed multi-scale (+ flip-averaged) probabilities: the argmax of a
        # sum is not a per-scale argmax, so no class-map kernel here
        logger.info("=> TTA eval: scales %s, flip=%s",
                    cfg.TEST.SCALE_LIST if cfg.TEST.MULTI_SCALE else [1.0],
                    bool(cfg.TEST.FLIP_TEST))
        make = engine.make_ms_flip_inference
    else:
        # class maps through the fused upsample+argmax, or the reference's
        # full-resolution probabilities
        make = engine.make_inference_classmap if args.fold_bn else engine.make_inference
        if data_devices:
            logger.info("=> data-parallel eval over %d devices", len(data_devices))
            kw = {"data_devices": data_devices}
        if mesh is not None:
            logger.info("=> spatial partitioning: H over %d devices", mesh.n_spatial)
            kw = {"spatial_mesh": mesh}
    infer = make(cfg, spec, sd, folded=args.fold_bn, compute_dtype=compute_dtype, device=dev,
                 **kw)

    profile = common.ProfileTrace(cfg.XLA.PROFILE_DIR if rank == 0 else "", TRACE_FILE, dev)
    try:
        if "test" in cfg.DATASET.TEST_SET and "city" in cfg.DATASET.DATASET:
            engine.test(cfg, test_dataset, testloader, infer, sv_dir=final_output_dir,
                        sv_pred=rank == 0, batch_pad=batch_pad)
            return None
        mean_iou, iou_array, pixel_acc, mean_acc = engine.testval(
            cfg, test_dataset, testloader, infer, sv_dir=final_output_dir, batch_pad=batch_pad)
    finally:
        profile.stop()
    logger.info("MeanIU: %.4f, Pixel_Acc: %.4f, Mean_Acc: %.4f", mean_iou, pixel_acc, mean_acc)
    logger.info("%s", iou_array)
    return mean_iou, iou_array, pixel_acc, mean_acc


if __name__ == "__main__":
    main()
