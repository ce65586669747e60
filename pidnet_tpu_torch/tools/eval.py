"""Evaluation CLI (counterpart of pidnet_tpu/tools/eval.py), the reference's
tools/eval.py UX:

    python -m pidnet_tpu_torch.tools.eval --cfg configs/cityscapes/pidnet_small_cityscapes.yaml \
        [--fold-bn] [--device cpu] [TEST.MODEL_FILE path.{pt,npz}] [KEY VALUE ...]

The model file is TEST.MODEL_FILE, else <final_output_dir>/best.pt.
Dispatch (reference tools/eval.py:104): a Cityscapes test list goes to the
submission writer (test_results/*.png); any other list is evaluated
single-scale and its mIoU, per-class IoU, pixel accuracy and mean
accuracy are logged and returned. TEST.MULTI_SCALE / TEST.FLIP_TEST take
the test-time augmentation; otherwise --fold-bn takes the class-map
closure (bf16 under XLA.BF16_INFERENCE, the fused upsample+argmax kernel)
and its absence the fp32 probabilities.

One device: DEVICES > 1 (data parallelism) and --spatial are not ported.
"""

from __future__ import annotations

import argparse
import os

import torch

from pidnet_tpu_torch import engine, resolve_device
from pidnet_tpu_torch.config import load_config
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.data import Loader, build_dataset
from pidnet_tpu_torch.tools import common
from pidnet_tpu_torch.utils.logging import create_logger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Eval segmentation network")
    parser.add_argument("--cfg", default="configs/cityscapes/pidnet_small_cityscapes.yaml",
                        type=str)
    parser.add_argument("--fold-bn", action="store_true",
                        help="fold BatchNorm into the convs (speed path); the compute dtype is "
                        "then XLA.BF16_INFERENCE's (bf16 by default)")
    parser.add_argument("--spatial", type=int, default=0, metavar="N",
                        help="H-sharding over N devices: not ported (ROADMAP.md Queue 1 item 6)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return parser.parse_args(argv)


def main(argv=None):
    """Returns (mean IoU, IoU array, pixel accuracy, mean accuracy) of a
    labelled list, None for a Cityscapes test list."""
    args = parse_args(argv)
    if args.spatial:
        raise NotImplementedError("--spatial is not ported yet (ROADMAP.md Queue 1 item 6)")
    dev = resolve_device(args.device)
    cfg = load_config(args.cfg, args.opts)
    if cfg.DEVICES not in (-1, 0, 1):
        raise NotImplementedError(
            f"DEVICES {cfg.DEVICES}: data-parallel evaluation is not ported yet (ROADMAP.md "
            "Queue 1 item 5); the port evaluates on one device")
    logger, final_output_dir, _ = create_logger(cfg, args.cfg, "test")
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
    testloader = Loader(test_dataset, 1, shuffle=False, num_workers=0)

    compute_dtype = torch.bfloat16 if args.fold_bn and cfg.XLA.BF16_INFERENCE else None
    if cfg.TEST.MULTI_SCALE or cfg.TEST.FLIP_TEST:
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
    infer = make(cfg, spec, sd, folded=args.fold_bn, compute_dtype=compute_dtype, device=dev)

    if "test" in cfg.DATASET.TEST_SET and "city" in cfg.DATASET.DATASET:
        engine.test(cfg, test_dataset, testloader, infer, sv_dir=final_output_dir)
        return None
    mean_iou, iou_array, pixel_acc, mean_acc = engine.testval(
        cfg, test_dataset, testloader, infer, sv_dir=final_output_dir)
    logger.info("MeanIU: %.4f, Pixel_Acc: %.4f, Mean_Acc: %.4f", mean_iou, pixel_acc, mean_acc)
    logger.info("%s", iou_array)
    return mean_iou, iou_array, pixel_acc, mean_acc


if __name__ == "__main__":
    main()
