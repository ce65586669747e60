"""Checkpoint conversion CLI (counterpart of pidnet_tpu/tools/convert.py,
without its serving export):

    # train2k .npz or a reference .pt/.pth.tar -> the port's .pt
    python -m pidnet_tpu_torch.tools.convert --a pidnet-s --c 19 \
        runs/train2k/weights_f16.npz out/pidnet_s.pt

    # fold BatchNorm into the conv weights on the way (inference only;
    # eval --fold-bn loads it)
    python -m pidnet_tpu_torch.tools.convert --a pidnet-s --c 19 --fold src.pt out/folded.pt

    # the reference's layout (FullModel `model.` prefix, OIHW), which its
    # get_seg_model loads
    python -m pidnet_tpu_torch.tools.convert --a pidnet-s --c 19 --export best.pt out/ref.pt

The train and eval CLIs load every one of these containers themselves;
this tool is for deployment. It works on host tensors and runs no model.
"""

from __future__ import annotations

import argparse
import os

import torch

from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.tools import common
from pidnet_tpu_torch.train import checkpoint as ckpt


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Convert checkpoints")
    parser.add_argument("src", help="input .npz (p./s. format) or .pt/.pth[.tar]")
    parser.add_argument("dst", help="output .pt")
    parser.add_argument("--a", default="pidnet-s", help="pidnet-s, pidnet-m or pidnet-l")
    parser.add_argument("--c", type=int, default=19, help="number of classes")
    parser.add_argument("--no-augment", action="store_true",
                        help="single-output (inference-only) parameter set, no aux heads")
    parser.add_argument("--fold", action="store_true",
                        help="fold BatchNorm into the conv weights (inference-only output)")
    parser.add_argument("--export", action="store_true",
                        help="write the reference's torch layout instead of the port's payload")
    parser.add_argument("--force", action="store_true",
                        help="write even when src matches fewer than half of the model's "
                        "tensors (default: refuse; a wrong --a/--c would write a mostly "
                        "random model)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.export and args.fold:
        raise SystemExit("--export writes the unfolded torch layout; drop --fold")
    spec = M.spec_for(args.a, args.c, augment=not args.no_augment)
    template = M.init(spec, torch.Generator().manual_seed(0))
    sd, n_loaded = common.load_weights(args.src, template)
    print(f"loaded {n_loaded} tensors from {args.src}")
    if n_loaded < len(template) // 2 and not args.force:
        raise SystemExit(
            f"src matched only {n_loaded}/{len(template)} of the model's tensors: does "
            f"{args.src} really hold a {args.a}/--c {args.c} model? (--force to write anyway)")

    os.makedirs(os.path.dirname(args.dst) or ".", exist_ok=True)
    if args.export:
        out = W.export_state_dict(sd)
        torch.save(out, args.dst)
        print(f"wrote torch state_dict ({len(out)} tensors) to {args.dst}")
    elif args.fold:
        # tagged, so that loaders route it to the folded model and refuse to
        # merge it into an unfolded one (tools.common.is_folded_checkpoint)
        ckpt.save_model(args.dst, fold_state_dict(sd, spec), {}, folded=True)
        print(f"wrote folded model to {args.dst}")
    else:
        state = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
        params = {k: v for k, v in sd.items() if k not in state}
        ckpt.save_model(args.dst, params, state)
        print(f"wrote model ({len(params)} params) to {args.dst}")


if __name__ == "__main__":
    main()
