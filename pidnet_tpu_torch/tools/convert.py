"""Checkpoint conversion CLI (counterpart of pidnet_tpu/tools/convert.py):

    # train2k .npz or a reference .pt/.pth.tar -> the port's .pt
    python -m pidnet_tpu_torch.tools.convert --a pidnet-s --c 19 \
        runs/train2k/weights_f16.npz out/pidnet_s.pt

    # fold BatchNorm into the conv weights on the way (inference only;
    # eval --fold-bn loads it)
    python -m pidnet_tpu_torch.tools.convert --a pidnet-s --c 19 --fold src.pt out/folded.pt

    # the reference's layout (FullModel `model.` prefix, OIHW), which its
    # get_seg_model loads
    python -m pidnet_tpu_torch.tools.convert --a pidnet-s --c 19 --export best.pt out/ref.pt

    # a self-contained serving program (convert/aot.py): the folded bf16
    # class-map pipeline traced with torch.export at a static input, the
    # weights inside; run it with convert.aot.load_serving
    python -m pidnet_tpu_torch.tools.convert --a pidnet-s --c 19 --export-aot \
        --r 1024 2048 runs/train2k/weights_f16.npz out/pidnet_s_serve.pt2

`--a` takes the PIDNet names and `ddrnet*`/`bisenet*`
(`tools.common.spec_from_name`). The train and eval CLIs load every one of
these containers themselves; this tool is for deployment. It works on host
tensors and runs no model: `--export-aot` traces on the CPU with fake
tensors. Its program runs K1 through a custom operator that has a CPU
version, so one file serves the card and the CPU, and there is no
`--platforms` (the JAX tool's lowering targets); a file is tied to the
torch version that wrote it.
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
    parser.add_argument("--a", default="pidnet-s",
                        help="pidnet-s, pidnet-m, pidnet-l, ddrnet_23_adb_bag or bisenet_adb_bag")
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
    parser.add_argument("--export-aot", action="store_true",
                        help="write a torch.export serving program (folded bf16 pipeline, "
                        "weights inside) at the static input --r and --batch; run it with "
                        "pidnet_tpu_torch.convert.aot.load_serving")
    parser.add_argument("--r", type=int, nargs=2, metavar=("H", "W"),
                        help="static input resolution for --export-aot")
    parser.add_argument("--batch", type=int, default=1, help="static batch for --export-aot")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.export and args.fold:
        raise SystemExit("--export writes the unfolded torch layout; drop --fold")
    if args.export_aot and not args.r:
        raise SystemExit("--export-aot needs a static input size: --r H W")
    # the serving program traces the single-head inference graph
    augment = not args.no_augment and not args.export_aot
    spec = common.spec_from_name(args.a, args.c, augment=augment)
    template = M.init(spec, torch.Generator().manual_seed(0))
    sd, n_loaded = common.load_weights(args.src, template)
    print(f"loaded {n_loaded} tensors from {args.src}")
    if n_loaded < len(template) // 2 and not args.force:
        raise SystemExit(
            f"src matched only {n_loaded}/{len(template)} of the model's tensors: does "
            f"{args.src} really hold a {args.a}/--c {args.c} model? (--force to write anyway)")

    os.makedirs(os.path.dirname(args.dst) or ".", exist_ok=True)
    if args.export_aot:
        from pidnet_tpu_torch.convert.aot import export_serving

        blob = export_serving(sd, spec, tuple(args.r), batch=args.batch)
        with open(args.dst, "wb") as f:
            f.write(blob)
        print(f"wrote serving program ({len(blob) / 2**20:.1f} MiB, input "
              f"{args.batch}x{args.r[0]}x{args.r[1]}x3 f32, torch {torch.__version__}) to "
              f"{args.dst}")
    elif args.export:
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
