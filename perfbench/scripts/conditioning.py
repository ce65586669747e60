"""How far the float32 reference's own training step moves under a change
the size of bfloat16's rounding of its input, seed by seed: a look at why
some seeds read a larger `update` than others (PERF.md section 6). Not
part of a benchmark run; the program does not run.

    python3 perfbench/scripts/conditioning.py --workload pidnet_l.train.b12 \\
        --seeds 1,2,3 [--device cuda:0]

For each seed, with the cell's seeded weights and batches: the reference's
checked steps on the float32 images and on the images rounded to
bfloat16, read against each other as a run is read against the reference
(`drivers/train.readings`); and, in the first step's float32 forward, the
pixels that the loss's two thresholds select (the boundary head's
sigmoid above 0.8, and OHEM's kept pixels), with how many lie near each
threshold. One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path[0] = str(Path(__file__).resolve().parent.parent.parent)

from perfbench.harness import cell, inputs, manifest  # noqa: E402
from perfbench.reference import float32  # noqa: E402
from perfbench.reference import train as R  # noqa: E402


def selections(ref, weights, batch, spec, rec) -> dict:
    """The first step's float32 selections: the boundary mask and OHEM's."""
    images, labels, _ = batch
    net = ref.Net({k: v.clone() for k, v in weights.items()}, train=True)
    with torch.no_grad():
        outputs = ref.forward(net, images.permute(0, 3, 1, 2).float(), spec)
        h, w = labels.shape[1:]
        final, bd = (F.interpolate(o, size=(h, w), mode="bilinear",
                                   align_corners=rec["align_corners"]) for o in outputs[-2:])
        p = torch.sigmoid(bd[:, 0])
        ignore = rec["ignore_label"]
        valid = labels != ignore
        prob = F.softmax(final, 1).gather(1, torch.where(valid, labels, 0).long()[:, None])[:, 0]
        sorted_prob = prob[valid].sort().values
        kth = float(sorted_prob[min(rec["min_kept"], sorted_prob.numel() - 1)])
        thr = max(kth, rec["ohem_thres"])
        sb = valid & (p > 0.8)
        sb_prob = prob[sb].sort().values
        sb_kth = float(sb_prob[min(rec["min_kept"], sb_prob.numel() - 1)]) if sb_prob.numel() \
            else None
        return {"boundary_above_0.8": int((p > 0.8).sum()),
                "boundary_near_0.8": {str(d): int(((p - 0.8).abs() < d).sum())
                                      for d in (1e-3, 1e-2)},
                "boundary_sigmoid_quantiles": torch.quantile(
                    p.flatten()[:: max(1, p.numel() // 1_000_000)],
                    torch.tensor([0.5, 0.9, 0.99, 0.999], device=p.device)).tolist(),
                "valid": int(valid.sum()), "ohem_threshold": thr, "ohem_kth": kth,
                "ohem_kept": int((prob[valid] < thr).sum()),
                "ohem_near": {str(d): int(((prob[valid] - thr).abs() < d).sum())
                              for d in (1e-3, 1e-2)},
                "sb_pixels": int(sb.sum()), "sb_kth": sb_kth}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the reference step's conditioning")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    drv = manifest.driver("train")
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        run = cell.new_run(args.workload, seed, args.device)
        rec = drv.recipe(run)
        spec = {**run.config, "augment": True}
        ref = inputs.reference(run.config)
        checked = run.traffic["checked_steps"]
        with float32():
            weights = inputs.weights(run.config, run.device, seed)
            batches = inputs.crops(run.traffic, run.config, run.device, seed)[:checked]
            rounded = [(x.bfloat16().float(), y, e) for x, y, e in batches]
            base = R.sgd_steps(ref, weights, batches, spec, rec, checked)
            moved = R.sgd_steps(ref, weights, rounded, spec, rec, checked)
            r = drv.readings(moved, base, weights)
            line = {"seed": seed, "update": r["grad_diff"], "grad": r["grad_median"],
                    "change": r["change_median"], "change_worst": r["change_worst"],
                    "change_worst_leaf": r["change_worst_leaf"],
                    "loss_steps": r["loss_steps"],
                    "selections": selections(ref, weights, batches[0], spec, rec)}
        print(json.dumps(line), flush=True)
        del base, moved, weights, batches, rounded
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
