"""Where the loss front's forward kernel spends its time on the card
(ops/ce_front.py::ce_front_fwd, the CUDA kernel ce_fwd_kernel in
csrc/ce_front.cu), since no kernel profiler runs there.

Builds variants of the kernel's source that each leave out one part of its
work and times each beside the full kernel, with CUDA events (median over
10 windows of 20 back-to-back launches, no wrapper in the way), at the
training main shape, (6,128,128,19) bf16 -> (6,1024,1024), align_corners,
on the plan the wrapper uses (tools/ce_bwd_ablate.py's build and timing):

    full       the kernel as it is
    no_exp     the exps left out (the FMA before each stays)
    no_max     the max over C left out (the first class stands in)
    no_log     the log left out (the sum stands in)
    no_labels  the label loads left out (every pixel counted)
    no_stores  the nll and w stores left out (the values are still computed)
    no_pixel   every pixel's math left out: staging, the walk over the rows,
               the label loads and the (0, 0) stores stay (the compiler may
               then drop the row lerps, which nothing reads)

The variants compute wrong outputs by design and serve nothing but this
timing. Each is an exact edit of the source that fails loudly once the
source no longer holds its text.

    python -m pidnet_tpu_torch.tools.ce_fwd_ablate
"""

from __future__ import annotations

import numpy as np
import torch

from pidnet_tpu_torch.ops import ce_front as cf
from pidnet_tpu_torch.tools import ce_bwd_ablate
from pidnet_tpu_torch.utils.timing import card_line

TOOL = "ce_fwd_ablate"
SHAPE, OUT_HW = (6, 128, 128, 19), (1024, 1024)
VARIANTS = {
    "full": [],
    "no_exp": [("psum[k & 3] += exp2_approx(fmaf(z[k], kLog2e, -mlog2e));",
                "psum[k & 3] += fmaf(z[k], kLog2e, -mlog2e);")],
    "no_max": [("float zmax = fmaxf(fmaxf(pmax[0], pmax[1]), fmaxf(pmax[2], pmax[3]));",
                "float zmax = z[0];")],
    "no_log": [("nll[at] = fmaf(log2_approx(sum), kLn2, zmax - zt);",
                "nll[at] = fmaf(sum, kLn2, zmax - zt);")],
    "no_labels": [("const int label = next_label;", "const int label = (xa + px + y) % c;"),
                  ("if (live && y + 1 < yb) next_label = lab[(int64_t)(y + 1 - ya) * ow];",
                   "")],
    "no_stores": [("if (live && kb == 0) {  // the (0, 0) of an uncounted pixel",
                   "if (live && kb == 0 && label == -7) {"),
                  ("if (kb == 0) {  // one lane stores the counted pixel",
                   "if (kb == 0 && sum < 0.f) {")],
    "no_pixel": [("if (!hit) {  // ignored or outside [0, C): (0, 0), no exp",
                  "if (hit || !hit) {")],
}


def variant_source(name: str) -> str:
    """The kernel's source with the variant's edits; raises if an edit
    does not match exactly once."""
    return ce_bwd_ablate.variant_source(name, VARIANTS, TOOL)


def run(seed: int = 1) -> dict:
    """{variant: ms} at the main shape on the current CUDA device, from
    seeded logits, labels (a tenth ignored) and class weights."""
    fns = ce_bwd_ablate.build_variants(VARIANTS, TOOL, "ce_fwd_bf16", n_ptrs=5)
    n, h, w, c = SHAPE
    oh, ow = OUT_HW
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(SHAPE) * 2).astype(np.float32)).cuda().bfloat16()
    lab = np.where(rng.random((n, oh, ow)) < 0.1, 255, rng.integers(0, c, (n, oh, ow)))
    labels = torch.from_numpy(lab.astype(np.int32)).cuda()
    cw = torch.from_numpy((0.8 + rng.random(c)).astype(np.float32)).cuda()
    nll = torch.empty((n, oh, ow), dtype=torch.float32, device="cuda")
    wmap = torch.empty_like(nll)
    plan = cf.forward_plan(n, h, w, c, oh, ow, True, x.element_size())
    args = (x.data_ptr(), labels.data_ptr(), cw.data_ptr(), nll.data_ptr(), wmap.data_ptr(), n, h,
            w, c, oh, ow, 255, 1, plan.band, plan.tile, plan.lpp, plan.window, plan.threads,
            torch.cuda.current_stream().cuda_stream)
    return ce_bwd_ablate.time_variants(fns, args, TOOL)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("ce_fwd_ablate: needs a CUDA device")
    print(f"card: {card_line()}; device {torch.cuda.get_device_name(0)}")
    times = run()
    full = times["full"]
    parts = ", ".join(f"{k} {v:.4f} ms ({v - full:+.4f})" for k, v in times.items() if k != "full")
    print(f"ce_fwd_ablate {SHAPE}->{OUT_HW} bf16: full {full:.4f} ms; {parts}")


if __name__ == "__main__":
    main()
