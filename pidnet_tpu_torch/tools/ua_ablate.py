"""Where the fused upsample + argmax kernel spends its time on the card
(ops/upsample_argmax.py::upsample_argmax, the CUDA kernel
upsample_argmax_kernel in csrc/upsample_argmax.cu), since no kernel
profiler runs there.

Builds variants of the kernel's source that each leave out one part of its
work and times each beside the full kernel at the serving main shape,
(1,128,256,19) bf16 -> (1,1024,2048), align_corners, on the plan the
wrapper uses (tools/ce_bwd_ablate.py's build and timing): its device time
under torch.profiler (20 launches), which is what the comparison reads,
and the CUDA-event window of 20 back-to-back launches without the wrapper
(median over 10), which the host's time a launch sets once the kernel is
shorter than it:

    full       the kernel as it is
    no_argmax  the compares and selects left out: each class's FMA is added
               into a sum, and class 0 (or 1, from a test on the sum that
               keeps the FMAs live) stands in
    no_stores  the class-map stores left out (the classes are still computed)
    no_wlerp   the W-lerps of the band's first source row reused for every
               row (one pair of row lerps a thread, not one per source row)
    no_pixel   every pixel's math left out: staging, the walk over the rows
               and their taps, and the stores (of the staged row's offset)
               stay (the compiler then drops the row lerps, which nothing
               reads)
    no_walk    the walk left out: the staging and the band rows' taps stay
    empty      everything left out: the launch of the same grid alone

The variants compute wrong outputs by design and serve nothing but this
timing. Each is an exact edit of the source that fails loudly once the
source no longer holds its text.

    python -m pidnet_tpu_torch.tools.ua_ablate
"""

from __future__ import annotations

import numpy as np
import torch

from pidnet_tpu_torch.ops import upsample_argmax as ua
from pidnet_tpu_torch.tools import ce_bwd_ablate
from pidnet_tpu_torch.utils.timing import card_line

TOOL = "ua_ablate"
SOURCE = "upsample_argmax"
SHAPE, OUT_HW = (1, 128, 256, 19), (1024, 2048)
_STORE = "if (live && lane == 0) *dst = cls;"
VARIANTS = {
    "full": [],
    "no_argmax": [("""      const bool gt = z > best;
      best = gt ? z : best;
      slot = gt ? k : slot;""", "      best += z;"),
                  ("    int cls = lane + lpp * slot;", "    int cls = best > 1e30f;")],
    "no_stores": [(_STORE, "if (live && lane == 0 && cls == -7) *dst = cls;")],
    "no_wlerp": [("if (at != cur) {  // a new source row: W-lerp its two rows at this column",
                  "if (cur == -1) {")],
    "no_pixel": [(_STORE, "if (live && lane == 0) *dst = at;")],
    "no_walk": [("  __syncthreads();\n\n  // The walk:",
                 "  __syncthreads();\n  if (stage[threadIdx.x] == -7.f) *out = 0;\n  return;\n\n"
                 "  // The walk:")],
    "empty": [("  extern __shared__ __align__(16) unsigned char smem[];\n  float* stage",
               "  if (h > 0) return;\n  extern __shared__ __align__(16) unsigned char smem[];\n"
               "  float* stage")],
}


def variant_source(name: str) -> str:
    """The kernel's source with the variant's edits; raises if an edit
    does not match exactly once."""
    return ce_bwd_ablate.variant_source(name, VARIANTS, TOOL, SOURCE)


def run(seed: int = 1) -> dict:
    """{variant: (device ms, event-window ms)} at the main shape on the
    current CUDA device, from seeded logits."""
    fns = ce_bwd_ablate.build_variants(VARIANTS, TOOL, "upsample_argmax_bf16", n_ptrs=2,
                                       source=SOURCE, n_ints=16)
    n, h, w, c = SHAPE
    oh, ow = OUT_HW
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(SHAPE) * 2).astype(np.float32)).cuda().bfloat16()
    out = torch.empty((n, oh, ow), dtype=torch.int32, device="cuda")
    plan = ua.plan(n, h, w, c, oh, ow, True)
    args = (x.data_ptr(), out.data_ptr(), n, h, w, c, oh, ow, h, 0, oh, 0, 1, plan.band, plan.tile,
            plan.lpp, plan.window, plan.threads, torch.cuda.current_stream().cuda_stream)
    window = ce_bwd_ablate.time_variants(fns, args, TOOL)
    device = ce_bwd_ablate.device_times(fns, args, "upsample_argmax_kernel")
    return {name: (device[name], window[name]) for name in fns}


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("ua_ablate: needs a CUDA device")
    print(f"card: {card_line()}; device {torch.cuda.get_device_name(0)}")
    times = run()
    full = times["full"][0]
    parts = ", ".join(f"{k} {d:.4f} ms ({d - full:+.4f}; window {e:.4f})"
                      for k, (d, e) in times.items() if k != "full")
    print(f"ua_ablate {SHAPE}->{OUT_HW} bf16, device time (torch.profiler): full {full:.4f} ms "
          f"(window {times['full'][1]:.4f}); {parts}")


if __name__ == "__main__":
    main()
