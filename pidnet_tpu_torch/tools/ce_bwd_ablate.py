"""Where the loss front's backward kernel spends its time on the card
(ops/ce_front.py::ce_front_bwd, the CUDA kernel ce_bwd_kernel in
csrc/ce_front.cu), since no kernel profiler runs there.

Builds variants of the kernel's source that each leave out one part of its
work and times each beside the full kernel, with CUDA events (median over
10 windows of 20 back-to-back launches, no wrapper in the way), at the
training main shape, (6,128,128,19) bf16 -> (6,1024,1024), align_corners,
on the plan the wrapper uses:

    full       the kernel as it is
    no_exp     the exps left out (the FMA before each stays)
    no_max     the max over C left out (the first class stands in)
    no_labels  the label and g loads left out (every pixel counted, g = 1)
    no_gather  the W-adjoint gather and dL's stores left out
    no_pixel   every pixel's softmax and sums left out: staging, the walk
               over the rows, the W-lerps, the flushes and the gather stay

The variants compute wrong outputs by design and serve nothing but this
timing. Each is an exact edit of the source that fails loudly once the
source no longer holds its text.

    python -m pidnet_tpu_torch.tools.ce_bwd_ablate
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess

import numpy as np
import torch

from pidnet_tpu_torch.ops import _build
from pidnet_tpu_torch.ops import ce_front as cf
from pidnet_tpu_torch.utils.timing import card_line, time_ms

SHAPE, OUT_HW = (6, 128, 128, 19), (1024, 1024)
VARIANTS = {
    "full": [],
    "no_exp": [("z[k] = exp2_approx(fmaf(z[k], kLog2e, -ml));", "z[k] = fmaf(z[k], kLog2e, -ml);")],
    "no_max": [("float m = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));", "float m = z[0];")],
    "no_labels": [("const int label = label_next;", "const int label = (px + y) % c;"),
                  ("const float gv = g_next;", "const float gv = 1.f;")],
    "no_gather": [("for (int e = threadIdx.x; e < (i1 - i0) * owned; e += blockDim.x) {",
                   "for (int e = threadIdx.x; e < 0; e += blockDim.x) {")],
    "no_pixel": [("if (!hit) continue;  // dz = 0: no exp", "if (hit || !hit) continue;")],
}


def variant_source(name: str, variants: dict = VARIANTS, tool: str = "ce_bwd_ablate") -> str:
    """The kernel's source with the variant's edits; raises if an edit
    does not match exactly once."""
    src = (_build.CSRC / "ce_front.cu").read_text()
    for old, new in variants[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{tool}: {name}: {old!r} found {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variants(variants: dict = VARIANTS, tool: str = "ce_bwd_ablate",
                   fn_name: str = "ce_bwd_bf16", n_ptrs: int = 4) -> dict:
    """Compile every variant at once (one nvcc each) into csrc/build/;
    returns {name: the bf16 launch function `fn_name`, whose arguments are
    `n_ptrs` pointers, 13 ints and the stream}."""
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    headers = b"".join(p.read_bytes() for p in sorted(_build.CSRC.glob("*.cuh")))
    procs = {}
    for name in variants:
        src = variant_source(name, variants, tool)
        key = src.encode() + headers + " ".join(_build.NVCC_FLAGS).encode()
        cu = _build.BUILD / f"{tool}-{name}-{hashlib.sha256(key).hexdigest()[:16]}.cu"
        so = cu.with_suffix(".so")
        proc = None
        if not so.exists():
            cu.write_text(src)
            proc = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
                                     str(so), str(cu)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, so)
    fns = {}
    for name, (proc, so) in procs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{tool}: nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), fn_name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(seed: int = 1) -> dict:
    """{variant: ms} at the main shape on the current CUDA device, from
    seeded logits, labels (a tenth ignored) and g."""
    fns = build_variants()
    n, h, w, c = SHAPE
    oh, ow = OUT_HW
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(SHAPE) * 2).astype(np.float32)).cuda().bfloat16()
    lab = np.where(rng.random((n, oh, ow)) < 0.1, 255, rng.integers(0, c, (n, oh, ow)))
    labels = torch.from_numpy(lab.astype(np.int32)).cuda()
    g = torch.from_numpy(rng.random((n, oh, ow)).astype(np.float32)).cuda()
    dl = torch.empty_like(x)
    plan = cf.backward_plan(n, h, w, c, oh, ow, True, x.element_size())
    args = (x.data_ptr(), labels.data_ptr(), g.data_ptr(), dl.data_ptr(), n, h, w, c, oh, ow, 255,
            1, plan.band, plan.tile, plan.xw, plan.lpp, plan.threads,
            torch.cuda.current_stream().cuda_stream)
    return time_variants(fns, args)


def time_variants(fns: dict, args: tuple, tool: str = "ce_bwd_ablate") -> dict:
    """{variant: ms} of each launch function on the same arguments."""
    times = {}
    for name, fn in fns.items():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{tool}: {name} launch failed: error {err}")
        times[name] = time_ms(lambda: fn(*args))
    return times


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("ce_bwd_ablate: needs a CUDA device")
    print(f"card: {card_line()}; device {torch.cuda.get_device_name(0)}")
    times = run()
    full = times["full"]
    parts = ", ".join(f"{k} {v:.4f} ms ({v - full:+.4f})" for k, v in times.items() if k != "full")
    print(f"ce_bwd_ablate {SHAPE}->{OUT_HW} bf16: full {full:.4f} ms; {parts}")


if __name__ == "__main__":
    main()
