"""Where the fused 3x3 conv's time goes on the card (ops/conv3x3.py, the
CUDA kernel csrc/conv3x3.cu), since no kernel profiler runs there.

Builds variants of the kernel's source that each leave out one part of its
work and times each beside the full kernel, with CUDA events (median over
10 windows of 20 back-to-back launches, no wrapper in the way), at the A/B
shapes of tools/conv_ab.py, bf16 out, no epilogue:

    full       the kernel as it is
    no_mma     the wgmma products left out (loads, barriers, epilogue)
    no_loads   the TMA loads left out; the producer still completes each
               stage's barrier (products on whatever the stages hold)
    no_stores  the output stores left out (products, loads, staging)

The variants compute wrong outputs by design and serve nothing but this
timing. Each is an exact edit of the source that fails loudly once the
source no longer holds its text.

    python -m pidnet_tpu_torch.tools.conv_ablate
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess

import torch

from pidnet_tpu_torch.ops import _build
from pidnet_tpu_torch.ops import conv3x3 as K
from pidnet_tpu_torch.tools.conv_ab import SHAPES, inputs
from pidnet_tpu_torch.utils.timing import card_line, time_ms

_B_LOAD = "tma_load_2d(a + A_BYTES + j * B_BLOCK, &w_map, bar, n0 + 64 * j, tap * cin + c0);"
VARIANTS = {
    "full": [],
    "no_mma": [("wgmma_bn(acc, da + 2 * kk, db + 128 * kk);", ";")],
    "no_loads": [
        ("mbar_expect_tx(bar, STAGE);", "mbar_arrive(bar);"),
        ("tma_load_4d(a, &x_map, bar, c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, img);", ";"),
        (_B_LOAD, ";"),
    ],
    "no_stores": [("if (yy < h && xx < wd) {", "if (yy < h && xx < wd && relu < 0) {")],
}


def variant_source(name: str) -> str:
    """The kernel's source with the variant's edits; raises if an edit
    does not match exactly once."""
    src = (_build.CSRC / "conv3x3.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"conv_ablate: {name}: {old!r} found {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """Compile every variant at once (one nvcc each) into csrc/build/;
    returns {name: the bf16 launch function}."""
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        src = variant_source(name)
        digest = hashlib.sha256((src + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
        cu = _build.BUILD / f"ablate-{name}-{digest}.cu"
        so = cu.with_suffix(".so")
        if not so.exists():
            cu.write_text(src)
            procs[name] = (subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), so)
        else:
            procs[name] = (None, so)
    fns = {}
    for name, (proc, so) in procs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"conv_ablate: nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).conv3x3_bf16
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(shapes=SHAPES) -> list:
    """[(shape, {variant: ms})] on the current CUDA device."""
    fns = build_variants()
    rows = []
    for _, n, h, w, c in shapes:
        x, wt, _ = inputs(n, h, w, c, "cuda")
        y = torch.empty((n, h, w, c), dtype=torch.bfloat16, device="cuda")
        th, tw, bn, stages, (gx, gy) = K._plan(n, h, w, c, c)
        dev = x.device.index
        args = (dev, x.data_ptr(), wt.data_ptr(), None, y.data_ptr(), None, n, h, w, c, c, 0,
                th, tw, bn, stages, gx, gy, torch.cuda.current_stream().cuda_stream)
        times = {}
        for name, fn in fns.items():
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"conv_ablate: {name} launch failed: error {err}")
            times[name] = time_ms(lambda: fn(*args))
        rows.append(((n, h, w, c), times))
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("conv_ablate: needs a CUDA device")
    print(f"card: {card_line()}; device {torch.cuda.get_device_name(0)}")
    for shape, times in run():
        full = times["full"]
        parts = ", ".join(f"{k} {v * 1e3:.1f} us ({v - full:+.4f} ms)" for k, v in times.items()
                          if k != "full")
        print(f"conv_ablate {shape} bf16 plain: full {full * 1e3:.1f} us; {parts}")


if __name__ == "__main__":
    main()
