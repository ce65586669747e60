"""Whole-image launches of K1-K3 against another checkout's kernels on the
card: the row window that H-sharding added to csrc/upsample_argmax.cu and
csrc/ce_front.cu (parallel/spatial.py) must leave a whole image's launch as
it was, bit for bit and in time.

    python scripts/window_ab.py --other DIR

DIR holds another checkout of the repository (its pidnet_tpu_torch/csrc is
what is read). Its two sources are built with this package's nvcc flags
into csrc/build/other-<name>-<hash>.so and called through their C
interface, with the row arguments (h, 0, oh, 0) where that interface has
them. At the main shapes, in bf16 and fp32 (K1 (1,128,256,19) ->
(1024,2048); K2 and K3 (6,128,128,19) -> (6,1024,1024)), each kernel's
outputs from both builds on the same seeded inputs must be equal bit for
bit (the exit code says whether they were); then, in bf16, both builds'
launches, without their Python wrappers, are timed in turns (other, this,
this, other) by CUDA events over back-to-back launches and by their device
time under torch.profiler; and K1's Python wrapper (the serving path's
`upsample_argmax`), which is shorter on the card than on the host, by its
host time a call, each checkout in a fresh process of its own, in the same
turns. Prints the card with every time.

A one-off A/B of the PyTorch port (pidnet_tpu_torch/) for the change that
gave the kernels their row window: the other checkout may predate it, and
its interface is then read without the four row arguments.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pidnet_tpu_torch.ops import _build  # noqa: E402
from pidnet_tpu_torch.ops import ce_front as cf  # noqa: E402
from pidnet_tpu_torch.ops import upsample_argmax as ua  # noqa: E402
from pidnet_tpu_torch.utils.timing import card_line, time_ms  # noqa: E402

K1_CASE = ((1, 128, 256, 19), (1024, 2048))
CE_CASE = ((6, 128, 128, 19), (1024, 1024))


def build_other(csrc: Path, name: str) -> tuple[ctypes.CDLL, bool]:
    """(the other checkout's library `name`, whether its interface takes
    the four row arguments)."""
    src = (csrc / f"{name}.cu").read_text()
    text = src.encode() + b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD / f"other-{name}-{digest}.so"
    if not out.exists():
        _build.BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                        str(csrc / f"{name}.cu")], check=True)
    return ctypes.CDLL(str(out)), "int r0g" in src


def bind(lib, name: str, n_ptrs: int, n_ints: int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def device_ms(fn, kernel: str, calls: int = 20) -> float:
    """Device ms a call of the kernels named `kernel` (torch.profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                 if kernel in e.key)
        if us > 0:
            return us / calls / 1e3
    raise RuntimeError(f"torch.profiler recorded no {kernel} launch")


def launches(other_dir: Path, dtype: torch.dtype, rng) -> dict:
    """{kernel: (other's launch, this build's launch, equal bit for bit)}
    at the main shapes in `dtype`."""
    csrc = other_dir / "pidnet_tpu_torch" / "csrc"
    k1_lib, k1_rows = build_other(csrc, "upsample_argmax")
    ce_lib, ce_rows = build_other(csrc, "ce_front")
    suffix = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    out = {}

    (n, h, w, c), (oh, ow) = K1_CASE
    x = torch.from_numpy((rng.standard_normal((n, h, w, c)) * 2).astype(np.float32)).cuda()
    x = x.to(dtype)
    p = ua.plan(n, h, w, c, oh, ow, True)
    rows = (h, 0, oh, 0)
    maps = [torch.empty((n, oh, ow), dtype=torch.int32, device="cuda") for _ in range(2)]
    args = [(x.data_ptr(), m.data_ptr(), n, h, w, c, oh, ow, *r, 1, p.band, p.tile, p.lpp,
             p.window, p.threads, stream) for m, r in ((maps[0], rows if k1_rows else ()),
                                                         (maps[1], rows))]
    fns = [bind(k1_lib, f"upsample_argmax_{suffix}", 2, len(args[0]) - 3),
           ua._kernel_fn(f"upsample_argmax_{suffix}")]
    calls = [lambda f=f, a=a: f(*a) for f, a in zip(fns, args)]
    for call in calls:
        assert call() == 0
    torch.cuda.synchronize()
    out["upsample_argmax"] = (*calls, torch.equal(*maps))

    (n, h, w, c), (oh, ow) = CE_CASE
    x, labels, cw, g = (t.cuda() for t in _ce_inputs(rng, (n, h, w, c), (oh, ow)))
    x = x.to(dtype)
    fp = cf.forward_plan(n, h, w, c, oh, ow, True, x.element_size())
    maps = [(torch.empty_like(g), torch.empty_like(g)) for _ in range(2)]
    rows = (h, 0, oh, 0)
    args = [(x.data_ptr(), labels.data_ptr(), cw.data_ptr(), nll.data_ptr(), wm.data_ptr(), n, h,
             w, c, oh, ow, *r, 255, 1, fp.band, fp.tile, fp.lpp, fp.window, fp.threads, stream)
            for (nll, wm), r in zip(maps, (rows if ce_rows else (), rows))]
    fns = [bind(ce_lib, f"ce_fwd_{suffix}", 5, len(args[0]) - 6),
           cf._kernel_fn("fwd", dtype)]
    calls = [lambda f=f, a=a: f(*a) for f, a in zip(fns, args)]
    for call in calls:
        assert call() == 0
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(*maps))
    out["ce_front_fwd"] = (*calls, same)

    bp = cf.backward_plan(n, h, w, c, oh, ow, True, x.element_size())
    dls = [torch.empty_like(x) for _ in range(2)]
    args = [(x.data_ptr(), labels.data_ptr(), g.data_ptr(), dl.data_ptr(), n, h, w, c, oh, ow, *r,
             255, 1, bp.band, bp.tile, bp.xw, bp.lpp, bp.threads, stream)
            for dl, r in zip(dls, (rows if ce_rows else (), rows))]
    fns = [bind(ce_lib, f"ce_bwd_{suffix}", 4, len(args[0]) - 5), cf._kernel_fn("bwd", dtype)]
    calls = [lambda f=f, a=a: f(*a) for f, a in zip(fns, args)]
    for call in calls:
        assert call() == 0
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    out["ce_front_bwd"] = (*calls, torch.equal(dls[0].view(bits), dls[1].view(bits)))
    out["_keep"] = (x, labels, cw, g, maps, dls)  # the launches' buffers
    return out


def _ce_inputs(rng, shape, out_hw):
    """Seeded logits, labels (about 1/10 ignore), class weights and an
    nll-map gradient, on the host."""
    n, _, _, c = shape
    logits = torch.from_numpy((rng.standard_normal(shape) * 2).astype(np.float32))
    lab = np.where(rng.random((n, *out_hw)) < 0.1, 255, rng.integers(0, c, (n, *out_hw)))
    labels = torch.from_numpy(lab.astype(np.int32))
    cw = torch.from_numpy((0.8 + rng.random(c)).astype(np.float32))
    g = torch.from_numpy(rng.random((n, *out_hw)).astype(np.float32))
    return logits, labels, cw, g


KERNELS = {"upsample_argmax": "upsample_argmax_kernel", "ce_front_fwd": "ce_fwd_kernel",
           "ce_front_bwd": "ce_bwd_kernel"}

# the host ms a call of a checkout's K1 wrapper at K1_CASE: the median of
# 20 windows of 50 calls, after 50 warm-up calls (and the checkout's build)
WRAPPER_CODE = """
import statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from pidnet_tpu_torch.ops import upsample_argmax as ua  # noqa: E402
shape, out_hw = {case}
x = torch.from_numpy((np.random.default_rng(0).standard_normal(shape) * 2).astype(np.float32))
x = x.cuda().bfloat16()
for _ in range(50):
    ua.upsample_argmax(x, out_hw, True)
torch.cuda.synchronize()
times = []
for _ in range(20):
    t0 = time.perf_counter()
    for _ in range(50):
        ua.upsample_argmax(x, out_hw, True)
    times.append((time.perf_counter() - t0) / 50 * 1e3)
    torch.cuda.synchronize()
print(ua.__file__, statistics.median(times))
"""


def wrapper_host_ms(root: Path) -> float:
    """K1's wrapper host ms a call in the checkout at `root`, in a fresh
    process that imports that checkout's package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", WRAPPER_CODE.format(case=K1_CASE),
                          str(root.resolve())], cwd=root, env=env, capture_output=True,
                         text=True, check=True).stdout.split()
    if not out[0].startswith(str(root.resolve())):
        raise RuntimeError(f"{out[0]} is not the package of {root}")
    return float(out[1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, type=Path,
                        help="another checkout of the repository")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of (other, this, this, other)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_line()
    rng = np.random.default_rng(0)
    equal = True
    for dtype in (torch.float32, torch.bfloat16):
        runs = launches(args.other, dtype, rng)
        for name in KERNELS:
            same = runs[name][2]
            equal &= same
            print(f"window_ab {name} {str(dtype)[6:]}: the whole image's launch equal to the "
                  f"other build's bit for bit {same}")
    for name, kernel in KERNELS.items():  # bf16, the last runs
        other, this = runs[name][0], runs[name][1]
        events = {"other": [], "this": []}
        device = {"other": [], "this": []}
        for _ in range(args.rounds):
            for who in ("other", "this", "this", "other"):
                fn = other if who == "other" else this
                events[who].append(time_ms(fn, batches=5))
                device[who].append(device_ms(fn, kernel))
        print(f"window_ab {name} bf16, raw launches in turns (other, this, this, other) x "
              f"{args.rounds}: CUDA events median other {statistics.median(events['other']):.4f} "
              f"ms, this {statistics.median(events['this']):.4f} ms (all: other "
              f"{[round(t, 4) for t in events['other']]}, this "
              f"{[round(t, 4) for t in events['this']]}); device (torch.profiler) median other "
              f"{statistics.median(device['other']):.4f} ms, this "
              f"{statistics.median(device['this']):.4f} ms [{card}]")
    this_root = Path(__file__).resolve().parents[1]
    hosts = {"other": [], "this": []}
    for _ in range(args.rounds):
        for who in ("other", "this", "this", "other"):
            hosts[who].append(wrapper_host_ms(args.other if who == "other" else this_root))
    print(f"window_ab upsample_argmax wrapper (the serving call) host ms a call, fresh "
          f"processes in turns (other, this, this, other) x {args.rounds}: median other "
          f"{statistics.median(hosts['other']):.4f}, this {statistics.median(hosts['this']):.4f} "
          f"(all: other {[round(t, 4) for t in hosts['other']]}, this "
          f"{[round(t, 4) for t in hosts['this']]}) [{card}]")
    print(f"window_ab: every whole-image launch equal bit for bit {equal} [{card}]")
    return 0 if equal else 1


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
