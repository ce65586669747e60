"""One traced run of a cell, as `perfbench/run.py --trace 1` makes it, and
where its card time and idle time fall among the program's spans.

    python3 perfbench/scripts/spans.py --workload <cell> --seed <n> --seconds 10 \
        [--without] [--out DIR]

It prints the result line as run.py does, and writes
<out>/<cell>.<seed>.<with|without>.json (by default under .perfbench_cache/spans)
with the breakdown (harness/spans.py): per span name, the device ms
launched inside it a step or call and the card's idle ms while the
calling thread was inside it; per innermost span, its kernels' ms; the
idle ms by innermost span on any thread; the share of the pass's busy
time launched inside the root spans; and the threads the trace's CUDA
calls came from beside those of the spans. `--without` leaves the
`program_span` metrics out of the cell, so that no span pass runs: set
beside a run with them, in turns, it shows whether the span pass moves the
other readings.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / ".perfbench_cache"


def breakdown(run) -> dict | None:
    from perfbench.harness import spans as S

    att = S.attribution(run)
    if att is None:
        return None
    (root, n), = att["roots"].items()
    names = sorted({name for _, inside in att["launched"] for name in inside}
                   | {name for _, inside in att["idle"] for name in inside})
    state = run.counted[S.KEY]
    calls = Counter(e.get("tid") for e in state["events"] if e.get("cat") in S.LAUNCH_CATS)
    top = {span: dict(sorted(k.items(), key=lambda kv: -kv[1])[:8])
           for span, k in att["by_span"].items()}
    return {
        "root": root, "roots": n, "busy_ms": att["busy_ms"],
        "launched_in_root_pct": 100.0 * S.ms_inside(att["launched"], root) / att["busy_ms"],
        "device_ms_per_root": {k: S.ms_inside(att["launched"], k) / n for k in names},
        "idle_ms_per_root": {k: S.ms_inside(att["idle"], k) / n for k in names},
        "idle_ms_by_innermost": {k: v / n for k, v in att["idle_by_span"].items()},
        "kernels_ms_by_innermost": top,
        "cuda_call_threads": {str(k): v for k, v in calls.items()},
        "span_threads": dict(Counter(str(s["tid"]) for s in state["spans"])),
        "base_ns": state.get("base_ns"),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--without", action="store_true",
                        help="leave the program_span metrics out: record no spans")
    parser.add_argument("--out", default=str(CACHE / "spans"))
    args = parser.parse_args()
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import cell, manifest

    bench = manifest.benchmark()
    if args.without:
        bench = {**bench, "per_layer": [m for m in bench["per_layer"]
                                        if m["source"] != "program_span"]}
    run = cell.new_run(args.workload, args.seed, "cuda:0", bench=bench)
    result = cell.measure(run, args.seconds, True, T_START)
    result["without"] = args.without
    spans = breakdown(run)
    os.makedirs(args.out, exist_ok=True)
    tag = "without" if args.without else "with"
    with open(os.path.join(args.out, f"{args.workload}.{args.seed}.{tag}.json"), "w") as f:
        json.dump({"result": result, "spans": spans}, f, indent=1)
    if spans is not None:
        short = {k: round(v, 3) for k, v in spans["device_ms_per_root"].items()}
        idle = {k: round(v, 3) for k, v in spans["idle_ms_per_root"].items()}
        print(f"spans: {spans['roots']} {spans['root']}, launched inside "
              f"{spans['launched_in_root_pct']:.3f}% of busy; device ms each {short}; "
              f"idle ms each {idle}; threads {spans['cuda_call_threads']} / "
              f"{spans['span_threads']}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
