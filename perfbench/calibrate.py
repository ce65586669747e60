"""The readings that the limits of `correct` are set from, for one cell, in
one process: the program's numbers over many seeds, the control's (the
reference in float8 in the program's place) on some of them, and the
numbers of the planted faults. Not part of a benchmark run.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--faults unchanged,half_batch --fault-seeds 4,5,6] \\
        [--seconds 2] [--out chiprun_out/calibrate.jsonl]

Each reading is one JSON line on standard output and in --out.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="readings for the limits of one cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=ints, default=[])
    parser.add_argument("--control-seeds", type=ints, default=[])
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", type=ints, default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from perfbench.harness import cell

    out = open(args.out, "a") if args.out else None
    plan = [(s, None, s in args.control_seeds) for s in args.seeds]
    plan += [(s, None, True) for s in args.control_seeds if s not in args.seeds]
    plan += [(s, f, False) for f in args.faults.split(",") if f for s in args.fault_seeds]
    for seed, fault, control in plan:
        t0 = time.perf_counter()
        run = cell.new_run(args.workload, seed, "cuda:0", fault=fault)
        result = cell.measure(run, args.seconds, False, t0, control=control)
        line = {"workload": args.workload, "seed": seed, "fault": fault,
                "numbers": {k: c["value"] for k, c in result["checks"].items()},
                "readings": run.readings, "control": run.control,
                "control_readings": run.control_readings, "setup_s": run.setup_s,
                "window_s": run.obs["window_s"], "attempted": run.obs["attempted"],
                "seconds": time.perf_counter() - t0}
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        del run, result
        gc.collect()
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
