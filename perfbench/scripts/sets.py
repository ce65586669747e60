"""Sets of benchmark runs, each a fresh process, and their spreads: how
the bounds in BENCHMARK.json were measured (PERF.md section 2).

    python3 perfbench/scripts/sets.py --workloads <cell>[,<cell>...] \\
        --seeds 1,2,3,4,5,6 [--sets 2] [--first-seed 99] [--trace-seeds 7,8,9] \\
        [--seconds 10] --out <folder>

Run it from the root of a checkout on the card. For each cell, in turn:
one run on `--first-seed` (where a checkout's first run builds the
kernels; recorded apart), then `--sets` sets of a run on each of `--seeds`
(the same seeds in every set), then a `--trace 1` run on each of
`--trace-seeds`. Each run's standard output and error go to
<folder>/<cell>.<set>.<seed>.out and .err; <folder>/summary.json holds
every result line, and a table of each set's medians and spreads, with
and without the run farthest from the median, and each set-up stage's
range, is printed. A spread is the distance between the first and third
quartiles (`statistics.quantiles(values, n=4)`) over the median. The
script exits with 1 where a run failed, printed no result or was not
correct, else 0.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

STAGES = re.compile(r"^perfbench: setup stages \(s\): (.*)$", re.M)


def ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",") if v]


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def without_farthest(values: list[float]) -> list[float]:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def one_run(cell: str, seed: int, trace: int, seconds: int, out: Path, label: str) -> dict:
    cmd = [sys.executable, "perfbench/run.py", "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1500)
    wall = time.perf_counter() - t0
    (out / f"{cell}.{label}.{seed}.out").write_text(proc.stdout)
    (out / f"{cell}.{label}.{seed}.err").write_text(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines and lines[-1].startswith("{"):
        result = json.loads(lines[-1])
    stages = {}
    m = STAGES.search(proc.stdout)
    if m:
        for part in m.group(1).split(", "):
            name, value = part.rsplit(" ", 1)
            stages[name] = float(value)
    print(f"{cell} {label} {seed} rc={proc.returncode} wall={wall:.1f} "
          f"correct={result and result['correct']}", flush=True)
    return {"cell": cell, "set": label, "seed": seed, "rc": proc.returncode, "wall_s": wall,
            "result": result, "stages": stages}


def summarise(runs: list[dict]) -> list[str]:
    lines = []
    cells = sorted({r["cell"] for r in runs})
    for cell in cells:
        for label in sorted({r["set"] for r in runs if r["cell"] == cell}):
            mine = [r for r in runs if r["cell"] == cell and r["set"] == label and r["result"]]
            metrics = sorted({k for r in mine for k in r["result"]["metrics"]})
            for k in metrics:
                values = [r["result"]["metrics"][k]["value"] for r in mine
                          if k in r["result"]["metrics"]]
                s, s5 = spread(values), spread(without_farthest(values)) if len(values) > 2 \
                    else None
                lines.append(f"{cell} {label} {k}: n={len(values)} median="
                             f"{statistics.median(values)!r} min={min(values)!r} "
                             f"max={max(values)!r} spread={s!r} spread_without_farthest={s5!r}")
            for k in sorted({k for r in mine for k in r["result"].get("checks", {})}):
                values = [r["result"]["checks"][k]["value"] for r in mine]
                lines.append(f"{cell} {label} check {k}: {min(values)!r}-{max(values)!r} "
                             f"limit {mine[0]['result']['checks'][k]['limit']!r}")
            stages = sorted({k for r in mine for k in r["stages"]},
                            key=lambda k: list(mine[0]["stages"]).index(k)
                            if k in mine[0]["stages"] else 99)
            ranges = [f"{k} {min(r['stages'][k] for r in mine if k in r['stages']):.3f}-"
                      f"{max(r['stages'][k] for r in mine if k in r['stages']):.3f}"
                      for k in stages]
            lines.append(f"{cell} {label} setup stages (s): {', '.join(ranges)}")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="sets of benchmark runs and their spreads")
    parser.add_argument("--workloads", required=True)
    parser.add_argument("--seeds", type=ints, default=[])
    parser.add_argument("--sets", type=int, default=2)
    parser.add_argument("--first-seed", type=int, default=None)
    parser.add_argument("--trace-seeds", type=ints, default=[])
    parser.add_argument("--seconds", type=int, default=10)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    for cell in args.workloads.split(","):
        if args.first_seed is not None:
            runs.append(one_run(cell, args.first_seed, 0, args.seconds, out, "first"))
        for s in range(args.sets):
            for seed in args.seeds:
                runs.append(one_run(cell, seed, 0, args.seconds, out, "AB"[s] if s < 2 else
                                    f"set{s}"))
        for seed in args.trace_seeds:
            runs.append(one_run(cell, seed, 1, args.seconds, out, "trace"))
    (out / "summary.json").write_text(json.dumps(runs, indent=1))
    for line in summarise(runs):
        print(line)
    bad = [r for r in runs if not (r["result"] and r["result"]["correct"])]
    for r in bad:
        print(f"NOT CORRECT OR NO RESULT: {r['cell']} {r['set']} {r['seed']} rc={r['rc']}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
