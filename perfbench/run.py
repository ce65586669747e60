"""The benchmark's command: one run of one cell on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes the cell's weights and inputs from the seed, sets up the program,
measures for `--seconds`, checks what the timed path produced against the
plain reference, and prints one JSON line last on standard output
(README.md). Run it from the root of a checkout; it exits with a code
other than 0, and prints no result, where the cell's cards are missing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"  # fixed, inside the checkout, listed in .gitignore


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True, help="a workloads name of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True, help="the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0,
                        help="1: report the per-layer metrics from a traced sub-window")
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[0] = str(ROOT)  # the checkout's root, in place of this script's folder
    from perfbench.harness import cell

    sys.exit(cell.main(args, T_START))
