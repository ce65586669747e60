"""Everything of a cell found by name: its entry in BENCHMARK.json, its
configuration (perfbench/configs/<config>.json), its traffic mix
(perfbench/traffic/<traffic>.json), its limits (perfbench/limits/<cell>.json),
its driver (perfbench/drivers/<driver>.py, named by the traffic mix) and
the reader of each metric it reports (perfbench/metrics/<metric>.py). No
list of names lives in code: a new cell, configuration, mix or metric is a
new file and a new entry."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    bench = bench or benchmark()
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(PERFBENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(PERFBENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict | None:
    path = PERFBENCH / "limits" / f"{cell_name}.json"
    return load_json(path) if path.exists() else None


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return _module(PERFBENCH / "drivers" / f"{name}.py", f"perfbench_driver_{name}")


def reader(metric: str):
    path = PERFBENCH / "metrics" / f"{metric}.py"
    return _module(path, "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"))


def metrics_of(cell_name: str, bench: dict | None = None) -> tuple[list[dict], list[dict]]:
    """(end-to-end metrics, per-layer metrics) that `cell_name` reports:
    an end-to-end metric where it lists the cell or lists none; a
    per-layer one where it lists the cell (each lists its cells)."""
    bench = bench or benchmark()
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    layer = [m for m in bench["per_layer"] if cell_name in m["workloads"]]
    return e2e, layer
