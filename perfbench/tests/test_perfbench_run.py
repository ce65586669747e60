"""A run of the harness without the card's look: the result line's keys,
the exits where no result may be printed, no JAX module loaded, and the
faults that `correct` has to catch, planted under the timed path."""

import json
import math
import shutil
import subprocess
import sys
import time

import pytest

from perfbench.harness import cell, manifest

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
# Sizes a CPU test can hold. Training keeps the mix's batch of 12, whose BN
# statistics the limits were read at, at 128 x 128.
SMALL = {"serve": {"batch": 2, "height": 64, "width": 128},
         "train": {"batch": 12, "height": 128, "width": 128}}


def small_run(name: str, seed: int, fault=None):
    entry = manifest.cell(name)
    traffic = manifest.traffic(entry["traffic"])
    config = manifest.config(entry["config"])
    if traffic["driver"] == "train" and config["family"] == "pidnet":
        # PIDNet-S, the family's smallest, stands in; other families keep their own
        config = manifest.config("pidnet_s")
    return cell.new_run(name, seed, "cpu", fault=fault,
                        traffic={**traffic, **SMALL[traffic["driver"]]}, config=config)


def test_result_line_has_the_contract_keys():
    run = small_run("pidnet_s.serve.b16", 2**31 + 11)
    result = cell.measure(run, 0.2, False, time.perf_counter())
    assert list(result) == RESULT_KEYS  # the checks come last
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    e2e, _ = manifest.metrics_of("pidnet_s.serve.b16")
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"]) and m["value"] > 0
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == set(manifest.limits("pidnet_s.serve.b16"))
    json.dumps(result)


def test_run_prints_no_result_without_a_card():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "pidnet_s.serve.b16",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=manifest.ROOT, timeout=300)
    if out.returncode == 0:
        pytest.skip("a card is present: this test is of the CPU")
    assert "{" not in out.stdout


def test_run_needs_the_program(tmp_path):
    """In a folder that holds only BENCHMARK.json and perfbench/, a run
    exits with a code other than 0 and prints no result."""
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "pidnet_s.serve.b16",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout


def test_a_run_loads_no_jax():
    """A whole run of each driver, in a fresh process, and then the names
    of its modules, compared by whole top-level name."""
    code = (
        "import sys, time; sys.path.insert(0, '.');\n"
        "from perfbench.tests.test_perfbench_run import small_run\n"
        "from perfbench.harness import cell\n"
        "for name in ('pidnet_s.serve.b16', 'pidnet_l.train.b12'):\n"
        "    cell.measure(small_run(name, 3), 0.1, False, time.perf_counter())\n"
        "print(cell.forbidden_modules(), 'pidnet_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=manifest.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_card_time_reader():
    """`train_card_ms` reads the card's busy time of the traced steps per
    step, and nothing where no card pass ran (a run on the CPU)."""
    reader = manifest.reader("train_card_ms")
    assert reader.CARD_TRACE
    run = small_run("pidnet_l.train.b12", 5)
    assert reader.read(run) is None
    run.card, run.trace_count = {"busy_s": 0.18, "window_s": 0.25}, 3
    assert reader.read(run) == pytest.approx(60.0)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pidnet_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert cell.forbidden_modules() == ["jax"]


FAULTS = [(w["name"], f) for w in manifest.benchmark()["workloads"]
          for f in ("altered", "half_batch")
          if manifest.traffic(w["traffic"])["driver"] == "serve"]
FAULTS += [(w["name"], f) for w in manifest.benchmark()["workloads"]
           for f in ("unchanged", "half_batch")
           if manifest.traffic(w["traffic"])["driver"] == "train"]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_planted_fault_is_not_correct(name, fault):
    """Each fault the cell can have, planted where the timed path produces
    its answer, read against the cell's own limits: `correct` is false.
    The sound run of the same seed, beside it, is correct."""
    sound = cell.measure(small_run(name, 2**31 + 21), 0.1, False, time.perf_counter())
    broken = cell.measure(small_run(name, 2**31 + 21, fault), 0.1, False, time.perf_counter())
    assert sound["correct"], sound["checks"]
    assert not broken["correct"], broken["checks"]
    if fault == "altered":  # a patch of one map: the number made for it fails it
        assert broken["checks"]["wrong8"]["value"] > broken["checks"]["wrong8"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in manifest.benchmark()["workloads"]])
def test_the_control_is_not_correct(card, name):
    """The reference in float8, put in the program's place at the cell's
    own size on the card, fails one of the cell's numbers."""
    run = cell.new_run(name, 2**31 + 31, card)
    cell.measure(run, 1.0, False, time.perf_counter(), control=True)
    limits = manifest.limits(name)
    assert any(run.control[k] > limits[k] for k in limits), run.control
