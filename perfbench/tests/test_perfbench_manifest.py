"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

import json
import re

import pytest

from perfbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
BENCH = manifest.benchmark()


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP_KEYS
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(set(names[:len(BENCH["configs"]) + len(BENCH["workloads"])])) == \
        len(BENCH["configs"]) + len(BENCH["workloads"])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units)
    for text in ([c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = manifest.cell(cell)
    config = manifest.config(entry["config"])
    traffic = manifest.traffic(entry["traffic"])
    assert manifest.driver(traffic["driver"]).setup
    assert manifest.limits(cell), f"perfbench/limits/{cell}.json"
    e2e, layer = manifest.metrics_of(cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e + layer:
        assert callable(manifest.reader(m["name"]).read)
    for m in layer:
        assert m["moves"] in names, (m["name"], m["moves"])
    assert (manifest.PERFBENCH / "reference" / f"{config['family']}.py").exists()


def published_file(config: dict) -> str:
    """The file of the reference repository that defines the configuration's
    model: a PIDNet model's Cityscapes YAML; for a paper ablation of another
    family, for which the reference publishes no YAML, its model file."""
    if config["family"] == "pidnet":
        return f"configs/cityscapes/{config['name']}_cityscapes.yaml"
    return f"models/others/{config['name']}.py"


def names_its_configuration(source: str, config: dict) -> bool:
    return source.endswith("/" + published_file(config))


def test_configs_files_and_published_widths():
    """Each configuration has its own file, is used by a cell, is cut in
    nothing, and its `source` ends with the published file of the model
    that its file names by `name` and `family` (`published_file`)."""
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"] == f"perfbench/configs/{c['name']}.json"
        assert c["reduced"] == []
        config = json.loads((manifest.ROOT / c["file"]).read_text())
        assert names_its_configuration(c["source"], config), (c["source"], published_file(config))


REPO = "https://github.com/XuJiacong/PIDNet/blob/main/"
PIDNET_S = {"name": "pidnet_small", "family": "pidnet"}
BISENET = {"name": "bisenet_adb_bag", "family": "bisenet"}


@pytest.mark.parametrize("source,config,named", [
    (REPO + "configs/cityscapes/pidnet_small_cityscapes.yaml", PIDNET_S, True),
    (REPO + "models/others/bisenet_adb_bag.py", BISENET, True),
    (REPO + "configs/cityscapes/pidnet_large_cityscapes.yaml", PIDNET_S, False),
    (REPO + "models/pidnet.py", PIDNET_S, False),
    (REPO + "configs/cityscapes/bisenet_adb_bag_cityscapes.yaml", BISENET, False),
    (REPO + "models/others/ddrnet_23_adb_bag.py", BISENET, False),
    ("https://arxiv.org/abs/2206.02066", BISENET, False),
])
def test_the_source_rule(source, config, named):
    assert names_its_configuration(source, config) is named


def test_run_seconds_fits_a_full_check():
    runs = 2 + 14 * 24
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
