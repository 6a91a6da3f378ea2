"""BENCHMARK.json, the configurations and the mixes: every one loads by
name and keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark import spec as specs
from benchmark.reference.config import CodecConfig

BENCH = specs.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(specs.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = specs.load_cell(cell)
    assert c.chips in (1, 4)
    CodecConfig(**c.config["codec"]).validate()
    entry = specs.module("entries", c.traffic["entry"])
    for fn in ("frame_count", "pieces", "setup", "drive", "judge"):
        assert callable(getattr(entry, fn))
    assert callable(specs.module("content", c.traffic["content"]).make)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"benchmark/configs/{name}.json"
    cfg = specs.load_config(name)
    assert cfg["reduced"] == entry["reduced"] == []
    assert entry["source"].startswith("https://")


@pytest.mark.parametrize("mix", sorted({w["traffic"]
                                        for w in BENCH["workloads"]}))
def test_mix_loads_by_name(mix):
    t = specs.load_traffic(mix)
    assert int(t["pool_gops"]) >= 1
    assert isinstance(t["content_seed"], int)
    assert specs.module("entries", t["entry"])
    assert specs.module("content", t["content"])


def test_unknown_module_name_is_an_error():
    with pytest.raises(FileNotFoundError):
        specs.module("entries", "no_such_entry")


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        reader = specs.reader(m["name"])
        assert callable(reader)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and NAME.match(w["name"])


def test_four_card_cells_within_share():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_every_cell_reports_a_per_layer_metric():
    for cell in CELLS:
        assert specs.load_cell(cell).per_layer


def test_command_names_only_the_benchmark():
    assert BENCH["command"] == ["python3", "-m", "benchmark.run"]
    with open(os.path.join(specs.ROOT, "BENCHMARK.json")) as f:
        json.load(f)
