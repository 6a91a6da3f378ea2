"""Fixtures of the benchmark's tests: a checkout whose cells keep the
benchmark's own shape at a size the CPU runs in seconds."""

import json
import os

import pytest

from benchmark import spec as specs

#: the small geometry every cell is cut to here (the GOP stays dyadic)
TINY = {"pixels_in_x": 128, "pixels_in_y": 64, "TRLs": 3, "SRLs": 3,
        "block_size": 16}


def make_tiny_root(dst: str) -> str:
    """A checkout at ``dst`` with the repository's ``BENCHMARK.json`` and
    its configurations and mixes, each configuration cut to :data:`TINY`
    and each mix traced from its start."""
    os.makedirs(os.path.join(dst, "benchmark", "configs"))
    os.makedirs(os.path.join(dst, "benchmark", "traffic"))
    bench = specs.load_benchmark()
    for c in bench["configs"]:
        cfg = specs.load_config(c["name"])
        cfg["codec"].update(TINY)
        with open(os.path.join(dst, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        mix = specs.load_traffic(w["traffic"])
        mix["trace_from"] = 0
        with open(os.path.join(dst, "benchmark", "traffic",
                               w["traffic"] + ".json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny") / "root"))


def cuda_available() -> bool:
    import torch
    return torch.cuda.is_available()
