"""What one run measures, found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic file and the reader of each metric.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, so a later change adds a cell, a mix or a
metric by adding files and entries:

* ``configs/<config>.json``: the codec settings (``codec``), the host
  layout of the deployment (``host_layout``) and where they come from;
* ``traffic/<mix>.json``: the parameters of a mix: the program's call
  that it drives (``entry``), the video it feeds (``content``) and their
  parameters;
* ``entries/<entry>.py``: how a mix's ``entry`` is set up, driven for the
  window and judged (:mod:`.rank` calls its ``setup``, ``drive`` and
  ``judge``), so that a mix over an entry that is there is data alone;
* ``content/<content>.py``: a ``make(frames, height, width, traffic,
  device)`` that makes a mix's video from its parameters;
* ``metrics/<metric>.py``: a ``read(run)`` that returns the metric's value
  from the run's records (:class:`.records.Run`), or None where it finds
  nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

#: the benchmark's folder, and the checkout's root above it
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it reads."""
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict        # the configuration file
    traffic: dict       # the traffic file
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; raises KeyError
    for a name it does not list."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    return Cell(name, int(w["chips"]), w["config"], w["traffic"], config,
                load_traffic(w["traffic"], root),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def load_traffic(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{name}.json")) as f:
        return json.load(f)


def load_config(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "benchmark", "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder, loaded
    from its file (a name may hold dots and dashes)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    mod_name = f"benchmark.{kind}._" + name.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    return module("metrics", metric).read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader finds
    something in ``run``."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
