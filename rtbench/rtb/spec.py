"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of the
checkout, and under ``rtbench/`` each configuration's file (named in
``BENCHMARK.json``), each traffic mix (``traffic/<traffic>.json``), each
cell's limits (``limits/<cell>.json``) and each metric's reader
(``metrics/<metric>.py``, a function ``read(run)``). Adding a cell, a mix,
a configuration or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

RTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(RTBENCH)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration's file, as it is run
    traffic: dict       # the mix's parameters
    limits: dict        # {number: limit}
    end_to_end: list    # BENCHMARK.json's entries that this cell reports
    per_layer: list


def _reports(metric, cell, e2e_names):
    """Whether `cell` reports `metric`: the cells its ``workloads`` lists,
    else every cell that reports the end-to-end metric it moves (an
    end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name, bench=None, root=ROOT):
    """The cell `name` of `bench` (BENCHMARK.json's contents) with its files
    read."""
    bench = bench or benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    rtb = os.path.join(root, "rtbench")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name=name, chips=w["chips"],
                config=load_json(os.path.join(root, configs[w["config"]]["file"])),
                traffic=load_json(os.path.join(rtb, "traffic", w["traffic"] + ".json")),
                limits=load_json(os.path.join(rtb, "limits", name + ".json")),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric_name, root=ROOT):
    """The ``read(run)`` function of ``metrics/<metric_name>.py``."""
    path = os.path.join(root, "rtbench", "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "rtbench_metric_" + metric_name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
