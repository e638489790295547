"""Finds a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names the cells and metrics. A
cell's traffic is ``workloads/<cell>.json``, its configuration
``configs/<config>.json``, its inputs ``inputs/<generator>.py`` and each metric
``metrics/<metric>.py``, all under this folder. A new cell or metric is new
files and entries; no file here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    end_to_end: list  # BENCHMARK.json metrics this cell reports untraced
    per_layer: list  # and traced


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return _json(ROOT / "BENCHMARK.json")


def cell(name):
    bench = benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[name]
    workload = _json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips", "why"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} differs between BENCHMARK.json and its workload file")
    config = _json(HERE / "configs" / f"{entry['config']}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, workload, config, e2e, per_layer)


def module(folder, name):
    """The module ``<folder>/<name>.py`` of this folder, loaded from its path."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{folder}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric):
    """``read(rec)`` of metrics/<metric>.py: the number, or None where the
    run has nothing for it to read."""
    return module("metrics", metric).read
