"""What a cell is made of, found by name: BENCHMARK.json at the root of
the checkout, benchmark/workloads/<cell>.json, configs/<config>.json,
traffic/<mix>.json, and the Python files of a traffic generator
(traffic/<generator>.py), an entry driver (drivers/<driver>.py) and a
metric's reader (metrics/<metric>.py). A new cell, configuration, mix,
generator, driver or metric is a new file; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass, field

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {what} name {name!r}")
    return name


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module of its own."""
    check_name(name, kind)
    path = os.path.join(BENCH, kind, f"{name}.py")
    mod_name = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    end_to_end: list = field(default_factory=list)   # BENCHMARK.json rows
    per_layer: list = field(default_factory=list)


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether a BENCHMARK.json metric is reported in `cell`: by its
    `workloads` list where it has one; otherwise an end-to-end metric is
    everywhere and a per-layer one wherever the metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, bench: dict | None = None) -> Cell:
    check_name(name, "workload")
    bench = bench if bench is not None else load_json(ROOT, "BENCHMARK.json")
    wl = load_json(BENCH, "workloads", f"{name}.json")
    cfg = load_json(BENCH, "configs",
                    f"{check_name(wl['config'], 'config')}.json")
    mix = load_json(BENCH, "traffic",
                    f"{check_name(wl['traffic'], 'traffic')}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, wl, cfg, mix, e2e, per_layer)
