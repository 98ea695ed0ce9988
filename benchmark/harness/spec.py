"""What a cell is made of, found by name: BENCHMARK.json at the root of
the checkout, benchmark/workloads/<cell>.json, configs/<config>.json,
traffic/<mix>.json, and the Python files of a traffic generator
(traffic/<generator>.py), an entry driver (drivers/<driver>.py), a
metric's reader (metrics/<metric>.py), the configuration's plain
reference (reference/<module>.py) and, where the cell holds numbers of
its own, the module that the workload names under "numbers"
(reference/<module>.py as well). The configuration also names the
program's entry points and params class as "package.module:attribute",
found with importlib. A new cell, configuration, processor, mix,
generator, driver or metric is a new file; nothing here changes. A name
that leads nowhere raises Missing, which names the file, module or
attribute that is not there."""
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


class Missing(LookupError):
    """A cell's files name a file, module or attribute that is not there."""


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
        raise Missing(f"no {kind} module {name!r}: {path} does not exist")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def named(config: dict, key: str) -> str:
    """What the configuration names under `key`."""
    if key not in config:
        raise Missing(f"configuration {config.get('name')!r} names no {key}")
    return config[key]


def program_object(config: dict, key: str):
    """The program's object that the configuration names under `key`, as
    "package.module:attribute"."""
    ref = named(config, key)
    mod_name, _, attr = str(ref).partition(":")
    if not mod_name or not attr:
        raise Missing(f"{key} {ref!r} is not package.module:attribute")
    try:
        return getattr(importlib.import_module(mod_name), attr)
    except (ImportError, AttributeError) as e:
        raise Missing(f"{key} {ref!r}: {e}") from e


def reference(config: dict):
    """The configuration's plain reference, reference/<module>.py."""
    return load_module("reference", named(config, "reference"))


def own_numbers(workload: dict):
    """The module of the cell's own numbers that the workload names under
    "numbers" (reference/<module>.py), or None where it names none."""
    if "numbers" not in workload:
        return None
    return load_module("reference", workload["numbers"])


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    end_to_end: list = field(default_factory=list)   # BENCHMARK.json rows
    per_layer: list = field(default_factory=list)
    numbers: object = None          # own_numbers(workload)


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
    reference(cfg)                  # a missing reference ends the run now
    mix = load_json(BENCH, "traffic",
                    f"{check_name(wl['traffic'], 'traffic')}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, wl, cfg, mix, e2e, per_layer, own_numbers(wl))
