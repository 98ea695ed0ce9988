"""BENCHMARK.json and the files it names: every cell, configuration, mix,
generator, driver and metric loads; names and units keep to their
characters; each metric's reader agrees with its row; every `moves` names
an end-to-end metric its cells report; every cell has a limit for each
number its outputs carry."""
import json
import os

import pytest

from harness import spec

BENCH = spec.BENCH
ROOT = spec.ROOT
B = spec.load_json(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]
LINE = set("\t\n\r")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "benchmark/run.py"]
    assert B["paths"] == ["benchmark"]
    assert 1 <= B["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in B["configs"]] + CELLS + \
        [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        spec.check_name(n, "entry")
    for m in METRICS:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in B["configs"] + B["workloads"]]
                 + [c["source"] for c in B["configs"]]
                 + [m["layer"] for m in B["per_layer"]]):
        assert 1 <= len(text) <= 200 and not LINE & set(text), text


@pytest.mark.parametrize("cfg", B["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    d = spec.load_json(ROOT, cfg["file"])
    assert d["name"] == cfg["name"] and d["source"] == cfg["source"]
    assert d["reduced"] == cfg["reduced"] == []
    assert len(d["source"]) <= 200
    assert d["channels"] == 2 and d["sample_rate"] == 48000
    # the resolved threshold is the processor's own
    from reference.tomatis_ref import threshold_dbfs
    assert threshold_dbfs(d["params"]) == d["threshold_dbfs"]


@pytest.mark.parametrize("cell", B["workloads"], ids=lambda c: c["name"])
def test_workload_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    c = spec.load_cell(cell["name"], B)
    w = c.workload
    assert (w["name"], w["config"], w["traffic"], w["chips"]) == (
        cell["name"], cell["config"], cell["traffic"], cell["chips"])
    assert os.path.exists(os.path.join(BENCH, "drivers",
                                       f"{w['driver']}.py"))
    assert os.path.exists(os.path.join(BENCH, "traffic",
                                       f"{c.mix['generator']}.py"))
    spec.load_module("drivers", w["driver"])
    # a limit for each number the cell's outputs carry
    want = {"audio_lsb", "end_lsb"}
    if c.mix["format"] == "flac":
        want |= {"state_frames", "level_db"}
        if c.config["processor"] == "xfade":
            want.add("alpha_frames")
    assert set(w["limits"]) == want
    # setup_s, another end-to-end metric and a per-layer one
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_readers(m):
    mod = spec.load_module("metrics", m["name"])
    assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    assert callable(mod.read) and mod.READS
    if m in B["per_layer"]:
        assert mod.MOVES == m["moves"]
        e2e = {e["name"]: e for e in B["end_to_end"]}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in CELLS
            assert spec.reports(e2e[m["moves"]], cell, set())
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_roofline_names_and_layers():
    for m in B["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    layers = {m["layer"] for m in B["per_layer"]}
    perf = open(os.path.join(ROOT, "PERF.md"), encoding="utf-8").read()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_every_mix_and_config_file_is_used():
    """Every workload file is a cell of BENCHMARK.json or says why it is
    kept out ("kept_out"), and every mix file is some workload's."""
    loads = [spec.load_json(BENCH, "workloads", f)
             for f in os.listdir(os.path.join(BENCH, "workloads"))]
    for w in loads:
        assert w["name"] in CELLS or w.get("kept_out"), w["name"]
    assert set(CELLS) <= {w["name"] for w in loads}
    files = {f[:-5] for f in os.listdir(os.path.join(BENCH, "traffic"))
             if f.endswith(".json")}
    assert files == {w["traffic"] for w in loads}
    cfgs = {c["name"] for c in B["configs"]}
    assert {w["config"] for w in B["workloads"]} == cfgs


def test_paths_hold_only_names_of_names():
    for d, _, files in os.walk(BENCH):
        rel = os.path.relpath(d, ROOT)
        if "_build" in rel or "__pycache__" in rel:
            continue
        for f in files:
            path = os.path.join(rel, f)
            assert len(path) <= 200
            for part in path.split(os.sep):
                spec.check_name(part, "path part")
    json.dumps(B)
