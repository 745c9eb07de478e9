"""``BENCHMARK.json`` keeps to the benchmark's contract, and every
configuration, cell, metric and work function it names is found by name."""
import json
import os
import re

import pytest

from conftest import PB, ROOT
from portbench import check, manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and 1 <= len(c["source"]) <= 200
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        names += [w["name"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"setup_s", "subjects_per_s", "iter_ms_p95", "peak_mem_gib"} <= set(e2e)
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25


def test_per_layer():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_reports_what_its_metrics_move(w):
    e2e, per_layer = manifest.cell_metrics(BENCH, w["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in names, m["name"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    wl = manifest.workload(w["name"])
    cfg = manifest.config(wl["config"])
    assert wl["config"] == w["config"] and wl["chips"] == w["chips"] and wl["why"] == w["why"]
    assert set(wl["limits"]) == set(check.NUMBERS)
    assert set(wl["traffic"]) >= {"subjects", "offset", "bumps", "vmax", "trace_epochs"}
    entry = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert manifest.load_json(os.path.join(ROOT, entry["file"])) == cfg
    assert cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]
    for f in cfg["roofline"]:
        nbytes, ops = manifest.work(f)(cfg)
        assert nbytes > 0 and ops > 0
    e2e, per_layer = manifest.cell_metrics(BENCH, w["name"])
    for m in e2e + per_layer:
        assert callable(manifest.reader(m["name"]))


def test_every_config_is_used_and_every_file_named():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for kind, names in (("configs", used), ("workloads", {w["name"] for w in BENCH["workloads"]})):
        files = {f[:-5] for f in os.listdir(os.path.join(PB, kind)) if f.endswith(".json")}
        assert files == names, kind


def test_file_names_are_names():
    for dirpath, _, files in os.walk(PB):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel


def test_the_json_files_parse():
    for kind in ("configs", "workloads"):
        for f in os.listdir(os.path.join(PB, kind)):
            json.load(open(os.path.join(PB, kind, f)))
