"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``workloads/<cell>.json``,
``metrics/<metric>.py`` (a reader: ``read(ctx)`` returns a number, or None
where the run gives it nothing to read) and ``work/<function>.py``
(``work(cfg)`` returns the bytes and float32 operations of one call)."""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name):
    return load_json(os.path.join(HERE, "workloads", f"{name}.json"))


def config(name):
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def _module(kind, name):
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name):
    """The reader of metric ``name``."""
    return _module("metrics", name).read


def work(name):
    """The work function of ``name``."""
    return _module("work", name).work


def cell_metrics(bench, cell):
    """``(end_to_end, per_layer)``: the metric entries of ``BENCHMARK.json``
    that cell ``cell`` reports (those without a ``workloads`` key, and
    those that list it)."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]

    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])
