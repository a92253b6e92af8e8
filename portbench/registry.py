"""Finds the benchmark's parts by name: a cell is ``workloads/<name>.json``
(its configuration and traffic mix), a configuration
``configs/<name>.json``, a traffic mix ``traffic/<name>.json`` (its
parameters, and the ``kind`` whose module reads them:
``traffic/<kind>.py``), a per-layer metric ``metrics/<name>.py`` (a
``read(run)`` that returns a number, or None where it finds nothing to
read).  ``BENCHMARK.json`` at the checkout's root says which metrics each
cell reports.  A new cell or metric is new files and entries; no file
here changes."""

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(HERE, kind, name + ".json")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def traffic_kind(kind: str):
    """The module of a traffic kind."""
    if not NAME.match(kind) or "." in kind:
        raise ValueError(f"bad traffic kind {kind!r}")
    return importlib.import_module(f"portbench.traffic.{kind}")


def cell(name: str) -> dict:
    """The cell's file with its configuration and traffic mix resolved:
    {"name", "config": {...}, "traffic": {...}}."""
    w = _json("workloads", name)
    return {"name": name, "config_name": w["config"],
            "traffic_name": w["traffic"], "config": config(w["config"]),
            "traffic": traffic(w["traffic"])}


def metric(name: str):
    """The reader module of a per-layer metric."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no metric reader named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_for(bench: dict, cell_name: str):
    """(end-to-end entries, per-layer entries) that ``cell_name`` reports:
    those whose ``workloads`` list it, or that have no such list."""
    def mine(entries):
        return [m for m in entries
                if cell_name in m.get("workloads", [cell_name])]
    for w in bench["workloads"]:
        if w["name"] == cell_name:
            break
    else:
        raise KeyError(f"BENCHMARK.json has no cell {cell_name!r}")
    return mine(bench["end_to_end"]), mine(bench["per_layer"])


def check_cell_entry(bench: dict, c: dict) -> None:
    """The cell's file and its BENCHMARK.json entry name the same
    configuration and traffic."""
    for w in bench["workloads"]:
        if w["name"] == c["name"]:
            if (w["config"], w["traffic"]) != (c["config_name"],
                                               c["traffic_name"]):
                raise ValueError(
                    f"cell {c['name']}: BENCHMARK.json says "
                    f"{w['config']}/{w['traffic']}, its file "
                    f"{c['config_name']}/{c['traffic_name']}")
            return
    raise KeyError(f"BENCHMARK.json has no cell {c['name']!r}")
