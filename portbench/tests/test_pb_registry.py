"""The harness finds configurations, traffic mixes and kinds, cells and
per-layer metrics by name, and BENCHMARK.json keeps to its contract."""

import os
import re

import pytest

from portbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_by_name(w):
    c = registry.cell(w["name"])
    assert (c["config_name"], c["traffic_name"]) == (w["config"],
                                                     w["traffic"])
    registry.check_cell_entry(BENCH, c)
    kind = registry.traffic_kind(c["traffic"]["kind"])
    for fn in ("setup", "window", "outputs"):
        assert callable(getattr(kind, fn))
    assert os.path.isfile(os.path.join(registry.HERE, "limits",
                                       w["name"] + ".json"))
    assert w["chips"] == 1


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(m):
    assert callable(registry.metric(m["name"]).read)
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    moved = e2e[m["moves"]]
    # each listed cell reports the end-to-end metric this one moves
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", [cell])


def test_configs_point_at_their_files():
    for c in BENCH["configs"]:
        cfg = registry.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_names_units_and_sizes_keep_to_the_contract():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= BENCH["run_seconds"] <= 51
    for w in BENCH["workloads"]:
        e2e, layers = registry.metrics_for(BENCH, w["name"])
        assert {"setup_s"} < {m["name"] for m in e2e} and layers


def test_unknown_and_malformed_names_are_refused():
    with pytest.raises(KeyError):
        registry.cell("nosuch.cell")
    with pytest.raises(ValueError):
        registry.config("../BENCHMARK")
    with pytest.raises(KeyError):
        registry.metric("nosuch_metric")
