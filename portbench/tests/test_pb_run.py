"""The command line: no card means no result, and a run's last line has
the keys the contract names, with the compared numbers last."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness, registry, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


CELL = registry.cell


def small(name):
    """The cell at a size the CPU tests hold: 3 s songs, a 90 s hour."""
    c = CELL(name)
    for t in c["config"]["tracks"]:
        t["seconds"] = 90 if t["signal"] == "hour" else 3
    return c


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "songs7.open",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(monkeypatch, capsys, trace):
    real = harness.run_cell

    def on_cpu(cell, seed, seconds, traced, **kw):
        kw["device"] = "cpu"
        res = real(cell, seed, seconds, traced, **kw)
        res["memory_peak_bytes"] = 0
        return res

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    monkeypatch.setattr(registry, "cell", small)
    monkeypatch.setattr(harness, "run_cell", on_cpu)
    rc = run.main(["--workload", "songs7.open", "--seed", str(2**31 + 3),
                   "--seconds", "1", "--trace", str(trace)])
    assert rc == 0
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in line) == bool(trace)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    e2e, layers = registry.metrics_for(registry.benchmark(), "songs7.open")
    want = {m["name"] for m in (layers if trace else e2e)}
    # the CPU run has no device trace: its readers find nothing to read
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    err = cap.err.strip().splitlines()
    assert err[-len(line["checks"]):] == [
        f"check {k}: {c['value']!r} (limit {c['limit']!r})"
        for k, c in line["checks"].items()]
