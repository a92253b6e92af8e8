#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, ``samples`` (each open's or gesture's
seconds), and last ``checks``.  Exits non-zero without
a result where there is no card, the program is missing, or JAX or the
JAX package is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import check, harness, importcheck, registry

    bench = registry.benchmark()
    cell = registry.cell(args.workload)
    registry.check_cell_entry(bench, cell)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import msv_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 1
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T0)
    e2e, layers = registry.metrics_for(bench, args.workload)
    if args.trace:
        metrics = harness.per_layer(res["run"], layers)
    else:
        vals = dict(res["e2e"], setup_s=res["setup_s"])
        metrics = {m["name"]: {"value": float(vals[m["name"]]),
                               "unit": m["unit"]} for m in e2e
                   if math.isfinite(vals.get(m["name"], math.nan))}
    correct, checks = check.verdict(res["numbers"],
                                    check.limits(args.workload))
    bad = importcheck.forbidden()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}: the benchmark measures "
              f"the PyTorch port alone", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"],
              "nvidia_smi": power_limit()}
    out = {"correct": bool(correct), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
        out["breakdown"] = res["breakdown"]
    # each open's or gesture's seconds, for reading a run's spread
    out["samples"] = res["samples"]
    out["checks"] = checks
    sys.stdout.flush()
    print(f"portbench: the reference and the comparison took "
          f"{res['judge_s']:.3f} s", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
