#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from: the compared
numbers of one cell over many seeds in one process, with the program as
the configuration states it, or with its lower-precision path switched on
(``--precision fast``, the control that has to come out as not correct:
the bf16 mel kernel on the mel scale, the linear route's GEMMs in TF32 on
the linear scale).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--precision fast]

Prints one JSON line a seed: {"seed", "precision", "numbers", "correct"}.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--precision", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import check, harness, registry

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    lims = check.limits(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False,
                               device="cuda", precision=args.precision)
        ok, _ = check.verdict(res["numbers"], lims)
        print(json.dumps({
            "seed": seed, "precision": args.precision or
            cell["config"]["precision"], "numbers": res["numbers"],
            "correct": ok, "e2e": res["e2e"], "s": time.perf_counter() - t0}),
            flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
