"""Readings for the correctness limits of one cell, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--dtype float32] [--faults none,zero,rows]

For each fault and seed, one run of the cell with a short window, in one
process, and one JSON line with every number the check computes (not only
the limited ones), the solver's counts and the run's `correct`.  Without
--dtype and with the fault ``none`` the port runs as the configuration
states (the lower readings); with --dtype float32 the port's own float32
path is the control, and each other fault (faults.py) is planted in the
port's answers (the upper readings).  The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--dtype", default=None)
    parser.add_argument("--faults", default="none")
    args = parser.parse_args(argv)

    import torch

    from . import check, faults, spec
    from .harness import run_cell

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    limits = spec.load_limits(args.workload)
    for fault in args.faults.split(","):
        remove = faults.plant(fault) if fault != "none" else None
        for seed in (int(s) for s in args.seeds.split(",")):
            start = time.perf_counter()
            out, numbers = run_cell(bench, cell, seed, args.seconds, False, "cuda",
                                    start, dtype=args.dtype, limits={})
            print(json.dumps(dict(
                workload=args.workload, seed=seed, dtype=args.dtype or "as configured",
                fault=fault, correct=check.verdict(numbers, limits), numbers=numbers,
                attempted=out["attempted"], failed=out["failed"],
                metrics={k: v["value"] for k, v in out["metrics"].items()},
                seconds=time.perf_counter() - start)), flush=True)
        if remove:
            remove()
    return 0

if __name__ == "__main__":
    sys.exit(main())
