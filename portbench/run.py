"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The window lasts at least --seconds and ends on a whole cycle of the
traffic mix's pool of programs.  The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, with --trace 1
breakdown, and last the numbers the correctness check compared, each
beside its limit (also the last lines of standard error).  Without a CUDA device, with fewer devices than
the cell asks for, or with jax or the JAX package loaded by the end, the
run prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "conex_tpu")


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or conex_tpu."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _caches()

    import torch

    from . import spec

    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), "
              f"found {found}; no result", file=sys.stderr)
        return 2
    try:
        import conex_tpu_torch  # noqa: F401

        from .harness import run_cell
    except ImportError as err:
        print(f"portbench: cannot import the port: {err}; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, _ = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the process loaded {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 3
    for name, entry in result["checks"].items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
