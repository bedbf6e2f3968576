"""Probe round 2: the Schur-phase formulations with the TPU kernels' padding.

Twin of part 2 of ``benchmarks/dev_tpu_probe2.py``: ``fused_b2`` (K5) and
``fused_a2`` (K6) are the At-layout and A-layout formulations of
``dev_pallas_probe`` as the TPU kernels run them with m padded to 8 and n
to 128.  Padding has no twin here, since zero padding changes no sum: the
plain versions are the formulations of K4 and K3, and the kernels too:
K5's is K4's (``launch_at``, whose mma tiles round every edge), K6's is
K3's, K1's kernels (``launch_a``, whose 8 x 8 blocks round every edge).

Part 1 of the JAX probe (bf16 split ladders and optimization barriers) is
a TPU precision workaround and is not ported (ROADMAP.md, "Not to port");
``part1`` raises.

    python -m conex_tpu_torch.benchmarks.dev_tpu_probe2 [part2] [--device cpu]
"""

from __future__ import annotations

import argparse

from .dev_pallas_probe import (
    check, check_kernel_inputs, einsum_schur, fused_a_plain, fused_b_plain,
    launch_a, launch_at, probe_inputs, route, timed,
)


def part1():
    raise NotImplementedError(
        "part1 (the bf16 split ladders and optimization barriers) is not "
        "ported: ROADMAP.md, 'Not to port'")


def fused_b2_plain(A, w, C):
    """K5's formulation: K4's (benchmarks/dev_tpu_probe2.py:119-136)."""
    return fused_b_plain(A, w, C)


def fused_a2_plain(A, w, C):
    """K6's formulation: K3's (benchmarks/dev_tpu_probe2.py:195-208)."""
    return fused_a_plain(A, w, C)


def fused_b2_kernel(A, w, C):
    """K5 on the card (replaces dev_tpu_probe2.py::_kernel_b2): K4's
    kernels, since the padding changes no sum."""
    check_kernel_inputs(A, w, C)
    out = launch_at(A, w, C)
    fused_b2_kernel.launches += 1
    return out


fused_b2_kernel.launches = 0


def fused_a2_kernel(A, w, C):
    """K6 on the card (replaces dev_tpu_probe2.py::_kernel_a2): K3's
    kernels, K1's, since the padding changes no sum."""
    check_kernel_inputs(A, w, C)
    out = launch_a(A, w, C)
    fused_a2_kernel.launches += 1
    return out


fused_a2_kernel.launches = 0


def fused_b2(A, w, C):
    return route(fused_b2_kernel, fused_b2_plain, A, w, C)


def fused_a2(A, w, C):
    return route(fused_a2_kernel, fused_a2_plain, A, w, C)


def part2(device="cuda", shape=(256, 50, 100)):
    B, m, n = shape
    A, w, C = probe_inputs(B, m, n, device)
    print(f"part2 shape B={B} m={m} n={n}, device={device}", flush=True)
    ref, best = timed(einsum_schur, A, w, C)
    print(f"einsum: best={best * 1e3:.3f} ms", flush=True)
    check("fused_b2", fused_b2, A, w, C, ref)
    check("fused_a2", fused_a2, A, w, C, ref)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("which", nargs="?", default="part2",
                        choices=("part1", "part2"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.which == "part1":
        part1()
    part2(args.device)


if __name__ == "__main__":
    main()
