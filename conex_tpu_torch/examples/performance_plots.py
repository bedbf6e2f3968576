"""Mu-per-Newton-step experiments (paper-figure reproduction) on the port.

Twin of ``examples/performance_plots.py``: the same random Hermitian-PSD
programs over the real, complex, quaternion and octonion algebras and the
same mixed-cone program (LP, SOC and a 4 x 4 LMI), drawn in the same order
from one ``np.random.default_rng(0)`` and solved by
``conex_tpu_torch.Program`` on ``device``: the card unless the caller asks
for the CPU.  It records mu per Newton step and writes the trajectories to
CSV, plus a plot when matplotlib is installed.

Run:  python3 -m conex_tpu_torch.examples.performance_plots [output_dir]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from conex_tpu_torch import Program, SolverConfig

ALGEBRAS = ((1, "real"), (2, "complex"), (4, "quaternion"), (8, "octonion"))


def rand_hermitian(d, n, rng):
    x = rng.uniform(-1, 1, (d, n, n))
    x[0] = 0.5 * (x[0] + x[0].T)
    for i in range(1, d):
        x[i] = 0.5 * (x[i] - x[i].T)
    return x


def mu_trajectory_hermitian(d, n, m, rng, config, device="cuda"):
    A = np.stack([rand_hermitian(d, n, rng) for _ in range(m)])
    C = np.zeros((d, n, n))
    C[0] = np.eye(n) * (n + 1.0)
    X0 = np.zeros((d, n, n))
    X0[0] = np.eye(n)
    b = np.einsum("vdij,dij->v", A, X0)
    prog = Program(m, device=device)
    prog.add_hermitian_constraint(A, C)
    res = prog.solve(b, config)
    return 1.0 / res.stats_inv_sqrt_mu**2, res


def mu_trajectory_mixed(rng, config, device="cuda"):
    m = 3
    prog = Program(m, device=device)
    A_lp = rng.uniform(-1, 1, (8, m))
    c_lp = np.abs(rng.uniform(0.5, 1.5, 8))
    prog.add_linear_constraint(A_lp, c_lp)
    A_soc = rng.uniform(-1, 1, (5, m))
    c_soc = rng.uniform(-1, 1, 5)
    c_soc[0] = np.linalg.norm(c_soc[1:]) + 1.0
    prog.add_soc_constraint(A_soc, c_soc)
    A_sdp = np.stack(
        [0.5 * (M + M.T) for M in rng.uniform(-1, 1, (m, 4, 4))]
    )
    prog.add_lmi_constraint(A_sdp, np.eye(4) * 5.0)
    b = prog.get_feasible_objective()
    res = prog.solve(b, config)
    return 1.0 / res.stats_inv_sqrt_mu**2, res


def main(argv=None):
    """Solve the five programs on the device that ``argv`` names, write
    their CSVs (and the plot) into its output directory; returns {name:
    (mu per step, Result)}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out", nargs="?", default="plots_out",
                        help="directory for the CSVs and the plot")
    parser.add_argument("--device", default="cuda",
                        help='torch device of the solves (default "cuda")')
    args = parser.parse_args(argv)
    out, device = args.out, args.device
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(0)
    config = SolverConfig(inv_sqrt_mu_max=1e5, max_iterations=90)

    runs = {}

    def report(name, mus, res, start):
        runs[name] = (mus, res)
        print(f"{name:10s}: {len(mus)} iterations, final mu {mus[-1]:.2e}, "
              f"solved={res.solved}, {time.perf_counter() - start:.3f} s")

    for d, name in ALGEBRAS:
        n = 3 if d == 8 else 8
        start = time.perf_counter()
        report(name, *mu_trajectory_hermitian(d, n, 4, rng, config, device), start)
    start = time.perf_counter()
    report("mixed", *mu_trajectory_mixed(rng, config, device), start)

    for name, (mus, _) in runs.items():
        np.savetxt(
            os.path.join(out, f"mu_per_step_{name}.csv"),
            np.column_stack([np.arange(len(mus)), mus]),
            delimiter=",",
            header="newton_step,mu",
        )

    try:
        import matplotlib
    except ImportError as e:  # matplotlib is optional
        print(f"(no plot: {e})")
    else:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        for name, (mus, _) in runs.items():
            ax.semilogy(mus, label=name)
        ax.set_xlabel("Newton step")
        ax.set_ylabel("mu")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out, "mu_per_step.png"), dpi=120)
        plt.close(fig)
        print(f"wrote {out}/mu_per_step.png")
    print(f"wrote CSVs to {out}/")
    return runs


if __name__ == "__main__":
    main()
