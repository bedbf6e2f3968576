"""The JAX package (conex_tpu) on the CPU, on the instances of
chip_smoke.py's phases 4d, 4e and 5e: what the reference reaches there,
which fixes those phases' iteration limits and accuracy gates.

    python3 tools/reference_runs.py eq_sdp [first,last]   # default 0,255
    python3 tools/reference_runs.py qp [iterations,...]   # default 100,200,300
    python3 tools/reference_runs.py herm

eq_sdp: each seed's equality-constrained SDP (chip_smoke.eq_sdp_instance at
n = 100, m = 50, p = 10) as one Program, kkt_solver LDLT, 100 iterations:
solved, iterations, ||Aeq y - beq||_inf, lambda_min(C - sum y_i A_i), b'y.
qp: the batch of 64 QPs (chip_smoke.qp_with_solution, 200 variables, 400
inequalities, seeds 0-63) through the vmapped solve under QP_CONFIG with
each iteration limit: the unsolved seeds, the iteration counts, and the
largest errors of y against x_opt and of the slack among the solved; then
seed 0 through Program with b moved by a few units of 2^-52 (how far one
rounding moves its iteration count), and through
add_quadratic_cost_epigraph (100 iterations allowed) with the same moves.
herm: bench_accuracy.py's complex and quaternion Hermitian SDPs
(chip_smoke.herm_accuracy_program's instances, f64, mu target 1e-8) as
Programs, with b moved by a few units of 2^-52: iterations, solved and
b'y, and how far b'y moves relative to the unmoved run.  Needs jax and
imports nothing of the port
(chip_smoke's instance makers are numpy); runs in f64 on the CPU, a few
minutes for each part.
"""

import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import conex_tpu  # noqa: E402
from conex_tpu.cones.lp import LinearCone  # noqa: E402
from conex_tpu.cones.qcost import QuadraticCost  # noqa: E402
from conex_tpu.parallel.sharded import solve_scenarios  # noqa: E402


def eq_sdp(first=0, last=255):
    _, n, m, p = chip_smoke.EQ_SDP_SHAPE
    config = conex_tpu.SolverConfig(kkt_solver=conex_tpu.KKT_SOLVER_LDLT,
                                    max_iterations=chip_smoke.EQ_SDP_ITERATIONS)
    iters = []
    for seed in range(first, last + 1):
        As, C, Aeq, beq, b = chip_smoke.eq_sdp_instance(seed, n, m, p)
        prog = conex_tpu.Program(m)
        prog.add_lmi_constraint(As, C)
        prog.add_equality_constraint(Aeq, beq)
        res = prog.solve(b, config)
        feas = np.abs(Aeq @ res.y - beq).max()
        lam = np.linalg.eigvalsh(C - np.einsum("v,vij->ij", res.y, As)).min()
        iters.append(res.num_iterations if res.solved else -1)
        print(f"eq_sdp seed {seed}: solved {res.solved} in {res.num_iterations} "
              f"iterations, ||Aeq y - beq||_inf {feas:.3e}, lambda_min {lam:.3e}, "
              f"b'y {float(b @ res.y)!r}", flush=True)
    iters = np.array(iters)
    print(f"eq_sdp seeds {first}-{last}: unsolved {np.flatnonzero(iters < 0).tolist()}, "
          f"iterations {iters[iters >= 0].min()}-{iters.max()}")


def qp(limits=(100, 200, 300)):
    n, ni = chip_smoke.QP_SHAPE
    S = chip_smoke.QP_BATCH
    W, A, b, c, x_opt, slack = map(np.stack, zip(*(
        chip_smoke.qp_with_solution(n, ni, np.random.default_rng(s)) for s in range(S))))
    blocks = (QuadraticCost(Q=jnp.asarray(W)), LinearCone(A=jnp.asarray(-A), c=jnp.asarray(b)))
    scalars = dict(k=jnp.zeros(S), b_scaling=jnp.ones(S), c_scaling=jnp.ones(S))
    for limit in limits:
        config = conex_tpu.SolverConfig(**dict(chip_smoke.QP_CONFIG_FIELDS,
                                               max_iterations=limit))
        t0 = time.perf_counter()
        r = jax.tree.map(np.asarray, solve_scenarios(
            blocks, (), jnp.asarray(-c), (jnp.zeros((S, 0)), jnp.ones((S, ni))),
            scalars, config))
        e_y = np.abs(r.y - x_opt).max(axis=1)
        e_s = np.abs(np.einsum("sij,sj->si", A, r.y) + b - slack).max(axis=1)
        ok = r.solved
        worst = int(np.argmax(np.where(ok, e_y, -1.0)))
        print(f"qp, {limit} iterations ({time.perf_counter() - t0:.1f} s): solved "
              f"{int(ok.sum())}/{S}, unsolved seeds {np.flatnonzero(~ok).tolist()}; "
              f"iterations {r.num_iterations.tolist()}; among the solved, the largest "
              f"|y - x_opt|_inf {e_y[ok].max():.3e} (seed {worst}) and slack error "
              f"{e_s[ok].max():.3e}; seed 0: {int(r.num_iterations[0])} iterations, "
              f"|y - x_opt|_inf {e_y[0]:.3e}", flush=True)
    Wn, An, bn, cn, xn, _ = chip_smoke.qp_with_solution(n, ni, np.random.default_rng(0))
    counts = []
    for e in (0, 1, -1, 2, -2):
        prog = conex_tpu.Program(n)
        prog.add_quadratic_cost(Wn)
        prog.add_linear_constraint(-An, bn)
        res = prog.solve(-cn * (1 + e * 2.0**-52), config)
        counts.append((e, res.num_iterations, bool(res.solved),
                       float(np.abs(res.y - xn).max())))
    print("qp seed 0 through Program, b moved by e units of 2^-52: (e, iterations, "
          f"solved, |y - x_opt|_inf) {counts}")
    for e in (0, 1, -1, 2, -2):
        prog = conex_tpu.Program(n + 1)
        prog.add_quadratic_cost_epigraph(Wn, range(n), n)
        prog.add_linear_constraint(np.hstack([-An, np.zeros((ni, 1))]), bn)
        res = prog.solve(np.concatenate([-cn, [-1.0]]) * (1 + e * 2.0**-52),
                         conex_tpu.SolverConfig(max_iterations=100, inv_sqrt_mu_max=1e5))
        x, t = res.y[:n], res.y[n]
        print(f"qp epigraph, seed 0, b moved by {e} units of 2^-52: solved {res.solved} "
              f"in {res.num_iterations} iterations, |y - x_opt|_inf "
              f"{np.abs(x - xn).max():.3e}, |t - x'Wx/2| {abs(t - 0.5 * x @ Wn @ x):.3e}")


def herm():
    for dim, name in ((2, "complex"), (4, "quaternion")):
        rng = np.random.default_rng(10 + dim)
        n, m = 16, 8
        A = np.stack([chip_smoke.rand_hermitian(dim, n, rng) for _ in range(m)])
        C = np.zeros((dim, n, n))
        C[0] = np.eye(n)
        prog = conex_tpu.Program(m)
        prog.add_hermitian_constraint(A, C)
        b = np.asarray(prog.get_feasible_objective())
        config = conex_tpu.SolverConfig(max_iterations=100,
                                        inv_sqrt_mu_max=1.0 / np.sqrt(1e-8))
        runs = []
        for e in (0, 1, -1, 2, -2):
            res = prog.solve(b * (1 + e * 2.0**-52), config)
            runs.append((e, res.num_iterations, bool(res.solved), float(b @ res.y)))
        by0 = runs[0][3]
        spread = max(abs(r[3] - by0) / abs(by0) for r in runs)
        print(f"herm {name} (n={n}, m={m}, f64): (e, iterations, solved, b'y) {runs}; "
              f"largest relative move of b'y {spread:.3e}", flush=True)


def main(argv):
    part, *rest = argv
    numbers = [int(x) for x in rest[0].split(",")] if rest else []
    if part == "eq_sdp":
        eq_sdp(*numbers)
    elif part == "qp":
        qp(numbers or (100, 200, 300))
    elif part == "herm":
        herm()
    else:
        sys.exit(f"unknown part {part!r}: eq_sdp, qp or herm")


if __name__ == "__main__":
    main(sys.argv[1:])
