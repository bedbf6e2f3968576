"""SeDuMi-format front end.

Twin of ``conex_tpu/sedumi.py``.  Python equivalent of the reference's
MATLAB entry point (interfaces/matlab/conex.m): solve the primal-dual pair

    (P) min c'x  s.t.  A x = b,  x in K
    (D) max b'y  s.t.  c - A'y in K*

for the self-dual cone K described by the SeDuMi structure
``K = dict(f=..., l=..., q=[...], s=[...])`` (free variables, nonnegative
orthant, Lorentz cones, PSD cones; s-blocks are stored as full n^2
vectorized columns, SeDuMi convention).  The y-problem is conex's native
form; x is recovered from the cone duals.  The solve runs on ``device``:
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .config import SolverConfig
from .program import Program


def solve_sedumi(A, b, c, K: Dict, config: Optional[SolverConfig] = None,
                 blkdiag: Optional[bool] = None, clean: bool = True,
                 device="cuda"):
    """Returns (x, y, info) like the reference conex.m.

    info keys: solved, iterations, primal_infeasible, dual_infeasible.
    ``device``: where the Program runs, the card unless asked for "cpu".

    Preprocessing (reference conex.m:3-35 + ConexPreprocess.m):
    ``clean`` drops zero equality rows up front (CleanLinear, duals mapped
    back through T); ``blkdiag`` eliminates free variables and splits
    sparse PSD cones into block-diagonal sub-cones (default: on when there
    is more than one s-block, matching ``pars.blkdiag = length(K.s) > 1``).
    """
    A = np.atleast_2d(np.asarray(A, dtype=np.float64))
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    c = np.asarray(c, dtype=np.float64).reshape(-1)

    ss_in = [int(s) for s in (K.get("s", []) or [])]
    qs_in = [int(q) for q in (K.get("q", []) or [])]
    if blkdiag is None:
        blkdiag = len(ss_in) > 1 and not qs_in

    T_clean = None
    if clean:
        from .preprocess import clean_linear

        A, b, T_clean = clean_linear(A, b)

    if blkdiag:
        from .preprocess import SedumiPresolve

        pre = SedumiPresolve.build(A, b, c, K)
        x_red, y_red, info = solve_sedumi(
            pre.A, pre.b, pre.c, pre.K, config=config,
            blkdiag=False, clean=False, device=device,
        )
        x, y = pre.recover(x_red, y_red)
        if T_clean is not None:
            y = T_clean @ y
        return x, y, info
    m = A.shape[0]  # number of equalities = number of y variables
    if A.shape[1] != c.shape[0]:
        raise ValueError("A columns must match c length")
    if b.shape[0] != m:
        raise ValueError("b length must match A rows")

    nf = int(K.get("f", 0) or 0)
    nl = int(K.get("l", 0) or 0)
    qs = [int(q) for q in (K.get("q", []) or [])]
    ss = [int(s) for s in (K.get("s", []) or [])]
    expected = nf + nl + sum(qs) + sum(s * s for s in ss)
    if expected != A.shape[1]:
        raise ValueError(
            f"cone dimensions sum to {expected}, but A has {A.shape[1]} columns"
        )

    if config is None:
        config = SolverConfig(
            inv_sqrt_mu_max=1000.0,
            max_iterations=100,
            final_centering_steps=1,
            prepare_dual_variables=True,
        )
    else:
        config = config.replace(prepare_dual_variables=True)

    prog = Program(m, device=device)
    readers = []  # functions assembling x segments after the solve
    col = 0

    if nf:
        Af = A[:, col:col + nf]
        cf = c[col:col + nf]
        eq_idx = prog.add_equality_constraint(Af.T, cf)
        readers.append(("f", eq_idx, nf))
        col += nf

    if nl:
        Al = A[:, col:col + nl]
        cl = c[col:col + nl]
        blk = prog.add_linear_constraint(Al.T, cl)
        readers.append(("blk", blk, nl))
        col += nl

    for q in qs:
        Aq = A[:, col:col + q]
        cq = c[col:col + q]
        blk = prog.add_soc_constraint(Aq.T, cq)
        readers.append(("blk", blk, q))
        col += q

    for n in ss:
        As = A[:, col:col + n * n]
        cs = c[col:col + n * n]
        Amats = As.reshape(m, n, n)
        Amats = 0.5 * (Amats + np.swapaxes(Amats, 1, 2))
        Cmat = cs.reshape(n, n)
        Cmat = 0.5 * (Cmat + Cmat.T)
        blk = prog.add_lmi_constraint(Amats, Cmat)
        readers.append(("sdp", blk, n))
        col += n * n

    res = prog.solve(b, config)

    x_parts = []
    for kind, idx, size in readers:
        if kind == "f":
            x_parts.append(prog.get_equality_dual(idx))
        elif kind == "sdp":
            X = prog.get_dual_variable(idx)
            x_parts.append(np.asarray(X).reshape(-1))
        else:
            x_parts.append(np.asarray(prog.get_dual_variable(idx)).reshape(-1))
    x = np.concatenate(x_parts) if x_parts else np.zeros(0)

    info = dict(
        solved=bool(res.solved),
        iterations=int(res.num_iterations),
        primal_infeasible=bool(res.primal_infeasible),
        dual_infeasible=bool(res.dual_infeasible),
    )
    y = np.asarray(res.y)
    if T_clean is not None:
        y = T_clean @ y
    return x, y, info
