"""The programs a cell solves, and when a solve counts as solved.

The programs of a mix are a fixed set, made from its ``programs_seed``,
and every run solves them in the same order whatever its ``--seed``: the
iterations a random program needs, and so its work, vary with its data and
even with the order of its variables, and a batch waits for its slowest
program, so programs drawn from ``--seed`` would move the rate with the
seed.  The seed draws which answers the check samples (check.py).

The generator is upstream's solver comparison
(interfaces/matlab/test/run_solver_comparison.m): random dense SDPs
maximize b'y s.t. C - sum_i y_i A_i PSD, with symmetric A_i uniform in
(-1, 1), C = I and b = A(X0) for an X0 = Y Y' + 0.1 I, Y uniform in (-1, 1),
so that every program is feasible and bounded.  Programs are made on the
device in chunks, each from its own torch.Generator seeded from (seed,
chunk), so a chunk can be made again without the others.

A program counts as solved when the solver says so and the relative
duality gap of its y and dual X (reference/sdp.py) is at most the
configuration's ``relative_gap``.
"""

from __future__ import annotations

import hashlib

import torch


def chunk_seed(seed: int, chunk: int) -> int:
    """A 63-bit generator seed for chunk ``chunk`` of run seed ``seed``."""
    digest = hashlib.sha256(f"portbench:{int(seed)}:{int(chunk)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_chunk(seed: int, chunk: int, count: int, n: int, m: int, dtype,
               device):
    """Chunk ``chunk`` of the set made from ``seed``: ``count`` programs, A (count, m, n, n), C (count, n, n), b (count, m),
    made in float64 on ``device`` and returned in ``dtype``."""
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(chunk_seed(seed, chunk))
    A = torch.rand((count, m, n, n), generator=gen, **f64).mul_(2.0).sub_(1.0)
    A = (A + A.transpose(-2, -1)).mul_(0.5)
    Y = torch.rand((count, n, n), generator=gen, **f64).mul_(2.0).sub_(1.0)
    X0 = Y @ Y.transpose(-2, -1) + 0.1 * torch.eye(n, **f64)
    b = torch.einsum("gvij,gij->gv", A, X0)
    C = torch.eye(n, **f64).expand(count, n, n).contiguous()
    return A.to(dtype), C.to(dtype), b.to(dtype)


def solver_config(config: dict):
    from conex_tpu_torch import SolverConfig

    return SolverConfig(**config["solver"])


def dtype_of(name: str):
    return {"float64": torch.float64, "float32": torch.float32}[name]
