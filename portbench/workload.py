"""The programs a cell solves: seeds, solver settings and types that every
problem class shares.

The programs of a mix are a fixed set, made from its ``programs_seed`` by
the generator of the configuration's class (problems/<class>.py), and
every run solves them in the same order whatever its ``--seed``: the
iterations a random program needs, and so its work, vary with its data and
even with the order of its variables, and a batch waits for its slowest
program, so programs drawn from ``--seed`` would move the rate with the
seed.  The seed draws which answers the check samples.

Programs are made on the device in chunks, each from its own
torch.Generator seeded from (seed, chunk), so a chunk can be made again
without the others.
"""

from __future__ import annotations

import hashlib

import torch


def chunk_seed(seed: int, chunk: int) -> int:
    """A 63-bit generator seed for chunk ``chunk`` of run seed ``seed``."""
    digest = hashlib.sha256(f"portbench:{int(seed)}:{int(chunk)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def solver_config(config: dict):
    from conex_tpu_torch import SolverConfig

    return SolverConfig(**config["solver"])


def dtype_of(name: str):
    return {"float64": torch.float64, "float32": torch.float32}[name]
