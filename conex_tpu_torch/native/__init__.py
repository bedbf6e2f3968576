"""Native (C++) host-side components, loaded via ctypes.

Copy of ``conex_tpu/native/__init__.py`` for the port.  The clique-tree
analysis is sequential graph preprocessing (the part of the runtime the
reference keeps in C++) and is implemented in clique_ordering.cc behind a
plain C ABI.  The shared library is built with g++ at first use into
``conex_tpu_torch/_build/`` (listed in .gitignore), under a file name that
carries a hash of the source and flags, so an edited source is never
served from a stale build.  Where g++ is missing or the build fails,
``available()`` is False and supernodal/ordering.py runs its Python
version of the same algorithm instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "clique_ordering.cc"
BUILD_DIR = _DIR.parent / "_build"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libconex_clique_order_{digest.hexdigest()[:16]}.so"


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = library_path()
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # Build beside the target and rename: a concurrent process
                # never loads a half-written library.
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                subprocess.run(["g++", *FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.conex_tpu_clique_order.argtypes = [
                ctypes.c_int, i32p, i32p, i32p, ctypes.c_int,
                i32p, i32p, i32p, i32p, i32p, i32p, i32p,
            ]
            lib.conex_tpu_clique_order.restype = ctypes.c_int
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def clique_order_native(cliques: Sequence[Sequence[int]],
                        valid_leaf: Optional[Sequence[int]] = None,
                        root: int = -1):
    """Native clique ordering; returns (order, supernodes, separators,
    parent, height) or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(cliques)
    num_vars = max(max(c) for c in cliques) + 1
    offsets = np.zeros(n + 1, np.int32)
    for i, c in enumerate(cliques):
        offsets[i + 1] = offsets[i] + len(c)
    data = np.asarray(
        [v for c in cliques for v in c], dtype=np.int32
    )
    vl = (
        np.asarray(valid_leaf, np.int32)
        if valid_leaf is not None and len(valid_leaf)
        else None
    )
    order = np.zeros(n, np.int32)
    parent = np.zeros(n, np.int32)
    height = np.zeros(n, np.int32)
    cap = max(n * num_vars, offsets[-1] + 1)
    sup_off = np.zeros(n + 1, np.int32)
    sup_data = np.zeros(cap, np.int32)
    sep_off = np.zeros(n + 1, np.int32)
    sep_data = np.zeros(cap, np.int32)

    def p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    lib.conex_tpu_clique_order(
        n, p(offsets), p(data),
        p(vl) if vl is not None else None, root,
        p(order), p(parent), p(height),
        p(sup_off), p(sup_data), p(sep_off), p(sep_data),
    )
    supernodes: List[List[int]] = [
        sup_data[sup_off[i]:sup_off[i + 1]].tolist() for i in range(n)
    ]
    separators: List[List[int]] = [
        sep_data[sep_off[i]:sep_off[i + 1]].tolist() for i in range(n)
    ]
    return (
        order.tolist(), supernodes, separators, parent.tolist(),
        height.tolist(),
    )
