"""Build and load the port's CUDA kernels.

``csrc/*.cu`` (two of them include ``csrc/mma.cuh``) are compiled with
nvcc, one process per compilation unit (``UNITS``: each source, and
fused_socp.cu once per working type), all started together, and linked
into one shared library with a plain C interface,
loaded with ctypes.  The build happens at first use, on the
machine with the card, into ``conex_tpu_torch/_build/`` (listed in
.gitignore); the library's file name carries a hash of the sources and
flags, so an edited source is never served from a stale build.  Nothing is
built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(_PKG / "csrc" / name for name in
                ("schur.cu", "fused_socp.cu", "schur_probes.cu"))
# Included by schur.cu and schur_probes.cu.
HEADERS = (_PKG / "csrc" / "mma.cuh",)
# Compilation units: (source, extra flags, object tag).  fused_socp.cu is
# compiled once per working type (its CONEX_SOCP_PART), so its float32 and
# float64 instantiations build side by side.
UNITS = (
    (SOURCES[0], (), "schur"),
    (SOURCES[1], ("-DCONEX_SOCP_PART=1",), "fused_socp_f32"),
    (SOURCES[1], ("-DCONEX_SOCP_PART=2",), "fused_socp_f64"),
    (SOURCES[2], (), "schur_probes"),
)
BUILD_DIR = _PKG / "_build"
# No --use_fast_math: the kernels keep IEEE sqrt, exp and division.  No FMA
# contraction: every product and sum is rounded on its own, as in the plain
# versions (fused_socp.cu matches parallel/fused_socp.py::solve_socp_plain
# to the bit).  The flag leaves explicit fma() calls alone, which schur.cu
# and schur_probes.cu make; on an H100 it costs the fused SOCP kernel 0.5-3%
# (PERF.md).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# conex_schur_f{32,64}(A, W, C, P, part, G, AW, AQc, wc, cqc, S, Bc, m, n,
# Q, D, R, stream): K1, and the probes K3 and K6
_SCHUR_ARGTYPES = [_P] * 10 + [_I] * 7 + [_P]
# conex_socp_fused_f{32,64}(23 device pointers, S, nc, n1, m, plan,
# iparams, dparams, stream); plan, iparams and dparams are host arrays
_SOCP_ARGTYPES = [_P] * 23 + [_I] * 4 + [_P] * 4
# conex_probe_at_f{32,64}(A, W, C, Y, Tb, part, G, AW, AQc, wc, cqc, B, m,
# n, Q, D, SC, route, opb, stream): K4 and K5
_PROBE_AT_ARGTYPES = [_P] * 11 + [_I] * 8 + [_P]
_PROBE_AT_NAMES = ("conex_probe_at_f32", "conex_probe_at_f64")


class Build(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time; 0.0 when an existing build was loaded
    log: str  # nvcc's output (ptxas registers, shared memory, spills)


_lock = threading.Lock()
_loaded: Optional[Build] = None


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from csrc/ at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr([(src.name, flags) for src, flags, _ in UNITS]).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands in parallel; their output, or RuntimeError naming
    the first that failed."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for cmd in cmds
    ]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, text in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}"
            )
    return "".join(outs)


def _bind(lib: ctypes.CDLL) -> None:
    for names, argtypes in (
        (("conex_schur_f32", "conex_schur_f64"), _SCHUR_ARGTYPES),
        (("conex_socp_fused_f32", "conex_socp_fused_f64"), _SOCP_ARGTYPES),
        (_PROBE_AT_NAMES, _PROBE_AT_ARGTYPES),
    ):
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I


def build(force: bool = False) -> Build:
    """Compile (if needed) and load the kernel library; cached per process.

    ``force`` recompiles even when a library for these sources exists.
    """
    global _loaded
    with _lock:
        if _loaded is not None and not force:
            return _loaded
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"libconex_tpu_torch_{_digest()}.so"
        seconds, log = 0.0, ""
        if force or not out.exists():
            # Compile to private names and rename: concurrent processes on
            # one checkout never load a half-written library.
            tag = f"{out.stem}.{os.getpid()}"
            objs = [BUILD_DIR / f"{tag}.{unit}.o" for _, _, unit in UNITS]
            tmp = BUILD_DIR / f"{tag}.so.tmp"
            nvcc = _nvcc()
            t0 = time.perf_counter()
            compiles = [
                [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)]
                for (src, flags, _), obj in zip(UNITS, objs)
            ]
            log = _run_all(compiles)
            log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
            seconds = time.perf_counter() - t0
            os.replace(tmp, out)
            for obj in objs:
                obj.unlink()
        lib = ctypes.CDLL(str(out))
        _bind(lib)
        _loaded = Build(lib=lib, path=out, seconds=seconds, log=log)
        return _loaded
