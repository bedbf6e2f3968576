"""The port's C ABI: build, load and bind ``libconex_tpu_torch``.

``conex_tpu_torch_c.c`` embeds CPython and drives
``conex_tpu_torch.interface.Conex`` behind ``conex_tpu.h``, this
directory's copy of ``interfaces/conex_tpu.h`` with one symbol more,
``CONEX_CreateConeProgramOnDevice`` (``CONEX_CreateConeProgram`` is it with
``"cuda"``).  A C or MATLAB caller of the JAX package's
``libconex_tpu.so`` switches library and changes nothing else.

``build()`` compiles the library with ``cc`` at first use, against this
interpreter's shared libpython (the flags come from ``sysconfig``), into
``conex_tpu_torch/_build/`` (listed in .gitignore) under a name that
carries a hash of the sources, the flags and libpython's path, and copies
it to the stable name ``libconex_tpu_torch.so`` there for MATLAB's
``loadlibrary``.  A failed build raises with the compiler's output: the
ABI has no Python version to fall back on.  ``build_host()`` compiles
``abi_host.c``, a plain C program that links the library (see its header).
Nothing is built when this module is imported.

A process that loads the library into a running interpreter (``load()``,
through ctypes) shares that interpreter; any other process starts one at
its first ``CONEX_CreateConeProgram*`` call, and finds this package and
torch through ``PYTHONPATH`` (``host_environment()``).

    python3 -m conex_tpu_torch.interfaces   # build; print the two paths
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import site
import subprocess
import sysconfig
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
HEADER = _DIR / "conex_tpu.h"
SOURCE = _DIR / "conex_tpu_torch_c.c"
HOST_SOURCE = _DIR / "abi_host.c"
MATLAB_DIR = _DIR / "matlab"
BUILD_DIR = _DIR.parent / "_build"
STABLE_LIBRARY = BUILD_DIR / "libconex_tpu_torch.so"
CC = "cc"
CFLAGS = ("-O2", "-fPIC", "-Wall")

_lock = threading.Lock()


def python_link():
    """(include directory, libpython path, its soname) of this interpreter;
    RuntimeError where it has no shared libpython to embed."""
    var = sysconfig.get_config_var
    libpython = Path(var("LIBDIR") or "") / (var("LDLIBRARY") or "")
    if not var("Py_ENABLE_SHARED") or not libpython.is_file():
        raise RuntimeError(
            f"the C ABI embeds CPython and needs a shared libpython: this "
            f"Python has Py_ENABLE_SHARED={var('Py_ENABLE_SHARED')!r} and no "
            f"{libpython}"
        )
    return var("INCLUDEPY"), libpython, var("INSTSONAME") or libpython.name


def _library_command(out: Path):
    include, libpython, soname = python_link()
    return [CC, *CFLAGS, "-shared", f"-I{include}", f"-I{_DIR}",
            f'-DCONEX_LIBPYTHON="{soname}"', str(SOURCE), "-o", str(out),
            str(libpython), f"-Wl,-rpath,{libpython.parent}", "-ldl"]


def _digest(parts) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part if isinstance(part, bytes) else str(part).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library of these sources, flags and libpython is built."""
    cmd = _library_command(Path("out"))
    digest = _digest([SOURCE.read_bytes(), HEADER.read_bytes(), *cmd])
    return BUILD_DIR / f"libconex_tpu_torch_c_{digest}.so"


def _compile(cmd_for, out: Path) -> None:
    """Run the compile command cmd_for(tmp) and rename tmp to out: a
    concurrent process never loads a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(cmd_for(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{CC} failed ({proc.returncode}): {' '.join(cmd_for(tmp))}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)


def build() -> Path:
    """Compile the library if no build of these sources exists, refresh the
    stable copy, and return the hashed library's path."""
    out = library_path()
    with _lock:
        if not out.exists():
            _compile(_library_command, out)
        if not (STABLE_LIBRARY.exists()
                and STABLE_LIBRARY.read_bytes() == out.read_bytes()):
            tmp = STABLE_LIBRARY.with_name(f"{STABLE_LIBRARY.name}.{os.getpid()}.tmp")
            tmp.write_bytes(out.read_bytes())
            os.replace(tmp, STABLE_LIBRARY)
    return out


def build_host() -> Path:
    """Compile abi_host.c against the library (built first if needed) and
    return the program's path."""
    lib = build()
    out = BUILD_DIR / f"abi_host_{_digest([HOST_SOURCE.read_bytes(), lib.name])}"

    def cmd(tmp):
        return [CC, "-O2", "-Wall", f"-I{_DIR}", str(HOST_SOURCE), "-o",
                str(tmp), str(lib), f"-Wl,-rpath,{BUILD_DIR}"]

    with _lock:
        if not out.exists():
            _compile(cmd, out)
    return out


def host_environment() -> dict:
    """This process's environment with PYTHONPATH set to the repository
    root and this interpreter's site-packages (then PYTHONPATH's entries),
    so that a C process embedding the library imports this package and
    torch."""
    env = dict(os.environ)
    paths = [str(_DIR.parents[1]), *site.getsitepackages()]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


class SolverConfiguration(ctypes.Structure):
    """CONEX_SolverConfiguration."""

    _fields_ = [
        ("prepare_dual_variables", ctypes.c_int),
        ("initialization_mode", ctypes.c_int),
        ("inv_sqrt_mu_max", ctypes.c_double),
        ("minimum_mu", ctypes.c_double),
        ("maximum_mu", ctypes.c_double),
        ("divergence_upper_bound", ctypes.c_double),
        ("enable_line_search", ctypes.c_int),
        ("dinf_upper_bound", ctypes.c_double),
        ("final_centering_steps", ctypes.c_int),
        ("final_centering_tolerance", ctypes.c_double),
        ("initial_centering_steps_warmstart", ctypes.c_int),
        ("initial_centering_steps_coldstart", ctypes.c_int),
        ("warmstart_abort_threshold", ctypes.c_double),
        ("max_iterations", ctypes.c_int),
        ("iterative_refinement_iterations", ctypes.c_int),
        ("infeasibility_threshold", ctypes.c_double),
        ("kkt_error_tolerance", ctypes.c_double),
        ("enable_rescaling", ctypes.c_int),
        ("kkt_solver", ctypes.c_int),
    ]

    def fields(self) -> dict:
        """The SolverConfig keywords the library passes for this struct."""
        return {name: getattr(self, name) for name, _ in self._fields_}


class IterationStats(ctypes.Structure):
    """CONEX_IterationStats."""

    _fields_ = [("mu", ctypes.c_double), ("iteration_number", ctypes.c_int)]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_D = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)
_CFG = ctypes.POINTER(SolverConfiguration)
# symbol: (restype, argtypes), as conex_tpu.h declares them
SIGNATURES = {
    "CONEX_CreateConeProgram": (_P, []),
    "CONEX_CreateConeProgramOnDevice": (_P, [ctypes.c_char_p]),
    "CONEX_DeleteConeProgram": (None, [_P]),
    "CONEX_AddDenseLinearConstraint": (_I, [_P, _D, _I, _I, _D, _I]),
    "CONEX_AddLinearInequalities": (_I, [_P, _D, _I, _I, _D, _I, _D, _I]),
    "CONEX_AddQuadraticCost": (_I, [_P, _D, _I, _I]),
    "CONEX_AddDenseLMIConstraint": (_I, [_P, _D, _I, _I, _I, _D, _I, _I]),
    "CONEX_AddSparseLMIConstraint": (
        _I, [_P, _D, _I, _I, _I, _D, _I, _I, ctypes.POINTER(ctypes.c_long), _I]),
    "CONEX_Maximize": (_I, [_P, _D, _I, _CFG, _D, _I]),
    "CONEX_Solve": (_I, [_P, _CFG, _D, _I]),
    "CONEX_GetDualVariableSize": (_I, [_P, _I]),
    "CONEX_GetDualVariable": (None, [_P, _I, _D, _I, _I]),
    "CONEX_SetDefaultOptions": (None, [_CFG]),
    "CONEX_GetIterationStats": (None, [_P, ctypes.POINTER(IterationStats), _I]),
    "CONEX_SetNumberOfVariables": (_I, [_P, _I]),
    "CONEX_NewLinearMatrixInequality": (_I, [_P, _I, _I, _IP]),
    "CONEX_NewLorentzConeConstraint": (_I, [_P, _I, _IP]),
    "CONEX_NewLinearInequality": (_I, [_P, _I, _IP]),
    "CONEX_UpdateLinearOperator": (_I, [_P, _I, _F, _I, _I, _I, _I]),
    "CONEX_UpdateAffineTerm": (_I, [_P, _I, _F, _I, _I, _I]),
    "CONEX_NewQuadraticCost": (_I, [_P, _IP]),
    "CONEX_UpdateQuadraticCostMatrix": (_I, [_P, _I, _F, _I, _I]),
}


def load() -> ctypes.CDLL:
    """Build if needed and load the library into this process (RTLD_LOCAL:
    the JAX package's library exports the same names), every symbol with
    its argtypes and restype.  The library runs in this interpreter."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib
