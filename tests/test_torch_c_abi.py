"""The port's C ABI (conex_tpu_torch/interfaces) against the Python Conex
of both packages, in f64 on the CPU.

The library is built here with cc (``interfaces.build()``) and loaded
with ctypes (RTLD_LOCAL: the JAX package's libconex_tpu.so exports the
same names); ``CONEX_CreateConeProgramOnDevice("cpu")`` puts each program
on the CPU.  tests/test_c_abi.py's six programs
(``chip_smoke.abi_programs``: the LP with duals and iteration stats, box
inequalities under LDLT, the sparse LMI, the quadratic cost, the
incremental QP and LMI) run through it with that test's own assertions,
and are held

* to the port's Python ``Conex(device="cpu")`` given the same calls: y,
  every dual and the last iteration's mu equal to the bit (the library
  drives that class in this interpreter);
* to JAX's ``conex_tpu.interface.Conex`` within the limits of
  tests/test_torch_frontends.py (LMI = 1e-6 relative for a model with an
  LMI block, EXACT = 1e-8 otherwise), with solved, the iteration count,
  the duals and mu side by side as its ``_both`` holds them.  The box
  program under LDLT clamps a pivot to +/-1e-9 in its final steps (its
  equality row), which amplifies rounding (tests/test_torch_equality_qp.py:
  its trajectory agrees to 1e-11, y to 4.2e-8, and one rounding of b
  moves y by 5.3e-9 in JAX alone and 1.7e-8 in the port alone): it is held
  at LMI, and the test checks that the clamp fires there and nowhere else.

The header-drift tests hold conex_tpu_torch/interfaces/conex_tpu.h to
interfaces/conex_tpu.h (every symbol with its argument list, the three
structs field by field) and the ctypes binding to the header.  abi_host,
a C process that starts with no interpreter, solves a small LMI (n = 8,
m = 4) dense and incrementally on the CPU with the in-process y.
"""

import ctypes
import json
import re
import subprocess
import sys
import sysconfig
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import chip_smoke
import conex_tpu
from conex_tpu import interface as jif

import conex_tpu_torch as ct
from conex_tpu_torch import interface as tif
from conex_tpu_torch import interfaces
from conex_tpu_torch.solver import kkt as tkkt

ROOT = Path(__file__).resolve().parents[1]
JAX_HEADER = ROOT / "interfaces" / "conex_tpu.h"
LMI, EXACT = 1e-6, 1e-8
PROGRAMS = chip_smoke.abi_programs()
# The programs held to JAX at LMI (see the docstring): an LMI block, or a
# clamped LDLT pivot.
WITH_LMI = ("sparse_lmi", "incremental_lmi")
CLAMPED = ("box_ldlt",)


@pytest.fixture(scope="module")
def lib():
    return interfaces.load()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _own_checks(name, out, program):
    """tests/test_c_abi.py's assertions on the result of each program."""
    m, ops, b, _ = program
    y = out["y"]
    assert out["solved"] == 1
    if name == "lp":
        A, c = ops[0][1:]
        x = out["duals"][0]
        np.testing.assert_allclose(A.T @ x, b, atol=1e-6)
        assert x.min() >= -1e-8 and out["mu"] < 1e-5
    elif name == "box_ldlt":
        A, lb, ub = ops[0][1:]
        Ay = A @ y
        assert (Ay <= ub + 1e-6).all() and (Ay >= lb - 1e-6).all()
        np.testing.assert_allclose(Ay[2], 0.5, atol=1e-6)
    elif name == "sparse_lmi":
        As, C, vars_ = ops[0][1:]
        S = C - np.einsum("vij,v->ij", As, y[vars_])
        assert np.linalg.eigvalsh(S).min() >= -1e-7 and np.abs(y).max() <= 1 + 1e-7
    elif name == "quadratic_cost":
        np.testing.assert_allclose(y, np.linalg.solve(ops[0][1], b), atol=1e-6)
    elif name == "incremental_qp":
        np.testing.assert_allclose(y, np.zeros(m), atol=1e-4)
    else:
        order = ops[0][1]
        As = np.zeros((m, order, order))
        for value, var, row, col, _ in ops[0][3]:
            As[var, row, col] = As[var, col, row] = value
        S = np.eye(order) - np.einsum("vij,v->ij", As, y)  # C = I
        assert np.linalg.eigvalsh(S).min() >= -1e-7


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_matches_the_python_conex_of_both_packages(lib, name, monkeypatch):
    program = PROGRAMS[name]
    defaults = chip_smoke.abi_defaults(lib)
    clamped = []
    clamp = tkkt._clamp_pivot

    def record(d):
        clamped.append(bool((d.abs() < tkkt.LDLT_PIVOT_CLAMP).any()))
        return clamp(d)

    monkeypatch.setattr(tkkt, "_clamp_pivot", record)
    out = chip_smoke.abi_run(lib, "cpu", *program)
    _own_checks(name, out, program)
    assert any(clamped) == (name in CLAMPED)
    prepares = program[3].get("prepare_dual_variables")

    tc, ts = chip_smoke.conex_run(lambda m: tif.Conex(m, device="cpu"),
                                  ct.SolverConfig, defaults, *program)
    assert np.array_equal(out["y"], ts.y)
    assert out["mu"] == tc.GetIterationNumberStats(-1).mu
    assert out["iterations"] == tc._result.num_iterations
    tx = tc.GetDualVariables() if prepares else []
    assert len(out["duals"]) == len(tx)
    for x, t in zip(out["duals"], tx):
        assert np.array_equal(x, np.ravel(t, order="F"))

    jc, js = chip_smoke.conex_run(jif.Conex, conex_tpu.SolverConfig, defaults, *program)
    _own_checks(name, dict(out, y=np.asarray(js.y)), program)
    tol = LMI if name in WITH_LMI + CLAMPED else EXACT
    assert bool(js.status) == bool(ts.status)
    assert jc._result.num_iterations == tc._result.num_iterations
    assert _rel(out["y"], js.y) <= tol
    assert _rel(out["mu"], jc.GetIterationNumberStats(-1).mu) <= tol
    jx = jc.GetDualVariables() if prepares else []
    assert len(jx) == len(tx)
    for t, j in zip(tx, jx):
        assert _rel(t, j) <= tol


def _declarations(header):
    """{symbol: normalized argument list} and {struct: [(type, field)]} of a
    header, comments removed."""
    text = re.sub(r"/\*.*?\*/", "", header.read_text(), flags=re.S)
    text = " ".join(text.split())
    funcs = {name: re.sub(r"\s*([*,()])\s*", r"\1", f"{ret} ({args})").strip()
             for ret, name, args in
             re.findall(r"([\w\s\*]+?)\s*\b(CONEX_\w+)\s*\(([^)]*)\)\s*;", text)}
    structs = {name: [tuple(f.rsplit(" ", 1)) for f in
                      (field.strip() for field in body.split(";")) if f]
               for body, name in re.findall(r"typedef struct \{(.*?)\} (\w+);", text)}
    return funcs, structs


def test_the_header_keeps_every_symbol_and_struct_of_the_jax_header():
    """A C or MATLAB caller switches library and changes nothing else: every
    symbol with the same argument list, the three structs with the same
    fields in the same order, and one symbol more."""
    jf, js = _declarations(JAX_HEADER)
    tf, ts = _declarations(interfaces.HEADER)
    assert len(jf) == 21 and set(js) == {
        "CONEX_SolverConfiguration", "CONEX_IterationStats", "CONEX_SolutionStats"}
    assert {k: tf[k] for k in jf} == jf
    assert set(tf) - set(jf) == {"CONEX_CreateConeProgramOnDevice"}
    assert tf["CONEX_CreateConeProgramOnDevice"].startswith("void*(")
    assert ts == js


def test_the_ctypes_binding_follows_the_header():
    funcs, structs = _declarations(interfaces.HEADER)
    assert set(interfaces.SIGNATURES) == set(funcs)
    for name, (_, argtypes) in interfaces.SIGNATURES.items():
        args = funcs[name].split("(", 1)[1].rstrip(")")
        assert len(argtypes) == (0 if args == "void" else args.count(",") + 1), name
    for cls, name in ((interfaces.SolverConfiguration, "CONEX_SolverConfiguration"),
                      (interfaces.IterationStats, "CONEX_IterationStats")):
        ctype = {"int": ctypes.c_int, "double": ctypes.c_double}
        assert [(ctype[t], f) for t, f in structs[name]] == [(t, f) for f, t in cls._fields_]


def test_a_python_exception_gives_conex_failure_and_its_traceback(lib, capfd):
    prog = lib.CONEX_CreateConeProgramOnDevice(b"cpu")
    try:
        assert lib.CONEX_SetNumberOfVariables(prog, 3) == 0
        Q = np.eye(2)  # not 3 x 3: Conex.AddQuadraticCost raises ValueError
        assert lib.CONEX_AddQuadraticCost(
            prog, Q.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 2, 2) == 1
        assert lib.CONEX_GetDualVariableSize(prog, 0) == -1
    finally:
        lib.CONEX_DeleteConeProgram(prog)
    err = capfd.readouterr().err
    assert err.count("Traceback") == 2
    assert "Cost matrix dimension does not match" in err


def test_the_build_needs_a_shared_libpython_and_raises_with_the_compilers_output(
        tmp_path, monkeypatch):
    real = sysconfig.get_config_var
    with mock.patch.object(sysconfig, "get_config_var",
                           lambda k: 0 if k == "Py_ENABLE_SHARED" else real(k)):
        with pytest.raises(RuntimeError, match="shared libpython"):
            interfaces.build()
    bad = tmp_path / "conex_tpu_torch_c.c"
    bad.write_text("int broken(void) { return undeclared; }\n")
    monkeypatch.setattr(interfaces, "SOURCE", bad)
    monkeypatch.setattr(interfaces, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(interfaces, "STABLE_LIBRARY", tmp_path / "_build" / "lib.so")
    with pytest.raises(RuntimeError, match="undeclared"):
        interfaces.build()
    assert not list((tmp_path / "_build").iterdir())


def test_the_build_writes_the_stable_copy_for_matlab():
    built = interfaces.build()
    assert built.parent == interfaces.BUILD_DIR == interfaces.STABLE_LIBRARY.parent
    assert built.name.startswith("libconex_tpu_torch_c_")
    assert interfaces.STABLE_LIBRARY.read_bytes() == built.read_bytes()
    out = subprocess.run([sys.executable, "-m", "conex_tpu_torch.interfaces"], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout.split("\n")
    assert out[:2] == [f"library {interfaces.STABLE_LIBRARY}",
                       f"header {interfaces.HEADER}"]


def test_abi_host_solves_as_in_process(lib, tmp_path):
    """The C process (no interpreter at its start: ensure_python starts one)
    gives the in-process y to the bit, built dense and incrementally."""
    m, n = 4, 8
    A, C, b = chip_smoke.bench_lmi(m, n, seed=1)
    config = dict(max_iterations=100, prepare_dual_variables=1)
    want = chip_smoke.abi_run(lib, "cpu", m, [("dense_lmi", A, C)], b, config)
    assert want["solved"] == 1
    path = tmp_path / "program.bin"
    np.concatenate([[m, n], chip_smoke.colmajor(*A), chip_smoke.colmajor(C), b]).tofile(path)
    host = interfaces.build_host()
    env = interfaces.host_environment()
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) here
    for build in ("dense", "incremental"):
        proc = subprocess.run([str(host), str(path), build, "cpu"], capture_output=True,
                              text=True, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out["solved"] == 1 and out["build"] == build and out["device"] == "cpu"
        assert np.array_equal(np.asarray(out["y"]), want["y"])
    proc = subprocess.run([str(host), str(path), "sparse"], capture_output=True, text=True)
    assert proc.returncode == 1 and "dense" in proc.stderr
