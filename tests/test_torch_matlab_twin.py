"""ctypes twin of the port's MATLAB shim
(conex_tpu_torch/interfaces/matlab/*.m), in f64 on the CPU.

No MATLAB or Octave runtime is available, so, as tests/test_matlab_twin.py
does for the JAX package's shim, the .m files are validated by driving the
port's library through ctypes with the call sequence, argument order,
options block and (column-major) data layout that conex_tpu_torch.m and
ConexTpuTorchProgram.m emit (``chip_smoke.matlab_program``), on the CPU
(``ConexTpuTorchProgram(m, 'cpu')``).  y and the reassembled SeDuMi dual x
are held to the SeDuMi front end of both packages (JAX's
``conex_tpu.sedumi.solve_sedumi`` and the port's
``solve_sedumi(device="cpu")``) at 1e-8, test_matlab_twin.py's limit, and
A x = b at 1e-6.  The helpers come from the port's own C ABI test, never
from tests/test_c_abi.py, which loads the JAX package's library (both
export the same names).
"""

import re

import numpy as np

import chip_smoke
from conex_tpu.sedumi import solve_sedumi as jax_solve_sedumi

from conex_tpu_torch import interfaces
from conex_tpu_torch.sedumi import solve_sedumi

from test_torch_c_abi import ROOT, lib  # noqa: F401 (lib is a fixture)

TWIN = {"ConexTpuTorchProgram.m": "ConexTpuProgram.m", "conex_tpu_torch.m": "conex_tpu.m"}


def test_matlab_twin_matches_both_sedumi_front_ends(lib):  # noqa: F811
    # tests/test_matlab_twin.py::_sedumi_instance(0): m = 3, K.l = 4, K.s = [5].
    A, b, c, K = chip_smoke.sedumi_lmi_instance(3, 4, 5)
    out = chip_smoke.abi_run(lib, "cpu", *chip_smoke.matlab_program(A, b, c, K))
    assert out["solved"] == 1
    x = np.concatenate(out["duals"])  # conex_tpu_torch.m's postlude
    for solve in (jax_solve_sedumi, lambda *a: solve_sedumi(*a, device="cpu")):
        x_ref, y_ref, info = solve(A, b, c, K)
        assert info["solved"]
        np.testing.assert_allclose(out["y"], y_ref, atol=1e-8)
        np.testing.assert_allclose(x, x_ref, atol=1e-8)
    np.testing.assert_allclose(A @ x, b, atol=1e-6)


def _source(name):
    return (interfaces.MATLAB_DIR / name).read_text()


def test_matlab_shim_files_reference_real_symbols():
    """Every calllib symbol and libstruct name of the twin .m files is in the
    port's header, through the alias libconex_tpu_torch only."""
    hdr = interfaces.HEADER.read_text()
    exported = set(re.findall(r"CONEX_\w+", hdr))
    for fname in TWIN:
        src = _source(fname)
        used = set(re.findall(r"'(CONEX_\w+)'", src))
        assert not used - exported, f"{fname} references unknown symbols {used - exported}"
        for st in re.findall(r"libstruct\('(\w+)'\)", src):
            assert f"}} {st};" in hdr, f"{fname}: struct {st} not in header"
        assert set(re.findall(r"calllib\('(\w+)'", src)) <= {"libconex_tpu_torch"}
    assert "'alias', 'libconex_tpu_torch'" in _source("ConexTpuTorchProgram.m")


def test_matlab_twin_keeps_the_jax_shims_call_sequence_and_options():
    """The twin .m files make the JAX shim's calls in the same order (the
    program created on a device), and conex_tpu_torch.m sets the options
    block that chip_smoke.MATLAB_OPTIONS replays."""
    for twin, original in TWIN.items():
        ours = re.findall(r"'(CONEX_\w+)'", _source(twin))
        theirs = re.findall(r"'(CONEX_\w+)'",
                            (ROOT / "interfaces" / "matlab" / original).read_text())
        assert ours == [s if s != "CONEX_CreateConeProgram"
                        else "CONEX_CreateConeProgramOnDevice" for s in theirs]
    options = dict(re.findall(r"p\.options\.(\w+) = ([\de.]+);", _source("conex_tpu_torch.m")))
    assert options == dict(re.findall(
        r"p\.options\.(\w+) = ([\de.]+);",
        (ROOT / "interfaces" / "matlab" / "conex_tpu.m").read_text()))
    assert {k: float(v) for k, v in options.items()} == chip_smoke.MATLAB_OPTIONS
