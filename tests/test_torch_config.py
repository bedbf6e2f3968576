"""The port's SolverConfig is a field-for-field copy of the JAX package's,
and its package root exports the JAX package's names."""

import dataclasses

import torch

torch.set_num_threads(1)

import conex_tpu.config as jcfg
import conex_tpu_torch.config as tcfg


def test_solver_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.SolverConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.SolverConfig)]
    assert tf == jf


def test_mode_constants_match():
    for name in ("COLDSTART", "WARMSTART", "KKT_SOLVER_LLT", "KKT_SOLVER_LDLT",
                 "KKT_SOLVER_QR"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


def test_schur_precision_names_match_mm_modes():
    from conex_tpu.algebra import mm

    assert tcfg.SCHUR_PRECISION_MODES == mm.MODES


def test_replace_returns_new_config():
    base = tcfg.SolverConfig()
    cfg = base.replace(max_iterations=7)
    assert cfg.max_iterations == 7
    assert base.max_iterations == 25


def test_default_config_exported_and_equal_to_jax():
    import conex_tpu
    import conex_tpu_torch

    assert "DEFAULT_CONFIG" in conex_tpu_torch.__all__
    assert conex_tpu_torch.DEFAULT_CONFIG is tcfg.DEFAULT_CONFIG
    for f in dataclasses.fields(jcfg.SolverConfig):
        assert (getattr(conex_tpu_torch.DEFAULT_CONFIG, f.name)
                == getattr(conex_tpu.DEFAULT_CONFIG, f.name)), f.name


def test_package_root_exports_what_the_jax_package_does():
    """Every name of conex_tpu.__all__ resolves on the port's root, Conex
    and solve_sedumi lazily as in JAX, and __version__ is JAX's; an
    unknown name still raises AttributeError."""
    import pytest

    import conex_tpu
    import conex_tpu_torch

    for name in conex_tpu.__all__:
        assert name in conex_tpu_torch.__all__, name
        assert getattr(conex_tpu_torch, name) is not None, name
    from conex_tpu_torch.interface import Conex
    from conex_tpu_torch.sedumi import solve_sedumi

    assert conex_tpu_torch.Conex is Conex
    assert conex_tpu_torch.solve_sedumi is solve_sedumi
    assert conex_tpu_torch.__version__ == conex_tpu.__version__ == "0.1.0"
    with pytest.raises(AttributeError):
        conex_tpu_torch.no_such_name
