"""A configuration of a new problem class needs only new files: a class
written outside portbench/, a small LP, runs through both drivers on the
CPU, is judged by its own check, and leaves portbench/ as it was."""

import hashlib
import time

import pytest

from portbench import check, faults, spec
from portbench.harness import run_cell

LP = '''"""maximize b'y s.t. c - A y >= 0 (LinearCone), A (k, m) uniform in
(-1, 1), c in (0.5, 1.5) so y = 0 is strictly feasible, b = A'x0 for an
x0 > 0 so the program is bounded."""

import torch

from portbench.workload import chunk_seed

NUMBERS = ("unsolved", "infeas")


def make(config, seed, chunk, count, dtype, device):
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(chunk_seed(seed, chunk))
    A = torch.rand((count, config["k"], config["m"]), generator=gen, **f64) * 2 - 1
    c = torch.rand((count, config["k"]), generator=gen, **f64) + 0.5
    x0 = torch.rand((count, config["k"]), generator=gen, **f64) + 0.1
    b = torch.einsum("pkv,pk->pv", A, x0)
    return A.to(dtype), c.to(dtype), b.to(dtype)


def scenario_batch(data):
    from conex_tpu_torch.cones.lp import LinearCone

    A, c, b = data
    return (LinearCone(A=A, c=c),), (), b


def scenario_start(blocks, b, dtype, device):
    kw = dict(dtype=dtype, device=device)
    count = b.shape[0]
    scalars = dict(k=torch.zeros(count, **kw), b_scaling=torch.ones(count, **kw),
                   c_scaling=torch.ones(count, **kw))
    return tuple(blk.identity_state(dtype) for blk in blocks), scalars


def scenario_dual(res):
    return res.ws[0] / (res.k * res.b_scaling)[:, None]


def program(data, dtype, device):
    from conex_tpu_torch import Program

    A, c, b = data
    prog = Program(A.shape[1], dtype=dtype, device=device)
    prog.add_linear_constraint(A, c)
    return prog, b


def program_dual(prog):
    return prog.get_dual_variable(0)


def gap(data, x, y):
    _, c, b = (t.double() for t in data)
    by = (b * y.double()).sum(-1)
    return ((c * x.double()).sum(-1) - by).abs() / (1.0 + by.abs())


def sample(seed, final, plan):
    return []


def judge(config, traffic, chunk_size, answers, sample, device):
    total = solved = 0
    infeas = 0.0
    for a in answers:
        A, c, b = make(config, traffic["programs_seed"], a.chunk, chunk_size,
                       torch.float64, device)
        ix = slice(a.start, a.start + a.y.shape[0])
        A, c, b = A[ix], c[ix], b[ix]
        y, x = a.y.double(), a.dual.double()
        scale = 1.0 + b.abs().amax(-1)
        bad = torch.stack([
            torch.linalg.vector_norm(torch.einsum("pkv,pk->pv", A, x) - b, dim=-1) / scale,
            (-x.amin(-1)).clamp(min=0.0) / scale,
            (-(c - torch.einsum("pkv,pv->pk", A, y)).amin(-1)).clamp(min=0.0)]).amax(0)
        ok = a.solved & (gap((A, c, b), x, y) <= config["accuracy"]["relative_gap"])
        total += a.y.shape[0]
        solved += int(ok.sum())
        if ok.any():
            infeas = max(infeas, float(bad[ok].max()))
    return dict(unsolved=1.0 - solved / total, infeas=infeas)
'''

CONFIG = {"class": "lp_demo", "k": 12, "m": 4, "dtype": "float64",
          "solver": {"max_iterations": 60, "inv_sqrt_mu_max": 40000.0,
                     "prepare_dual_variables": True},
          "accuracy": {"relative_gap": 1e-7}}
TRAFFIC = {
    "scenarios": {"driver": "scenarios", "programs_seed": 0, "batch": 8, "pool": 2,
                  "check": {}},
    "program": {"driver": "program", "programs_seed": 0, "pool": 4, "chunk": 2,
                "check": {}},
}
LIMITS = {"unsolved": 0.01, "infeas": 1e-6}


def _tree():
    """Every file under portbench/ but bytecode, with a digest of its bytes."""
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in spec.PKG.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _run(tmp_path, driver, config=CONFIG):
    (tmp_path / "lp_demo.py").write_text(LP)
    bench = {"end_to_end": [e for e in spec.load_benchmark()["end_to_end"]], "per_layer": []}
    cell = {"name": f"lp_demo.{driver}", "config": "lp_demo", "traffic": driver, "chips": 1}
    return run_cell(bench, cell, 3_000_000_061, 0.3, False, "cpu", time.perf_counter(),
                    config=config, traffic=TRAFFIC[driver], limits=LIMITS,
                    problems=tmp_path)


@pytest.mark.parametrize("driver", sorted(TRAFFIC))
def test_a_sound_run_of_a_class_from_new_files_is_correct(tmp_path, driver):
    before = _tree()
    out, numbers = _run(tmp_path, driver)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == set(LIMITS) and list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"solved_per_s", "setup_s"}
    assert _tree() == before


@pytest.mark.parametrize("driver", sorted(TRAFFIC))
def test_an_answer_left_at_zero_is_not_correct_in_the_new_class(tmp_path, driver,
                                                                 monkeypatch):
    faults.plant("zero", monkeypatch.setattr)
    out, _ = _run(tmp_path, driver)
    assert not out["correct"]
    assert out["checks"]["infeas"]["value"] > LIMITS["infeas"]


def test_a_judge_that_leaves_out_a_number_fails_loudly(tmp_path):
    (tmp_path / "short.py").write_text(
        "NUMBERS = ('unsolved', 'infeas')\n"
        "def judge(config, traffic, chunk_size, answers, sample, device):\n"
        "    return dict(unsolved=0.0)\n")
    problem = spec.load_problem("short", tmp_path)
    with pytest.raises(ValueError, match="infeas"):
        check.judge(problem, {}, {}, 1, [], [], "cpu")
