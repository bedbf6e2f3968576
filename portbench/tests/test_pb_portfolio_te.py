"""The portfolio_te class and its plain reference, on the CPU at small
sizes: the generator, the program's structure at the benchmark portfolio,
a sound run judged correct, the control and each planted fault judged not
correct, the reference's refusal to judge without its certificate."""

import hashlib
import subprocess
import sys
import time

import pytest
import torch

from portbench import faults, spec
from portbench.harness import run_cell
from portbench.reference import portfolio_te as plain

BENCH = spec.load_benchmark()
CELL = spec.workload(BENCH, "portfolio_te_k10.socp_b64")
PROBLEM = spec.load_problem("portfolio_te")
SEED = 3_000_000_071
# sha256 over the bytes of F, D, mu and the tracking limit of chunk 1 of
# three programs at k = 2, n = 20, in float64 on the CPU: osqp_portfolio's
# draws.
DIGESTS = {0: "d1070c89cc02f2269ed9769f5bf61ba5d10ae461cb8f9dbc62bbf75d5ef084d4",
           3_000_000_061: "dbeba4fa2acaf1232137790b7fb0334a63e16df2f046a7bfe535d913524463a2"}


def _config(k=1, **kw):
    return dict(spec.load_config(CELL["config"]), k=k, n=100 * k, **kw)


def _traffic(batch=8):
    return dict(spec.load_traffic(CELL["traffic"]), batch=batch, pool=2)


def _run(seconds=0.3, seed=SEED, **kw):
    return run_cell(BENCH, CELL, seed, seconds, False, "cpu", time.perf_counter(),
                    config=_config(), traffic=_traffic(), **kw)[0]


def _failed(out):
    return {k for k, v in out["checks"].items() if not v["value"] <= v["limit"]}


@pytest.mark.parametrize("seed", sorted(DIGESTS))
def test_the_generator_makes_osqp_portfolios_draws(seed):
    config = dict(_config(), k=2, n=20)
    parts = PROBLEM.make(config, seed, 1, 3, torch.float64, "cpu")
    assert [tuple(t.shape) for t in parts] == [(3, 20, 2), (3, 20), (3, 20), (3,)]
    h = hashlib.sha256()
    for t in parts:
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == DIGESTS[seed]
    qp = spec.load_problem("osqp_portfolio").make(dict(config, gamma=1.0), seed, 1, 3,
                                                  torch.float64, "cpu")
    for a, b in zip(parts[:3], qp[:3]):
        assert torch.equal(a, b)
    assert parts[3].tolist() == [0.25] * 3


def test_the_benchmark_portfolio_touches_the_risk_cap_and_keeps_inside_the_rest():
    """At y_b = (x_b, F'x_b): the box and the rows hold, the total-risk
    cone's slack lies on its boundary (sigma = sigma_b), the tracking
    cone's is its apex (tau, 0); b'y is mu'x."""
    data = PROBLEM.make(_config(k=2), 0, 0, 2, torch.float64, "cpu")
    F, D, mu, tracking = data
    A_soc, c_soc, A_box, c_box, Aeq, beq, b = PROBLEM.port_data(data)
    n, k = 200, 2
    assert A_soc.shape == (2, 2, 1 + n + k, n + k) and c_box.shape == (2, 2 * n)
    cap = plain.caps(F, D, tracking)
    y = torch.cat([cap.x_b, cap.f_b], dim=1)
    assert torch.allclose((Aeq @ y[..., None])[..., 0], beq, atol=1e-14)
    assert bool(((c_box - (A_box @ y[..., None])[..., 0]) > 0).all())
    s = c_soc - torch.einsum("sbrv,sv->sbr", A_soc, y)
    head, tail = s[..., 0], s[..., 1:].norm(dim=-1)
    assert torch.allclose(head[:, 0], tail[:, 0], rtol=1e-13)
    assert torch.allclose(head[:, 1], 0.25 * cap.sigma) and float(tail[:, 1].max()) <= 1e-15
    assert torch.allclose((b * y).sum(1), plain.objective(mu, y), rtol=1e-14)


def test_an_uncertified_reference_refuses_to_judge(monkeypatch):
    data = PROBLEM.make(_config(), 0, 0, 2, torch.float64, "cpu")
    solve = plain.solve_plain
    monkeypatch.setattr(plain, "solve_plain", lambda *a: solve(*a, max_iterations=3))
    monkeypatch.setattr(PROBLEM, "_OPTIMA", type(PROBLEM._OPTIMA)())
    with pytest.raises(ValueError, match="does not certify"):
        PROBLEM.optimum(data)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 16 and out["attempted"] % 16 == 0
    assert set(out["checks"]) == set(PROBLEM.NUMBERS) == set(spec.load_limits(CELL["name"]))
    assert out["checks"]["soc"]["value"] > 0 and out["checks"]["ldlt"]["value"] > 0


def test_the_float32_control_is_not_correct():
    out = _run(dtype="float32")
    assert not out["correct"]
    assert "unsolved" in _failed(out)


@pytest.mark.parametrize("fault", ["zero", "rows"])
def test_a_planted_answer_fault_is_not_correct_by_the_unsolved_share(monkeypatch, fault):
    faults.plant(fault, monkeypatch.setattr)
    out = _run()
    assert out["failed"] >= 1 and _failed(out) == {"unsolved"}


def without_det(monkeypatch):
    """SOCCone.schur with the det(w) R term of Q(w) left out: Q(w) y = 2
    <w, y> w."""
    from conex_tpu_torch.algebra import spin
    from conex_tpu_torch.cones import soc

    schur = soc.SOCCone.schur

    def faulty(self, w):
        keep = spin.quadratic_representation
        spin.quadratic_representation = lambda x, y: 2.0 * (x * y).sum(-1, keepdim=True) * x
        try:
            return schur(self, w)
        finally:
            spin.quadratic_representation = keep

    monkeypatch.setattr(soc.SOCCone, "schur", faulty)


def test_a_schur_block_without_the_det_term_is_not_correct(monkeypatch):
    without_det(monkeypatch)
    out = _run()
    assert not out["correct"] and "unsolved" in _failed(out)


def test_the_soc_number_alone_catches_the_fault_in_the_sampled_block(monkeypatch):
    """The fault planted in the check's sample alone, after a sound
    window: only soc sees it."""
    sample = PROBLEM.sample

    def planted(seed, final, plan):
        with pytest.MonkeyPatch.context() as mp:
            without_det(mp)
            return sample(seed, final, plan)

    monkeypatch.setattr(spec, "problem_of", lambda config, directory=None: PROBLEM)
    monkeypatch.setattr(PROBLEM, "sample", planted)
    out = _run()
    assert _failed(out) >= {"soc"} and "unsolved" not in _failed(out)
    assert out["checks"]["soc"]["value"] > 1e-6


def test_every_seed_solves_whole_cycles_of_the_same_programs():
    outs = [_run(seed=seed) for seed in (SEED, 2**31 + 7)]
    for out in outs:
        assert out["attempted"] % 16 == 0 and out["correct"]
    assert outs[0]["checks"]["unsolved"] == outs[1]["checks"]["unsolved"]
    assert outs[0]["checks"]["infeas"] == outs[1]["checks"]["infeas"]


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys\n"
            "import portbench.reference.portfolio_te\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'conex_tpu', 'conex_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
