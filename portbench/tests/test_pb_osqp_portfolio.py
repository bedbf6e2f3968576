"""The osqp_portfolio class and its plain reference, on the CPU at small
sizes: the generator, the program's structure, the reference's optimum
against an exact active-set solve, the reference's LDLT against the
port's, a sound run judged correct and the control and each planted fault
judged not correct, the three LDLT readers."""

import hashlib
import subprocess
import sys
import time

import pytest
import torch

from portbench import faults, phases, spec
from portbench.harness import run_cell
from portbench.reference import portfolio_qp as plain

BENCH = spec.load_benchmark()
CELL = spec.workload(BENCH, "osqp_portfolio_k10.qp_b64")
PROBLEM = spec.load_problem("osqp_portfolio")
SEED = 3_000_000_067
# sha256 over the bytes of F, D, mu and gamma of chunk 1 of three programs
# at k = 2, n = 20, in float64 on the CPU.
DIGESTS = {0: "f94a2b39f9d515a3d9661086f13fc4264adad030bfaae58f6234fececc8301eb",
           3_000_000_061: "3eb00a5efb4429718779f31c31af8ff6c832c4f181f78119ebd12a9a7f8e4b1b"}


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
def test_the_generator_makes_the_same_programs(seed):
    config = dict(_config(), k=2, n=20)
    parts = PROBLEM.make(config, seed, 1, 3, torch.float64, "cpu")
    assert [tuple(t.shape) for t in parts] == [(3, 20, 2), (3, 20), (3, 20), (3,)]
    h = hashlib.sha256()
    for t in parts:
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == DIGESTS[seed]
    F, D, _, gamma = parts
    assert (F != 0).sum((1, 2)).tolist() == [20, 20, 20]  # half of n k
    assert bool((D >= 0).all() and (D <= 2 ** 0.5).all()) and gamma.tolist() == [1.0] * 3


def test_the_programs_structure_is_the_box_the_factor_link_and_the_budget():
    """In conex's form: 1/2 y'Qy - b'y is the objective, c - A y >= 0 is
    the box, Aeq y = beq holds exactly for f = F'x and 1'x = 1."""
    data = PROBLEM.make(_config(k=2), 0, 0, 2, torch.float64, "cpu")
    F, D, mu, gamma = data
    Q, A, c, Aeq, beq, b = PROBLEM.port_data(data)
    n, k = 200, 2
    x = torch.rand((2, n), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    x = x / x.sum(1, keepdim=True)
    y = torch.cat([x, (F.transpose(1, 2) @ x[..., None])[..., 0]], dim=1)
    assert torch.allclose((Aeq @ y[..., None])[..., 0], beq, atol=1e-14)
    assert bool(((c - (A @ y[..., None])[..., 0]) >= 0).all())
    assert A.shape == (2, 2 * n, n + k) and Aeq.shape == (2, k + 1, n + k)
    out = y.clone()
    out[:, 0] = 1.5
    assert bool(((c - (A @ out[..., None])[..., 0]) < 0).any(1).all())
    out[:, 0] = -0.5
    assert bool(((c - (A @ out[..., None])[..., 0]) < 0).any(1).all())
    cost = 0.5 * (y[:, None, :] @ Q @ y[..., None])[:, 0, 0] - (b * y).sum(1)
    assert torch.allclose(cost, plain.objective(D, mu, gamma, y), rtol=1e-13)


def _active_set(F, D, mu, gamma, x, tol=1e-7):
    """The exact optimum on the active set read off x: x_i = 0 or 1 where
    x is within tol of a bound, the equality-constrained QP solved on the
    rest, and the bound multipliers its stationarity gives.  Where no
    asset is free the budget row holds by the fixed ones, and its
    multiplier is the least that keeps the upper bounds' nonnegative."""
    n, k = F.shape
    lo, hi = x < tol, x > 1 - tol
    E, e = plain.rows(F[None])
    E, e = E[0], e[0]
    H = torch.cat([2 * D, torch.full((k,), 2.0, dtype=torch.float64)])
    g = torch.cat([-mu / gamma, torch.zeros(k, dtype=torch.float64)])
    keep = torch.cat([~(lo | hi), torch.ones(k, dtype=torch.bool)])
    fixed = torch.cat([hi.double(), torch.zeros(k, dtype=torch.float64)])
    used = E[:, keep].abs().sum(1) > 0
    Ek = E[used][:, keep]
    p, r = int(keep.sum()), int(used.sum())
    K = torch.zeros((p + r, p + r), dtype=torch.float64)
    K[:p, :p] = torch.diag(H[keep])
    K[:p, p:] = -Ek.T
    K[p:, :p] = Ek
    rhs = torch.cat([-g[keep], (e - E @ fixed)[used]])
    sol = torch.linalg.solve(K, rhs)
    v = fixed.clone()
    v[keep] = sol[:p]
    lam = torch.zeros(k + 1, dtype=torch.float64)
    lam[used] = sol[p:]
    assert float((E @ v - e).abs().max()) <= 1e-12
    grad = (H * v + g - E.T @ lam)[:n]
    if not bool(used[k]):
        lam_b = grad[hi].max() if hi.any() else grad[lo].min()
        grad = grad - lam_b
    return v, grad[lo], -grad[hi]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_reference_finds_the_exact_optimum(seed):
    """At k = 1: the reference certifies its answers, and each equals the
    exact optimum of the active set it reads off (the free assets inside
    the box, the bound multipliers of the others nonnegative) to 1e-8,
    its objective to 1e-12; seed 0 holds an asset at its upper bound."""
    F, D, mu, gamma = PROBLEM.make(_config(), seed, 0, 3, torch.float64, "cpu")
    opt = plain.solve_plain(F, D, mu, gamma)
    assert bool(opt.certified.all())
    assert float(opt.gap.max()) <= plain.GAP_BAR
    uppers = 0
    for p in range(3):
        x = opt.v[p, :100]
        v, z_lo, z_hi = _active_set(F[p], D[p], mu[p], gamma[p], x)
        assert bool((v[:100] >= -1e-12).all() and (v[:100] <= 1 + 1e-12).all())
        assert bool((z_lo >= -1e-9).all() and (z_hi >= -1e-9).all())
        assert float((v - opt.v[p]).abs().max()) <= 1e-8
        exact = plain.objective(D[p], mu[p], gamma[p], v)
        assert abs(float(exact - opt.objective[p])) <= 1e-12 * (1 + abs(float(exact)))
        uppers += int((x > 1 - 1e-7).sum())
    assert uppers >= 1 or seed != 0


def test_an_uncertified_reference_refuses_to_judge(monkeypatch):
    """A reference stopped after two iterations lacks its certificate:
    the judge raises, and judges nothing."""
    data = PROBLEM.make(_config(), 0, 0, 2, torch.float64, "cpu")
    assert not bool(plain.solve_plain(*data, max_iterations=2).certified.any())
    solve = plain.solve_plain
    monkeypatch.setattr(plain, "solve_plain", lambda *a: solve(*a, max_iterations=2))
    monkeypatch.setattr(PROBLEM, "_OPTIMA", type(PROBLEM._OPTIMA)())
    with pytest.raises(ValueError, match="does not certify"):
        PROBLEM.optimum(data)


def _kkt(N_case):
    """A portfolio KKT matrix at a random box iterate (k = 1, N = 103; k =
    3, N = 307), or at N = 103 the same with its first pivot at 1e-12,
    clamped to 1e-9 by both."""
    k = 1 if N_case in (103, "103-clamped") else 3
    F, D, _, _ = PROBLEM.make(_config(k=k), 5, 0, 2, torch.float64, "cpu")
    w = torch.rand((2, 200 * k), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(k)) * 3 + 0.1
    K = plain.assemble_plain(F, D, w)
    if N_case == "103-clamped":
        K[:, 0, 0] = 1e-12
    return K


@pytest.mark.parametrize("case", [103, "103-clamped", 307])
def test_the_plain_ldlt_agrees_with_the_ports(case):
    from conex_tpu_torch.solver import kkt

    K = _kkt(case)
    M, fail = kkt._ldlt_clamped(K)
    L, d = plain.ldlt_plain(K)
    assert not bool(fail.any())
    if case == "103-clamped":
        assert d[:, 0].tolist() == [plain.PIVOT_CLAMP] * 2
        assert torch.diagonal(M, dim1=1, dim2=2)[:, 0].tolist() == [kkt.LDLT_PIVOT_CLAMP] * 2
    # The clamped pivot grows L's first column by 1e9 over the entries it
    # eliminates, and the two orders of summation part by that much more.
    bar = 1e-10 if case == "103-clamped" else 1e-13
    for s in range(2):
        assert PROBLEM.factor_error(M[s], L[s], d[s]) <= bar
    recon = L @ torch.diag_embed(d) @ L.transpose(1, 2)
    if case != "103-clamped":
        assert float((recon - K).abs().max()) <= 1e-12 * float(K.abs().max())


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 16 and out["attempted"] % 16 == 0
    assert set(out["checks"]) == set(PROBLEM.NUMBERS) == set(spec.load_limits(CELL["name"]))
    assert out["checks"]["ldlt"]["value"] > 0


def test_the_float32_control_is_not_correct():
    out = _run(dtype="float32")
    assert not out["correct"]
    assert {"unsolved", "ldlt"} <= _failed(out)


def test_an_answer_left_at_zero_is_not_correct_by_the_unsolved_share(monkeypatch):
    faults.plant("zero", monkeypatch.setattr)
    out = _run()
    assert _failed(out) == {"unsolved"} and out["checks"]["unsolved"]["value"] == 1.0


def test_one_program_in_16_altered_is_not_correct_by_the_unsolved_share(monkeypatch):
    faults.plant("rows", monkeypatch.setattr)
    out = _run()
    assert out["failed"] >= 1 and _failed(out) == {"unsolved"}


def _without_one_update(K, panel=32):
    """The port's blocked LDLT with the first panel's trailing update left
    out."""
    from conex_tpu_torch.solver import kkt

    M = K.clone()
    n = K.shape[-1]
    for j0 in range(0, n, panel):
        j1 = min(j0 + panel, n)
        kkt._factor_columns(M, j0, j1)
        if j1 == n:
            break
        L11 = torch.tril(M[:, j0:j1, j0:j1], -1)
        d = torch.diagonal(M[:, j0:j1, j0:j1], dim1=-2, dim2=-1)
        X = torch.linalg.solve_triangular(L11, M[:, j1:, j0:j1].transpose(-2, -1),
                                          upper=False, unitriangular=True).transpose(-2, -1)
        L21 = X / d[:, None, :]
        M[:, j1:, j0:j1] = L21
        if j0 > 0:
            M[:, j1:, j1:] -= (L21 * d[:, None, :]) @ L21.transpose(-2, -1)
    return M, ~torch.isfinite(M).all(dim=(-2, -1))


def test_a_factor_without_one_panel_update_is_not_correct_by_its_ldlt(monkeypatch):
    from conex_tpu_torch.solver import kkt

    monkeypatch.setattr(kkt, "_ldlt_clamped", _without_one_update)
    out = _run()
    assert not out["correct"] and "ldlt" in _failed(out)
    assert out["checks"]["ldlt"]["value"] > 1e-3


def test_every_seed_solves_whole_cycles_of_the_same_programs():
    outs = [_run(seed=seed) for seed in (SEED, 2**31 + 7)]
    for out in outs:
        assert out["attempted"] % 16 == 0 and out["correct"]
    assert outs[0]["checks"]["unsolved"] == outs[1]["checks"]["unsolved"]
    assert outs[0]["checks"]["infeas"] == outs[1]["checks"]["infeas"]


class _Ctx:
    cell = {"name": "pb-test.osqp_portfolio"}
    config = {"n": 1000, "k": 10}
    traffic = {"batch": 64}
    device = torch.device("cuda")
    dtype = "float64"
    kind = "NVIDIA H100 80GB HBM3"

    def note(self, text):
        pass


def _read(monkeypatch, rows, counters):
    monkeypatch.setitem(phases._DONE, _Ctx.cell["name"],
                        phases.Phases(window_s=2.0, busy_s=1.0, rows=rows, counters=counters))
    return {name: spec.load_metric(name).read(_Ctx())
            for name in ("ldlt_idle_pct", "ldlt_launches_per_factor", "ldlt_roofline_pct")}


def test_the_ldlt_readers(monkeypatch):
    rows = {"conex.solve": phases.Row(), "conex.ldlt": phases.Row(1, 0.1, 0.1, 0.3, 9000),
            "conex.ldlt.update": phases.Row(7, 0.01, 0.1, 0.1, 1000)}
    got = _read(monkeypatch, rows, {"kkt.ldlt.calls": 2})
    assert got["ldlt_idle_pct"] == pytest.approx(100 * 0.4 / 2.0)
    assert got["ldlt_launches_per_factor"] == 5000
    N = 1021
    least = 64 * N**3 / 3 / 67e12  # operations bound it: 1.45 GB take 0.43 ms
    assert got["ldlt_roofline_pct"] == pytest.approx(100 * least / (0.6 / 2))


def test_the_ldlt_readers_read_nothing_from_a_port_without_the_spans(monkeypatch):
    got = _read(monkeypatch, {"conex.solve": phases.Row(), "conex.factor": phases.Row()},
                {"loop.passes": 3})
    assert got == dict.fromkeys(got)


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys\n"
            "import portbench.reference.portfolio_qp\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'conex_tpu', 'conex_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
