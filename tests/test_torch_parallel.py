"""The port's multi-device entry points (conex_tpu_torch/parallel/sharded.py)
against conex_tpu, in f64 on the CPU: the twin of tests/test_parallel.py.

The port runs in a gloo group of R = 2, 4 and 8 spawned ranks on the CPU
(``launch.run_ranks``: spawn, a FileStore rendezvous, one thread per rank,
a bounded wait; tests/torch_rank_cases.py is the rank side), once per R
for the whole module.  JAX runs in this process, single-device
(``solve_compiled``, once per case) and sharded over a virtual mesh of R CPU devices
(tests/conftest.py gives 8).  Each case is held to both, within the JAX
tests' own tolerances for sharded against single-device runs:
``assert_allclose`` with atol 1e-9 on y and 1e-6 on the final iterate w
(and its default rtol 1e-7).  The ranks' results must be equal to the bit:
everything a rank returns is replicated after its last reduction.

The equality case holds the replicated equality rows: every rank adds them
before the sum all-reduce, so they are counted R times, in both packages
(conex_tpu/solver/loop.py:160-183).  The scaled row is the same constraint
and y stays that of the single-device solve, to 1e-9 on both sides.  The
final iterate moves: JAX's sharded w is 2.9e-6, 1.4e-5 and 6.0e-5 of its
largest entry from its single-device w at R = 2, 4 and 8 on this instance
(and the port's single-device w 6.6e-9 from JAX's), so w is held there to
1e-4 of its largest entry.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from conex_tpu import SolverConfig as JConfig
from conex_tpu.cones.equality import EqualityBlock as JEq
from conex_tpu.cones.lp import LinearCone as JLinear
from conex_tpu.cones.psd import DenseLMICone as JCone
from conex_tpu.cones.psd import make_psd_state as jstate
from conex_tpu.parallel import sharded as jsharded
from conex_tpu.solver.loop import solve_compiled

import conex_tpu_torch as ct
from conex_tpu_torch.parallel import collectives, launch
from conex_tpu_torch.parallel import sharded as tsharded

import torch_rank_cases
from test_parallel import _sdp_batch

RANKS = (2, 4, 8)
# Seconds for one spawn of R ranks to run every case: a few seconds here.
RANK_TIMEOUT = 240.0


def _data():
    d = {"cone": _sdp_batch(np.random.default_rng(0), 8, 6, 4)}
    rng = np.random.default_rng(3)
    A, C, b = _sdp_batch(rng, 8, 5, 4)
    Aeq = rng.uniform(-1, 1, (1, 4))
    beq = Aeq @ (0.05 * rng.uniform(-1, 1, 4))
    d["cone_eq"] = (A, C, b + Aeq.T @ rng.uniform(-1, 1, 1), Aeq, beq)
    # A box |y_i| <= 1 and two random rows: 8 rows, bounded and strictly
    # feasible at y = 0.
    rng = np.random.default_rng(5)
    A = np.vstack([np.eye(3), -np.eye(3), rng.uniform(-1, 1, (2, 3))])
    d["lp"] = (A, np.concatenate([np.ones(6), [0.5, 0.5]]), rng.uniform(-1, 1, 3))
    rng = np.random.default_rng(1)
    d["scenarios"] = tuple(map(np.stack, zip(*[_sdp_batch(rng, 2, 5, 3)
                                               for _ in range(8)])))
    rng = np.random.default_rng(2)
    d["grid"] = tuple(map(np.stack, zip(*[_sdp_batch(rng, 4, 5, 3) for _ in range(2)])))
    d["indivisible"] = _sdp_batch(np.random.default_rng(4), 3, 4, 2)
    return d


DATA = _data()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, per R: one spawn per R for the module."""
    return {R: launch.run_ranks(torch_rank_cases.parallel_cases, R, (DATA,),
                                workdir=tmp_path_factory.mktemp(f"ranks{R}"),
                                timeout=RANK_TIMEOUT)
            for R in RANKS}


def _scalars(shape=()):
    return dict(k=jnp.zeros(shape, jnp.float64), b_scaling=jnp.ones(shape, jnp.float64),
                c_scaling=jnp.ones(shape, jnp.float64))


def _mesh(R, shape=None, names=("tp",)):
    devs = np.asarray(jax.devices()[:R])
    return Mesh(devs.reshape(shape or (R,)), names)


def jsolve(blocks, eq_blocks, b, init_ws, init_scalars, config):
    return solve_compiled(blocks, eq_blocks, b, init_ws, init_scalars, config)


@functools.cache
def _single(case, s=None):
    """JAX's single-device solve of ``case`` (scenario ``s``), made once."""
    if case == "cone_eq":
        A, C, b, Aeq, beq = DATA[case]
        eqs = (JEq(A=jnp.asarray(Aeq), b=jnp.asarray(beq)),)
        config = JConfig(max_iterations=60, kkt_solver=ct.KKT_SOLVER_LDLT)
    elif case == "lp":
        return jsolve(*_lp_args())
    else:
        A, C, b = (x if s is None else x[s] for x in DATA[case])
        eqs = ()
        config = JConfig(max_iterations=25 if case == "grid" else 30)
    blk = JCone(A=jnp.asarray(A), C=jnp.asarray(C))
    return jsolve((blk,), eqs, jnp.asarray(b), (blk.identity_state(jnp.float64),),
                  _scalars(), config)


def _lp_args():
    A, c, b = DATA["lp"]
    blk = JLinear(A=jnp.asarray(A), c=jnp.asarray(c))
    return ((blk,), (), jnp.asarray(b), (blk.identity_state(jnp.float64),), _scalars(),
            JConfig(max_iterations=40, enable_line_search=True, prepare_dual_variables=True))


def _one(case, ranks, R):
    """Rank 0's result of ``case``, after checking that every rank's is
    the same to the bit."""
    out = [r[case] for r in ranks[R]]
    for other in out[1:]:
        for key, value in out[0].items():
            np.testing.assert_array_equal(other[key], value)
    return out[0]


def _hold(got, want, y_atol=1e-9, w_atol=1e-6):
    np.testing.assert_array_equal(got["solved"], np.asarray(want.solved))
    np.testing.assert_allclose(got["y"], np.asarray(want.y), atol=y_atol)
    w = want.ws[0].w if hasattr(want.ws[0], "w") else want.ws[0]
    np.testing.assert_allclose(got["w"], np.asarray(w), atol=w_atol)


@pytest.mark.parametrize("R", RANKS)
def test_cone_sharded_matches_single_device(ranks, R):
    A, C, b = DATA["cone"]
    blk = JCone(A=jnp.asarray(A), C=jnp.asarray(C))
    args = ((blk,), (), jnp.asarray(b), (blk.identity_state(jnp.float64),), _scalars(),
            JConfig(max_iterations=30))
    got = _one("cone", ranks, R)
    _hold(got, _single("cone"))
    _hold(got, jsharded.solve_cone_sharded(*args, _mesh(R)))


@pytest.mark.parametrize("R", RANKS)
def test_cone_sharded_with_a_replicated_equality_block(ranks, R):
    A, C, b, Aeq, beq = DATA["cone_eq"]
    blk = JCone(A=jnp.asarray(A), C=jnp.asarray(C))
    eq = JEq(A=jnp.asarray(Aeq), b=jnp.asarray(beq))
    args = ((blk,), (eq,), jnp.asarray(b), (blk.identity_state(jnp.float64),),
            _scalars(), JConfig(max_iterations=60, kkt_solver=ct.KKT_SOLVER_LDLT))
    got = _one("cone_eq", ranks, R)
    assert got["solved"]
    single, sharded = _single("cone_eq"), jsharded.solve_cone_sharded(*args, _mesh(R))
    w_atol = 1e-4 * np.abs(np.asarray(single.ws[0].w)).max()
    _hold(got, single, w_atol=w_atol)
    _hold(got, sharded, w_atol=w_atol)
    np.testing.assert_allclose(np.asarray(sharded.y), np.asarray(single.y), atol=1e-9)
    # y meets the equality row.
    assert abs(Aeq @ got["y"] - beq)[0] < 1e-7


@pytest.mark.parametrize("R", RANKS)
def test_cone_sharded_lp_with_line_search_and_dual_recovery(ranks, R):
    """The line search's max, min and fail reductions and the dual
    recovery's assemble, factor and solve under the group; w is the
    recovered dual of the sharded rows."""
    got = _one("lp", ranks, R)
    assert got["solved"]
    _hold(got, _single("lp"))
    _hold(got, jsharded.solve_cone_sharded(*_lp_args(), _mesh(R)))


@pytest.mark.parametrize("R", RANKS)
def test_scenarios_match_loop(ranks, R):
    A, C, b = DATA["scenarios"]
    S, B, n = C.shape[:3]
    config = JConfig(max_iterations=30)
    got = _one("scenarios", ranks, R)
    blk = JCone(A=jnp.asarray(A), C=jnp.asarray(C))
    init_ws = (jstate(jnp.broadcast_to(jnp.eye(n), (S, B, n, n))),)
    sharded = jsharded.solve_scenarios((blk,), (), jnp.asarray(b), init_ws,
                                       _scalars((S,)), config,
                                       mesh=_mesh(R, names=("dp",)), axis="dp")
    np.testing.assert_allclose(got["y"], np.asarray(sharded.y), atol=1e-9)
    np.testing.assert_allclose(got["w"], np.asarray(sharded.ws[0].w), atol=1e-6)
    for s in range(S):
        res_s = _single("scenarios", s)
        np.testing.assert_allclose(got["y"][s], np.asarray(res_s.y), atol=1e-9)
        assert bool(got["solved"][s]) == bool(res_s.solved)
        assert got["num_iterations"][s] == int(res_s.num_iterations)


@pytest.mark.parametrize("R", RANKS)
def test_scenarios_cone_sharded_2d(ranks, R):
    A, C, b = DATA["grid"]
    S, B, n = C.shape[:3]
    config = JConfig(max_iterations=25)
    got = _one("grid", ranks, R)
    blk = JCone(A=jnp.asarray(A), C=jnp.asarray(C))
    init_ws = (jstate(jnp.broadcast_to(jnp.eye(n), (S, B, n, n))),)
    sharded = jsharded.solve_scenarios_cone_sharded(
        (blk,), (), jnp.asarray(b), init_ws, _scalars((S,)), config,
        _mesh(R, (2, R // 2), ("dp", "tp")), total_rank=B * n)
    np.testing.assert_allclose(got["y"], np.asarray(sharded.y), atol=1e-9)
    np.testing.assert_allclose(got["w"], np.asarray(sharded.ws[0].w), atol=1e-6)
    for s in range(S):
        np.testing.assert_allclose(got["y"][s], np.asarray(_single("grid", s).y), atol=1e-9)


@pytest.mark.parametrize("R", RANKS)
def test_the_shard_index_is_the_rank_in_the_axis_group(ranks, R):
    """A rank's coordinate on a mesh axis (``get_local_rank``, which picks
    its shard) is its rank in the axis's group (which picks its cliques in
    supernodal/distributed.py), on the 1D and the 2D mesh."""
    coords = [r["coordinates"] for r in ranks[R]]
    for rank, per_axis in enumerate(coords):
        for local, in_group in per_axis:
            assert local == in_group
        assert per_axis[0][0] == rank
        assert (per_axis[1][0], per_axis[2][0]) == divmod(rank, R // 2)


@pytest.mark.parametrize("R", RANKS)
def test_a_cone_axis_that_does_not_divide_raises(ranks, R):
    for r in ranks[R]:
        assert r["indivisible"] is not None and "does not divide" in r["indivisible"]


@pytest.mark.parametrize("R", RANKS)
def test_the_reductions(ranks, R):
    for r in ranks[R]:
        red = r["reductions"]
        np.testing.assert_array_equal(red["sum"], [R * (R + 1) / 2, -R * (R - 1) / 2])
        np.testing.assert_array_equal(red["isum"], [R * (R - 1) // 2])
        np.testing.assert_array_equal(red["max"], [R, 0.0])
        np.testing.assert_array_equal(red["min"], [1.0, -(R - 1)])
        np.testing.assert_array_equal(red["any"], [True, False])


def test_without_a_group_the_reductions_are_the_identity():
    x = torch.arange(3.0)
    assert collectives.psum((x,), None)[0] is x
    assert collectives.pmax(x, None) is x and collectives.pmin(x, None) is x
    assert collectives.axis_index(None) == 0 and collectives.axis_size(None) == 1


def test_a_mesh_must_be_a_device_mesh():
    A, C, b = DATA["indivisible"]
    blk = ct.DenseLMICone(A=torch.as_tensor(A)[None], C=torch.as_tensor(C)[None])
    args = ((blk,), (), torch.as_tensor(b)[None],
            (torch_rank_cases._psd_states(4, 1, 3)),
            torch_rank_cases.scalars(1), ct.SolverConfig())
    for call in (lambda: tsharded.solve_scenarios(*args, mesh=object()),
                 lambda: tsharded.solve_cone_sharded(*args, object()),
                 lambda: tsharded.solve_scenarios_cone_sharded(*args, object(), 8.0)):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()


def test_a_failing_rank_fails_the_run(tmp_path):
    """Its error comes back at once and the rank still running is
    stopped."""
    with pytest.raises(Exception, match="fails on purpose"):
        launch.run_ranks(torch_rank_cases.failing_rank, 2, workdir=tmp_path,
                         timeout=RANK_TIMEOUT)


def test_a_hung_rank_is_killed_at_the_timeout(tmp_path):
    with pytest.raises(TimeoutError):
        launch.run_ranks(torch_rank_cases.hung_rank, 2, workdir=tmp_path, timeout=5.0)
