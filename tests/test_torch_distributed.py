"""The port's distributed supernodal factorizations
(conex_tpu_torch/supernodal/distributed.py and dist_compressed.py) against
conex_tpu, in f64 on the CPU: the twin of tests/test_distributed.py and
tests/test_dist_compressed.py, parametrized over the two structures.

The host side is a copy and must come out equal: the structures tuple for
tuple, ``padded_arrays`` and the compressed ``_device_arrays`` array for
array.  The factorizations run in a gloo group of R = 2, 4 and 8 spawned
ranks on the CPU, once per R for the module (tests/torch_rank_cases.py is
the rank side); JAX runs in this process under ``shard_map`` over a
virtual mesh of R CPU devices.  Tolerances are the JAX tests' own: the
chains 1e-9 (the LDLT 1e-7) against numpy's dense solve and against JAX's
distributed solve, the full cone-sharded solve with a distributed KKT
1e-8 in y against JAX's single-device and distributed solves.  Every
rank's result must be equal to the bit: the solution is all-reduced.
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
from conex_tpu.cones.soc import SOCCone as JSOC
from conex_tpu.parallel.sharded import solve_cone_sharded as jsolve_sharded
from conex_tpu.solver.loop import _solve_impl as jsolve
from conex_tpu.supernodal import dist_compressed as jdc
from conex_tpu.supernodal import distributed as jdist
from conex_tpu.supernodal.solver import SupernodalStructure as JStructure

from conex_tpu_torch.config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT
from conex_tpu_torch.parallel import launch
from conex_tpu_torch.solver import kkt as tkkt
from conex_tpu_torch.supernodal import compressed as tcompressed
from conex_tpu_torch.supernodal import dist_compressed as tdc
from conex_tpu_torch.supernodal import distributed as tdist

import torch_rank_cases
from test_dist_compressed import run_dist_compressed
from test_distributed import chain_cliques, random_clique_spd, run_distributed

RANKS = (2, 4, 8)
KINDS = ("distributed", "dist_compressed")
RANK_TIMEOUT = 240.0
JAX_STRUCTURES = {"distributed": jdist.DistributedSupernodalStructure,
                  "dist_compressed": jdc.DistributedCompressedStructure}
PORT_STRUCTURES = torch_rank_cases.STRUCTURES
JAX_RUN = {"distributed": run_distributed, "dist_compressed": run_dist_compressed}


def star_cliques():
    """Five chains of six cliques meeting at the hub variable 0."""
    cliques, v = [], 1
    for _ in range(5):
        prev = 0
        for _ in range(6):
            cliques.append([prev, v, v + 1])
            prev = v + 1
            v += 2
    return cliques, v


def _chain_case(cliques, n, seed, mode=KKT_SOLVER_LLT, flip=(), negative=False):
    rng = np.random.default_rng(seed)
    if negative:
        return cliques, n, -np.eye(n), np.zeros(n), mode
    G = random_clique_spd(cliques, n, rng)
    for v in flip:
        G[v, v] = -G[v, v]
    return cliques, n, G, rng.normal(size=n), mode


def soc_chain():
    """tests/test_distributed.py's sparse SOC chain: 10 blocks of 8
    Lorentz cones of dimension 4 on the variables {i, i+1, i+2}."""
    rng = np.random.default_rng(7)
    n_blocks, B, dim = 10, 8, 3
    num_vars = n_blocks + 2
    As, cs, vars_, cliques = [], [], [], []
    for i in range(n_blocks):
        v = (i, i + 1, i + 2)
        A = rng.uniform(-1, 1, (B, dim + 1, len(v)))
        x0 = np.concatenate([np.full((B, 1), 2.0), rng.uniform(-0.5, 0.5, (B, dim))], axis=1)
        As.append(A)
        cs.append(np.einsum("bkv->bk", 0 * A) + x0)
        vars_.append(v)
        cliques.append(list(v))
    b = np.zeros(num_vars)
    for A, v in zip(As, vars_):
        e = np.zeros((B, dim + 1))
        e[:, 0] = 1.0
        contrib = np.einsum("bkv,bk->v", A, e)
        for j, var in enumerate(v):
            b[var] += 0.5 * contrib[j]
    return As, cs, vars_, b, cliques


def _data(R):
    chains = {"chain24": _chain_case(*chain_cliques(24), 0)}
    if R == 4:
        chains["star"] = _chain_case(*star_cliques(), 1)
        chains["ldlt"] = _chain_case(*chain_cliques(20), 2, KKT_SOLVER_LDLT, flip=(5, 17, 33))
        chains["fail"] = _chain_case(*chain_cliques(8), 0, negative=True)
    data = {"chains": chains}
    if R == 8:
        chains["tiny"] = _chain_case(*chain_cliques(3), 3)
        data["soc_chain"] = soc_chain()
    return data


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {R: launch.run_ranks(torch_rank_cases.distributed_cases, R, (_data(R),),
                                workdir=tmp_path_factory.mktemp(f"ranks{R}"),
                                timeout=RANK_TIMEOUT)
            for R in RANKS}


def _one(ranks, R, key):
    out = [r[key] for r in ranks[R]]
    for other in out[1:]:
        for name, value in out[0].items():
            np.testing.assert_array_equal(other[name], value)
    return out[0]


def _check_chain(ranks, R, name, kind, atol=1e-9):
    cliques, n, G, b, mode = _data(R)["chains"][name]
    got = _one(ranks, R, (name, kind))
    assert not got["fail"] and not got["fail_kkt"]
    want = np.linalg.solve(G, b)
    np.testing.assert_allclose(got["x"], want, atol=atol)
    np.testing.assert_allclose(got["x_kkt"], want, atol=atol)
    ds = JAX_STRUCTURES[kind].from_cliques(cliques, n, R)
    x, fail = JAX_RUN[kind](G, b, ds, "llt" if mode == KKT_SOLVER_LLT else "ldlt", R)
    assert not fail
    np.testing.assert_allclose(got["x"], x, atol=atol)


# ---------------------------------------------------------------------------
# The host side: equal to the JAX package's
# ---------------------------------------------------------------------------

PATTERNS = {
    "chain24": (chain_cliques(24), None),
    "star": (star_cliques(), None),
    "tiny": (chain_cliques(3), None),
    "chain16_leaves": (chain_cliques(16), [i % 2 for i in range(16)]),
}


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("kind", KINDS)
def test_structure_equals_jax(kind, R):
    for (cliques, n), valid_leaf in PATTERNS.values():
        got = PORT_STRUCTURES[kind].from_cliques(cliques, n, R, valid_leaf=valid_leaf)
        want = JAX_STRUCTURES[kind].from_cliques(cliques, n, R, valid_leaf=valid_leaf)
        assert tuple(got) == tuple(want)


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("kind", KINDS)
def test_index_arrays_equal_jax(kind, R):
    """distributed: ``padded_arrays``; dist_compressed: ``_device_arrays``."""
    for (cliques, n), valid_leaf in PATTERNS.values():
        got = PORT_STRUCTURES[kind].from_cliques(cliques, n, R, valid_leaf=valid_leaf)
        want = JAX_STRUCTURES[kind].from_cliques(cliques, n, R, valid_leaf=valid_leaf)
        if kind == "distributed":
            g, w = got.padded_arrays(), want.padded_arrays()
            assert tuple(g[4]) == tuple(w[4]) and g[5] == w[5]
            for a, b in zip(g[:4], w[:4]):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        else:
            g, w = tdc._device_arrays(got), jdc._device_arrays(want)
            assert g.keys() == w.keys()
            assert g["geom"] == w["geom"]
            for key in g.keys() - {"geom"}:
                np.testing.assert_array_equal(g[key], w[key])
                assert g[key].dtype == w[key].dtype


@pytest.mark.parametrize("kind", KINDS)
def test_partition_covers_all_variables(kind):
    cliques, n = chain_cliques(16)
    ds = tdist.DistributedSupernodalStructure.from_cliques(cliques, n, 4)
    if kind == "distributed":
        owned = set(ds.r_vars)
        for blks in ds.local_blocks:
            for s, _ in blks:
                for v in s:
                    assert v not in owned, "variable owned twice"
                    owned.add(v)
        assert owned == set(range(n))
        # local separators stay local-or-root (subtree locality)
        for blks in ds.local_blocks:
            local_vars = {v for s, _ in blks for v in s} | set(ds.r_vars)
            for _, p in blks:
                assert set(p) <= local_vars
    else:
        dcs = tdc.DistributedCompressedStructure.from_cliques(cliques, n, 4)
        seen = [k for cl in dcs.device_cliques for k in cl] + list(dcs.root_cliques)
        assert seen == list(range(len(dcs.base.blocks)))
        owned = {}
        for k, (s, _) in enumerate(dcs.base.blocks):
            for v in s:
                assert v not in owned
                owned[v] = k
        assert set(owned) == set(range(n))


# ---------------------------------------------------------------------------
# The factorizations across ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("kind", KINDS)
def test_llt_chain(ranks, kind, R):
    _check_chain(ranks, R, "chain24", kind)


@pytest.mark.parametrize("kind", KINDS)
def test_llt_star_of_chains(ranks, kind):
    """The hub variable must land in the root separator set."""
    _check_chain(ranks, 4, "star", kind)


@pytest.mark.parametrize("kind", KINDS)
def test_ldlt_indefinite(ranks, kind):
    """KKT-style indefinite diagonal through the clamped LDLT."""
    _check_chain(ranks, 4, "ldlt", kind, atol=1e-7)


@pytest.mark.parametrize("kind", KINDS)
def test_more_ranks_than_subtrees(ranks, kind):
    """R = 8 on a 3-clique tree: the surplus ranks own no clique and still
    take part in every all-reduce."""
    cliques, n = chain_cliques(3)
    ds = PORT_STRUCTURES[kind].from_cliques(cliques, n, 8)
    per_rank = ds.local_blocks if kind == "distributed" else ds.device_cliques
    assert any(len(blks) == 0 for blks in per_rank)
    _check_chain(ranks, 8, "tiny", kind)


@pytest.mark.parametrize("kind", KINDS)
def test_fail_flag(ranks, kind):
    got = _one(ranks, 4, ("fail", kind))
    assert got["fail"] and got["fail_kkt"]
    cliques, n = chain_cliques(8)
    ds = JAX_STRUCTURES[kind].from_cliques(cliques, n, 4)
    assert JAX_RUN[kind](-np.eye(n), np.zeros(n), ds, "llt", 4)[1]


@functools.cache
def _jax_soc_chain():
    As, cs, vars_, b, cliques = soc_chain()
    blocks = tuple(JSOC(A=jnp.asarray(A), c=jnp.asarray(c), vars_=v)
                   for A, c, v in zip(As, cs, vars_))
    ws = tuple(blk.identity_state(jnp.float64) for blk in blocks)
    scalars = dict(k=jnp.zeros((), jnp.float64), b_scaling=jnp.ones((), jnp.float64),
                   c_scaling=jnp.ones((), jnp.float64))
    config = JConfig(max_iterations=40)
    single = jsolve(blocks, (), jnp.asarray(b), ws, scalars, config,
                    kkt_structure=JStructure.from_cliques(cliques, len(b)))
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("tp",))
    dist = {kind: jsolve_sharded(blocks, (), jnp.asarray(b), ws, scalars, config, mesh,
                                 kkt_structure=JAX_STRUCTURES[kind].from_cliques(
                                     cliques, len(b), 8))
            for kind in KINDS}
    return single, dist


@pytest.mark.parametrize("kind", KINDS)
def test_cone_sharded_with_distributed_kkt(ranks, kind):
    """The full solve: the sparse SOC chain's cone batches sharded over 8
    ranks and its KKT clique tree factored across them."""
    got = _one(ranks, 8, ("soc_chain", kind))
    single, dist = _jax_soc_chain()
    assert bool(got["solved"]) == bool(single.solved)
    assert got["num_iterations"] == int(single.num_iterations)
    np.testing.assert_allclose(got["y"], np.asarray(single.y), atol=1e-8)
    np.testing.assert_allclose(got["y"], np.asarray(dist[kind].y), atol=1e-8)


def test_a_distributed_structure_requires_a_group():
    cliques, n = chain_cliques(4)
    G = torch.as_tensor(random_clique_spd(cliques, n, np.random.default_rng(0)))[None]
    for kind, cls in PORT_STRUCTURES.items():
        ds = cls.from_cliques(cliques, n, 2)
        K = G if kind == "distributed" else tcompressed.compress_dense(G, ds.base)
        for mode in (KKT_SOLVER_LLT, KKT_SOLVER_LDLT):
            with pytest.raises(ValueError, match="requires axis_name"):
                tkkt.factor(K, mode, ds)
