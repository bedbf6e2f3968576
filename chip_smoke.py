"""Drive the PyTorch port (conex_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. the card: name and power limit from nvidia-smi; no CUDA card fails;
2. build: the three sources (csrc/schur.cu, csrc/fused_socp.cu, once per
   working type, and csrc/schur_probes.cu) with nvcc, with the build time
   and ptxas's registers, shared memory, stack frame and spills for every
   entry (K2: one per TEAM, 8 and 32, route and type);
3. Schur kernel against plain: the CUDA Schur kernel (K1) against
   schur_plain on the card, in f64 (relative Frobenius error <= 1e-12) and
   in f32 against an f64 oracle (<= 1e-4), at four shapes (S, Bc, m, n): a
   small one (3, 2, 4, 13), many cones (2, 64, 20, 100), m + 1 above one
   Gram tile with a ragged n (3, 2, 70, 130), and the benchmark shape
   (256, 1, 50, 100); two kernel calls at the benchmark shape must give
   the same bits; CUDA-event times of both there, in turns;
3b. fused SOCP kernel against plain: the CUDA kernel against
   solve_socp_plain on the card, every field of FusedSOCPResult: iteration
   counts and status flags identical, the floating fields (y, y_kkt, w, k,
   the scalings, stats_k, stats_dinf) within a relative limit.  In f64
   (limit 1e-8: the two take every sum in the same order and agree to the
   bit; a change of order alone grows tenfold per iteration where k climbs
   fast) on small batches that reach every branch (feasible, infeasible, a
   factorization failure, refinement, the stall detector, dual recovery, a
   poisoned warmstart) and on a batch of 64 scenarios of 4 cones of dim 250
   and m = 16 whose working set (301 KB each) takes the global route, each
   under TEAM 32 and TEAM 8, and at the bench_socp shape (S = 1,000, 30
   fixed iterations).  In f32 at the
   bench_socp shape at S = 1,000, 10,000 and 100,000 (limit 1e-6, ten
   ulps: see F32_LIMIT); every call prints the plan it ran under
   (parallel/fused_socp.py::socp_plan: route, TEAM, scenarios per block,
   shared bytes); as an extra check, f32
   against an f64 oracle
   at S = 10,000: 30 iterations and no failure in both, median relative
   stats_k difference over iterations 1-2 <= 1e-3.  CUDA-event times of
   both at the three sizes;
3c. the probe kernels K3-K6 against their plain versions on the card (K3
   and K6 run K1's kernels, csrc/schur.cu, under K1's plan at S = 1, Bc =
   B, each record with that plan; K4 and K5 csrc/schur_probes.cu's), on
   the probes' inputs (seed 0): in f64 (relative
   Frobenius error <= 1e-12) at two small shapes (one with two tiles of
   the Gram matrix) and at the probe shape
   (B=256, m=50, n=100), in f32 against the f64 plain version (<= 1e-4) at
   the probe shape, where two f32 calls of each must give the same bits;
   on nonsymmetric inputs (uniform A, W, C) at (3, 5, 13) and (2, 70, 130)
   in f64 (<= 1e-12), with each variant's distance from einsum_schur
   beside it (K4 and K5 compute tr(A_v W A_u^T W^T), which leaves the
   oracle there); K4 and K5 print their plan (dev_pallas_probe.py::
   probe_at_plan); K1 on the same inputs as one program of 256 cones
   (S=1, Bc=256) against the same f64 oracle, with the same limits, and
   two of its f32 calls must give the same bits;
   CUDA-event times at the probe shape in f32 of each kernel and its plain
   version, and of the einsum_schur twin against K1 at S=1, in turns;
4. the SDP main path: bench.py's workload (B=256 dense SDPs, n=100, m=50,
   f32, 30 fixed Newton iterations) through conex_tpu_torch.solve_scenarios:
   every scenario must run exactly 30 iterations without a factorization
   failure, through the Schur kernel once per iteration; Newton it/s as the
   best of 3 runs; then a small f64 instance of the same configuration on
   the card against the same solve on the CPU (the plain path);
4b. the SOCP main path: `bench.py socp`'s workload (nc=1, n=20, m=10, f32,
   30 fixed iterations) through parallel.fused_socp.solve_socp_fused at
   S = 1,000, 10,000, 100,000: 30 iterations and no failure in every
   scenario, one kernel launch per call, Newton it/s as the best of 3 runs,
   and the plan of each size;
   the same workload at S = 10,000 through solve_scenarios with SOCCone
   (the general path), its it/s and its agreement with the fused path;
4c. the LP path (no kernel: K1 and K2 must not launch on it):
   benchmarks/bench_accuracy.py's dense LP (200 variables, 400
   inequalities, f64, seed 0, mu target 1e-8) through
   Program(device="cuda"), and a batch of 64 of them (scenario s drawn
   with seed s, A of 41 MB) through solve_scenarios, each in both mu
   modes (divergence and line search): every solve solved, relative gap
   <= 1e-7 and dual residual <= 1e-10 (bench_accuracy.py's measures), y
   within 1e-8 relative of the same solve on the CPU in as many
   iterations; the wall per solve (best of 3) and Newton it/s;
5. a known answer: a small f64 SDP through Program(device="cuda"), against
   lambda_min(C) and the CPU solve;
5b. a known SOC answer through Program(device="cuda"): max b'y s.t.
   (1, y) in the Lorentz cone, y = b/|b|, and its dual, against the CPU;
5c. the LP known answer of the repository's verify notes (maximize
   y1 + 2 y2, optimum (1, 3), b'y = 7) on the card against the CPU, then
   a warmstart resume after save_state / load_state (at most 3
   iterations, as on the CPU);
6. the probe entry points: benchmarks/dev_pallas_probe.py's main at
   256,50,100 and dev_tpu_probe2.py's part2 through their twins in
   conex_tpu_torch/benchmarks, on the card in f32: each variant's kernel
   must launch, and K1's main-path entry and K2 must not; then one K4
   call must hold no more device memory than its plan's scratch (no At
   copy of A), and one K3 call no more than its plan's panel scratch and
   partials.

The last lines are the kernels' JSON record (K2's and K3-K6's with their
plans; with each kernel's bound:
the larger of its operations over the peak rate of the units that do
them and its bytes over 3.35 TB/s; every Schur kernel's products run on
the tensor cores, three TF32 passes per f32 product at 495 TFLOP/s), the
card's name and power limit, and {"ok": true, "device": {...}}.  Imports
nothing of JAX.
"""

import json
import subprocess
import sys
import time

SCHUR_SOURCE = "conex_tpu_torch/csrc/schur.cu"
SCHUR_REPLACES = "conex_tpu/cones/psd_pallas.py:48"
FUSED_SOURCE = "conex_tpu_torch/csrc/fused_socp.cu"
FUSED_REPLACES = "conex_tpu/parallel/fused_socp.py:234"
PROBE_SOURCE = "conex_tpu_torch/csrc/schur_probes.cu"
# (variant, its module in conex_tpu_torch/benchmarks, the TPU kernel, the
# CUDA source its kernels are in: K3 and K6 run K1's)
PROBES = (("fused_a", "dev_pallas_probe", "benchmarks/dev_pallas_probe.py:37",
           SCHUR_SOURCE),
          ("fused_b", "dev_pallas_probe", "benchmarks/dev_pallas_probe.py:69",
           PROBE_SOURCE),
          ("fused_b2", "dev_tpu_probe2", "benchmarks/dev_tpu_probe2.py:104",
           PROBE_SOURCE),
          ("fused_a2", "dev_tpu_probe2", "benchmarks/dev_tpu_probe2.py:180",
           SCHUR_SOURCE))
PROBE_SHAPE = (256, 50, 100)  # B, m, n: dev_pallas_probe.py:208
AT_LAYOUT = ("fused_b", "fused_b2")  # K4 and K5: tr(A_v W A_u^T W^T)
# The LP path: benchmarks/bench_accuracy.py:53-90's dense LP (m variables,
# n inequalities, f64, solved to mu = 1e-8), once through Program and as a
# batch of LP_BATCH scenarios (scenario s drawn with seed s) through
# solve_scenarios, in both mu modes.  Limits: the relative gap and dual
# residual of bench_accuracy.py:46-50 (the JAX package reaches 2.07e-8 and
# 1.98e-14 there, BENCH_ACCURACY.json), and a single solve's y within
# LP_Y_LIMIT relative of the same solve on the CPU with the same iteration
# count.
#
# Every scenario of the batch is held to the gap and the dual residual, and
# to the CPU by its objective (two solves within LP_GAP_LIMIT of the
# optimum lie within it of each other) and its iteration count (within
# the five final-centering steps of SolverConfig); the batch's median y to
# LP_Y_LIMIT.  Not every scenario's y to LP_Y_LIMIT in as many iterations:
# at this target the f64 iteration is as sensitive as that to one rounding.
# On an H100 the CPU alone, with b moved by 2^-52, moved y by up to 1.1e-5
# and the iteration count in 6 of 64 scenarios, as the card did (up to
# 1.0e-5, in 3), while each y lies up to 1.6e-4 from its exact vertex
# (this phase prints all three, every run).
LP_SHAPE = (200, 400)  # m, n
LP_BATCH = 64
LP_GAP_LIMIT = 1e-7
LP_DUAL_LIMIT = 1e-10
LP_Y_LIMIT = 1e-8
LP_CENTERING_SPREAD = 5
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# float32 outside the tensor cores, TF32 and float64 on the tensor cores,
# and device memory.
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
F64_TENSOR_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
LIBRARY_NOTE = ("library_ms is null for every kernel: no single PyTorch call "
                "computes the five Schur outputs (K1, K3-K6) or the SOCP "
                "solve (K2)")
SOCP_SIZES = (1_000, 10_000, 100_000)
SOCP_FLAGS = ("num_iterations", "solved", "fail", "primal_infeasible",
              "dual_infeasible", "mu_stalled", "warmstart_aborted")
SOCP_FLOATS = ("y", "y_kkt", "w", "k", "b_scaling", "c_scaling", "stats_k",
               "stats_dinf")
SOCP_PER_SCENARIO = ("y", "y_kkt", "w")
# Kernel against plain, relative.  The two round every operation alike and
# measure equal to the bit in both precisions on an H100.  f64 allows for
# sums taken in another order, amplified over up to 60 iterations.  In f32
# a change of rounding is not bounded that way: FMA contraction alone moves
# the bench_socp trajectory by a median 0.19 over 30 iterations (iterations
# 1-2: 1.2e-7), so the limit admits ten float32 ulps and nothing more.
F64_LIMIT = 1e-8
F32_LIMIT = 1e-6


def bound(ops, nbytes, flops=F32_FLOPS):
    """The least time the card could take: operations over the peak rate
    ``flops`` of the units that do them, or bytes over the memory rate,
    whichever is larger."""
    t_ops, t_bytes = ops / flops, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def schur_bound(cones, programs, m, n, itemsize=4, tensor_cores=False,
                at_layout=False):
    """K1, K3, K6: per cone the m+1 panels Op_v W (C W as operator m),
    2 (m+1) n^3, and one triangle of the extended Gram matrix over them,
    2 (m+1)(m+2)/2 n^2 (it is symmetric for any inputs: a trace is unchanged
    by cycling its factors).  ``at_layout``: K4 and K5's function, whose G,
    tr(A_v W A_u^T W^T), is not symmetric unless W is: two n^3 products per
    operator, 4 (m+1) n^3, and every one of the m^2 + 2m + 2 outputs as a
    sum of depth n^2.  A, W and C read once, G, AW, AQc, wc, cqc of each
    program written once.  ``tensor_cores``: the products run there, as in
    K1, K4, K5: three TF32 passes per f32 product at TF32's rate, or
    float64 at the DMMA rate; else on CUDA cores at float32's rate."""
    if at_layout:
        ops = (4 * cones * (m + 1) * n**3
               + 2 * cones * (m * m + 2 * m + 2) * n**2)
    else:
        ops = (2 * cones * (m + 1) * n**3
               + 2 * cones * ((m + 1) * (m + 2) // 2) * n**2)
    nbytes = itemsize * (cones * (m + 2) * n * n + programs * (m * m + 2 * m + 2))
    if not tensor_cores:
        return bound(ops, nbytes)
    if itemsize == 4:
        return bound(3 * ops, nbytes, TF32_FLOPS)
    return bound(ops, nbytes, F64_TENSOR_FLOPS)


def socp_bound(S, nc, n1, m, iterations, T, refine, itemsize=4):
    """K2, counted from csrc/fused_socp.cu for the Newton iterations this
    run took: per iteration the panel Q(w^1/2) A and the AW dots (7 nc n1
    m), one triangle of the Gram sum G (nc n1 m (m+1)), AQc (2 nc n1 m),
    two slack products (4 nc n1 m), the Cholesky (m^3 / 3) and two KKT
    solves with their refinement (4 m^2 (1 + 2 refine)); the O(n1) cone
    arithmetic is left out.  Bytes: the seven inputs read once, the
    outputs (y, w, six scalars and five int32 flags per scenario, and the
    T x S statistics) written once."""
    per_iteration = (nc * n1 * (13 * m + m * (m + 1)) + m**3 / 3
                     + 4 * m * m * (1 + 2 * refine))
    nbytes = (itemsize * S * (nc * n1 * m + 2 * nc * n1 + m + 3)
              + itemsize * S * (m + nc * n1 + 6 + 2 * T) + 4 * 5 * S)
    return bound(iterations * per_iteration, nbytes)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_name_and_power_limit():
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        return "nvidia-smi not found"
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}"
    return lines[0].strip()


def rel_err(got, want):
    """Largest relative Frobenius error over matching output tuples; NaN
    where any output holds a NaN, so that no limit passes it."""
    import torch

    errs = []
    for g, w in zip(got, want):
        w = w.double()
        den = max(float(torch.linalg.vector_norm(w)), 1e-300)
        errs.append(float(torch.linalg.vector_norm(g.double() - w)) / den)
    return float("nan") if any(e != e for e in errs) else max(errs)  # NaN fails


def schur_inputs(S, Bc, m, n, seed, device):
    """Symmetric A, C near I and an SPD-ish W, made on the card from a seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=torch.float64, device=device, generator=g)

    def sym(*shape):
        X = torch.rand(*shape, **kw) * 2 - 1
        return 0.5 * (X + X.transpose(-2, -1))

    eye = torch.eye(n, dtype=torch.float64, device=device)
    A = sym(S, Bc, m, n, n)
    C = (eye + 0.1 * sym(S, Bc, n, n)).contiguous()
    W = (eye + 0.05 * sym(S, Bc, n, n)).contiguous()
    return A, W, C


def time_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(device):
    import torch

    from conex_tpu_torch.cones import psd_schur

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {}
    for label, shape in (("small", (3, 2, 4, 13)), ("many cones", (2, 64, 20, 100)),
                         ("two tiles", (3, 2, 70, 130)), ("bench", (256, 1, 50, 100))):
        A, W, C = schur_inputs(*shape, seed=1, device=device)
        got64 = psd_schur.schur_kernel(A, W, C)
        want64 = psd_schur.schur_plain(A, W, C)
        torch.cuda.synchronize()
        e64 = rel_err(got64, want64)
        A32, W32, C32 = (x.float() for x in (A, W, C))
        got32 = psd_schur.schur_kernel(A32, W32, C32)
        plain32 = psd_schur.schur_plain(A32, W32, C32)
        oracle = psd_schur.schur_plain(*(x.double() for x in (A32, W32, C32)))
        torch.cuda.synchronize()
        e32 = rel_err(got32, oracle)
        e32_plain = rel_err(plain32, oracle)
        max_abs = max(float((g - p).abs().max()) for g, p in zip(got32, plain32))
        log(f"[3 kernel] {label} S,Bc,m,n={shape}: f64 rel err {e64:.3e} "
            f"(limit 1e-12); f32 rel err vs f64 oracle {e32:.3e} (limit 1e-4; "
            f"plain f32 {e32_plain:.3e}); f32 max |kernel - plain| {max_abs:.3e}")
        if not e64 <= 1e-12:
            fail(f"f64 kernel disagrees with schur_plain at {label}: {e64}")
        if not e32 <= 1e-4:
            fail(f"f32 kernel disagrees with the f64 oracle at {label}: {e32}")
        record = dict(max_abs_err=max_abs)
        del got64, want64, oracle
    again = psd_schur.schur_kernel(A32, W32, C32)
    torch.cuda.synchronize()
    same = all(torch.equal(g, a) for g, a in zip(got32, again))
    log(f"[3 kernel] bench shape f32: two kernel calls give the same bits: {same}")
    if not same:
        fail("two kernel calls at the bench shape differ")
    # Time both at the benchmark shape, in turns: plain, kernel, kernel, plain.
    ms = {"plain": [], "kernel": []}
    fns = {"plain": lambda: psd_schur.schur_plain(A32, W32, C32),
           "kernel": lambda: psd_schur.schur_kernel(A32, W32, C32)}
    for name in ("plain", "kernel", "kernel", "plain"):
        ms[name].append(time_ms(fns[name], 10))
    tensor = schur_bound(256, 256, 50, 100, tensor_cores=True)
    log(f"[3 kernel] bench shape f32 ms per call: kernel {ms['kernel']}, "
        f"plain {ms['plain']} (CUDA events, 10 calls each); bound on the "
        f"tensor cores {tensor}, on CUDA cores {schur_bound(256, 256, 50, 100)}")
    record.update(ms=min(ms["kernel"]), plain_ms=min(ms["plain"]), **tensor)
    return record


def bench_workload(device):
    """bench.py:73-102, with the port's tensors on ``device``."""
    import numpy as np
    import torch

    from conex_tpu_torch import SolverConfig
    from conex_tpu_torch.cones.psd import DenseLMICone, make_psd_state

    B, n, m = 256, 100, 50
    iters = 30
    dtype = np.float32
    rng = np.random.default_rng(0)
    A = rng.uniform(-1, 1, (B, 1, m, n, n)).astype(dtype)
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    C = np.broadcast_to(np.eye(n, dtype=dtype), (B, 1, n, n)).copy()
    X0 = rng.uniform(-1, 1, (B, 1, n, n)).astype(dtype)
    X0 = np.einsum("sbij,sbkj->sbik", X0, X0) + 0.1 * np.eye(n, dtype=dtype)
    b = np.einsum("sbvij,sbij->sv", A, X0).astype(dtype)

    blk = DenseLMICone(A=torch.from_numpy(A).to(device),
                       C=torch.from_numpy(C).to(device))
    eye = torch.eye(n, dtype=torch.float32, device=device)
    init_ws = (make_psd_state(eye.expand(B, 1, n, n).contiguous()),)
    scalars = dict(
        k=torch.zeros((B,), dtype=torch.float32, device=device),
        b_scaling=torch.ones((B,), dtype=torch.float32, device=device),
        c_scaling=torch.ones((B,), dtype=torch.float32, device=device),
    )
    config = SolverConfig(
        max_iterations=iters,
        final_centering_steps=0,
        inv_sqrt_mu_max=1e15,
        fixed_iterations=True,
        inv_sqrt_mu_cap_scaled=100.0,
    )
    return blk, torch.from_numpy(b).to(device), init_ws, scalars, config


def first_failure_report(blk, b, init_ws, scalars, config, res, s):
    """The first invalid scenario's f32 trajectory beside an f64 run of it."""
    import dataclasses

    from conex_tpu_torch import solve_scenarios

    pick = lambda x: x[s:s + 1].double()  # noqa: E731
    blk64 = dataclasses.replace(blk, A=pick(blk.A), C=pick(blk.C))
    ws64 = tuple(type(w)(*map(pick, w)) for w in init_ws)
    r64 = solve_scenarios((blk64,), (), pick(b), ws64,
                          {k: pick(v) for k, v in scalars.items()}, config)
    log(f"[4 main path] scenario {s}: f32 iters {int(res.num_iterations[s])} "
        f"fail {bool(res.fail[s])}; f64 iters {int(r64.num_iterations[0])} "
        f"fail {bool(r64.fail[0])}")
    log(f"  f32 stats_k {res.stats_k[s].tolist()}")
    log(f"  f64 stats_k {r64.stats_k[0].tolist()}")
    log(f"  f32 stats_dinf {res.stats_dinf[s].tolist()}")
    log(f"  f64 stats_dinf {r64.stats_dinf[0].tolist()}")


def phase_main_path(device):
    import torch

    from conex_tpu_torch import solve_scenarios
    from conex_tpu_torch.cones import psd_schur
    from conex_tpu_torch.parallel import fused_socp

    t0 = time.perf_counter()
    blk, b, init_ws, scalars, config = bench_workload(device)
    log(f"[4 main path] workload built in {time.perf_counter() - t0:.2f} s")

    def run(bv):
        res = solve_scenarios((blk,), (), bv, init_ws, scalars, config)
        torch.cuda.synchronize()
        return res

    psd_schur.schur_kernel.launches = 0
    fused_socp.solve_socp_kernel.launches = 0
    t0 = time.perf_counter()
    res = run(b)
    launches = psd_schur.schur_kernel.launches
    if fused_socp.solve_socp_kernel.launches:
        fail("the fused SOCP kernel ran on the SDP path")
    log(f"[4 main path] first run {time.perf_counter() - t0:.3f} s, "
        f"Schur kernel launches {launches}")
    n_iters = res.num_iterations.cpu()
    fails = res.fail.cpu()
    iters = config.max_iterations
    log(f"[4 main path] iterations min {int(n_iters.min())} max "
        f"{int(n_iters.max())}, failures {int(fails.sum())}/{len(fails)}")
    bad = (n_iters != iters) | fails
    if bad.any():
        first_failure_report(blk, b, init_ws, scalars, config, res,
                             int(bad.nonzero()[0, 0]))
        fail("bench validity rule: every scenario must run exactly "
             f"{iters} iterations with no factorization failure")
    if launches != iters:
        fail(f"Schur kernel launched {launches} times in {iters} iterations")
    if res.y.shape != b.shape or not torch.isfinite(res.y).all():
        fail(f"y is not finite of shape {tuple(b.shape)}")
    total = int(n_iters.sum())
    best = float("inf")
    for rep in range(3):
        bv = b * (1.0 + 1e-6 * (rep + 1))
        t0 = time.perf_counter()
        run(bv)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        log(f"[4 main path] rep {rep}: {dt:.4f} s")
    log(f"[4 main path] Newton it/s {total / best:.2f} "
        f"({total} iterations, best of 3: {best:.4f} s)")
    return launches


def phase_small_vs_cpu(device):
    """The bench configuration at a small size in f64: card against CPU."""
    import numpy as np
    import torch

    from conex_tpu_torch import SolverConfig, convert, solve_scenarios
    from conex_tpu_torch.cones.psd import make_psd_state

    S, n, m = 4, 12, 5
    rng = np.random.default_rng(3)
    A = rng.uniform(-1, 1, (S, 1, m, n, n))
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    C = np.broadcast_to(np.eye(n), (S, 1, n, n)).copy()
    X0 = rng.uniform(-1, 1, (S, 1, n, n))
    X0 = np.einsum("sbij,sbkj->sbik", X0, X0) + 0.1 * np.eye(n)
    b = np.einsum("sbvij,sbij->sv", A, X0)
    config = SolverConfig(max_iterations=30, final_centering_steps=0,
                          inv_sqrt_mu_max=1e15, fixed_iterations=True,
                          inv_sqrt_mu_cap_scaled=100.0)
    out = []
    for dev in (device, "cpu"):
        ws = make_psd_state(convert.tensor(
            np.broadcast_to(np.eye(n), (S, 1, n, n)), dev))
        scal = convert.scalars(dict(k=np.zeros(S), b_scaling=np.ones(S),
                                    c_scaling=np.ones(S)), dev)
        res = solve_scenarios((convert.lmi_cone(A, C, dev),), (),
                              convert.tensor(b, dev), (ws,), scal, config)
        out.append(convert.to_numpy(res))
    g, c = out
    dk = float(np.max(np.abs(g.stats_k - c.stats_k) / np.abs(c.stats_k)))
    dy = float(np.max(np.abs(g.y - c.y) / (np.abs(c.y) + 1e-9)))
    log(f"[4 main path] small f64 card vs CPU: max rel diff stats_k {dk:.3e}, "
        f"y {dy:.3e} (limit 1e-6)")
    if not (g.num_iterations == c.num_iterations).all() or g.fail.any():
        fail("small f64 run: card and CPU disagree on iterations or failures")
    if not (dk <= 1e-6 and dy <= 1e-6):
        fail("small f64 run: card and CPU trajectories disagree")


def phase_known_answer(device):
    import numpy as np

    from conex_tpu_torch import Program, SolverConfig

    n = 6
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(0.5, 3.0, n)
    C = Q @ np.diag(ev) @ Q.T
    C = 0.5 * (C + C.T)
    config = SolverConfig(prepare_dual_variables=True, inv_sqrt_mu_max=1e4,
                          max_iterations=60)
    ys = []
    for dev in (device, "cpu"):
        prog = Program(1, device=dev)
        prog.add_lmi_constraint(np.eye(n)[None], C)
        res = prog.solve(np.ones(1), config)
        if not res.solved:
            fail(f"known-answer SDP not solved on {dev}")
        ys.append(float(res.y[0]))
    y_card, y_cpu = ys
    log(f"[5 known answer] max y s.t. C - y I PSD: card {y_card!r}, "
        f"CPU {y_cpu!r}, lambda_min(C) {ev[0]!r}")
    if abs(y_card - ev[0]) > 1e-6:
        fail("card objective is not lambda_min(C)")
    if abs(y_card - y_cpu) > 1e-8:
        fail("card and CPU objectives differ by more than 1e-8")


# ---------------------------------------------------------------------------
# The fused batched-SOCP solver (kernel K2)
# ---------------------------------------------------------------------------


def random_socp(rng, S, nc, n, m, feasible=True):
    """tests/test_fused_socp.py:22-40: S programs of nc Lorentz cones of
    dim n+1 over m variables; a feasible one has b = A(x) for an interior
    dual point x, an infeasible one a random b."""
    import numpy as np

    A = rng.standard_normal((S, nc, n + 1, m))
    if feasible:
        x = rng.standard_normal((S, nc, n + 1))
        x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + rng.uniform(
            0.5, 1.5, (S, nc))
        b = 2.0 * np.einsum("scnv,scn->sv", A, x)
    else:
        b = rng.standard_normal((S, m))
    c = rng.standard_normal((S, nc, n + 1))
    c[..., 0] = np.linalg.norm(c[..., 1:], axis=-1) + rng.uniform(
        0.5, 2.0, (S, nc))
    return A, c, b


def socp_workload(S, n=20, m=10):
    """benchmarks/bench_socp.py:28-36 (seed 0): S single-cone SOCPs, f32."""
    import numpy as np

    dtype = np.float32
    rng = np.random.default_rng(0)
    A = rng.standard_normal((S, 1, n + 1, m)).astype(dtype)
    x = rng.standard_normal((S, 1, n + 1)).astype(dtype)
    x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + 1.0
    b = 2.0 * np.einsum("scnv,scn->sv", A, x).astype(dtype)
    c = rng.standard_normal((S, 1, n + 1)).astype(dtype)
    c[..., 0] = np.linalg.norm(c[..., 1:], axis=-1) + 1.0
    return A, c, b


def socp_config(iters=30):
    """benchmarks/bench_socp.py:66-73's cfg(iters)."""
    from conex_tpu_torch import SolverConfig

    return SolverConfig(max_iterations=iters, final_centering_steps=0,
                        inv_sqrt_mu_max=1e15, kkt_error_tolerance=1e45,
                        fixed_iterations=True)


def fused_inputs(A, c, b, dtype, device, init_w=None, init_k=None):
    """The kernel's seven inputs (A, c, b, w0, k0, b and c scalings) as
    contiguous tensors; the defaults of solve_socp_fused."""
    import numpy as np
    import torch

    S, nc, n1, _ = A.shape
    if init_w is None:
        init_w = np.zeros((S, nc, n1))
        init_w[..., 0] = 1.0
    if init_k is None:
        init_k = np.zeros(S)
    return tuple(
        torch.as_tensor(np.asarray(x), dtype=dtype, device=device).contiguous()
        for x in (A, c, b, init_w, init_k, np.ones(S), np.ones(S)))


def _same(g, w):
    """Where two tensors hold the same value (NaN and inf included)."""
    return (g == w) | (g.isnan() & w.isnan())


def stats_rel(got, want):
    """Entrywise |got - want| / |want|; 0 where the two are equal."""
    import torch

    g, w = got.double(), want.double()
    return torch.where(_same(g, w), 0.0, (g - w).abs() / w.abs().clamp_min(1e-300))


def per_scenario_rel(got, want):
    """Each scenario's |got - want| / |want| in the 2-norm; 0 where the two
    are equal."""
    import torch

    S = want.shape[0]
    g, w = got.double().reshape(S, -1), want.double().reshape(S, -1)
    num = torch.linalg.vector_norm(g - w, dim=1)
    rel = num / torch.linalg.vector_norm(w, dim=1).clamp_min(1e-300)
    return torch.where(_same(g, w).all(1), 0.0, rel)


def max_abs_diff(got, want):
    import torch

    g, w = got.double(), want.double()
    return float(torch.where(_same(g, w), 0.0, (g - w).abs()).max())


def unbounded_and_infeasible(rng, A, c, b, unbounded, infeasible):
    """In place: make the objective of the ``unbounded`` scenarios grow
    without bound along y_0 (-A e_0 inside every cone, b_0 > 0), and the
    ``infeasible`` ones infeasible (cone 0 reads c_0 = -1 whatever y is)."""
    import numpy as np

    idx = list(unbounded)
    x = rng.standard_normal((len(idx),) + A.shape[1:3])
    x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + 0.5
    A[idx, :, :, 0] = -x
    b[idx, 0] = np.abs(b[idx, 0]) + 1.0
    idx = list(infeasible)
    A[idx, 0, 0, :] = 0.0
    c[idx, 0, 0] = -1.0


def fused_plan(args, config, **kw):
    """socp_plan of a kernel call on ``args`` (the seven inputs)."""
    from conex_tpu_torch.parallel import fused_socp

    A = args[0]
    return fused_socp.socp_plan(*A.shape, A.element_size(), config.max_iterations, **kw)


def check_fused(label, args, config, limit, teams=(None,)):
    """Kernel against plain on the same inputs, once under the plan of each
    of ``teams`` (None: socp_plan's pick), every field of FusedSOCPResult:
    iteration counts and flags identical; the floating fields within
    ``limit`` relative (in each scenario's 2-norm for y, y_kkt and w,
    entrywise for the rest).  Returns the plain version's counts of each
    flag and the largest |kernel - plain| over the floating fields."""
    import torch

    from conex_tpu_torch.parallel import fused_socp

    want = fused_socp.epilogue(fused_socp.solve_socp_plain(*args, config), config)
    counts = {name: int(getattr(want, name).to(torch.int64).sum()) for name in SOCP_FLAGS}
    counts["aborted at iteration 1"] = int((want.stats_dinf[:, 0] >= 2.0).sum())
    log(f"[3b fused kernel] {label}: S={args[0].shape[0]}, plain version's counts {counts}")
    max_abs = 0.0
    for team in teams:
        plan = fused_plan(args, config, team=team)
        got = fused_socp.epilogue(fused_socp.solve_socp_kernel(*args, config, plan=plan),
                                  config)
        torch.cuda.synchronize()
        log(f"[3b fused kernel] {label}: plan: {plan.describe()}")
        for name in SOCP_FLAGS:
            g, w = getattr(got, name), getattr(want, name)
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5, 0].tolist()
                fail(f"{label}, TEAM {plan.team}: {name} differs from the plain version "
                     f"in scenarios {bad}: kernel {g[bad].tolist()} plain {w[bad].tolist()}")
        rel = {name: float((per_scenario_rel if name in SOCP_PER_SCENARIO else stats_rel)(
            getattr(got, name), getattr(want, name)).max()) for name in SOCP_FLOATS}
        diff = max(max_abs_diff(getattr(got, f), getattr(want, f)) for f in SOCP_FLOATS)
        max_abs = max(max_abs, diff)
        log(f"[3b fused kernel] {label}, TEAM {plan.team}: flags identical; max relative "
            f"difference {rel} (limit {limit:g}); max |kernel - plain| {diff:.3e}")
        if not all(v <= limit for v in rel.values()):
            s = int(stats_rel(got.stats_k, want.stats_k).amax(1).argmax())
            log(f"  scenario {s}: kernel stats_k {got.stats_k[s].tolist()}")
            log(f"  scenario {s}: plain  stats_k {want.stats_k[s].tolist()}")
            fail(f"{label}, TEAM {plan.team}: kernel and plain version disagree beyond "
                 f"{limit:g}: {rel}")
    return counts, max_abs


def phase_fused_kernel(device):
    """Returns the kernel's record: max |kernel - plain| over the f32
    comparisons at the main path's shapes, and the CUDA-event times of both
    at the largest."""
    import numpy as np
    import torch

    from conex_tpu_torch import WARMSTART, SolverConfig
    from conex_tpu_torch.parallel import fused_socp

    f64 = torch.float64
    # Cold: feasible scenarios of 3 cones, random objectives (40 of them
    # made unbounded or infeasible on purpose), and one whose A has an
    # all-zero column (its factorization fails at iteration 0).
    rng = np.random.default_rng(11)
    feas = random_socp(rng, 200, 3, 4, 3)
    rand = random_socp(rng, 100, 3, 4, 3, feasible=False)
    A, c, b = (np.concatenate(pair) for pair in zip(feas, rand))
    unbounded_and_infeasible(rng, A, c, b, range(200, 220), range(220, 240))
    A[5, :, :, 1] = 0.0
    cold = SolverConfig(max_iterations=60, prepare_dual_variables=True,
                        iterative_refinement_iterations=1, mu_stall_iterations=4)
    # The cold, warm and global-route batches run under both of the
    # library's TEAM sizes: 32 (one team per warp) and 8 (four teams share
    # a warp, each with its own mask), so every branch runs under both.
    teams = fused_socp.TEAMS
    counts, max_abs = check_fused("f64 cold", fused_inputs(A, c, b, f64, device),
                                  cold, F64_LIMIT, teams)
    if not (counts["fail"] >= 1 and counts["solved"] >= 1
            and counts["mu_stalled"] >= 1):
        fail(f"f64 cold batch misses a branch: {counts}")
    # Warm from a poisoned iterate (w0 = 1e6 e) in half the scenarios; one
    # with a zero column resets at its first iteration and fails at the
    # next; ten unbounded ones run out of iterations.
    rng = np.random.default_rng(12)
    A, c, b = random_socp(rng, 200, 2, 4, 3)
    unbounded_and_infeasible(rng, A, c, b, range(150, 160), ())
    A[7, :, :, 0] = 0.0
    w0 = np.zeros((200, 2, 5))
    w0[..., 0] = 1.0
    w0[:100, :, 0] = 1e6
    warm = SolverConfig(max_iterations=40, initialization_mode=WARMSTART,
                        warmstart_abort_threshold=2.0)
    counts, abs_warm = check_fused(
        "f64 warm", fused_inputs(A, c, b, f64, device, w0, np.ones(200)), warm,
        F64_LIMIT, teams)
    if not (counts["aborted at iteration 1"] >= 100 and counts["fail"] >= 1
            and counts["solved"] <= 200 - 11):
        fail(f"f64 warm batch misses the abort, the failure or the "
             f"unsolved: {counts}")
    # f64 on the global route: one scenario's working set (nc = 4 cones of
    # dim 250, m = 16: 301 KB) exceeds a block's shared memory.
    rng = np.random.default_rng(13)
    args = fused_inputs(*random_socp(rng, 64, 4, 249, 16), f64, device)
    big = SolverConfig(max_iterations=40, prepare_dual_variables=True,
                       iterative_refinement_iterations=1)
    if fused_plan(args, big).route != "global":
        fail(f"the large batch does not take the global route: {fused_plan(args, big)}")
    counts, abs_global = check_fused("f64 global route", args, big, F64_LIMIT, teams)
    if counts["solved"] < 1:
        fail(f"f64 global-route batch solves nothing: {counts}")
    max_abs = max(max_abs, abs_global)
    del args
    # f64 at the bench_socp shape (30 fixed iterations), the same rule.
    config = socp_config()
    counts, abs_bench = check_fused(
        "f64 bench shape", fused_inputs(*socp_workload(1_000), f64, device),
        config, F64_LIMIT)
    if counts["num_iterations"] != 30 * 1_000 or counts["fail"]:
        fail(f"f64 bench shape: not 30 iterations without failure: {counts}")
    log(f"[3b fused kernel] f64 max |kernel - plain|: {max(max_abs, abs_warm, abs_bench):.3e}")

    # f32 at the bench_socp shape against an f64 oracle (an extra check of
    # the f32 arithmetic: the kernel is held to its plain twin below).
    A, c, b = socp_workload(10_000)
    got = fused_socp.epilogue(fused_socp.solve_socp_kernel(
        *fused_inputs(A, c, b, torch.float32, device), config), config)
    want = fused_socp.epilogue(fused_socp.solve_socp_plain(
        *fused_inputs(A, c, b, f64, device), config), config)
    torch.cuda.synchronize()
    for name, r in (("kernel f32", got), ("f64 oracle", want)):
        if not ((r.num_iterations == 30).all() and not r.fail.any()):
            fail(f"bench shape: {name} did not run 30 iterations in every "
                 f"scenario without failure")
    rel = stats_rel(got.stats_k, want.stats_k)
    med12 = float(rel[:, :2].median())
    log(f"[3b fused kernel] f32 bench shape S=10000: stats_k vs f64 oracle, "
        f"iterations 1-2 median {med12:.3e} (limit 1e-3); whole trajectory "
        f"median {float(rel.median()):.3e}, p99 "
        f"{float(rel.flatten().quantile(0.99)):.3e}, max {float(rel.max()):.3e}")
    if not med12 <= 1e-3:
        fail(f"f32 kernel drifts from the f64 oracle at iterations 1-2: {med12}")

    # At the main path's three sizes in f32: kernel against plain on the
    # same inputs, every field; then CUDA-event times, in turns: plain,
    # kernel, kernel, plain.
    times, max_abs = {}, 0.0
    for S in SOCP_SIZES:
        args = fused_inputs(*socp_workload(S), torch.float32, device)
        counts, abs_s = check_fused(f"f32 S={S}", args, config, F32_LIMIT)
        max_abs = max(max_abs, abs_s)
        fns = {"plain": lambda: fused_socp.solve_socp_plain(*args, config),
               "kernel": lambda: fused_socp.solve_socp_kernel(*args, config)}
        ms = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            ms[name].append(time_ms(fns[name], 3))
        times[S] = (min(ms["kernel"]), min(ms["plain"]))
        log(f"[3b fused kernel] S={S} f32, 30 iterations, ms per call: kernel "
            f"{ms['kernel']}, plain {ms['plain']} (CUDA events, 3 calls each)")
        _, nc, n1, m = args[0].shape
        del args, fns
    kernel_ms, plain_ms = times[SOCP_SIZES[-1]]
    plan = fused_socp.socp_plan(SOCP_SIZES[-1], nc, n1, m, 4, config.max_iterations)
    traffic = plan.traffic_bytes(counts["num_iterations"])
    log(f"[3b fused kernel] S={SOCP_SIZES[-1]} f32: device-memory traffic from the "
        f"plan {traffic / 1e9:.4f} GB, {1e3 * traffic / HBM_BYTES_PER_S:.4f} ms at "
        f"3.35 TB/s")
    return dict(max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
                plan=dict(route=plan.route, team=plan.team,
                          scenarios_per_block=plan.per_block,
                          shared_bytes=plan.shared_bytes),
                **socp_bound(SOCP_SIZES[-1], nc, n1, m, counts["num_iterations"],
                             config.max_iterations,
                             config.iterative_refinement_iterations))


def phase_socp_main_path(device):
    import torch

    from conex_tpu_torch import solve_scenarios
    from conex_tpu_torch.cones import psd_schur
    from conex_tpu_torch.cones.soc import SOCCone
    from conex_tpu_torch.parallel import fused_socp
    from conex_tpu_torch.parallel.fused_socp import solve_socp_fused

    config = socp_config()
    iters = config.max_iterations
    kernel = fused_socp.solve_socp_kernel
    psd_schur.schur_kernel.launches = 0
    kernel.launches = 0
    for S in SOCP_SIZES:
        A, c, b = (torch.from_numpy(x).to(device) for x in socp_workload(S))

        def run(bv):
            before = kernel.launches
            out = solve_socp_fused(A, c, bv, config)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                fail(f"S={S}: {kernel.launches - before} kernel launches in one call")
            return out

        out = run(b)
        total = int(out.num_iterations.sum())
        n_fail = int(out.fail.sum())
        plan = fused_socp.socp_plan(*A.shape, A.element_size(), iters)
        log(f"[4b socp main path] S={S}: plan: {plan.describe()}")
        log(f"[4b socp main path] S={S}: iterations {total} (want {iters * S}), "
            f"failures {n_fail}")
        if total != iters * S or n_fail:
            fail(f"S={S}: bench_socp validity rule: every scenario must run "
                 f"{iters} iterations without failure")
        if out.y.shape != b.shape or not torch.isfinite(out.y).all():
            fail(f"S={S}: y is not finite of shape {tuple(b.shape)}")
        best = float("inf")
        for rep in range(3):
            t0 = time.perf_counter()
            run(b * (1.0 + 1e-6 * (rep + 1)))
            best = min(best, time.perf_counter() - t0)
        log(f"[4b socp main path] S={S}: fused Newton it/s {total / best:.2f} "
            f"(best of 3: {best * 1e3:.3f} ms)")
        if S == 10_000:
            general_inputs = (A, c, b, out)
    launches = kernel.launches
    log(f"[4b socp main path] fused kernel launches {launches}, Schur kernel "
        f"launches {psd_schur.schur_kernel.launches}")
    if psd_schur.schur_kernel.launches:
        fail("the Schur kernel ran on the SOCP path")

    # The general path at S = 10,000: the solve loop with SOCCone blocks.
    A, c, b, fused = general_inputs
    S, nc, n1, _ = A.shape
    w0 = torch.zeros((S, nc, n1), dtype=A.dtype, device=device)
    w0[..., 0] = 1.0
    scalars = dict(k=torch.zeros((S,), dtype=A.dtype, device=device),
                   b_scaling=torch.ones((S,), dtype=A.dtype, device=device),
                   c_scaling=torch.ones((S,), dtype=A.dtype, device=device))

    def run_general(bv):
        res = solve_scenarios((SOCCone(A=A, c=c),), (), bv, (w0,), scalars, config)
        torch.cuda.synchronize()
        return res

    res = run_general(b)
    total = int(res.num_iterations.sum())
    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        run_general(b * (1.0 + 1e-6 * (rep + 1)))
        best = min(best, time.perf_counter() - t0)
    rel = stats_rel(fused.stats_k[:, :2], res.stats_k[:, :2])
    med = float(rel.median())
    log(f"[4b socp main path] general path S={S}: iterations {total}, failures "
        f"{int(res.fail.sum())}, Newton it/s {total / best:.2f} (best of 3: "
        f"{best * 1e3:.3f} ms); stats_k iterations 1-2 fused vs general: median "
        f"{med:.3e} p99 {float(rel.flatten().quantile(0.99)):.3e} max "
        f"{float(rel.max()):.3e} (limit on the median 1e-3)")
    if not torch.isfinite(res.k).all() or not med <= 1e-3:
        fail("the general SOCP path disagrees with the fused path")
    if kernel.launches != launches:
        fail("the general SOCP path launched the fused kernel")
    return launches


def phase_soc_known_answer(device):
    """max b'y s.t. (1, y) in Q^{m+1}: y = b/|b|, dual x = (|b|, -b)."""
    import numpy as np

    from conex_tpu_torch import Program, SolverConfig

    m = 4
    b = np.random.default_rng(6).standard_normal(m)
    A = np.vstack([np.zeros((1, m)), -np.eye(m)])
    c = np.zeros(m + 1)
    c[0] = 1.0
    config = SolverConfig(prepare_dual_variables=True, max_iterations=60)
    out = {}
    for dev in ("card", "cpu"):
        prog = Program(m, device=device if dev == "card" else "cpu")
        prog.add_soc_constraint(A, c)
        res = prog.solve(b, config)
        if not res.solved:
            fail(f"known-answer SOCP not solved on the {dev}")
        out[dev] = (res.y, prog.get_dual_variable(0))
    (y_card, x_card), (y_cpu, x_cpu) = out["card"], out["cpu"]
    e_ans = float(np.abs(y_card - b / np.linalg.norm(b)).max())
    e_cpu = float(np.abs(y_card - y_cpu).max())
    e_dual = float(np.linalg.norm(x_card - x_cpu) / np.linalg.norm(x_cpu))
    e_kkt = float(np.abs(A.T @ x_card - b).max())
    log(f"[5b soc known answer] y on the card {y_card.tolist()}: max |y - b/|b||"
        f" {e_ans:.3e} (limit 1e-6), max |card - CPU| {e_cpu:.3e} (limit 1e-8); "
        f"dual card vs CPU relative {e_dual:.3e} (limit 1e-8), max |A'x - b| "
        f"{e_kkt:.3e} (limit 1e-6)")
    if not (e_ans <= 1e-6 and e_cpu <= 1e-8 and e_dual <= 1e-8 and e_kkt <= 1e-6):
        fail("the SOC known answer does not hold on the card")


# ---------------------------------------------------------------------------
# The LP path (no kernel: the LP cone is elementwise work and two products)
# ---------------------------------------------------------------------------


def gap_stats(by, cx, b, Ax):
    """Relative duality gap and dual-feasibility residual
    (benchmarks/bench_accuracy.py:46-50)."""
    import numpy as np

    rel_gap = abs(cx - by) / (1.0 + abs(by))
    dual_res = float(np.linalg.norm(Ax - b) / (1.0 + np.linalg.norm(b)))
    return rel_gap, dual_res


def lp_instance(seed):
    """benchmarks/bench_accuracy.py:58-63's dense LP from a seed: A (n, m),
    b (m,), c (n,)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m, n = LP_SHAPE
    A = rng.uniform(-1, 1, (n, m))
    x0 = rng.uniform(0.5, 1.5, n)
    b = A.T @ x0
    c = rng.uniform(0.5, 1.5, n)
    return A, b, c


def lp_config(line_search):
    """bench_accuracy.py:66-70, in either mu mode."""
    from conex_tpu_torch import SolverConfig

    return SolverConfig(max_iterations=100, inv_sqrt_mu_max=1e4,
                        prepare_dual_variables=True,
                        enable_line_search=line_search)


def check_lp(label, A, b, c, card, cpu, batch=False):
    """Whether the card's solution meets the LP path's limits, logging what
    breaks them and, beside it, the tail of both trajectories; and its
    (rel_gap, dual_res, y's relative distance from the CPU's).  ``card``
    and ``cpu``: (y, x, iterations, stats_k, stats_dinf) of one solve.

    Always: the relative gap and the dual residual.  A single solve: y
    within LP_Y_LIMIT of the CPU's in as many iterations.  A scenario of
    the batch: its objective within LP_GAP_LIMIT of the CPU's and its
    iteration count within LP_CENTERING_SPREAD of it (see LP_Y_LIMIT)."""
    import numpy as np

    y, x, iters, k, dinf = card
    y_cpu, _, iters_cpu, k_cpu, dinf_cpu = cpu
    rel_gap, dual_res = gap_stats(float(b @ y), float(c @ x), b, A.T @ x)
    e_cpu = float(np.linalg.norm(y - y_cpu) / np.linalg.norm(y_cpu))
    e_obj = abs(float(b @ (y - y_cpu))) / (1.0 + abs(float(b @ y_cpu)))
    ok = rel_gap <= LP_GAP_LIMIT and dual_res <= LP_DUAL_LIMIT
    if batch:
        ok = (ok and e_obj <= LP_GAP_LIMIT
              and abs(iters - iters_cpu) <= LP_CENTERING_SPREAD)
    else:
        ok = ok and e_cpu <= LP_Y_LIMIT and iters == iters_cpu
    if not ok:
        last = max(iters, iters_cpu)
        log(f"LP {label}: {iters} iterations (CPU {iters_cpu}), relative gap "
            f"{rel_gap:.3e} (limit {LP_GAP_LIMIT}), dual residual {dual_res:.3e} "
            f"(limit {LP_DUAL_LIMIT}), y vs CPU {e_cpu:.3e}, objective vs CPU "
            f"{e_obj:.3e}, least slack {float((c - A @ y).min()):.3e}")
        for name, card_t, cpu_t in (("stats_k", k, k_cpu), ("stats_dinf", dinf, dinf_cpu)):
            log(f"  {name} of iterations {last - 4}-{last - 1}: card "
                f"{[float(v) for v in card_t[last - 4:last]]}, CPU "
                f"{[float(v) for v in cpu_t[last - 4:last]]}")
    return ok, (rel_gap, dual_res, e_cpu)


def lp_vertex(A, c, y):
    """The vertex y* of the m inequalities tightest at y: A_act y* = c_act,
    the exact optimum of a nondegenerate LP whose solve ended at y."""
    import numpy as np

    act = np.argsort(c - A @ y)[:A.shape[1]]
    return np.linalg.solve(A[act], c[act])


def program_solution(prog, res):
    """(y, x, iterations, stats_k, stats_dinf) of a Program's LP solve."""
    raw = res._raw
    return (res.y, prog.get_dual_variable(0), res.num_iterations, raw.stats_k,
            raw.stats_dinf)


def batch_solution(r, s):
    """The same of scenario s of a batched solve (numpy SolveResult); x as
    Program.get_dual_variable forms it."""
    x = r.ws[0][s] / (r.k[s] * r.b_scaling[s])
    return (r.y[s], x, int(r.num_iterations[s]), r.stats_k[s], r.stats_dinf[s])


def phase_lp_path(device):
    """The LP path on the card: bench_accuracy's LP through Program, then
    LP_BATCH of them through solve_scenarios, in both mu modes, each held
    to its limits and to the same solve on the CPU.  No kernel runs on it:
    K1 and K2 must not launch."""
    import numpy as np
    import torch

    from conex_tpu_torch import Program, convert, solve_scenarios
    from conex_tpu_torch.cones import psd_schur
    from conex_tpu_torch.parallel import fused_socp

    kernels = (psd_schur.schur_kernel, fused_socp.solve_socp_kernel)
    for kernel in kernels:
        kernel.launches = 0
    m, n = LP_SHAPE
    A, b, c = lp_instance(0)
    for line_search in (False, True):
        mode = "line search" if line_search else "divergence"
        config = lp_config(line_search)
        out = {}
        for where in ("card", "cpu"):
            prog = Program(m, device=device if where == "card" else "cpu")
            prog.add_linear_constraint(A, c)
            res = prog.solve(b, config)
            if not res.solved:
                fail(f"LP {m} x {n} ({mode}) not solved on the {where}")
            out[where] = (prog, res)
        prog, res = out["card"]
        ok, (gap, dual, e_cpu) = check_lp(
            f"{m} x {n} ({mode})", A, b, c,
            *(program_solution(*out[where]) for where in ("card", "cpu")))
        if not ok:
            fail(f"the LP {m} x {n} ({mode}) breaks the limits on the card")
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            prog.solve(b, config)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        log(f"[4c lp path] Program, {m} vars x {n} inequalities, f64, {mode}: "
            f"solved in {res.num_iterations} iterations (CPU "
            f"{out['cpu'][1].num_iterations}), relative gap {gap:.3e} (limit "
            f"{LP_GAP_LIMIT}), dual residual {dual:.3e} (limit {LP_DUAL_LIMIT}), "
            f"least slack {float((c - A @ res.y).min()):.3e}, y vs CPU {e_cpu:.3e} "
            f"(limit {LP_Y_LIMIT}); wall per solve {best * 1e3:.3f} ms (best of 3), "
            f"Newton it/s {res.num_iterations / best:.2f}")

    # The batch: scenario s drawn with seed s, as one solve.
    S = LP_BATCH
    As, bs, cs = map(np.stack, zip(*(lp_instance(s) for s in range(S))))
    broken = {}
    for line_search in (False, True):
        mode = "line search" if line_search else "divergence"
        config = lp_config(line_search)

        def run(bv, dev):
            blk = convert.linear_cone(As, cs, dev)
            return solve_scenarios(
                (blk,), (), convert.tensor(bv, dev),
                (torch.ones((S, n), dtype=torch.float64, device=dev),),
                convert.scalars(dict(k=np.zeros(S), b_scaling=np.ones(S),
                                     c_scaling=np.ones(S)), dev), config)

        t0 = time.perf_counter()
        r = convert.to_numpy(run(bs, device))
        first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run(bs, device)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        r_cpu = convert.to_numpy(run(bs, torch.device("cpu")))
        # The CPU's own sensitivity to one rounding: b moved by 2^-52.
        r_ulp = convert.to_numpy(run(bs * (1 + 2.0**-52), torch.device("cpu")))
        rel = lambda u, v: np.linalg.norm(u - v, axis=1) / np.linalg.norm(v, axis=1)  # noqa: E731
        vertex = np.stack([lp_vertex(As[s], cs[s], r_cpu.y[s]) for s in range(S)])
        log(f"[4c lp path] batch ({mode}): y card vs CPU max {rel(r.y, r_cpu.y).max():.3e} "
            f"median {np.median(rel(r.y, r_cpu.y)):.3e}, iterations differ in "
            f"{int((r.num_iterations != r_cpu.num_iterations).sum())}; CPU with b "
            f"moved by 2^-52 vs CPU: y max {rel(r_ulp.y, r_cpu.y).max():.3e} median "
            f"{np.median(rel(r_ulp.y, r_cpu.y)):.3e}, iterations differ in "
            f"{int((r_ulp.num_iterations != r_cpu.num_iterations).sum())}; distance "
            f"from the optimal vertex: card max {rel(r.y, vertex).max():.3e}, CPU max "
            f"{rel(r_cpu.y, vertex).max():.3e}, CPU moved max {rel(r_ulp.y, vertex).max():.3e}")
        if not r.solved.all():
            fail(f"LP batch ({mode}): scenarios {np.flatnonzero(~r.solved).tolist()} "
                 "not solved on the card")
        worst, bad = np.zeros(3), []
        for s in range(S):
            ok, errs = check_lp(f"batch scenario {s} ({mode})", As[s], bs[s], cs[s],
                                batch_solution(r, s), batch_solution(r_cpu, s),
                                batch=True)
            worst = np.maximum(worst, errs)
            if not ok:
                bad.append(s)
        total = int(r.num_iterations.sum())
        log(f"[4c lp path] batch of {S} scenarios (seeds 0-{S - 1}), f64, {mode}: "
            f"all solved in {int(r.num_iterations.min())}-{int(r.num_iterations.max())} "
            f"iterations; worst relative gap {worst[0]:.3e}, "
            f"dual residual {worst[1]:.3e}, y vs CPU {worst[2]:.3e}; wall per solve "
            f"{best * 1e3:.3f} ms (best of 3; first {first * 1e3:.3f} ms), Newton "
            f"it/s {total / best:.2f} ({total} iterations)")
        median = float(np.median(rel(r.y, r_cpu.y)))
        if median > LP_Y_LIMIT:
            log(f"LP batch ({mode}): the median y vs CPU {median:.3e} exceeds "
                f"{LP_Y_LIMIT}")
            bad.append("median")
        if bad:
            broken[mode] = bad
    if broken:
        fail(f"LP batch: scenarios break the limits on the card: {broken}")
    if any(kernel.launches for kernel in kernels):
        fail("K1 or K2 launched on the LP path")


def phase_lp_known_answer(device):
    """The verify skill's LP known answer on the card against the CPU, then
    a warmstart resume after save_state / load_state."""
    import numpy as np

    from conex_tpu_torch import WARMSTART, Program, SolverConfig

    # maximize y1 + 2 y2  s.t.  y1 <= 2, y2 <= 3, y1 + y2 <= 4: optimum (1, 3)
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    c = np.array([2.0, 3.0, 4.0])
    b = np.array([1.0, 2.0])
    config = SolverConfig(prepare_dual_variables=True, inv_sqrt_mu_max=1e4,
                          max_iterations=50)
    warm = config.replace(initialization_mode=WARMSTART)
    out = {}
    for where in ("card", "cpu"):
        dev = device if where == "card" else "cpu"
        prog = Program(2, device=dev)
        prog.add_linear_constraint(A, c)
        res = prog.solve(b, config)
        x = prog.get_dual_variable(0)
        resumed = Program(2, device=dev)
        resumed.add_linear_constraint(A, c)
        resumed.load_state(prog.save_state())
        res2 = resumed.solve(b, warm)
        out[where] = (res, x, res2)
    (res, x, res2), (res_cpu, x_cpu, res2_cpu) = out["card"], out["cpu"]
    e_obj = abs(float(b @ res.y) - 7.0)
    e_cpu = float(np.abs(res.y - res_cpu.y).max())
    e_dual = float(np.abs(x - x_cpu).max())
    e_kkt = float(np.abs(A.T @ x - b).max())
    e_warm = float(np.abs(res2.y - res2_cpu.y).max())
    log(f"[5c lp known answer] y on the card {res.y.tolist()} in "
        f"{res.num_iterations} iterations: |b'y - 7| {e_obj:.3e} (limit 1e-6), "
        f"max |card - CPU| {e_cpu:.3e} (limit 1e-8), dual max |card - CPU| "
        f"{e_dual:.3e} (limit 1e-8), max |A'x - b| {e_kkt:.3e} (limit 1e-6); "
        f"warmstart after save_state/load_state: solved {res2.solved} in "
        f"{res2.num_iterations} iterations (limit 3, CPU {res2_cpu.num_iterations}), "
        f"max |card - CPU| {e_warm:.3e} (limit 1e-8)")
    if not (res.solved and res_cpu.solved and e_obj <= 1e-6 and e_cpu <= 1e-8
            and e_dual <= 1e-8 and e_kkt <= 1e-6):
        fail("the LP known answer does not hold on the card")
    if not (res2.solved and res2.num_iterations <= 3
            and res2.num_iterations == res2_cpu.num_iterations and e_warm <= 1e-8):
        fail("the warmstart resume after save_state/load_state does not hold")


# ---------------------------------------------------------------------------
# The Schur-phase probes (kernels K3-K6)
# ---------------------------------------------------------------------------


def nonsymmetric_inputs(B, m, n, seed, device):
    """A, W and C uniform on [-1, 1], float32, made on the card from a
    seed: no symmetry anywhere."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.rand(*shape, generator=g, device=device) * 2 - 1
                 for shape in ((B, m, n, n), (B, n, n), (B, n, n)))


def a_plan_record(plan, itemsize):
    """What a K3/K6 call runs under: K1's plan at S = 1, Bc = B, with its
    scratch (the panels of a chunk and the partials) in bytes."""
    import math

    return dict(cones_per_chunk=plan.cones_per_chunk, chunks=plan.chunks,
                depth_chunks=plan.depth_chunks, launches=plan.launches,
                scratch_bytes=itemsize * (math.prod(plan.scratch_shape)
                                          + math.prod(plan.partial_shape)))


def probe_variants():
    """{variant: (its plain version, its kernel wrapper)} of PROBES."""
    import importlib

    out = {}
    for name, module, _, _ in PROBES:
        mod = importlib.import_module(f"conex_tpu_torch.benchmarks.{module}")
        out[name] = (getattr(mod, f"{name}_plain"), getattr(mod, f"{name}_kernel"))
    return out


def phase_probe_kernels(device):
    """Returns each probe kernel's record: max |kernel - plain| in f32 at
    the probe shape, and the CUDA-event times of both there."""
    import torch

    from conex_tpu_torch.benchmarks import dev_pallas_probe
    from conex_tpu_torch.cones import psd_schur

    variants = probe_variants()
    records = {name: {} for name in variants}
    B, m, n = PROBE_SHAPE
    for name in AT_LAYOUT:
        plan = dev_pallas_probe.probe_at_plan(B, m, n, 4)
        records[name]["plan"] = dict(route=plan.route, cones_per_chunk=plan.cones_per_chunk,
                                     operators_per_block=plan.operators_per_block,
                                     depth_chunks=plan.depth_chunks,
                                     slabs_per_chunk=plan.slabs_per_chunk,
                                     shared_bytes=plan.shared_bytes,
                                     scratch_bytes=plan.scratch_bytes)
        log(f"[3c probe kernels] {name} probe shape f32 plan: {plan.describe()}; "
            f"design traffic, counted from the plan, "
            f"{plan.traffic_bytes() / 1e9:.4f} GB, "
            f"{1e3 * plan.traffic_bytes() / HBM_BYTES_PER_S:.4f} ms at 3.35 TB/s")
    for name in variants:
        if name not in AT_LAYOUT:
            records[name]["plan"] = a_plan_record(
                dev_pallas_probe.probe_a_plan(B, m, n, 4), 4)
            log(f"[3c probe kernels] {name} probe shape f32 plan (K1's, S=1, "
                f"Bc={B}): {records[name]['plan']}")
    # m + 1 = 71 at the second shape: two 64-row tiles of the Gram matrix.
    # Nonsymmetric inputs tell K4/K5's function from the oracle's, and hold
    # every f32 fragment path to a transposed read or store: with symmetric
    # A, W and C, M_v, N and W are symmetric too.  The symmetric probe shape
    # comes last: K1's check and the times below use its inputs.
    for label, shape in (("small", (3, 5, 13)), ("two tiles", (2, 70, 130)),
                         ("nonsymmetric small", (3, 5, 13)),
                         ("nonsymmetric two tiles", (2, 70, 130)),
                         ("nonsymmetric probe", PROBE_SHAPE),
                         ("probe", PROBE_SHAPE)):
        nonsymmetric = label.startswith("nonsymmetric")
        if nonsymmetric:
            A, w, C = nonsymmetric_inputs(*shape, seed=7, device=device)
        else:
            A, w, C = dev_pallas_probe.probe_inputs(*shape, device)
        A64, w64, C64 = (x.double() for x in (A, w, C))
        oracle = dev_pallas_probe.einsum_schur(A64, w64, C64)
        for name, (plain, kernel) in variants.items():
            want64 = plain(A64, w64, C64)
            got64 = kernel(A64, w64, C64)
            torch.cuda.synchronize()
            e64 = rel_err(got64, want64)
            msg = (f"[3c probe kernels] {name} {label} B,m,n={shape}: f64 rel err {e64:.3e} "
                   f"(limit 1e-12); G's distance from einsum_schur "
                   f"{rel_err(got64[:1], oracle[:1]):.3e}")
            if not e64 <= 1e-12:
                fail(f"{name}: f64 kernel disagrees with its plain version at {label}: {e64}")
            if nonsymmetric or label == "probe":
                got32, plain32 = kernel(A, w, C), plain(A, w, C)
                again = kernel(A, w, C)
                torch.cuda.synchronize()
                e32 = rel_err(got32, want64)
                same = all(torch.equal(g, a) for g, a in zip(got32, again))
                max_abs = max(float((g - p).abs().max()) for g, p in zip(got32, plain32))
                msg += (f"; f32 rel err vs f64 plain {e32:.3e} (limit 1e-4; plain f32 "
                        f"{rel_err(plain32, want64):.3e}); f32 max |kernel - plain| "
                        f"{max_abs:.3e}; two f32 calls give the same bits: {same}")
                if not e32 <= 1e-4:
                    fail(f"{name}: f32 kernel disagrees with the f64 plain version "
                         f"at {label}: {e32}")
                if not same:
                    fail(f"{name}: two f32 calls at {label} differ")
                if label == "probe":
                    records[name]["max_abs_err"] = max_abs
                del got32, plain32, again
            log(msg)
        del oracle
    del got64

    # K1 on the same inputs, as one program of B cones (S = 1, Bc = B).
    def as_one_program(A, w, C):
        return A.view(1, B, m, n, n), w.view(1, B, n, n), C.view(1, B, n, n)

    k1_args = as_one_program(A, w, C)
    e64 = rel_err([x[0] for x in psd_schur.schur_kernel(
        *as_one_program(A64, w64, C64))], want64)
    got32, again = (psd_schur.schur_kernel(*k1_args) for _ in range(2))
    torch.cuda.synchronize()
    e32 = rel_err([x[0] for x in got32], want64)
    same = all(torch.equal(g, a) for g, a in zip(got32, again))
    log(f"[3c probe kernels] K1 at S=1, Bc={B}: f64 rel err {e64:.3e} (limit "
        f"1e-12); f32 rel err vs f64 oracle {e32:.3e} (limit 1e-4); two f32 "
        f"calls give the same bits: {same}")
    if not (e64 <= 1e-12 and e32 <= 1e-4 and same):
        fail(f"K1 at S=1 disagrees with the f64 oracle or with itself: "
             f"{e64}, {e32}, same bits {same}")
    del got32, again
    del A64, w64, C64, want64

    # CUDA-event times at the probe shape in f32, each kernel and its plain
    # version in turns (plain, kernel, kernel, plain), 10 calls each.
    for name, (plain, kernel) in variants.items():
        ms = {"plain": [], "kernel": []}
        fns = {"plain": lambda: plain(A, w, C), "kernel": lambda: kernel(A, w, C)}
        for which in ("plain", "kernel", "kernel", "plain"):
            ms[which].append(time_ms(fns[which], 10))
        log(f"[3c probe kernels] {name} probe shape f32 ms per call: kernel "
            f"{ms['kernel']}, plain {ms['plain']} (CUDA events, 10 calls each)")
        records[name].update(ms=min(ms["kernel"]), plain_ms=min(ms["plain"]),
                             **schur_bound(B, 1, m, n, tensor_cores=True,
                                           at_layout=name in AT_LAYOUT))
    ms = {"einsum_schur": [], "K1": []}
    fns = {"einsum_schur": lambda: dev_pallas_probe.einsum_schur(A, w, C),
           "K1": lambda: psd_schur.schur_kernel(*k1_args)}
    for which in ("einsum_schur", "K1", "K1", "einsum_schur"):
        ms[which].append(time_ms(fns[which], 10))
    log(f"[3c probe kernels] probe shape f32 ms per call: einsum_schur "
        f"{ms['einsum_schur']}, K1 at S=1, Bc={B} {ms['K1']} (CUDA events, 10 "
        f"calls each); K1's bound {schur_bound(B, 1, m, n, tensor_cores=True)}")
    return records


def phase_probe_entry_points():
    """The two probe harnesses on the card; returns each variant's kernel
    launches in this phase."""
    from conex_tpu_torch.benchmarks import dev_pallas_probe, dev_tpu_probe2
    from conex_tpu_torch.cones import psd_schur
    from conex_tpu_torch.parallel import fused_socp

    kernels = {name: kernel for name, (_, kernel) in probe_variants().items()}
    others = (psd_schur.schur_kernel, fused_socp.solve_socp_kernel)
    for kernel in (*kernels.values(), *others):
        kernel.launches = 0
    t0 = time.perf_counter()
    dev_pallas_probe.main([",".join(map(str, PROBE_SHAPE))])
    dev_tpu_probe2.part2()
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    log(f"[6 probe entry points] {time.perf_counter() - t0:.2f} s, kernel "
        f"launches {launches}")
    if not all(launches.values()):
        fail(f"a probe variant did not launch its kernel: {launches}")
    if any(kernel.launches for kernel in others):
        fail("the probes launched K1 or K2")

    # K4 reads A in place: a call holds its plan's scratch and outputs, and
    # no At copy of A.
    import torch

    A, w, C = dev_pallas_probe.probe_inputs(*PROBE_SHAPE, "cuda")
    plan = dev_pallas_probe.probe_at_plan(*PROBE_SHAPE, A.element_size())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dev_pallas_probe.fused_b_kernel(A, w, C)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - held
    log(f"[6 probe entry points] one K4 call: peak device memory above what it "
        f"was given {extra} bytes; its plan's scratch {plan.scratch_bytes} bytes; "
        f"A {A.numel() * A.element_size()} bytes")
    if extra > plan.scratch_bytes + (1 << 20):
        fail("K4's call holds more than its plan's scratch: a copy of A?")

    # K3 runs K1's kernels on views: a call holds K1's panel scratch and
    # partials under its plan, and no copy of A.
    a_plan = a_plan_record(dev_pallas_probe.probe_a_plan(*PROBE_SHAPE, A.element_size()),
                           A.element_size())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dev_pallas_probe.fused_a_kernel(A, w, C)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - held
    log(f"[6 probe entry points] one K3 call: peak device memory above what it "
        f"was given {extra} bytes; its plan's panel scratch and partials "
        f"{a_plan['scratch_bytes']} bytes")
    if extra > a_plan["scratch_bytes"] + (1 << 20):
        fail("K3's call holds more than its plan's scratch: a copy of A?")
    return launches


def main():
    card = card_name_and_power_limit()
    log(f"[1 card] {card}")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[1 card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{kind}, {count} visible")

    from conex_tpu_torch import _build

    build = _build.build(force=True)
    log(f"[2 build] nvcc {build.seconds:.2f} s -> {build.path.name}")
    for line in build.log.splitlines():
        if ("ptxas info" in line and ("Used" in line or "entry" in line)
                or "stack frame" in line):
            log(f"[2 build] {line.strip()}")

    schur = phase_kernel(device)
    fused = phase_fused_kernel(device)
    probes = phase_probe_kernels(device)
    schur["launches"] = phase_main_path(device)
    phase_small_vs_cpu(device)
    fused["launches"] = phase_socp_main_path(device)
    phase_lp_path(device)
    phase_known_answer(device)
    phase_soc_known_answer(device)
    phase_lp_known_answer(device)
    for name, n in phase_probe_entry_points().items():
        probes[name]["launches"] = n

    kernels = [
        dict(name="schur", route="cuda", source=SCHUR_SOURCE,
             replaces=SCHUR_REPLACES, library_ms=None, **schur),
        dict(name="fused_socp", route="cuda", source=FUSED_SOURCE,
             replaces=FUSED_REPLACES, library_ms=None, **fused),
    ] + [dict(name=name, route="cuda", source=source, replaces=replaces,
              library_ms=None, **probes[name])
         for name, _, replaces, source in PROBES]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "plan")
    log(LIBRARY_NOTE)
    print(json.dumps({"kernels": [{k: kern[k] for k in keys if k != "plan" or k in kern}
                                  for kern in kernels]}), flush=True)
    print(card_name_and_power_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
