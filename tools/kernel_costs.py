"""What the port's kernel build costs, and where the paths' time goes.

    python3 tools/kernel_costs.py [build] [fma] [profile] [probes] [sdp] [k1] [k2] [lp] [kkt] [herm]

Needs one CUDA card and nvcc; imports nothing of JAX.  Ten parts (all of
them when none is named), each printing its own lines:

1. build: the nvcc wall time of the library as ``conex_tpu_torch._build``
   builds it (one nvcc per compilation unit, in parallel, then a link),
   each unit's own time in that parallel run, csrc/fused_socp.cu compiled
   as one unit (both working types) alone, and one nvcc call that compiles
   the sources in turn;
2. FMA: the library built twice more, with the product build's flags
   (``-fmad=false``) and with FMA contraction (nvcc's default); CUDA-event times
   of the Schur kernel (K1) at bench.py's shape and of the fused SOCP
   kernel (K2) on bench_socp's workload at S = 1,000, 10,000, 100,000, in
   turns (fma, nofma, nofma, fma), and how far the two builds' f32 results
   lie apart;
3. profile: torch.profiler over one solve of bench_socp's workload through
   solve_socp_fused at S = 1,000, 10,000 and 100,000 (one K2 launch and the
   epilogue's elementwise launches; the inputs go to K2 in the caller's
   layout, with no permute copies) and through solve_scenarios with SOCCone
   at S = 10,000: the unprofiled wall (best of 3), the device-kernel time,
   its share of that wall, the kernel launches, and the largest kernels;
4. probes: the same profile of one call of each Schur probe kernel
   (K3-K6), of its plain version and of K1 as one program (S = 1, Bc =
   256), on the probes' inputs at B = 256, m = 50, n = 100, f32: where
   each call's time goes, launch by launch (K3 and K6: K1's panel, Gram
   and reduce under K1's plan at S = 1, Bc = 256, printed; K4 and K5:
   sandwich, Gram, reduce); then K4 on its two routes in turns, T kept
   in shared memory against T written to device memory (profiled too),
   and K4 under
   variants of csrc/schur_probes.cu built beside the product (one TF32
   pass, no products, two other warp units of the sandwich), each
   profiled with its error;
5. sdp: the same profile of one solve of the SDP main path (bench.py's
   workload, chip_smoke.bench_workload: 256 scenarios, n = 100, m = 50,
   f32, 30 iterations), with the device time of its 15 largest kernels
   and the launches per iteration;
6. k1: K1 (the Schur kernel) at the main path's shape (S = 256, Bc = 1)
   and as one program of 256 cones (S = 1, Bc = 256), f32, under several
   plans (cones/psd_schur.py: SCRATCH_BYTES, the panel scratch of a chunk
   of cones, and GRAM_BLOCKS_PER_SM, which sets the depth split): each
   plan, CUDA-event times in turns, and one profiled call of the product
   plan, launch by launch; then, at the main path's shape, variants of
   csrc/schur.cu built beside the product (one TF32 pass instead of three,
   and no products at all), each profiled launch by launch with its error
   against the f64 oracle: what the products cost over the copies;
7. k2: the fused SOCP kernel (K2) on bench_socp's workload at S = 1,000,
   10,000 and 100,000, f32, under every TEAM on both routes (a build with
   every TEAM, ALL_TEAMS_BUILD, beside the product, which holds TEAM 8 and
   32): CUDA-event times in turns, the plan's pick
   (parallel/fused_socp.py::socp_plan), and one profiled call of the pick,
   launch by launch; then the pick under variants of
   csrc/fused_socp.cu built beside the product (K2_VARIANTS: a stage's
   chains cut out, the sums not unrolled or in chunks of 8, the stage
   functions out of line), in turns: where the time goes;
8. lp: the same profile of one solve of the LP path (chip_smoke.py phase
   4c: bench_accuracy's 200 x 400 LP in f64) through Program and of the
   batch of 64 through solve_scenarios, in both mu modes, with the
   launches per iteration of the longest scenario;
9. kkt: the same profile of the indefinite-KKT path (chip_smoke.py phases
   4d and 4e): one solve of the 256 equality-constrained SDPs (f64, LDLT),
   one LDLT factor and one LDLT solve of their (256, 60, 60) KKT matrices,
   the QP batch of 64 and the QP of seed 0 through Program;
10. herm: the same profile of the Hermitian path (chip_smoke.py phase 4f:
   bench_hermitian.py's batch of 32 complex LMIs, n = 64, m = 16, f32, 30
   fixed iterations) with the warm seeds and with the cold estimator
   forced, and of the same batch at d = 4, each with its 15 largest
   kernels and the launches per iteration.

A run of all the parts holds the card for several minutes (part 2 builds
the library twice); naming parts runs only those, so a question about one
of them costs the card time of that part alone.  Run from the repository root.  The extra libraries go to
``conex_tpu_torch/_build/`` beside the product build.
"""

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the workloads and the timing helper)

SIZES = (1_000, 10_000, 100_000)


def log(msg):
    print(msg, flush=True)


def compile_library(name, flags):
    """The compilation units built with ``flags``, one nvcc each in
    parallel, and linked into BUILD_DIR/<name>.so; a loaded Build."""
    from conex_tpu_torch import _build

    nvcc = _build._nvcc()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"{name}.so"
    objs = [_build.BUILD_DIR / f"{name}.{unit}.o" for _, _, unit in _build.UNITS]
    t0 = time.perf_counter()
    text = _build._run_all([[nvcc, *flags, *unit_flags, "-c", "-o", str(obj), str(src)]
                            for (src, unit_flags, _), obj in zip(_build.UNITS, objs)])
    text += _build._run_all([[nvcc, "-shared", "-o", str(out), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _build._bind(lib)
    return _build.Build(lib=lib, path=out, seconds=seconds, log=text)


def timed_compiles(cmds):
    """Run the commands in parallel; the seconds each took to finish."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
             for cmd in cmds]
    seconds = [None] * len(procs)
    while None in seconds:
        for i, proc in enumerate(procs):
            if seconds[i] is None and proc.poll() is not None:
                if proc.returncode:
                    raise RuntimeError(f"failed ({proc.returncode}): {' '.join(cmds[i])}")
                seconds[i] = time.perf_counter() - t0
        time.sleep(0.05)
    return seconds


def part_build():
    from conex_tpu_torch import _build

    built = _build.build(force=True)
    log(f"[build] product build (one nvcc per compilation unit in parallel, "
        f"then a link): {built.seconds:.2f} s")
    nvcc, obj = _build._nvcc(), str(_build.BUILD_DIR / "unit_timing.o")
    units = [[nvcc, *_build.NVCC_FLAGS, *flags, "-c", "-o", f"{obj}.{tag}", str(src)]
             for src, flags, tag in _build.UNITS]
    for (_, _, tag), s in zip(_build.UNITS, timed_compiles(units)):
        log(f"[build] unit {tag}: {s:.2f} s (all units in parallel)")
    (s,) = timed_compiles([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", obj,
                            str(_build.SOURCES[1])]])
    log(f"[build] csrc/fused_socp.cu as one unit, both types, alone: {s:.2f} s")
    out = _build.BUILD_DIR / "single_call.so"
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                    *map(str, _build.SOURCES)], check=True, capture_output=True)
    log(f"[build] one nvcc call over the sources: {time.perf_counter() - t0:.2f} s")


def part_fma(device):
    import torch

    from conex_tpu_torch import _build
    from conex_tpu_torch.cones import psd_schur
    from conex_tpu_torch.parallel import fused_socp

    torch.backends.cuda.matmul.allow_tf32 = False
    fma_flags = tuple(f for f in _build.NVCC_FLAGS if f != "-fmad=false")
    builds = {"fma": compile_library("variant_fma", fma_flags),
              "nofma": compile_library("variant_nofma", _build.NVCC_FLAGS)}
    for name, b in builds.items():
        log(f"[fma] built {name} in {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "ptxas info" in line and "Used" in line:
                log(f"[fma] {name}: {line.strip()}")
    order = ("fma", "nofma", "nofma", "fma")

    def timed(fn):
        ms = {name: [] for name in builds}
        for name in order:
            _build._loaded = builds[name]  # route the wrappers to this build
            ms[name].append(chip_smoke.time_ms(fn, 3))
        return ms

    A, W, C = (x.float() for x in chip_smoke.schur_inputs(256, 1, 50, 100, seed=1,
                                                          device=device))
    ms = timed(lambda: psd_schur.schur_kernel(A, W, C))
    log(f"[fma] K1 S,Bc,m,n=(256, 1, 50, 100) f32 ms per call: {ms} "
        f"(CUDA events, 3 calls each)")
    del A, W, C
    config = chip_smoke.socp_config()
    for S in SIZES:
        args = chip_smoke.fused_inputs(*chip_smoke.socp_workload(S), torch.float32,
                                       device)
        ms = timed(lambda: fused_socp.solve_socp_kernel(*args, config))
        log(f"[fma] K2 S={S} f32, 30 iterations, ms per call: {ms} "
            f"(CUDA events, 3 calls each)")
        outs = {}
        for name, b in builds.items():
            _build._loaded = b
            outs[name] = fused_socp.solve_socp_kernel(*args, config)
        rel = chip_smoke.stats_rel(outs["fma"].stats_k, outs["nofma"].stats_k)
        log(f"[fma] K2 S={S} f32 stats_k, fma build against nofma build: "
            f"iterations 1-2 median {float(rel[:, :2].median()):.3e}, whole "
            f"trajectory median {float(rel.median()):.3e}, max {float(rel.max()):.3e}")
        del args, outs
    _build._loaded = None


def profile(label, fn, iterations=None, top=5):
    """The unprofiled wall of fn (best of 3) and one profiled call
    (chip_smoke.device_profile): device-kernel time, launches, busy share
    and the largest kernels."""
    fn()
    best = chip_smoke.best_wall(fn)
    device_ms, launches, kernels = chip_smoke.device_profile(fn)
    per = f" ({launches / iterations:.1f} per iteration)" if iterations else ""
    log(f"[profile] {label}: wall {best * 1e3:.3f} ms (best of 3, unprofiled); "
        f"device-kernel time {device_ms:.3f} ms in {sum(k[1] for k in kernels)} "
        f"device ops, {launches} launch calls{per}; device busy "
        f"{100 * device_ms / (best * 1e3):.1f}% of the wall")
    for ms, count, key in kernels[:top]:
        log(f"[profile]   {ms:9.3f} ms x{count:<6} {key[:90]}")


def part_profile(device):
    import torch

    from conex_tpu_torch import solve_scenarios
    from conex_tpu_torch.cones.soc import SOCCone
    from conex_tpu_torch.parallel.fused_socp import solve_socp_fused

    config = chip_smoke.socp_config()
    for S in SIZES:
        A, c, b = (torch.from_numpy(x).to(device) for x in chip_smoke.socp_workload(S))
        profile(f"solve_socp_fused S={S}", lambda: solve_socp_fused(A, c, b, config))
    S = 10_000
    A, c, b = (torch.from_numpy(x).to(device) for x in chip_smoke.socp_workload(S))
    w0 = torch.zeros(A.shape[:3], dtype=A.dtype, device=device)
    w0[..., 0] = 1.0
    scalars = dict(k=torch.zeros((S,), dtype=A.dtype, device=device),
                   b_scaling=torch.ones((S,), dtype=A.dtype, device=device),
                   c_scaling=torch.ones((S,), dtype=A.dtype, device=device))
    profile(f"solve_scenarios SOCCone S={S}",
            lambda: solve_scenarios((SOCCone(A=A, c=c),), (), b, (w0,), scalars, config))


def part_probes(device):
    from conex_tpu_torch import _build
    from conex_tpu_torch.benchmarks import dev_pallas_probe as p1
    from conex_tpu_torch.cones import psd_schur

    B, m, n = chip_smoke.PROBE_SHAPE
    A, w, C = p1.probe_inputs(B, m, n, device)
    log(f"[probes] K3 and K6 f32 run K1's kernels under "
        f"{chip_smoke.a_plan_record(p1.probe_a_plan(B, m, n, 4), 4)}")
    for name, (plain, kernel) in chip_smoke.probe_variants().items():
        profile(f"{name} kernel", lambda: kernel(A, w, C))
        profile(f"{name}_plain", lambda: plain(A, w, C))
    profile(f"K1 S=1, Bc={B}", lambda: psd_schur.schur_kernel(
        A.view(1, B, m, n, n), w.view(1, B, n, n), C.view(1, B, n, n)))

    # K4's sandwich with T kept in shared memory (the shared route) against
    # T written to device memory and read back (the device route), in turns.
    plans = {route: p1.probe_at_plan(B, m, n, 4, route=route) for route in p1.ROUTES}
    p1.check_kernel_inputs(A, w, C)
    ms = {route: [] for route in plans}
    for route in list(plans) + list(plans)[::-1]:
        ms[route].append(chip_smoke.time_ms(lambda: p1.launch_at(A, w, C, plans[route]), 10))
    for route, plan in plans.items():
        log(f"[probes] K4 f32, {route} route: ms per call {ms[route]} (CUDA "
            f"events, 10 calls each, in turns); {plan.describe()}; design traffic "
            f"{plan.traffic_bytes() / 1e9:.4f} GB")
    profile("K4 kernel, device route", lambda: p1.launch_at(A, w, C, plans["device"]))

    # K4 under variants of csrc/schur_probes.cu built beside the product
    # (K1's: one TF32 pass, no products; and other warp tiles of the
    # sandwich), launch by launch, with the error against the f64 plain
    # version: what the products cost in each launch, and what the tile does.
    want = p1.fused_b_plain(A.double(), w.double(), C.double())
    builds = source_variants("schur_probes.cu", {**K1_VARIANTS, **SANDWICH_TILES},
                             _build._PROBE_AT_NAMES, _build._PROBE_AT_ARGTYPES)
    product = _build.build()
    try:
        for name, build in builds.items():
            _build._loaded = build
            err = chip_smoke.rel_err(p1.fused_b_kernel(A, w, C), want)
            log(f"[probes] K4 variant {name}: f32 rel err vs f64 plain {err:.3e}")
            profile(f"K4 kernel, variant {name}", lambda: p1.fused_b_kernel(A, w, C))
    finally:
        _build._loaded = product


def part_sdp(device):
    import torch

    from conex_tpu_torch import solve_scenarios

    torch.backends.cuda.matmul.allow_tf32 = False
    blk, b, init_ws, scalars, config = chip_smoke.bench_workload(device)
    profile("SDP main path, one solve of 30 iterations",
            lambda: solve_scenarios((blk,), (), b, init_ws, scalars, config),
            iterations=config.max_iterations, top=15)


def part_lp(device):
    import numpy as np
    import torch

    from conex_tpu_torch import Program, convert, solve_scenarios

    m, n = chip_smoke.LP_SHAPE
    A, b, c = chip_smoke.lp_instance(0)
    S = chip_smoke.LP_BATCH
    As, bs, cs = map(np.stack, zip(*(chip_smoke.lp_instance(s) for s in range(S))))
    blk = convert.linear_cone(As, cs, device)
    args = ((blk,), (), convert.tensor(bs, device),
            (torch.ones((S, n), dtype=torch.float64, device=device),),
            convert.scalars(dict(k=np.zeros(S), b_scaling=np.ones(S),
                                 c_scaling=np.ones(S)), device))
    for line_search in (False, True):
        mode = "line search" if line_search else "divergence"
        config = chip_smoke.lp_config(line_search)
        prog = Program(m, device=device)
        prog.add_linear_constraint(A, c)
        iters = prog.solve(b, config).num_iterations
        profile(f"LP {m} x {n} f64 through Program, {mode}",
                lambda: prog.solve(b, config), iterations=iters, top=10)
        iters = int(solve_scenarios(*args, config).num_iterations.max())
        profile(f"LP batch of {S} f64 through solve_scenarios, {mode}",
                lambda: solve_scenarios(*args, config), iterations=iters, top=10)


def part_kkt(device):
    import numpy as np
    import torch

    from conex_tpu_torch import KKT_SOLVER_LDLT, convert, solve_scenarios
    from conex_tpu_torch.solver import kkt

    S, n, m, p = chip_smoke.EQ_SDP_SHAPE
    args, (_, _, Aeq, _, _) = chip_smoke.eq_sdp_batch(range(S), n, m, p, device)
    config = chip_smoke.eq_sdp_config()
    iters = int(solve_scenarios(*args, config).num_iterations.max())
    profile(f"equality SDP, {S} scenarios, f64, LDLT", lambda: solve_scenarios(*args, config),
            iterations=iters, top=15)
    K = torch.zeros((S, m + p, m + p), dtype=torch.float64, device=device)
    K[:, :m, :m] = torch.eye(m, dtype=torch.float64, device=device)
    K[:, m:, :m] = torch.from_numpy(Aeq).to(device)
    K[:, :m, m:] = K[:, m:, :m].transpose(1, 2)
    f = kkt.factor(K, KKT_SOLVER_LDLT)
    rhs = torch.ones((S, m + p), dtype=torch.float64, device=device)
    profile(f"one LDLT factor ({S}, {m + p}, {m + p})", lambda: kkt.factor(K, KKT_SOLVER_LDLT))
    profile("one LDLT solve", lambda: kkt.solve(f, rhs, KKT_SOLVER_LDLT))

    nq, ni = chip_smoke.QP_SHAPE
    Q = chip_smoke.QP_BATCH
    Ws, As, bs, cs, _, _ = map(np.stack, zip(*(
        chip_smoke.qp_with_solution(nq, ni, np.random.default_rng(s)) for s in range(Q))))
    qargs = ((convert.quadratic_cost(Ws, device), convert.linear_cone(-As, bs, device)), (),
             convert.tensor(-cs, device),
             (torch.zeros((Q, 0), dtype=torch.float64, device=device),
              torch.ones((Q, ni), dtype=torch.float64, device=device)),
             convert.scalars(dict(k=np.zeros(Q), b_scaling=np.ones(Q),
                                  c_scaling=np.ones(Q)), device))
    qconfig = chip_smoke.qp_config()
    iters = int(solve_scenarios(*qargs, qconfig).num_iterations.max())
    profile(f"QP batch of {Q}, f64, LLT, line search", lambda: solve_scenarios(*qargs, qconfig),
            iterations=iters, top=10)
    W, A, b, c, _, _ = chip_smoke.qp_with_solution(nq, ni, np.random.default_rng(0))
    prog = chip_smoke.qp_program(nq, W, A, b, device)
    iters = prog.solve(-c, qconfig).num_iterations
    profile("QP seed 0 through Program", lambda: prog.solve(-c, qconfig),
            iterations=iters, top=10)


# (scratch MiB, Gram blocks per SM): chunks that stay in the 50 MB L2
# cache, then one chunk under several depth splits.
K1_PLANS = ((32, 3), (1024, 3), (1024, 6), (1024, 12), (1024, 24))
# Edits of csrc/schur.cu for part k1's variants.
_ONE_PASS = (("static constexpr int kPasses = 3;", "static constexpr int kPasses = 1;"),
             ("      mma_tf32(c.c, a.lo, b.hi);\n    } else if",
              "      mma_tf32(c.c, a.hi, b.hi);\n    } else if"))
_NO_PRODUCTS = _ONE_PASS + (
    ("  hi = tf32_round(x);\n  lo = tf32_round(x - __uint_as_float(hi));",
     "  hi = __float_as_uint(x);\n  lo = 0u;"),
    ("""  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));""",
     "  c[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1]);"))
K1_VARIANTS = {"one TF32 pass": _ONE_PASS, "no products": _NO_PRODUCTS}


def _sandwich_tile(fm, fn, threads):
    """Edits of csrc/schur_probes.cu: the sandwich's warp unit of fm x fn
    fragments, in blocks of ``threads``."""
    return (("constexpr int SW_FM = 1;", f"constexpr int SW_FM = {fm};"),
            ("constexpr int SW_FN = 7;", f"constexpr int SW_FN = {fn};"),
            ("constexpr int SW_THREADS = 448;", f"constexpr int SW_THREADS = {threads};"))


SANDWICH_TILES = {"sandwich unit 2 x 4, 512 threads": _sandwich_tile(2, 4, 512),
                  "sandwich unit 1 x 13, 224 threads": _sandwich_tile(1, 13, 224)}


def source_variants(source, variants, entries, argtypes):
    """csrc/<source> with the header csrc/mma.cuh written into it, under
    each {name: edits} of ``variants``, built beside the product into
    BUILD_DIR, one nvcc each in parallel; {name: Build} whose libraries
    bind ``entries`` only."""
    from conex_tpu_torch import _build

    path = _build.SOURCES[[p.name for p in _build.SOURCES].index(source)]
    base = path.read_text().replace('#include "mma.cuh"',
                                    _build.HEADERS[0].read_text())
    procs = {}
    for name, edits in variants.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: csrc/{source} lacks {old!r}")
            text = text.replace(old, new)
        stem = f"variant_{path.stem}_" + re.sub(r"\W+", "_", name)  # nvcc-safe
        src, out = _build.BUILD_DIR / f"{stem}.cu", _build.BUILD_DIR / f"{stem}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    builds = {}
    for name, (out, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{text}")
        lib = ctypes.CDLL(str(out))
        for fn in entries:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        builds[name] = _build.Build(lib=lib, path=out, seconds=0.0, log=text)
    return builds


def part_k1(device):
    from conex_tpu_torch.benchmarks import dev_pallas_probe
    from conex_tpu_torch.cones import psd_schur

    default = psd_schur.SCRATCH_BYTES, psd_schur.GRAM_BLOCKS_PER_SM

    def use(mib, bps):
        psd_schur.SCRATCH_BYTES, psd_schur.GRAM_BLOCKS_PER_SM = mib << 20, bps

    A, W, C = (x.float() for x in chip_smoke.schur_inputs(256, 1, 50, 100, seed=1,
                                                          device=device))
    B, m, n = chip_smoke.PROBE_SHAPE
    Ap, w, Cp = dev_pallas_probe.probe_inputs(B, m, n, device)
    shapes = {"S=256, Bc=1": (A, W, C),
              "S=1, Bc=256": (Ap.view(1, B, m, n, n), w.view(1, B, n, n),
                              Cp.view(1, B, n, n))}
    try:
        for label, args in shapes.items():
            ms = {plan: [] for plan in K1_PLANS}
            for plan in K1_PLANS + K1_PLANS[::-1]:
                use(*plan)
                ms[plan].append(chip_smoke.time_ms(
                    lambda: psd_schur.schur_kernel(*args), 10))
            for plan in K1_PLANS:
                use(*plan)
                sp = psd_schur.schur_plan(*args[0].shape[:4], 4)
                log(f"[k1] {label} f32, scratch {plan[0]} MiB, {plan[1]} Gram blocks "
                    f"per SM: {sp}, {sp.launches} launches; ms per call "
                    f"{ms[plan]} (CUDA events, 10 calls each)")
            psd_schur.SCRATCH_BYTES, psd_schur.GRAM_BLOCKS_PER_SM = default
            profile(f"K1 {label} f32, product plan", lambda: psd_schur.schur_kernel(*args))
    finally:
        psd_schur.SCRATCH_BYTES, psd_schur.GRAM_BLOCKS_PER_SM = default

    from conex_tpu_torch import _build

    product = _build.build()
    oracle = psd_schur.schur_plain(A.double(), W.double(), C.double())
    builds = source_variants("schur.cu", K1_VARIANTS,
                             ("conex_schur_f32", "conex_schur_f64"),
                             _build._SCHUR_ARGTYPES)
    try:
        for name, build in builds.items():
            _build._loaded = build
            err = chip_smoke.rel_err(psd_schur.schur_kernel(A, W, C), oracle)
            log(f"[k1] variant {name}: f32 rel err vs f64 oracle {err:.3e}")
            profile(f"K1 S=256, Bc=1 f32, variant {name}",
                    lambda: psd_schur.schur_kernel(A, W, C))
    finally:
        _build._loaded = product


# Edits of csrc/fused_socp.cu for part k2's variants.  The first two cut
# a stage's chains out (timing only: their results are wrong, but every
# scenario still runs its 30 iterations); the others change only the form
# of the code and give the product's bits.
_SUM_CHUNKS = ("""#pragma unroll 4
  for (int i = lo; i < hi; ++i) s = s + term(i);""", """  int i = lo;
  for (; i + 8 <= hi; i += 8) {
    T t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = term(i + k);
#pragma unroll
    for (int k = 0; k < 8; ++k) s = s + t[k];
  }
  for (; i < hi; ++i) s = s + term(i);""")
K2_VARIANTS = {
    "no substitutions": (("  __device__ void chol_solve(T* v) const {\n    if (lane == 0) {",
                          "  __device__ void chol_solve(T* v) const {\n    if (lane == 0 && v[0] == T(12345)) {"),),
    "no Cholesky sums": (
        ("const T acc = sum_terms(T(0), 0, j, [=](int t) { return lj[t] * lj[t]; });",
         "const T acc = T(0);"),
        ("const T s = sum_terms(T(0), 0, j, [=](int t) { return li[t] * lj[t]; });",
         "const T s = T(0);")),
    "sums not unrolled": (("#pragma unroll 4\n  for (int i = lo; i < hi; ++i) s = s + term(i);",
                           "  for (int i = lo; i < hi; ++i) s = s + term(i);"),
                          ("#pragma unroll 4\n  for (int i = lo; i < hi; ++i) s = s - term(i);",
                           "  for (int i = lo; i < hi; ++i) s = s - term(i);")),
    "sums in chunks of 8": (_SUM_CHUNKS,),
    "stage functions out of line": tuple(
        (f"  __device__ {f}", f"  __device__ __noinline__ {f}")
        for f in ("void spectral(", "void qrep(", "void assemble(", "bool cholesky(",
                  "void chol_solve(", "void solve_kkt(", "void minus_slack(")) + (
        ("__device__ T mu_from_divergence(", "__device__ __noinline__ T mu_from_divergence("),),
}


# The build of csrc/fused_socp.cu, as it stands, with every TEAM of
# fused_socp.ALL_TEAMS (the product holds TEAM 8 and 32 only).
ALL_TEAMS_BUILD = "every TEAM"


def k2_variants():
    """csrc/fused_socp.cu built beside the product, float32 only, in
    parallel into BUILD_DIR: under each of K2_VARIANTS, and as
    ALL_TEAMS_BUILD; {name: Build}."""
    from conex_tpu_torch import _build

    base = _build.SOURCES[1].read_text()
    jobs = {name: (edits, ()) for name, edits in K2_VARIANTS.items()}
    jobs[ALL_TEAMS_BUILD] = ((), ("-DCONEX_SOCP_ALL_TEAMS",))
    cmds, outs = [], {}
    for name, (edits, defines) in jobs.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: csrc/fused_socp.cu lacks {old!r}")
            text = text.replace(old, new)
        stem = "k2_variant_" + name.replace(" ", "_")
        src, out = _build.BUILD_DIR / f"{stem}.cu", _build.BUILD_DIR / f"{stem}.so"
        src.write_text(text)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-DCONEX_SOCP_PART=1", *defines,
                     "-shared", "-o", str(out), str(src)])
        outs[name] = out
    t0 = time.perf_counter()
    _build._run_all(cmds)
    log(f"[k2] {len(cmds)} builds beside the product, in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    builds = {}
    for name, out in outs.items():
        lib = ctypes.CDLL(str(out))
        lib.conex_socp_fused_f32.argtypes = _build._SOCP_ARGTYPES
        lib.conex_socp_fused_f32.restype = ctypes.c_int
        builds[name] = _build.Build(lib=lib, path=out, seconds=0.0, log="")
    return builds


def part_k2(device):
    import torch

    from conex_tpu_torch import _build
    from conex_tpu_torch.parallel import fused_socp

    config = chip_smoke.socp_config()
    product = _build.build()
    builds = k2_variants()
    all_teams = builds.pop(ALL_TEAMS_BUILD)
    variants = {"product": product, **builds}
    for S in SIZES:
        args = chip_smoke.fused_inputs(*chip_smoke.socp_workload(S), torch.float32,
                                       device)
        pick = chip_smoke.fused_plan(args, config)
        plans = {f"TEAM {t} {r}": chip_smoke.fused_plan(args, config, team=t, route=r)
                 for t in fused_socp.ALL_TEAMS for r in ("shared", "global")}
        ms = {name: [] for name in plans}
        try:
            _build._loaded = all_teams
            for name in list(plans) + list(plans)[::-1]:
                plan = plans[name]
                ms[name].append(chip_smoke.time_ms(
                    lambda: fused_socp.solve_socp_kernel(*args, config, plan=plan), 3))
        finally:
            _build._loaded = product
        for name, plan in plans.items():
            log(f"[k2] S={S} f32 {name}: ms per call {ms[name]} (CUDA events, 3 "
                f"calls each, in turns); {plan.describe()}")
        log(f"[k2] S={S}: the plan's pick: {pick.describe()}")
        profile(f"K2 S={S} f32, the plan's pick",
                lambda: fused_socp.solve_socp_kernel(*args, config, plan=pick))
        ms = {name: [] for name in variants}
        want = fused_socp.solve_socp_kernel(*args, config, plan=pick)
        try:
            for name in list(variants) + list(variants)[::-1]:
                _build._loaded = variants[name]
                got = fused_socp.solve_socp_kernel(*args, config, plan=pick)
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                ms[name].append(chip_smoke.time_ms(
                    lambda: fused_socp.solve_socp_kernel(*args, config, plan=pick), 3))
                ms[name].append("same bits" if same else "other bits")
        finally:
            _build._loaded = product
        for name, v in ms.items():
            log(f"[k2] S={S} f32, the plan's pick, {name}: ms per call {v[0::2]} "
                f"(CUDA events, 3 calls each, in turns); results: {v[1]}")
        del args, want


def part_herm(device):
    from conex_tpu_torch import solve_scenarios
    from conex_tpu_torch.cones import hermitian

    S, d, n, m = chip_smoke.HERM_SHAPE
    config = chip_smoke.herm_config()
    for dim, cold in ((d, False), (d, True), (4, False)):
        args = chip_smoke.herm_args(*chip_smoke.herm_workload(S, dim, n, m), device)
        hermitian.FORCE_COLD = cold
        try:
            profile(f"Hermitian batch S={S}, d={dim}, n={n}, m={m}, f32, "
                    f"{'cold (FORCE_COLD)' if cold else 'warm'}",
                    lambda: solve_scenarios(*args, config),
                    iterations=config.max_iterations, top=15)
        finally:
            hermitian.FORCE_COLD = False


PARTS = {"build": lambda device: part_build(), "fma": part_fma,
         "profile": part_profile, "probes": part_probes, "sdp": part_sdp,
         "k1": part_k1, "k2": part_k2, "lp": part_lp, "kkt": part_kkt,
         "herm": part_herm}


def main(argv=None):
    import torch

    names = (sys.argv[1:] if argv is None else argv) or list(PARTS)
    unknown = set(names) - set(PARTS)
    if unknown:
        sys.exit(f"unknown parts {sorted(unknown)}; the parts are {list(PARTS)}")
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs a CUDA card")
    log(f"[card] {chip_smoke.card_name_and_power_limit()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    device = torch.device("cuda", 0)
    for name in names:
        PARTS[name](device)


if __name__ == "__main__":
    main()
