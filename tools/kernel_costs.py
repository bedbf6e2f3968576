"""What the port's kernel build costs, and where the SOCP path's time goes.

    python3 tools/kernel_costs.py [build] [fma] [profile] [probes]

Needs one CUDA card and nvcc; imports nothing of JAX.  Four parts (all of
them when none is named), each printing its own lines:

1. build: the nvcc wall time of the library as ``conex_tpu_torch._build``
   builds it (one nvcc per source, in parallel, then a link), beside one
   nvcc call that compiles the sources in turn;
2. FMA: the library built twice more, with the product build's flags
   (``-fmad=false``) and with FMA contraction (nvcc's default); CUDA-event times
   of the Schur kernel (K1) at bench.py's shape and of the fused SOCP
   kernel (K2) on bench_socp's workload at S = 1,000, 10,000, 100,000, in
   turns (fma, nofma, nofma, fma), and how far the two builds' f32 results
   lie apart;
3. profile: torch.profiler over one solve of bench_socp's workload through
   solve_socp_fused at S = 1,000 and 100,000 and through solve_scenarios
   with SOCCone at S = 10,000: the unprofiled wall (best of 3), the
   device-kernel time, its share of that wall, the kernel launches, and the
   largest kernels;
4. probes: the same profile of one call of each Schur probe kernel
   (K3-K6), of its plain version and of K1 as one program (S = 1, Bc =
   256), on the probes' inputs at B = 256, m = 50, n = 100, f32: where
   each call's time goes, launch by launch.

A run of all four parts holds the card for several minutes (part 2 builds
the library twice); naming parts runs only those, so a question about one
of them costs the card time of that part alone (``probes`` alone: about
30 s).  Run from the repository root.  The extra libraries go to
``conex_tpu_torch/_build/`` beside the product build.
"""

import ctypes
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the workloads and the timing helper)

SIZES = (1_000, 10_000, 100_000)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def log(msg):
    print(msg, flush=True)


def compile_library(name, flags):
    """The sources compiled with ``flags``, one nvcc each in parallel, and
    linked into BUILD_DIR/<name>.so; a loaded Build."""
    from conex_tpu_torch import _build

    nvcc = _build._nvcc()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"{name}.so"
    objs = [_build.BUILD_DIR / f"{name}.{src.stem}.o" for src in _build.SOURCES]
    t0 = time.perf_counter()
    text = _build._run_all([[nvcc, *flags, "-c", "-o",
                             str(obj), str(src)] for src, obj in zip(_build.SOURCES, objs)])
    text += _build._run_all([[nvcc, "-shared", "-o", str(out), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _build._bind(lib)
    return _build.Build(lib=lib, path=out, seconds=seconds, log=text)


def part_build():
    from conex_tpu_torch import _build

    built = _build.build(force=True)
    log(f"[build] product build (one nvcc per source in parallel, then a "
        f"link): {built.seconds:.2f} s")
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


def profile(label, fn):
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):  # the attribute's name differs between torch versions
        if hasattr(e, "self_device_time_total"):
            return e.self_device_time_total
        return e.self_cuda_time_total

    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in events if e.key in LAUNCH_CALLS)
    log(f"[profile] {label}: wall {best * 1e3:.3f} ms (best of 3, unprofiled); "
        f"device-kernel time {device_ms:.3f} ms in {sum(e.count for e in kernels)} "
        f"device ops, {launches} launch calls; device busy "
        f"{100 * device_ms / (best * 1e3):.1f}% of the wall")
    for e in sorted(kernels, key=dev_us, reverse=True)[:5]:
        log(f"[profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<6} {e.key[:90]}")


def part_profile(device):
    import torch

    from conex_tpu_torch import solve_scenarios
    from conex_tpu_torch.cones.soc import SOCCone
    from conex_tpu_torch.parallel.fused_socp import solve_socp_fused

    config = chip_smoke.socp_config()
    for S in (1_000, 100_000):
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
    from conex_tpu_torch.benchmarks import dev_pallas_probe
    from conex_tpu_torch.cones import psd_schur

    B, m, n = chip_smoke.PROBE_SHAPE
    A, w, C = dev_pallas_probe.probe_inputs(B, m, n, device)
    for name, (plain, kernel) in chip_smoke.probe_variants().items():
        profile(f"{name} kernel", lambda: kernel(A, w, C))
        profile(f"{name}_plain", lambda: plain(A, w, C))
    profile(f"K1 S=1, Bc={B}", lambda: psd_schur.schur_kernel(
        A.view(1, B, m, n, n), w.view(1, B, n, n), C.view(1, B, n, n)))


PARTS = {"build": lambda device: part_build(), "fma": part_fma,
         "profile": part_profile, "probes": part_probes}


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
