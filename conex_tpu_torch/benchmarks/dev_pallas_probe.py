"""Probe: two formulations of the fused Schur phase on the card.

Twin of ``benchmarks/dev_pallas_probe.py``.  For one program of B dense LMI
cones summed into one result it forms

    G_vu = tr(A_v W A_u W)   AW_v = tr(A_v W)   AQc_v = tr(C W A_v W)
    w_dot_c = tr(C W)        c_dot_Qc = tr(C W C W)

from A (B, m, n, n), w and C (B, n, n), in two formulations, each against
``einsum_schur``, the oracle:

* ``fused_a`` (K3, the A layout): the panel P = A.reshape(m n, n) @ W as
  one product, then G as one product of depth n^2 with the panel's
  transpose;
* ``fused_b`` (K4, the At layout): At = A with axes 1 and 2 swapped,
  Pb = At.reshape(n m, n) @ W and Rb = W @ At.reshape(n, m n), then
  G = sum_i Pb[i] Rb[i]^T.

Each ``fused_*`` sends a CUDA tensor to its hand-written kernel in
``csrc/schur_probes.cu`` (``fused_*_kernel``, with a ``.launches`` counter)
and a CPU tensor to its plain PyTorch version (``fused_*_plain``); any
other device raises.  The kernels compute in the inputs' type, float32 or
float64.

    python -m conex_tpu_torch.benchmarks.dev_pallas_probe [B,m,n] [--device cpu]

runs the probe (default 256,50,100 on the card) and prints each
variant's errors against the oracle and its best time of 5.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def einsum_schur(A, w, C):
    P = torch.einsum("bvij,bjk->bvik", A, w)
    CW = C @ w
    G = torch.einsum("bvik,buki->vu", P, P)
    AW = torch.einsum("bvii->v", P)
    AQc = torch.einsum("bik,bvki->v", CW, P)
    w_dot_c = torch.einsum("bii->", CW)
    c_dot_Qc = torch.einsum("bik,bki->", CW, CW)
    return G, AW, AQc, w_dot_c, c_dot_Qc


def _traces_of_cw(CW):
    """w_dot_c = tr(C W) and c_dot_Qc = sum(CW * CW^T), over the cones."""
    return (CW.diagonal(dim1=1, dim2=2).sum(),
            (CW * CW.transpose(1, 2)).sum())


# ---------------- Variant A: one big product over the A layout ---------------
def fused_a_plain(A, w, C):
    """K3's formulation (benchmarks/dev_pallas_probe.py:51-65) in plain
    PyTorch: P3 = A.reshape(m n, n) @ W, G = P3 (m x n^2) times the
    transposed P3 (n^2 x m), summed over the cones."""
    B, m, n, _ = A.shape
    P3 = (A.reshape(B, m * n, n) @ w).reshape(B, m, n, n)
    PT3 = P3.transpose(2, 3)
    G = (P3.reshape(B, m, n * n) @ PT3.reshape(B, m, n * n).transpose(1, 2)).sum(0)
    CW = C @ w
    AW = P3.diagonal(dim1=2, dim2=3).sum((0, 2))
    AQc = (P3 * CW.transpose(1, 2)[:, None]).sum((0, 2, 3))
    return (G, AW, AQc, *_traces_of_cw(CW))


# ---------------- Variant B: batch-leading products over the At layout -------
def fused_b_plain(A, w, C):
    """K4's formulation (benchmarks/dev_pallas_probe.py:84-107) in plain
    PyTorch: Pb[i,v,k] = (A_v W)[i,k] and Rb[i,u,k] = (W A_u)[i,k] from
    At (n, m, n), G = sum_i Pb[i] Rb[i]^T, summed over the cones."""
    B, m, n, _ = A.shape
    At = A.transpose(1, 2)  # (B, n, m, n)
    Pb = (At.reshape(B, n * m, n) @ w).reshape(B, n, m, n)
    Rb = (w @ At.reshape(B, n, m * n)).reshape(B, n, m, n)
    G = (Pb @ Rb.transpose(2, 3)).sum((0, 1))
    CW = C @ w
    AW = Pb.diagonal(dim1=1, dim2=3).sum((0, 2))
    AQc = (Pb * CW.transpose(1, 2)[:, :, None, :]).sum((0, 1, 3))
    return (G, AW, AQc, *_traces_of_cw(CW))


# ---------------- The kernels --------------------------------------------------
_GRID_LIMIT = 65535  # CUDA's bound on gridDim.y, which runs over the cones


def check_shapes(A, w, C):
    """Raise unless A is (B, m, n, n) and w, C are (B, n, n) of one floating
    type on one device."""
    if A.dim() != 4 or A.shape[2] != A.shape[3]:
        raise ValueError(f"A must be (B, m, n, n), got {tuple(A.shape)}")
    B, m, n, _ = A.shape
    if w.shape != (B, n, n) or C.shape != (B, n, n):
        raise ValueError(f"w and C must be {(B, n, n)}, got {tuple(w.shape)}, "
                         f"{tuple(C.shape)}")
    if min(B, m, n) < 1:
        raise ValueError(f"empty shape {tuple(A.shape)}")
    if not (A.device == w.device == C.device):
        raise ValueError(f"tensors on different devices: {A.device}, {w.device}, "
                         f"{C.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the probe kernels take float32 or float64, not {A.dtype}")
    if not (A.dtype == w.dtype == C.dtype):
        raise TypeError(f"dtypes differ: {A.dtype}, {w.dtype}, {C.dtype}")


def check_kernel_inputs(A, w, C):
    check_shapes(A, w, C)
    if not A.is_cuda:
        raise ValueError("the probe kernels take CUDA tensors")
    if not (A.is_contiguous() and w.is_contiguous() and C.is_contiguous()):
        raise ValueError("the probe kernels take contiguous tensors")
    B, m, n, _ = A.shape
    if B > _GRID_LIMIT or (m + 1) * n * n >= 2**31:
        raise ValueError(f"shape {tuple(A.shape)} exceeds the kernels' launch grid")


def launch(variant, op, w, C, shape):
    """Run conex_probe_<variant> of csrc/schur_probes.cu on ``op`` (A, or
    At for the At-layout variants) and the checked w, C of A's ``shape``;
    returns (G, AW, AQc, w_dot_c, c_dot_Qc)."""
    from .._build import build

    B, m, n, _ = shape
    suffix = "f32" if op.dtype == torch.float32 else "f64"
    fn = getattr(build().lib, f"conex_probe_{variant}_{suffix}")
    kw = dict(dtype=op.dtype, device=op.device)
    X = torch.empty((B, m + 1, n, n), **kw)  # panel scratch
    Y = torch.empty((B, m + 1, n, n), **kw)
    part = torch.empty((B, (m + 1) * (m + 2)), **kw)  # one partial per cone
    G = torch.empty((m, m), **kw)
    AW = torch.empty((m,), **kw)
    AQc = torch.empty((m,), **kw)
    wc = torch.empty((), **kw)
    cqc = torch.empty((), **kw)
    with torch.cuda.device(op.device):
        stream = torch.cuda.current_stream(op.device).cuda_stream
        err = fn(op.data_ptr(), w.data_ptr(), C.data_ptr(), X.data_ptr(),
                 Y.data_ptr(), part.data_ptr(), G.data_ptr(), AW.data_ptr(),
                 AQc.data_ptr(), wc.data_ptr(), cqc.data_ptr(), B, m, n, stream)
    if err != 0:
        raise RuntimeError(f"probe kernel {variant} launch failed: cudaError {err}")
    return G, AW, AQc, wc, cqc


def fused_a_kernel(A, w, C):
    """K3 on the card (replaces dev_pallas_probe.py::_kernel_a)."""
    check_kernel_inputs(A, w, C)
    out = launch("a", A, w, C, A.shape)
    fused_a_kernel.launches += 1
    return out


fused_a_kernel.launches = 0


def at_layout(A):
    """At (B, n, m, n), At[b,i,v,j] = A[b,v,i,j]: the operand that
    dev_pallas_probe.py:154 builds for _kernel_b."""
    return A.transpose(1, 2).contiguous()


def fused_b_kernel(A, w, C):
    """K4 on the card (replaces dev_pallas_probe.py::_kernel_b).  It reads
    At, made here from A, as the JAX wrapper means to (its pallas_call is
    given A instead, dev_pallas_probe.py:180)."""
    check_kernel_inputs(A, w, C)
    out = launch("b", at_layout(A), w, C, A.shape)
    fused_b_kernel.launches += 1
    return out


fused_b_kernel.launches = 0


def route(kernel, plain, A, w, C):
    """The kernel for CUDA tensors, the plain version for CPU tensors; any
    other device raises."""
    check_shapes(A, w, C)
    if A.device.type == "cuda":
        return kernel(A, w, C)
    if A.device.type == "cpu":
        return plain(A, w, C)
    raise ValueError(f"no probe kernel for device {A.device}")


def fused_a(A, w, C):
    return route(fused_a_kernel, fused_a_plain, A, w, C)


def fused_b(A, w, C):
    return route(fused_b_kernel, fused_b_plain, A, w, C)


# ---------------- The harness ----------------------------------------------------
def probe_inputs(B, m, n, device):
    """The probes' inputs (dev_pallas_probe.py:211-217), float32, seed 0:
    A uniform on [-1, 1] and symmetrized, w = X X^T + 0.1 I, C = I."""
    dtype = np.float32
    rng = np.random.default_rng(0)
    A = rng.uniform(-1, 1, (B, m, n, n)).astype(dtype)
    A = 0.5 * (A + np.swapaxes(A, 2, 3))
    w = rng.uniform(-1, 1, (B, n, n)).astype(dtype)
    w = np.einsum("bij,bkj->bik", w, w) + 0.1 * np.eye(n, dtype=dtype)
    C = np.broadcast_to(np.eye(n, dtype=dtype), (B, n, n)).copy()
    return tuple(torch.from_numpy(x).to(device) for x in (A, w, C))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(f, *args, reps=5):
    """f(*args) and its best host time over ``reps`` more calls, each ended
    by a synchronize."""
    device = args[0].device
    out = f(*args)
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        f(*args)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return out, best


def check(name, fn, A, w, C, ref):
    """Print fn's largest error on each output relative to ref's largest
    entry, and its best time of 5.  A failure raises."""
    out, best = timed(fn, A, w, C)
    errs = [float((o - r).abs().max() / (r.abs().max() + 1e-30))
            for o, r in zip(out, ref)]
    print(f"{name}: OK rel_errs={['%.2e' % e for e in errs]} best={best * 1e3:.3f} ms",
          flush=True)
    return best


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("shape", nargs="?", default="256,50,100", help="B,m,n")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    B, m, n = (int(x) for x in args.shape.split(","))
    device = torch.device(args.device)
    A, w, C = probe_inputs(B, m, n, device)

    print(f"shape B={B} m={m} n={n}, device={device}", flush=True)
    ref, best = timed(einsum_schur, A, w, C)
    print(f"einsum oracle: best={best * 1e3:.3f} ms", flush=True)
    check("fused_a (one big product, A layout)", fused_a, A, w, C, ref)
    check("fused_b (batch-leading products, At layout)", fused_b, A, w, C, ref)


if __name__ == "__main__":
    main()
