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
  G = sum_i Pb[i] Rb[i]^T.  That is G_vu = tr(A_v W A_u^T W^T), the
  oracle's G only where A_v and W are symmetric (as in ``probe_inputs``).
  Its kernel computes the same function regrouped, from A read in place:
  M_v = W^T A_v W, N = (W C W)^T, G_vu = <M_v, A_u>, AW_v = <A_v, W^T>,
  AQc_v = <A_v, N>, w_dot_c = <C, W^T>, c_dot_Qc = <C, N>, under the plan
  of ``probe_at_plan``.

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
import math
import time
from dataclasses import dataclass

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


def launch(variant, A, w, C):
    """Run conex_probe_<variant> of csrc/schur_probes.cu (K3 or K6) on the
    checked A, w, C; returns (G, AW, AQc, w_dot_c, c_dot_Qc)."""
    from .._build import build

    B, m, n, _ = A.shape
    suffix = "f32" if A.dtype == torch.float32 else "f64"
    fn = getattr(build().lib, f"conex_probe_{variant}_{suffix}")
    kw = dict(dtype=A.dtype, device=A.device)
    X = torch.empty((B, m + 1, n, n), **kw)  # panel scratch
    Y = torch.empty((B, m + 1, n, n), **kw)
    part = torch.empty((B, (m + 1) * (m + 2)), **kw)  # one partial per cone
    G, AW, AQc, wc, cqc = _outputs(m, kw)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), w.data_ptr(), C.data_ptr(), X.data_ptr(),
                 Y.data_ptr(), part.data_ptr(), G.data_ptr(), AW.data_ptr(),
                 AQc.data_ptr(), wc.data_ptr(), cqc.data_ptr(), B, m, n, stream)
    if err != 0:
        raise RuntimeError(f"probe kernel {variant} launch failed: cudaError {err}")
    return G, AW, AQc, wc, cqc


def _outputs(m, kw):
    return (torch.empty((m, m), **kw), torch.empty((m,), **kw),
            torch.empty((m,), **kw), torch.empty((), **kw), torch.empty((), **kw))


def fused_a_kernel(A, w, C):
    """K3 on the card (replaces dev_pallas_probe.py::_kernel_a)."""
    check_kernel_inputs(A, w, C)
    out = launch("a", A, w, C)
    fused_a_kernel.launches += 1
    return out


fused_a_kernel.launches = 0


# ---------------- K4 and K5's plan -------------------------------------------
# The sizes of csrc/schur_probes.cu's At-layout kernels.  The sandwich's
# shared route holds W, split, and two n x n buffers in one block's shared
# memory (SwLayout); its device route is a 64 x 64 tile kernel run twice,
# with K slabs through a ring of RING_STAGES stages.
AT_GRAM_TILE = 64
AT_RING_TILE = 64
RING_STAGES = 3
SLAB_BYTES = 128  # the Gram's depth slab: 128 bytes of each row
SHARED_BYTES = 232_448  # a block's most dynamic shared memory on an H100
# The most scratch (Y, and T on the device route) one call holds: the
# cones go in chunks of at most this many bytes, as K1's panel does
# (cones/psd_schur.py::SCRATCH_BYTES).
SCRATCH_BYTES = 1 << 30
GRAM_BLOCKS_PER_SM = 3  # Gram blocks wanted per chunk, per SM
H100_SMS = 132
ROUTES = ("shared", "device")  # the kernel's route 0 and 1
_GRID_YZ = 65535  # CUDA's bound on gridDim.y
_GRID_X = 2**31 - 1


def _cdiv(a, b):
    return -(-a // b)


def at_shared_bytes(n, itemsize):
    """The sandwich's shared memory on the shared route (SwLayout): W split,
    E8 x LDW elements of 8 bytes (E8 = n rounded up to 8, LDW = 4 mod 16),
    and two NP x (NP + 4) buffers, NP = n rounded up to a fragment's rows
    (16 f32, 8 f64)."""
    e8 = 8 * _cdiv(n, 8)
    ldw = e8 + (4 - e8) % 16
    rows = 16 if itemsize == 4 else 8
    np_ = rows * _cdiv(n, rows)
    return e8 * ldw * 8 + 2 * np_ * (np_ + 4) * itemsize


def at_ring_bytes(itemsize):
    """The sandwich's shared memory on the device route: RING_STAGES stages
    of a 64 x KS slab of L and a KS x 64 slab of R (KS = 32 f32, 16 f64)."""
    ks = 32 if itemsize == 4 else 16
    t = AT_RING_TILE
    return RING_STAGES * (t * (ks + 4) + ks * (t + 8)) * itemsize


@dataclass(frozen=True)
class ProbeAtPlan:
    """How one call of K4 or K5 covers its work.

    The B cones go in chunks of ``cones_per_chunk``.  Per chunk, the
    sandwich (one launch on the ``"shared"`` route, two on ``"device"``)
    writes the scratch Y (``scratch_shape``: rows M_0 .. M_{m-1}, W^T, N of
    each cone; the device route also T, ``t_shape``); on the shared route a
    block takes ``operators_per_block`` of one cone's m+1 operators, and
    stages each while it multiplies the one before.  A Gram launch
    reads it back: a Gram block takes one cone, one tile of the
    (m+2) x (m+1) matrix E and one depth chunk d, ``slabs_per_chunk`` slabs
    of ``slab`` elements of the cone's n^2 depth (``depth_range``).  Each
    writes a partial row; one reduce adds them in a fixed order.
    """

    B: int
    m: int
    n: int
    itemsize: int
    route: str
    cones_per_chunk: int
    depth_chunks: int
    slabs_per_chunk: int
    operators_per_block: int

    @property
    def slab(self):
        return SLAB_BYTES // self.itemsize

    @property
    def slabs(self):
        """Slabs of one cone's depth n^2."""
        return _cdiv(self.n * self.n, self.slab)

    @property
    def chunks(self):
        return _cdiv(self.B, self.cones_per_chunk)

    @property
    def tiles(self):
        """Gram tiles of E: (m+2) rows by (m+1) columns."""
        return _cdiv(self.m + 2, AT_GRAM_TILE) * _cdiv(self.m + 1, AT_GRAM_TILE)

    @property
    def scratch_shape(self):
        return (self.cones_per_chunk, self.m + 2, self.n, self.n)

    @property
    def t_shape(self):
        """T = Op_v W of a chunk, on the device route only."""
        if self.route != "device":
            return None
        return (self.cones_per_chunk, self.m + 1, self.n, self.n)

    @property
    def partial_shape(self):
        """One row per (cone, depth chunk): E row-major."""
        return (self.B * self.depth_chunks, (self.m + 2) * (self.m + 1))

    @property
    def shared_bytes(self):
        """The sandwich's dynamic shared memory per block."""
        if self.route == "shared":
            return at_shared_bytes(self.n, self.itemsize)
        return at_ring_bytes(self.itemsize)

    @property
    def sandwich_blocks(self):
        """Blocks of one chunk's sandwich launch (each of the two on the
        device route)."""
        Q, m1 = self.cones_per_chunk, self.m + 1
        if self.route == "shared":
            return Q * _cdiv(m1, self.operators_per_block)
        return Q * m1

    @property
    def launches(self):
        sandwich = 1 if self.route == "shared" else 2
        return self.chunks * (sandwich + 1) + 1

    @property
    def scratch_bytes(self):
        elems = sum(math.prod(s) for s in (self.scratch_shape, self.t_shape,
                                           self.partial_shape) if s)
        return self.itemsize * elems

    def traffic_bytes(self):
        """Device-memory bytes of one call as designed: A and C read by the
        sandwich and again by the Gram, W read once (twice on the device
        route), Y written and read back, T too on the device route, the
        partials written and read, the outputs written."""
        B, m, nn = self.B, self.m, self.n * self.n
        total = (2 * B * (m + 1) * nn + B * nn + 2 * B * (m + 2) * nn
                 + 2 * math.prod(self.partial_shape) + m * m + 2 * m + 2)
        if self.route == "device":
            total += 2 * B * (m + 1) * nn + B * nn
        return self.itemsize * total

    def chunk_cones(self, chunk):
        """(first cone, number of cones) of a chunk."""
        c0 = chunk * self.cones_per_chunk
        return c0, min(self.cones_per_chunk, self.B - c0)

    def depth_range(self, d):
        """The depth [lo, hi) of n^2 that depth chunk d sums."""
        lo = d * self.slabs_per_chunk * self.slab
        return lo, min(self.n * self.n, lo + self.slabs_per_chunk * self.slab)

    def gram_blocks(self):
        """(cone, depth chunk, tile) of every Gram block of every chunk,
        decoded from the block index as ``gram_y_kernel`` decodes it."""
        out = []
        for chunk in range(self.chunks):
            c0, count = self.chunk_cones(chunk)
            for tile in range(self.tiles):
                for x in range(count * self.depth_chunks):
                    q, d = divmod(x, self.depth_chunks)
                    out.append((c0 + q, d, tile))
        return out

    def check(self):
        """Raise ValueError if a launch grid exceeds CUDA's bounds."""
        Q, m1 = self.cones_per_chunk, self.m + 1
        ring = _cdiv(self.n, AT_RING_TILE) ** 2
        xs = (self.sandwich_blocks, Q * self.depth_chunks,
              _cdiv(self.m * self.m + 2 * m1, 32))
        if max(xs) > _GRID_X or max(ring, self.tiles) > _GRID_YZ:
            raise ValueError(f"shape {(self.B, self.m, self.n)} exceeds the "
                             "kernels' launch grid")

    def describe(self):
        ops = (f" ({self.operators_per_block} operators a block)"
               if self.route == "shared" else "")
        return (f"route {self.route}{ops}, {self.cones_per_chunk} cones per chunk "
                f"({self.chunks} chunks), {self.depth_chunks} depth chunks of "
                f"{self.slabs_per_chunk} slabs of {self.slab}, shared "
                f"{self.shared_bytes} bytes, scratch {self.scratch_bytes} "
                f"bytes, {self.launches} launches")


def probe_at_plan(B, m, n, itemsize, sms=H100_SMS, route=None):
    """The plan of one K4 or K5 call: the shared route where its buffers
    fit a block (else the device route, or the ``route`` asked for, which
    raises where it cannot run), with the operators of a cone spread over
    as many blocks as give each SM one; as many cones per chunk as
    SCRATCH_BYTES of scratch holds (at least one); the depth split into as
    few chunks of whole slabs as give each chunk GRAM_BLOCKS_PER_SM Gram
    blocks per SM."""
    fits = at_shared_bytes(n, itemsize) <= SHARED_BYTES
    if route is None:
        route = "shared" if fits else "device"
    elif route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; the routes are {ROUTES}")
    elif route == "shared" and not fits:
        raise ValueError(f"the shared route does not hold n = {n} in "
                         f"{itemsize}-byte elements")
    nn = n * n
    cone_bytes = itemsize * nn * ((m + 2) + (m + 1 if route == "device" else 0))
    per_chunk = max(1, min(B, SCRATCH_BYTES // cone_bytes))
    tiles = _cdiv(m + 2, AT_GRAM_TILE) * _cdiv(m + 1, AT_GRAM_TILE)
    slabs = _cdiv(nn, SLAB_BYTES // itemsize)
    want = _cdiv(GRAM_BLOCKS_PER_SM * sms, per_chunk * tiles)
    per_depth = _cdiv(slabs, max(1, min(slabs, want)))
    opb = _cdiv(m + 1, min(m + 1, _cdiv(sms, per_chunk)))
    return ProbeAtPlan(B=B, m=m, n=n, itemsize=itemsize, route=route,
                       cones_per_chunk=per_chunk,
                       depth_chunks=_cdiv(slabs, per_depth),
                       slabs_per_chunk=per_depth, operators_per_block=opb)


def launch_at(A, w, C, plan=None):
    """K4's function on the card from the checked A, w, C, read in place:
    conex_probe_at of csrc/schur_probes.cu under ``plan`` (probe_at_plan's
    by default); returns (G, AW, AQc, w_dot_c, c_dot_Qc)."""
    from .._build import build

    B, m, n, _ = A.shape
    if plan is None:
        sms = torch.cuda.get_device_properties(A.device).multi_processor_count
        plan = probe_at_plan(B, m, n, A.element_size(), sms)
    if (plan.B, plan.m, plan.n, plan.itemsize) != (B, m, n, A.element_size()):
        raise ValueError(f"the plan is for {(plan.B, plan.m, plan.n, plan.itemsize)}, "
                         f"not {(B, m, n, A.element_size())}")
    plan.check()
    suffix = "f32" if A.dtype == torch.float32 else "f64"
    fn = getattr(build().lib, f"conex_probe_at_{suffix}")
    kw = dict(dtype=A.dtype, device=A.device)
    Y = torch.empty(plan.scratch_shape, **kw)
    Tb = torch.empty(plan.t_shape, **kw) if plan.t_shape else None
    part = torch.empty(plan.partial_shape, **kw)
    G, AW, AQc, wc, cqc = _outputs(m, kw)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), w.data_ptr(), C.data_ptr(), Y.data_ptr(),
                 None if Tb is None else Tb.data_ptr(), part.data_ptr(),
                 G.data_ptr(), AW.data_ptr(), AQc.data_ptr(), wc.data_ptr(),
                 cqc.data_ptr(), B, m, n, plan.cones_per_chunk,
                 plan.depth_chunks, plan.slabs_per_chunk,
                 ROUTES.index(plan.route), plan.operators_per_block, stream)
    if err != 0:
        raise RuntimeError(f"probe kernel at launch failed: cudaError {err}")
    return G, AW, AQc, wc, cqc


def fused_b_kernel(A, w, C):
    """K4 on the card (replaces dev_pallas_probe.py::_kernel_b): its
    function, tr(A_v W A_u^T W^T) and the rest, from A read in place (no
    At): launch_at."""
    check_kernel_inputs(A, w, C)
    out = launch_at(A, w, C)
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
