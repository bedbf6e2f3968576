"""Schur-complement phase of the dense LMI cone: CUDA kernel and plain twin.

Twin of ``conex_tpu/cones/psd_pallas.py``.  For every scenario s, summed
over its Bc cones b, the phase forms

    G_vu  = tr(A_v W A_u W)      AW_v = tr(A_v W)      AQc_v = tr(C W A_v W)
    w_dot_c = tr(C W)            c_dot_Qc = tr(C W C W)

from A (S, Bc, m, n, n), W and C (S, Bc, n, n).

``schur_fused`` is the entry point.  A CUDA tensor goes to the hand-written
kernel in ``csrc/schur.cu`` (float32 or float64), or the call raises; a CPU
tensor goes to ``schur_plain``, the einsum formulation of
``conex_tpu/cones/psd.py:182-209`` with an explicit scenario axis.
``utils.profiling.counters["schur.calls"]`` counts the kernel's calls:
one per call, whatever number of CUDA launches the call makes (the
``launches`` of its ``SchurPlan``).  The probes K3 and K6 (benchmarks/
dev_pallas_probe.py, dev_tpu_probe2.py) compute this function for one
program of cones and run the same kernels through ``launch_schur``,
which counts nothing: their wrappers keep their own counts.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.profiling import counters


def schur_plain(A, W, C):
    """(G, AW, AQc, w_dot_c, c_dot_Qc) in plain PyTorch."""
    P = torch.einsum("sbvij,sbjk->sbvik", A, W)  # A_v W panel
    CW = C @ W
    G = torch.einsum("sbvik,sbuki->svu", P, P)  # tr(A_v W A_u W)
    AW = torch.einsum("sbvii->sv", P)  # tr(A_v W)
    AQc = torch.einsum("sbik,sbvki->sv", CW, P)  # tr(C W A_v W)
    w_dot_c = torch.einsum("sbii->s", CW)
    c_dot_Qc = torch.einsum("sbik,sbki->s", CW, CW)  # tr(C W C W)
    return G, AW, AQc, w_dot_c, c_dot_Qc


# The kernel's tile sizes (csrc/schur.cu): a panel block computes a
# PANEL_ROWS x PANEL_COLS tile of Op_v W, a Gram block a GRAM_TILE square
# tile of M (E = M + M^T) over units of UNIT x UNIT pairs (i, k).
PANEL_ROWS = 112
PANEL_COLS = 104
GRAM_TILE = 64
UNIT = 8
# The most panel scratch one call holds: the cones go in chunks of at most
# this many bytes of panel.  On an H100, chunks small enough to stay in the
# 50 MB L2 cache measured slower than one chunk of the whole batch
# (tools/kernel_costs.py k1), so this only caps the memory of a call.
SCRATCH_BYTES = 1 << 30
# Gram blocks wanted per chunk, per SM (the split of the depth into
# chunks); more measured no faster (tools/kernel_costs.py k1).
GRAM_BLOCKS_PER_SM = 3
H100_SMS = 132
_GRID_YZ = 65535  # CUDA's bound on gridDim.y
_GRID_X = 2**31 - 1


def _cdiv(a, b):
    return -(-a // b)


def _units(n):
    """Pairs (I, K), I <= K, of UNIT-wide blocks of 0..n-1."""
    blocks = _cdiv(n, UNIT)
    return blocks * (blocks + 1) // 2


@dataclass(frozen=True)
class SchurPlan:
    """How one kernel call covers its work.

    The S Bc cones, flattened as s Bc + b, go in chunks of
    ``cones_per_chunk``; each chunk is a panel launch (P = Op_v W into a
    scratch of ``scratch_shape``) and a Gram launch.  The extended
    (m+1) x (m+1) Gram matrix is E = M + M^T, where M sums the depth
    units: pairs (I, K), I <= K, of UNIT-wide blocks of i and k
    (``units``, row-major).  A Gram block takes one cone, one tile (tv, tu)
    of M and one depth chunk: units [d U, (d+1) U), U =
    ``units_per_chunk``.  Unless a block holds a whole scenario's sum
    (``direct``: Bc = 1, one depth chunk, one tile), it writes a partial,
    and a last launch sums the partials of each scenario in (cone, depth
    chunk) order.
    """

    S: int
    Bc: int
    m: int
    n: int
    cones_per_chunk: int
    depth_chunks: int
    units_per_chunk: int

    @property
    def cones(self):
        return self.S * self.Bc

    @property
    def chunks(self):
        return _cdiv(self.cones, self.cones_per_chunk)

    @property
    def tiles(self):
        """Gram tiles along a side of M."""
        return _cdiv(self.m + 1, GRAM_TILE)

    @property
    def units(self):
        return _units(self.n)

    @property
    def direct(self):
        return self.Bc == 1 and self.depth_chunks == 1 and self.tiles == 1

    @property
    def scratch_shape(self):
        """The panels of a chunk, each in UNIT x UNIT blocks of n rounded up."""
        padded = UNIT * _cdiv(self.n, UNIT)
        return (self.cones_per_chunk, self.m + 1, padded, padded)

    @property
    def partial_shape(self):
        """One row per (cone, depth chunk): M row-major, then the m+1 traces."""
        if self.direct:
            return (0, 0)
        m1 = self.m + 1
        return (self.cones * self.depth_chunks, m1 * m1 + m1)

    @property
    def launches(self):
        return 2 * self.chunks + (0 if self.direct else 1)

    def chunk_cones(self, chunk):
        """(first flat cone, number of cones) of a chunk."""
        c0 = chunk * self.cones_per_chunk
        return c0, min(self.cones_per_chunk, self.cones - c0)

    def panel_grid(self, count):
        return (count * (self.m + 1),
                _cdiv(self.n, PANEL_ROWS) * _cdiv(self.n, PANEL_COLS))

    def gram_grid(self, count):
        return (count * self.depth_chunks, self.tiles * self.tiles)

    def reduce_grid(self):
        m = self.m
        return (self.S, _cdiv(m * m + 2 * m + 2, 32))

    def gram_blocks(self):
        """(s, b, tv, tu, d) of every Gram block of every chunk, decoded
        from the block index as ``gram_kernel`` decodes it."""
        out = []
        for chunk in range(self.chunks):
            c0, count = self.chunk_cones(chunk)
            gx, gy = self.gram_grid(count)
            for y in range(gy):
                tv, tu = divmod(y, self.tiles)
                for x in range(gx):
                    q, d = divmod(x, self.depth_chunks)
                    s, b = divmod(c0 + q, self.Bc)
                    out.append((s, b, tv, tu, d))
        return out

    def depth_units(self, d):
        """The units (I, K) of depth chunk d, decoded as the kernel does."""
        blocks = _cdiv(self.n, UNIT)
        lo = d * self.units_per_chunk
        hi = min(self.units, lo + self.units_per_chunk)
        I, K = 0, lo
        while K >= blocks - I:
            K -= blocks - I
            I += 1
        K += I
        out = []
        for _ in range(hi - lo):
            out.append((I, K))
            K += 1
            if K == blocks:
                I += 1
                K = I
        return out

    def check(self):
        """Raise ValueError if a launch grid exceeds CUDA's bounds."""
        gx, gy = self.panel_grid(self.cones_per_chunk)
        hx, hy = self.gram_grid(self.cones_per_chunk)
        rx, ry = self.reduce_grid()
        if max(gx, hx, rx) > _GRID_X or max(gy, hy, ry) > _GRID_YZ:
            raise ValueError(
                f"shape {(self.S, self.Bc, self.m, self.n)} exceeds the "
                "kernel's launch grid"
            )


def schur_plan(S, Bc, m, n, itemsize, sms=H100_SMS):
    """The plan of one call: as many cones per chunk as SCRATCH_BYTES of
    panel holds (at least one), and the depth split into as few chunks of
    whole units as give each chunk GRAM_BLOCKS_PER_SM Gram blocks per SM."""
    cone_bytes = (m + 1) * (UNIT * _cdiv(n, UNIT)) ** 2 * itemsize
    per_chunk = max(1, min(S * Bc, SCRATCH_BYTES // cone_bytes))
    tiles = _cdiv(m + 1, GRAM_TILE)
    units = _units(n)
    want = _cdiv(GRAM_BLOCKS_PER_SM * sms, per_chunk * tiles * tiles)
    per_depth = _cdiv(units, max(1, min(units, want)))
    return SchurPlan(S=S, Bc=Bc, m=m, n=n, cones_per_chunk=per_chunk,
                     depth_chunks=_cdiv(units, per_depth),
                     units_per_chunk=per_depth)


def launch_schur(A, W, C, plan):
    """Run csrc/schur.cu's kernels under ``plan`` on A (S, Bc, m, n, n), W
    and C (S, Bc, n, n), contiguous CUDA tensors of one type (float32 or
    float64) that the caller has checked; returns (G, AW, AQc, w_dot_c,
    c_dot_Qc) of shapes (S, m, m), (S, m), (S, m), (S,), (S,).  Counts no
    call: ``schur_kernel`` counts its own in ``schur.calls``, the probes
    K3/K6 theirs."""
    from .._build import build

    S, Bc, m, n, _ = A.shape
    if (plan.S, plan.Bc, plan.m, plan.n) != (S, Bc, m, n):
        raise ValueError(f"the plan is for {(plan.S, plan.Bc, plan.m, plan.n)}, "
                         f"not {(S, Bc, m, n)}")
    lib = build().lib
    fn = lib.conex_schur_f32 if A.dtype == torch.float32 else lib.conex_schur_f64
    kw = dict(dtype=A.dtype, device=A.device)
    P = torch.empty(plan.scratch_shape, **kw)  # panel scratch of one chunk
    part = None if plan.direct else torch.empty(plan.partial_shape, **kw)
    G = torch.empty((S, m, m), **kw)
    AW = torch.empty((S, m), **kw)
    AQc = torch.empty((S, m), **kw)
    wc = torch.empty((S,), **kw)
    cqc = torch.empty((S,), **kw)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(
            A.data_ptr(), W.data_ptr(), C.data_ptr(), P.data_ptr(),
            None if part is None else part.data_ptr(),
            G.data_ptr(), AW.data_ptr(), AQc.data_ptr(), wc.data_ptr(),
            cqc.data_ptr(), S, Bc, m, n, plan.cones_per_chunk,
            plan.depth_chunks, plan.units_per_chunk, stream,
        )
    if err != 0:
        raise RuntimeError(f"schur kernel launch failed: cudaError {err}")
    return G, AW, AQc, wc, cqc


def schur_kernel(A, W, C):
    """Launch the CUDA kernel on CUDA tensors; raises on what it does not take."""
    if not (A.is_cuda and W.is_cuda and C.is_cuda):
        raise ValueError("schur_kernel takes CUDA tensors")
    if not (A.device == W.device == C.device):
        raise ValueError(f"tensors on different devices: {A.device}, {W.device}, {C.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"schur_kernel takes float32 or float64, not {A.dtype}")
    if not (A.dtype == W.dtype == C.dtype):
        raise TypeError(f"dtypes differ: {A.dtype}, {W.dtype}, {C.dtype}")
    if A.dim() != 5 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"A must be (S, Bc, m, n, n), got {tuple(A.shape)}")
    S, Bc, m, n, _ = A.shape
    if W.shape != (S, Bc, n, n) or C.shape != (S, Bc, n, n):
        raise ValueError(
            f"W and C must be {(S, Bc, n, n)}, got {tuple(W.shape)}, {tuple(C.shape)}"
        )
    if min(S, Bc, m, n) < 1:
        raise ValueError(f"empty shape {tuple(A.shape)}")
    if not (A.is_contiguous() and W.is_contiguous() and C.is_contiguous()):
        raise ValueError("schur_kernel takes contiguous tensors")
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    plan = schur_plan(S, Bc, m, n, A.element_size(), sms)
    plan.check()
    out = launch_schur(A, W, C, plan)
    counters["schur.calls"] += 1
    return out


def schur_fused(A, W, C):
    """The Schur phase: the CUDA kernel for CUDA tensors, schur_plain for
    CPU tensors; any other device raises."""
    if A.device.type == "cuda":
        return schur_kernel(A, W, C)
    if A.device.type == "cpu":
        return schur_plain(A, W, C)
    raise ValueError(f"no Schur kernel for device {A.device}")
