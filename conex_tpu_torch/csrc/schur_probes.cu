// The Schur-phase probe kernels K4 and K5, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the At-layout probes in benchmarks/:
//   K4  dev_pallas_probe.py::_kernel_b   (fused_b)   At layout
//   K5  dev_tpu_probe2.py::_kernel_b2    (fused_b2)  At layout, m padded to 8
// Each sums, over one program of B dense LMI cones, from A (B, m, n, n), W
// and C (B, n, n):
//
//   G_vu = tr(A_v W A_u^T W^T)   AW_v = tr(A_v W)   AQc_v = tr(C W A_v W)
//   wc = tr(C W)                 cqc = tr(C W C W)
//
// That G is the oracle's tr(A_v W A_u W) where A_v and W are symmetric, as
// in the probes' own inputs, and differs elsewhere; the kernels keep their
// TPU kernels' function for any input and assume no symmetry of A, W or C.
// The wrappers are in conex_tpu_torch/benchmarks/dev_pallas_probe.py and
// dev_tpu_probe2.py.
//
// The A-layout probes K3 (dev_pallas_probe.py::_kernel_a, fused_a) and K6
// (dev_tpu_probe2.py::_kernel_a2, fused_a2) have no kernel here.  They
// compute K1's function, tr(A_v W A_u W) and the same four other outputs,
// for any input, and take K1's layout: their A (B, m, n, n) is K1's
// (S, Bc, m, n, n) with S = 1, Bc = B, a view with no copy.  K6's padding
// of m to 8 changes no sum.  So both run csrc/schur.cu's kernels (K1's
// tensor-core panel, paired-block Gram and fixed-order reduce) under
// schur_plan(1, B, m, n, ...): dev_pallas_probe.py::launch_a.
//
// ---- K4, K5: E = sum_b Y_b X_b^T over regrouped products --------------------
//
// The TPU kernel forms Pb[i,v,k] = (A_v W)[i,k] and Rb[i,u,k] = (W A_u)[i,k]
// from At (B, n, m, n) and sums G_vu = sum_{i,k} Pb[i,v,k] Rb[i,u,k].  The
// same function, regrouped exactly for any input, with <X, Y> = sum_ij
// X_ij Y_ij summed over the cones:
//
//   M_v = W^T A_v W  (v < m)      N = (W C W)^T
//   G_vu = <M_v, A_u>    AW_v = <A_v, W^T>    AQc_v = <A_v, N>
//   wc = <C, W^T>        cqc = <C, N>
//
// With Y's rows M_0 .. M_{m-1}, W^T and N (Y (B, m+2, n, n), each row n^2
// long) and X's rows A_0 .. A_{m-1} and C, read in place from the caller's
// A and C, every output is an entry of E = sum_b Y_b X_b^T, (m+2) x (m+1):
// there is no At and no copy of A.  Per chunk of cones (the plan:
// dev_pallas_probe.py::probe_at_plan), then once:
//   1. sandwich: a block takes one cone's W, split once into TF32 hi and
//      lo in shared memory, and a range of its operators Op_v (v <= m,
//      Op_m = C): T = Op_v W into a second buffer as T^T, then T^T W =
//      M_v^T into Y's row v as M_v, or, for C, T^T W^T = N into row m + 1,
//      with W^T into row m.  Shared route (W, Op_v and T^T fit a block: n
//      <= 112 in f32, 96 in f64): T never reaches device memory, and the
//      block stages the next operator while it forms the second product.
//      Device route (the plan's choice where they do not fit): two launches
//      of a 64 x 64 tile kernel with K slabs through a cp.async ring, T
//      through scratch.
//   2. gram: one block of 4 warps per (cone, depth chunk, 64 x 64 tile of E)
//      sums Y_b X_b^T over its chunk of the n^2 depth, in slabs of 128 bytes
//      a row through a three-stage cp.async ring, and writes a partial;
//   3. reduce: each output sums the partial rows in a fixed order.  No
//      atomics: two calls give the same bits.
// Precision is K1's (mma.cuh): an f32 product is three TF32 m16n8k8 mma
// passes, lo*hi + hi*lo + hi*hi, and the Gram sums each slab in fresh
// accumulators, since the tensor cores' adds round toward zero; f64 is
// DMMA m8n8k4.
//
// K5 is K4.  Its TPU kernel pads m to 8 and n to 128 for Mosaic's (8, 128)
// tiling; zero padding changes no sum, and the mma tiles (16 x 8) already
// round every edge, so K5's wrapper launches these same kernels.
//
// What bounds K4 and K5.  Their function needs two n^3 products per
// operator and the whole of E: 4 (m+1) n^3 B + 2 (m^2 + 2m + 2) n^2 B =
// 52.2 + 13.3 = 65.5 GFLOP at the probe shape, 0.397 ms at three TF32
// passes on the tensor cores (495 TFLOP/s), against 0.53 GB of inputs and
// outputs.  As built, A is read twice (sandwich and Gram) and Y written and
// read once: about 2.1 GB, 0.63 ms at 3.35 TB/s, the design's own floor.
// On an H100 80GB HBM3 at 700 W a call takes 2.43 ms (PERF.md): the
// sandwich 1.83 ms, of which three mma.sync passes cost 0.74 ms over one
// and one pass 0.15 ms over none, and the rest is its staging, stores and
// barriers, one block per SM; the Gram 0.58 ms, 0.44 of it without
// products.  Past mma.sync's rate lies wgmma (later work).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

#include "mma.cuh"

constexpr int kWarp = 32;

// ---- sandwich, shared route -----------------------------------------------
//
// A block takes one cone's W and a range of its operators.  W is staged
// once, split into TF32 hi and lo (f32; f64 keeps W), in Ws: the B operand
// of both products, T = Op_v W and then M_v^T = T^T W (v < m) or N =
// T^T W^T (v = m, T = C W).  So each element that every warp reads is
// split once, and the A operands, Op_v in Oa and T^T in Ot, are split as a
// warp reads its own rows.  While the block forms the second product from
// Ot, Oa takes the next operator.  A warp's unit is SW_FM fragments of
// rows by a chunk of up to SW_FN fragments of columns; M_v^T goes from the
// registers to Y transposed (each store fills whole 32-byte sectors), N as
// it is.
constexpr int SW_FM = 1;
constexpr int SW_FN = 7;
constexpr int SW_THREADS = 448;
constexpr int SW_WARPS = SW_THREADS / kWarp;

// The B operand as it lies in Ws: f32 as (hi, lo), f64 as itself.
template <typename T>
struct PreSplit;

template <>
struct PreSplit<float> {
  using S = float2;
  __device__ static S make(float x) {
    uint32_t hi, lo;
    split(x, hi, lo);
    return make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }
  template <class F>
  __device__ static void load_b(Mma<float>::B& b, int lane, F f) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const S s = f(t + 4 * r, g);
      b.hi[r] = __float_as_uint(s.x);
      b.lo[r] = __float_as_uint(s.y);
    }
  }
};

template <>
struct PreSplit<double> {
  using S = double;
  __device__ static S make(double x) { return x; }
  template <class F>
  __device__ static void load_b(Mma<double>::B& b, int lane, F f) {
    b.x = f(lane & 3, lane >> 2);
  }
};

// The layout of the shared route, from n alone.  Ws is [E8][LDW] of
// PreSplit<T>::S (8 bytes), E8 = n rounded up to 8, LDW = 4 mod 16: the
// fragment reads of 8-byte elements, down its columns (t LDW + g) or along
// its rows (g LDW + t), hit 32 distinct banks per half warp.  Oa and Ot
// are [NP][NP + 4] of T, NP = n rounded up to Mma<T>::M, read along their
// rows (g LDO + t), and Ot written down its columns.
template <typename T>
struct SwLayout {
  int e8, ldw, np, ldo, ncf, chunks, stripes;
  __host__ __device__ explicit SwLayout(int n) {
    e8 = cdiv(n, 8) * 8;
    ldw = e8 + ((4 - e8) % 16 + 16) % 16;
    np = cdiv(n, Mma<T>::M) * Mma<T>::M;
    ldo = np + 4;
    ncf = cdiv(n, Mma<T>::N);
    chunks = cdiv(ncf, SW_FN);
    stripes = cdiv(n, SW_FM * Mma<T>::M);
  }
  __host__ __device__ int ws_elems() const { return e8 * ldw; }
  __host__ __device__ int os_elems() const { return np * ldo; }
  __host__ __device__ int bytes() const {
    return ws_elems() * 8 + 2 * os_elems() * int(sizeof(T));
  }
};

// acc = rows [row0, row0 + SW_FM F::M) of X (row stride ldx) times the
// column fragments [f0, f0 + nf) of Ws (kWT: of Ws^T), over depth steps
// F::K.  Fragments of rows past n are skipped.
template <typename T, bool kWT>
__device__ __forceinline__ void unit_product(
    typename Mma<T>::C (&acc)[SW_FM][SW_FN], int lane, int row0, int n, int f0,
    int nf, int steps, const typename PreSplit<T>::S* __restrict__ Ws, int ldw,
    const T* __restrict__ X, int ldx) {
  using F = Mma<T>;
  using P = PreSplit<T>;
#pragma unroll
  for (int fm = 0; fm < SW_FM; ++fm)
#pragma unroll
    for (int j = 0; j < SW_FN; ++j) F::zero(acc[fm][j]);
  // Two depth steps an iteration: one step's fragment loads and splits
  // overlap the other's products (a few percent of a K4 call, PERF.md).
#pragma unroll 2
  for (int kk = 0; kk < steps; ++kk) {
    const int k0 = kk * F::K;
    typename F::A a[SW_FM];
#pragma unroll
    for (int fm = 0; fm < SW_FM; ++fm)
      if (row0 + fm * F::M < n)
        F::load_a(a[fm], lane, [&](int r, int k) {
          return X[(row0 + fm * F::M + r) * ldx + k0 + k];
        });
    typename F::B b[SW_FN];
#pragma unroll
    for (int j = 0; j < SW_FN; ++j)
      if (j < nf)
        P::load_b(b[j], lane, [&](int k, int c) {
          const int col = (f0 + j) * F::N + c;
          return kWT ? Ws[col * ldw + k0 + k] : Ws[(k0 + k) * ldw + col];
        });
#pragma unroll
    for (int pass = 0; pass < F::kPasses; ++pass)
#pragma unroll
      for (int j = 0; j < SW_FN; ++j)
#pragma unroll
        for (int fm = 0; fm < SW_FM; ++fm)
          if (j < nf && row0 + fm * F::M < n)
            F::mma(pass, acc[fm][j], a[fm], b[j]);
  }
}

// Hands each accumulator of the unit to f(row, col, value).
template <typename T, class ST>
__device__ __forceinline__ void unit_store(
    const typename Mma<T>::C (&acc)[SW_FM][SW_FN], int lane, int row0, int n,
    int f0, int nf, ST f) {
  using F = Mma<T>;
#pragma unroll
  for (int fm = 0; fm < SW_FM; ++fm)
#pragma unroll
    for (int j = 0; j < SW_FN; ++j)
      if (j < nf && row0 + fm * F::M < n)
        F::store(acc[fm][j], lane, [&](int r, int c, T x) {
          f(row0 + fm * F::M + r, (f0 + j) * F::N + c, x);
        });
}

// Block (q, bb) of cone c0 + q takes operators [bb opb, (bb + 1) opb) of
// v <= m (Op_v = A[cone, v], Op_m = C[cone]).  Per operator: Oa <- Op_v;
// T = Oa Ws, written to Ot as T^T; then T^T Ws = M_v^T into Y[q, v] as
// M_v, or T^T Ws^T = N into Y[q, m + 1], with Y[q, m] = W^T from the block
// of v = m.  grid: count cdiv(m + 1, opb); SW_THREADS threads; dynamic
// shared memory SwLayout::bytes().  VW: elements per copy into Oa.
template <typename T, int VW>
__global__ void __launch_bounds__(SW_THREADS, 1)
sandwich_kernel(const T* __restrict__ A, const T* __restrict__ W,
                const T* __restrict__ C, T* __restrict__ Y, int64_t c0, int m,
                int n, int opb) {
  using F = Mma<T>;
  using P = PreSplit<T>;
  using S = typename P::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SwLayout<T> L(n);
  S* Ws = reinterpret_cast<S*>(smem_raw);
  T* Oa = reinterpret_cast<T*>(smem_raw + L.ws_elems() * 8);
  T* Ot = Oa + L.os_elems();
  const int m1 = m + 1;
  const int bpc = cdiv(m1, opb);
  const int64_t q = blockIdx.x / bpc;
  const int v_lo = blockIdx.x % bpc * opb;
  const int v_hi = min(m1, v_lo + opb);
  const int64_t cone = c0 + q;
  const int64_t nn = int64_t(n) * n;
  const T* w = W + cone * nn;
  T* Yq = Y + q * (m + 2) * nn;

  auto stage = [&](int v) {  // Oa <- Op_v, zero past n
    const T* op = v < m ? A + (cone * m + v) * nn : C + cone * nn;
    for (int idx = threadIdx.x; idx < L.np * (L.np / VW); idx += SW_THREADS) {
      const int r = idx / (L.np / VW), c = idx % (L.np / VW) * VW;
      const bool in = r < n && c < n;
      cp_async<VW>(Oa + r * L.ldo + c, in ? op + int64_t(r) * n + c : op, in);
    }
    cp_commit();
  };
  stage(v_lo);
  for (int idx = threadIdx.x; idx < L.e8 * L.e8; idx += SW_THREADS) {
    const int k = idx / L.e8, c = idx % L.e8;
    Ws[k * L.ldw + c] = P::make(k < n && c < n ? w[int64_t(k) * n + c] : T(0));
  }
  // Ot's rows past the columns of T stay zero: the second product reads
  // them as rows of its last fragments.
  for (int idx = threadIdx.x; idx < L.os_elems(); idx += SW_THREADS) Ot[idx] = T(0);
  cp_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int steps = cdiv(n, F::K);
  const int units = L.stripes * L.chunks;
  typename F::C acc[SW_FM][SW_FN];
  for (int v = v_lo; v < v_hi; ++v) {
    for (int u = warp; u < units; u += SW_WARPS) {
      const int row0 = u % L.stripes * SW_FM * F::M, ch = u / L.stripes;
      const int f0 = ch * L.ncf / L.chunks, nf = (ch + 1) * L.ncf / L.chunks - f0;
      unit_product<T, false>(acc, lane, row0, n, f0, nf, steps, Ws, L.ldw, Oa,
                             L.ldo);
      unit_store<T>(acc, lane, row0, n, f0, nf,
                    [&](int i, int j, T x) { Ot[j * L.ldo + i] = x; });  // T^T
    }
    __syncthreads();  // Ot holds T^T; Oa is free
    if (v + 1 < v_hi) stage(v + 1);
    const bool last = v == m;
    T* out = Yq + (last ? m + 1 : v) * nn;
    for (int u = warp; u < units; u += SW_WARPS) {
      const int row0 = u % L.stripes * SW_FM * F::M, ch = u / L.stripes;
      const int f0 = ch * L.ncf / L.chunks, nf = (ch + 1) * L.ncf / L.chunks - f0;
      if (last) {
        unit_product<T, true>(acc, lane, row0, n, f0, nf, steps, Ws, L.ldw, Ot,
                              L.ldo);
        unit_store<T>(acc, lane, row0, n, f0, nf, [&](int i, int j, T x) {
          if (i < n && j < n) out[int64_t(i) * n + j] = x;  // N
        });
      } else {
        unit_product<T, false>(acc, lane, row0, n, f0, nf, steps, Ws, L.ldw,
                               Ot, L.ldo);
        unit_store<T>(acc, lane, row0, n, f0, nf, [&](int i, int j, T x) {
          if (i < n && j < n) out[int64_t(j) * n + i] = x;  // M_v = (M_v^T)^T
        });
      }
    }
    if (last) {
      T* wt = Yq + int64_t(m) * nn;
      for (int idx = threadIdx.x; idx < n * n; idx += SW_THREADS)
        wt[idx] = w[int64_t(idx % n) * n + idx / n];
    }
    cp_wait<0>();
    __syncthreads();  // Oa holds the next operator; Ot is free
  }
}

// ---- sandwich, device route -----------------------------------------------
//
// One RG x RG tile of one n x n product per block, K in slabs of F::KS
// through a cp.async ring, one element per copy (an operand may be read
// transposed).  step 1: T[q, v] = Op_v W into the scratch Tb (count, m+1,
// n, n).  step 2: Y[q, v] = W^T T[q, v] for v < m; for v = m, Y[q, m + 1] =
// (W T[q, m])^T and the tile of Y[q, m] = W^T.  grid: (count (m + 1),
// tiles of n x n); dynamic shared memory kRingStages stages.
constexpr int RG = 64;
constexpr int kRingThreads = (RG / 16) * kWarp;  // a warp per 16-row stripe
constexpr int kRingStages = 3;

template <typename T>
__host__ __device__ constexpr int ring_stage() {  // Ls [RG][KS + 4], Rs [KS][RG + 8]
  return RG * (Mma<T>::KS + 4) + Mma<T>::KS * (RG + 8);
}

template <typename T>
__global__ void __launch_bounds__(kRingThreads)
ring_kernel(const T* __restrict__ A, const T* __restrict__ W,
            const T* __restrict__ C, T* __restrict__ Tb, T* __restrict__ Y,
            int64_t c0, int m, int n, int step) {
  using F = Mma<T>;
  constexpr int KS = F::KS, LL = KS + 4, LR = RG + 8;
  constexpr int FM = 16 / F::M, FN = RG / F::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int m1 = m + 1;
  const int64_t q = blockIdx.x / m1;
  const int v = blockIdx.x % m1;
  const int64_t cone = c0 + q;
  const int tiles_c = cdiv(n, RG);
  const int i0 = (blockIdx.y / tiles_c) * RG, j0 = (blockIdx.y % tiles_c) * RG;
  const int64_t nn = int64_t(n) * n;
  const T* w = W + cone * nn;
  T* t = Tb + (q * m1 + v) * nn;
  T* Yq = Y + q * (m + 2) * nn;
  // L(i, k) = lp[i li + k lk]; R(k, j) = rp[k n + j]; out (i, j) at
  // op[i oi + j oj].
  const T* lp;
  const T* rp;
  T* op;
  int64_t li, lk, oi, oj;
  if (step == 1) {
    lp = v < m ? A + (cone * m + v) * nn : C + cone * nn;
    li = n;
    lk = 1;
    rp = w;
    op = t;
    oi = n;
    oj = 1;
  } else {
    lp = w;
    li = v < m ? 1 : n;
    lk = v < m ? n : 1;
    rp = t;
    op = Yq + (v < m ? v : m + 1) * nn;
    oi = v < m ? n : 1;
    oj = v < m ? 1 : n;
  }

  auto load = [&](int slab, int stage) {
    T* Ls = smem + stage * ring_stage<T>();
    T* Rs = Ls + RG * LL;
    const int k0 = slab * KS;
    // Neighbouring threads copy neighbouring addresses of L: along k where
    // its rows are contiguous, along i where its columns are.
    for (int idx = threadIdx.x; idx < RG * KS; idx += kRingThreads) {
      const int r = lk == 1 ? idx / KS : idx % RG;
      const int k = lk == 1 ? idx % KS : idx / RG;
      const bool in = i0 + r < n && k0 + k < n;
      cp_async<1>(Ls + r * LL + k, in ? lp + (i0 + r) * li + (k0 + k) * lk : lp,
                  in);
    }
    for (int idx = threadIdx.x; idx < KS * RG; idx += kRingThreads) {
      const int k = idx / RG, c = idx % RG;
      const bool in = k0 + k < n && j0 + c < n;
      cp_async<1>(Rs + k * LR + c, in ? rp + int64_t(k0 + k) * n + j0 + c : rp,
                  in);
    }
  };

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row0 = warp * 16;
  typename F::C acc[FM][FN];
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) F::zero(acc[fm][fn]);
  const int slabs = cdiv(n, KS);
#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) {
    if (s < slabs) load(s, s);
    cp_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    const int ahead = s + kRingStages - 1;
    if (ahead < slabs) load(ahead, ahead % kRingStages);
    cp_commit();
    cp_wait<kRingStages - 1>();
    __syncthreads();
    const T* Ls = smem + (s % kRingStages) * ring_stage<T>();
    const T* Rs = Ls + RG * LL;
    const int steps = cdiv(min(KS, n - s * KS), F::K);
#pragma unroll
    for (int kk = 0; kk < KS / F::K; ++kk) {
      if (kk < steps) {
        typename F::A a[FM];
#pragma unroll
        for (int fm = 0; fm < FM; ++fm)
          F::load_a(a[fm], lane, [&](int r, int k) {
            return Ls[(row0 + fm * F::M + r) * LL + kk * F::K + k];
          });
        typename F::B b[FN];
#pragma unroll
        for (int fn = 0; fn < FN; ++fn)
          F::load_b(b[fn], lane, [&](int k, int c) {
            return Rs[(kk * F::K + k) * LR + fn * F::N + c];
          });
#pragma unroll
        for (int pass = 0; pass < F::kPasses; ++pass)
#pragma unroll
          for (int fn = 0; fn < FN; ++fn)
#pragma unroll
            for (int fm = 0; fm < FM; ++fm) F::mma(pass, acc[fm][fn], a[fm], b[fn]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn)
      F::store(acc[fm][fn], lane, [&](int r, int c, T x) {
        const int i = i0 + row0 + fm * F::M + r, j = j0 + fn * F::N + c;
        if (i < n && j < n) op[i * oi + j * oj] = x;
      });
  if (step == 2 && v == m) {
    T* wt = Yq + int64_t(m) * nn;
    for (int idx = threadIdx.x; idx < RG * RG; idx += kRingThreads) {
      const int i = i0 + idx / RG, j = j0 + idx % RG;
      if (i < n && j < n) wt[int64_t(i) * n + j] = w[int64_t(j) * n + i];
    }
  }
}

// ---- Gram ------------------------------------------------------------------
//
// A block's tile of E: YG rows (of Y) x YG columns (of X), a warp per 16
// rows; its depth chunk in slabs of 128 bytes a row.
constexpr int YG = 64;
constexpr int kYgThreads = (YG / 16) * kWarp;
constexpr int kYgStages = 3;

template <typename T>
__host__ __device__ constexpr int yg_slab() {
  return 128 / int(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int yg_stage() {  // Ys [YG][DS + 4], Xs [YG][DS + 4]
  return 2 * YG * (yg_slab<T>() + 4);
}

// Block (q, d) of tile (tr, tu): E[r, u] = sum_p Y[q, r, p] X[u, p] over
// depth chunk d of cone c0 + q, p in [d SC DS, (d + 1) SC DS) and below n^2,
// where X[u] = A[cone, u] for u < m and C[cone] for u = m; written to
// partial row cone D + d, (m+2) x (m+1) row-major.  grid: (count D, tiles);
// dynamic shared memory kYgStages stages.  Both operands are read along
// their rows (g LD + t, LD = 4 mod 32 in f32).
template <typename T, int VW>
__global__ void __launch_bounds__(kYgThreads, 4)
gram_y_kernel(const T* __restrict__ A, const T* __restrict__ C,
              const T* __restrict__ Y, T* __restrict__ part, int64_t c0, int m,
              int n, int D, int SC) {
  using F = Mma<T>;
  constexpr int DS = yg_slab<T>(), LD = DS + 4;
  constexpr int FM = 16 / F::M, FN = YG / F::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int m1 = m + 1, m2 = m + 2;
  const int64_t q = blockIdx.x / D;
  const int d = blockIdx.x % D;
  const int64_t cone = c0 + q;
  const int tiles_u = cdiv(m1, YG);
  const int r0 = (blockIdx.y / tiles_u) * YG, u0 = (blockIdx.y % tiles_u) * YG;
  const int64_t nn = int64_t(n) * n;
  const int64_t p_lo = int64_t(d) * SC * DS;
  const int64_t p_hi = p_lo + int64_t(SC) * DS < nn ? p_lo + int64_t(SC) * DS : nn;
  const int slabs = cdiv(int(p_hi - p_lo), DS);
  const T* Yc = Y + q * m2 * nn;
  const T* Ac = A + cone * m * nn;
  const T* Cc = C + cone * nn;

  auto load = [&](int s, int stage) {
    T* Ys = smem + stage * yg_stage<T>();
    T* Xs = Ys + YG * LD;
    const int64_t p0 = p_lo + int64_t(s) * DS;
    for (int idx = threadIdx.x; idx < YG * (DS / VW); idx += kYgThreads) {
      const int r = idx / (DS / VW), k = idx % (DS / VW) * VW;
      const bool pin = p0 + k < p_hi;
      const int yr = r0 + r, xr = u0 + r;
      const bool yin = pin && yr < m2, xin = pin && xr < m1;
      const T* xrow = xr < m ? Ac + xr * nn : Cc;
      cp_async<VW>(Ys + r * LD + k, yin ? Yc + yr * nn + p0 + k : Yc, yin);
      cp_async<VW>(Xs + r * LD + k, xin ? xrow + p0 + k : Cc, xin);
    }
  };

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row0 = warp * 16;
  const bool live = r0 + row0 < m2;  // a warp wholly past E's rows idles
  const int cols = cdiv(min(YG, m1 - u0), F::N);  // live column fragments
  typename F::C acc[FM][FN], unit[FM][FN];  // unit: one slab's sums
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) F::zero(acc[fm][fn]);

#pragma unroll
  for (int s = 0; s < kYgStages - 1; ++s) {
    if (s < slabs) load(s, s);
    cp_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    const int ahead = s + kYgStages - 1;
    if (ahead < slabs) load(ahead, ahead % kYgStages);
    cp_commit();
    cp_wait<kYgStages - 1>();
    __syncthreads();
    const T* Ys = smem + (s % kYgStages) * yg_stage<T>();
    const T* Xs = Ys + YG * LD;
    if (live) {
      auto& sums = pick<F::kUnitSums>(unit, acc);
      if constexpr (F::kUnitSums) {
#pragma unroll
        for (int fm = 0; fm < FM; ++fm)
#pragma unroll
          for (int fn = 0; fn < FN; ++fn) F::zero(unit[fm][fn]);
      }
#pragma unroll
      for (int kk = 0; kk < DS / F::K; ++kk) {
        typename F::A a[FM];
#pragma unroll
        for (int fm = 0; fm < FM; ++fm)
          F::load_a(a[fm], lane, [&](int r, int k) {
            return Ys[(row0 + fm * F::M + r) * LD + kk * F::K + k];
          });
        // B in two halves: fewer fragments live at once (no spills at
        // four blocks per SM).
#pragma unroll
        for (int h = 0; h < FN; h += FN / 2) {
          typename F::B b[FN / 2];
#pragma unroll
          for (int j = 0; j < FN / 2; ++j)
            if (h + j < cols)
              F::load_b(b[j], lane, [&](int k, int c) {
                return Xs[((h + j) * F::N + c) * LD + kk * F::K + k];
              });
#pragma unroll
          for (int pass = 0; pass < F::kPasses; ++pass)
#pragma unroll
            for (int j = 0; j < FN / 2; ++j)
#pragma unroll
              for (int fm = 0; fm < FM; ++fm)
                if (h + j < cols) F::mma(pass, sums[fm][h + j], a[fm], b[j]);
        }
      }
      if constexpr (F::kUnitSums) {
#pragma unroll
        for (int fm = 0; fm < FM; ++fm)
#pragma unroll
          for (int fn = 0; fn < FN; ++fn) F::add(acc[fm][fn], unit[fm][fn]);
      }
    }
    __syncthreads();
  }

  if (live) {
    T* prow = part + (cone * D + d) * int64_t(m2) * m1;
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int fn = 0; fn < FN; ++fn)
        if (fn < cols)
          F::store(acc[fm][fn], lane, [&](int r, int c, T x) {
            const int row = r0 + row0 + fm * F::M + r, col = u0 + fn * F::N + c;
            if (row < m2 && col < m1) prow[int64_t(row) * m1 + col] = x;
          });
  }
}

// ---- the sum over cones and depth chunks ----------------------------------

constexpr int kYrThreads = 256;

// out[e] = the sum of E's entry for output e over the partial rows: G_vu =
// E[v, u], AW_v = E[m, v], AQc_v = E[m + 1, v], wc = E[m, m], cqc =
// E[m + 1, m].  A block takes 32 outputs, one per lane; warp w sums the
// w-th eighth of the rows in order, and lane e of warp 0 adds the eight
// sums in warp order.  grid: blocks of 32 of the m^2 + 2 m + 2 outputs.
template <typename T>
__global__ void __launch_bounds__(kYrThreads)
reduce_y_kernel(const T* __restrict__ part, int rows, int m, T* __restrict__ G,
                T* __restrict__ AW, T* __restrict__ AQc, T* __restrict__ wc,
                T* __restrict__ cqc) {
  constexpr int kWarps = kYrThreads / kWarp;
  __shared__ T sums[kWarps][kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int e = blockIdx.x * kWarp + lane;
  const int m1 = m + 1, mm = m * m;
  int r = 0, u = 0;  // E[r, u]
  T* dst = nullptr;
  if (e < mm) {
    r = e / m;
    u = e % m;
    dst = G + e;
  } else if (e < mm + m) {
    r = m;
    u = e - mm;
    dst = AW + u;
  } else if (e < mm + 2 * m) {
    r = m + 1;
    u = e - mm - m;
    dst = AQc + u;
  } else if (e == mm + 2 * m) {
    r = u = m;
    dst = wc;
  } else if (e == mm + 2 * m + 1) {
    r = m + 1;
    u = m;
    dst = cqc;
  }
  T s = T(0);
  if (dst) {
    const int64_t stride = int64_t(m + 2) * m1, at = int64_t(r) * m1 + u;
    const int j_hi = int((int64_t(warp) + 1) * rows / kWarps);
    for (int j = int(int64_t(warp) * rows / kWarps); j < j_hi; ++j)
      s += part[j * stride + at];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && dst) {
    s = sums[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += sums[w][lane];
    *dst = s;
  }
}

// ---- K4 and K5's launches -------------------------------------------------

constexpr int kSharedRoute = 0;  // the routes of probe_at_plan
constexpr int kDeviceRoute = 1;

template <typename T, int VW>
int launch_at(const T* A, const T* W, const T* C, T* Y, T* Tb, T* part, T* G,
              T* AW, T* AQc, T* wc, T* cqc, int B, int m, int n, int Q, int D,
              int SC, int route, int opb, cudaStream_t stream) {
  const int gram_smem = kYgStages * yg_stage<T>() * int(sizeof(T));
  const int sw_smem = SwLayout<T>(n).bytes();
  const int ring_smem = kRingStages * ring_stage<T>() * int(sizeof(T));
  // The plan restates this file's layout in its own units: refuse one whose
  // D chunks of SC slabs do not cover n^2 exactly (the last chunk may be
  // partial, none empty), or whose route's shared memory a block cannot get.
  const int64_t nn = int64_t(n) * n, chunk = int64_t(SC) * yg_slab<T>();
  if (B < 1 || m < 1 || n < 1 || Q < 1 || D < 1 || SC < 1 || opb < 1 ||
      D * chunk < nn || (D - 1) * chunk >= nn ||
      (route == kDeviceRoute && Tb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (gram_smem > smem_max || (route == kSharedRoute && sw_smem > smem_max) ||
      (route == kDeviceRoute && ring_smem > smem_max))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(
      gram_y_kernel<T, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gram_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (route == kSharedRoute) {
    err = cudaFuncSetAttribute(sandwich_kernel<T, VW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sw_smem);
  } else if (route == kDeviceRoute) {
    err = cudaFuncSetAttribute(ring_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ring_smem);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const int m1 = m + 1;
  const int tiles = cdiv(m + 2, YG) * cdiv(m1, YG);
  for (int64_t c0 = 0; c0 < B; c0 += Q) {
    const int count = static_cast<int>(B - c0 < Q ? B - c0 : Q);
    if (route == kSharedRoute) {
      sandwich_kernel<T, VW><<<count * cdiv(m1, opb), SW_THREADS, sw_smem,
                               stream>>>(A, W, C, Y, c0, m, n, opb);
    } else {
      const dim3 grid(count * m1, cdiv(n, RG) * cdiv(n, RG));
      for (int step = 1; step <= 2; ++step) {
        ring_kernel<T><<<grid, kRingThreads, ring_smem, stream>>>(
            A, W, C, Tb, Y, c0, m, n, step);
        if (step == 1) {
          err = cudaGetLastError();
          if (err != cudaSuccess) return static_cast<int>(err);
        }
      }
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gram_y_kernel<T, VW><<<dim3(count * D, tiles), kYgThreads, gram_smem,
                           stream>>>(A, C, Y, part, c0, m, n, D, SC);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  reduce_y_kernel<T><<<cdiv(m * m + 2 * m + 2, kWarp), kYrThreads, 0,
                       stream>>>(part, B * D, m, G, AW, AQc, wc, cqc);
  return static_cast<int>(cudaGetLastError());
}

// Copies of 16 bytes where every row of A, W, C and Y starts on 16 bytes.
template <typename T>
int dispatch_at(const T* A, const T* W, const T* C, T* Y, T* Tb, T* part,
                T* G, T* AW, T* AQc, T* wc, T* cqc, int B, int m, int n, int Q,
                int D, int SC, int route, int opb, cudaStream_t stream) {
  constexpr int kVec = 16 / int(sizeof(T));
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if (n % kVec == 0 && (addr(A) | addr(W) | addr(C) | addr(Y)) % 16 == 0)
    return launch_at<T, kVec>(A, W, C, Y, Tb, part, G, AW, AQc, wc, cqc, B, m,
                              n, Q, D, SC, route, opb, stream);
  return launch_at<T, 1>(A, W, C, Y, Tb, part, G, AW, AQc, wc, cqc, B, m, n, Q,
                         D, SC, route, opb, stream);
}

}  // namespace

// K4 and K5.  Shapes: A (B, m, n, n), W and C (B, n, n); scratch Y (Q, m+2,
// n, n), Tb (Q, m+1, n, n) on the device route (else unused) and part
// (B D, (m+2)(m+1)); outputs G (m, m), AW and AQc (m), wc and cqc (one
// element).  All contiguous on the current device.  Q cones per chunk, D depth chunks of
// SC slabs, route 0 (shared) or 1 (device), and opb operators per block
// on the shared route: dev_pallas_probe.py::probe_at_plan.  Returns
// cudaErrorInvalidValue for a plan that does not fit this file's layout or
// the device, else the first CUDA error, or 0.
#define CONEX_PROBE_AT_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const T* A, const T* W, const T* C, T* Y, T* Tb,        \
                      T* part, T* G, T* AW, T* AQc, T* wc, T* cqc, int B,     \
                      int m, int n, int Q, int D, int SC, int route, int opb, \
                      void* stream) {                                         \
    return dispatch_at<T>(A, W, C, Y, Tb, part, G, AW, AQc, wc, cqc, B, m, n, \
                          Q, D, SC, route, opb,                               \
                          static_cast<cudaStream_t>(stream));                 \
  }

CONEX_PROBE_AT_ENTRY(conex_probe_at_f32, float)    // K4 and K5
CONEX_PROBE_AT_ENTRY(conex_probe_at_f64, double)
