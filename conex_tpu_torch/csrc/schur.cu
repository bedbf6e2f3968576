// Schur-complement phase of a batch of dense LMI cones, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conex_tpu/cones/psd_pallas.py::_schur_kernel
// (launched by schur_fused).  For every scenario s it forms, summed over the
// scenario's Bc cones b,
//
//   G_vu  = tr(A_v W A_u W)        AW_v = tr(A_v W)
//   AQc_v = tr(C W A_v W)          wc   = tr(C W)      cqc = tr(C W C W)
//
// C is treated as operator number m (no copy of A is made), so with the
// panel P_v = Op_v W, v = 0..m, every output is an entry of the extended
// Gram matrix E_vu = <P_v, P_u^T> = sum_ik P_v[i,k] P_u[k,i] or a trace:
// G = E[:m, :m], AQc_v = E_vm, cqc = E_mm, AW_v = tr P_v, wc = tr P_m.
// E is symmetric for any A, W and C (a trace is unchanged by cycling its
// factors); the kernel assumes no symmetry of A, W or C.
//
// What bounds it.  At the benchmark shape (S=256, Bc=1, m=50, n=100, f32)
// the work is 26.1 GFLOP of panel products and 6.8 GFLOP for one triangle
// of E, against 0.53 GB of inputs and outputs.  On CUDA cores (67 TFLOP/s)
// that is 0.49 ms of operations; on the tensor cores, three TF32 products
// per f32 product at 495 TFLOP/s, 0.20 ms, above the 0.16 ms of the bytes.
// As built, the panel goes through device memory: A and C read (0.53 GB),
// P written (0.57 GB, padded to n = 104) and read back (0.61 GB), 1.7 GB
// or 0.51 ms at 3.35 TB/s.  Chunks of cones whose panel stays in the 50 MB
// L2 cache measured slower than one chunk (the tails of many short
// launches), so the plan takes one chunk up to a cap on the scratch.
//
// The design.
//  * Precision.  f32: each operand x is split into hi = tf32(x) and
//    lo = tf32(x - hi), both rounded to nearest (ties away, as
//    cvt.rna.tf32.f32), and a product is lo*hi + hi*lo + hi*hi, three
//    m16n8k8 TF32 mma into an f32 accumulator: about f32 accuracy (one
//    TF32 pass keeps three digits, which the workload cannot take).  The
//    tensor cores add into the accumulator rounding toward zero, so the
//    Gram sums each unit of depth apart and adds the units on CUDA cores.
//    f64: m8n8k4 DMMA.
//  * Chunks.  The cones (flat index s Bc + b) go in chunks whose panel fits
//    the scratch (cones/psd_schur.py::schur_plan); per chunk one panel
//    launch writes it and one Gram launch reads it back.
//  * Panel.  One block of 7 warps per (cone, operator, 112 x 104 tile of
//    P): at n = 100 one tile covers the whole product (89% and 96% of the
//    tile's rows and columns are used); K goes in slabs (32 deep in f32,
//    16 in f64) through a three-stage cp.async ring.  P is stored in 8 x 8
//    blocks, each 64 consecutive elements, zero past n.
//  * Gram.  E = M + M^T, where M sums over units of depth: unit (I, K),
//    I <= K, pairs the 8 x 8 blocks (I, K) and (K, I) of i and k, whose
//    contributions to E are transposes of each other (see the Gram
//    section).  So each block of P is read once, and the mirrored half of
//    E costs nothing.  One block of 4 warps per (cone, 64 x 64 tile of M,
//    depth chunk of units): at m + 1 = 51 one tile covers M (80% of its
//    rows and columns are used); each warp takes 16 rows, all columns.
//    Three cp.async stages of 16-byte copies.  Spreading cones and depth
//    chunks over blocks fills the card at S = 1 as at S = 256.
//  * Sum.  When a block holds a scenario's whole sum (Bc = 1, one depth
//    chunk, one tile) it writes G, AQc, cqc, AW and wc itself; otherwise
//    it writes a partial (its tile of M, and the traces of its depth chunk)
//    and reduce_kernel adds each scenario's partials in a fixed order.  No
//    atomics: the same bits every run.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
// Panel tile: PR x PC outputs, one 16-row stripe per warp.
constexpr int PR = 112;
constexpr int PC = 104;
constexpr int kPanelThreads = (PR / 16) * kWarp;
constexpr int kPanelStages = 3;
// Gram tile: GT x GT entries; a unit of depth is BI x BI pairs (i, k).
constexpr int GT = 64;
constexpr int BI = 8;
constexpr int kGramWarps = 4;  // a warp takes GT / 4 rows of a tile
constexpr int kGramThreads = kGramWarps * kWarp;
constexpr int kGramStages = 3;
constexpr int kReduceThreads = 256;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

#include "mma.cuh"

// ---- panel ----------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr int panel_stage() {  // As [PR][KS + 4], then Ws [KS][PC]
  return PR * (Mma<T>::KS + 4) + Mma<T>::KS * PC;
}

// P[q, v] = Op_v W of cone c0 + q, for v < m (Op_v = A[cone, v]) and v = m
// (Op_m = C[cone]), stored in BI x BI blocks: P_v is (nb, nb, BI, BI),
// nb = cdiv(n, BI), with zeros past n.  grid: (count (m + 1), tiles of P;
// they cover rows and columns up to BI nb); dynamic shared memory:
// kPanelStages stages.  VW: elements per copy (16 bytes when n allows).
template <typename T, int VW>
__global__ void __launch_bounds__(kPanelThreads, sizeof(T) == 4 ? 2 : 1)
panel_kernel(const T* __restrict__ A, const T* __restrict__ C,
             const T* __restrict__ W, T* __restrict__ P, int64_t c0, int m,
             int n) {
  using F = Mma<T>;
  constexpr int KS = F::KS, LA = KS + 4;
  constexpr int FM = 16 / F::M, FN = PC / F::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int m1 = m + 1;
  const int64_t q = blockIdx.x / m1;
  const int v = blockIdx.x % m1;
  const int64_t cone = c0 + q;
  const int tiles_c = cdiv(n, PC);
  const int r0 = (blockIdx.y / tiles_c) * PR;
  const int col0 = (blockIdx.y % tiles_c) * PC;
  const int64_t nn = int64_t(n) * n;
  const T* op = v < m ? A + (cone * m + v) * nn : C + cone * nn;
  const T* w = W + cone * nn;
  const int nb = cdiv(n, BI);
  T* out = P + (q * m1 + v) * int64_t(BI * nb) * (BI * nb);

  auto load = [&](int slab, int stage) {
    T* As = smem + stage * panel_stage<T>();
    T* Ws = As + PR * LA;
    const int k0 = slab * KS;
    for (int idx = threadIdx.x; idx < PR * KS / VW; idx += kPanelThreads) {
      const int r = idx / (KS / VW), k = idx % (KS / VW) * VW;
      const bool in = r0 + r < n && k0 + k < n;
      cp_async<VW>(As + r * LA + k, in ? op + int64_t(r0 + r) * n + k0 + k : op,
                   in);
    }
    for (int idx = threadIdx.x; idx < KS * PC / VW; idx += kPanelThreads) {
      const int k = idx / (PC / VW), c = idx % (PC / VW) * VW;
      const bool in = k0 + k < n && col0 + c < n;
      cp_async<VW>(Ws + k * PC + c, in ? w + int64_t(k0 + k) * n + col0 + c : w,
                   in);
    }
  };

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row0 = warp * 16;  // the warp's stripe within the tile
  const bool live = r0 + row0 < n;
  typename F::C acc[FM][FN];
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) F::zero(acc[fm][fn]);

  const int slabs = cdiv(n, KS);
#pragma unroll
  for (int s = 0; s < kPanelStages - 1; ++s) {
    if (s < slabs) load(s, s);
    cp_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    const int ahead = s + kPanelStages - 1;
    if (ahead < slabs) load(ahead, ahead % kPanelStages);
    cp_commit();
    cp_wait<kPanelStages - 1>();
    __syncthreads();
    const T* As = smem + (s % kPanelStages) * panel_stage<T>();
    const T* Ws = As + PR * LA;
    const int steps = cdiv(min(KS, n - s * KS), F::K);
    if (live) {
#pragma unroll
      for (int kk = 0; kk < KS / F::K; ++kk) {
        if (kk < steps) {
          typename F::A a[FM];
#pragma unroll
          for (int fm = 0; fm < FM; ++fm)
            F::load_a(a[fm], lane, [&](int r, int k) {
              return As[(row0 + fm * F::M + r) * LA + kk * F::K + k];
            });
          // The columns in two halves: fewer B fragments live at once.
          constexpr int FH = (FN + 1) / 2;
#pragma unroll
          for (int h = 0; h < FN; h += FH) {
            typename F::B b[FH];
#pragma unroll
            for (int j = 0; j < FH; ++j)
              if (h + j < FN)
                F::load_b(b[j], lane, [&](int k, int c) {
                  return Ws[(kk * F::K + k) * PC + (h + j) * F::N + c];
                });
#pragma unroll
            for (int pass = 0; pass < F::kPasses; ++pass)
#pragma unroll
              for (int j = 0; j < FH; ++j)
#pragma unroll
                for (int fm = 0; fm < FM; ++fm)
                  if (h + j < FN) F::mma(pass, acc[fm][h + j], a[fm], b[j]);
          }
        }
      }
    }
    __syncthreads();
  }

  using Pair = std::conditional_t<sizeof(T) == 4, float2, double2>;
  if (live) {
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int fn = 0; fn < FN; ++fn)
        F::store_pairs(acc[fm][fn], lane, [&](int r, int c, T x0, T x1) {
          const int row = r0 + row0 + fm * F::M + r, col = col0 + fn * F::N + c;
          if (row >= BI * nb || col >= BI * nb) return;  // zeros past n
          T* o = out + (int64_t(row / BI) * nb + col / BI) * (BI * BI) +
                 row % BI * BI + col % BI;
          *reinterpret_cast<Pair*>(o) = Pair{x0, x1};
        });
  }
}

// ---- Gram -----------------------------------------------------------------
//
// The depth (i, k) of E's sums goes in units of B x B pairs: unit (I, K),
// I <= K, holds the blocks i in [B I, B I + B), k in [B K, B K + B) and,
// for I < K, the mirrored blocks (K, I).  With C_IK[v, u] the sum over the
// (I, K) blocks of P_v[i, k] P_u[k, i], the mirrored blocks give
// C_KI = C_IK^T, so E = M + M^T with M = sum over units of C_IK, halved
// for I = K (C_II is symmetric).  A unit stages the block P_v[I, K] for
// rows v and P_u[K, I] for columns u, so each block of P is read once, and
// E's symmetry costs no mirrored work.

template <typename T>
__host__ __device__ constexpr int gram_stage() {  // Xs [GT][LD], Ys [GT][LD]
  return 2 * GT * (BI * BI + 4);
}

// The tile (tv, tu) of M for cone c0 + q over depth chunk d: units
// [d UC, (d + 1) UC) of the row-major list of (I, K), I <= K.  grid:
// (count D, tiles^2); dynamic shared memory: kGramStages stages.  part ==
// nullptr (Bc = 1, D = 1, one tile): write the outputs from E = M + M^T; else
// write M and the traces to partial row (c0 + q) D + d.
template <typename T>
__global__ void __launch_bounds__(kGramThreads)
gram_kernel(const T* __restrict__ P, T* __restrict__ part, T* __restrict__ G,
            T* __restrict__ AW, T* __restrict__ AQc, T* __restrict__ wc,
            T* __restrict__ cqc, int64_t c0, int m, int n, int D, int UC) {
  using F = Mma<T>;
  constexpr int DS = BI * BI, LD = DS + 4;
  constexpr int WR = GT / kGramWarps;  // rows of the tile per warp
  constexpr int FM = WR / F::M, FN = GT / F::N;
  static_assert(GT * GT <= kGramStages * gram_stage<T>(),
                "M's tile fits the staging");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int m1 = m + 1;
  const int64_t q = blockIdx.x / D;
  const int d = blockIdx.x % D;
  const int64_t cone = c0 + q;
  const int tiles = cdiv(m1, GT);
  const int tv = blockIdx.y / tiles, tu = blockIdx.y % tiles;
  const int v0 = tv * GT, u0 = tu * GT;
  const int nb = cdiv(n, BI);
  const int64_t nn = int64_t(BI * nb) * (BI * nb);  // one panel, in blocks
  const T* Pc = P + q * m1 * nn;
  const int j_lo = d * UC, j_hi = min(nb * (nb + 1) / 2, j_lo + UC);
  int I0 = 0, K0 = j_lo;  // unit j_lo as (I, K)
  while (K0 >= nb - I0) {
    K0 -= nb - I0;
    ++I0;
  }
  K0 += I0;
  const auto next = [&](int& I, int& K) {
    if (++K == nb) K = ++I;
  };

  // A unit stages rows v of Xs as the block P_v[I, K], (ii, kk) at
  // ii B + kk, and rows u of Ys as the block P_u[K, I], (kk, ii) at kk B +
  // ii: each a copy of 64 consecutive elements.  The product's depth p =
  // B j + t (t < B) is the pair (ii, kk) = (t, t ^ j): a bijection under
  // which both operands' fragment reads hit 32 distinct banks, though one
  // of them reads the block across its rows.
  constexpr int VW = 16 / int(sizeof(T));
  auto load = [&](int I, int K, int stage) {
    T* Xs = smem + stage * gram_stage<T>();
    T* Ys = Xs + GT * LD;
    const int64_t xb = int64_t(I * nb + K) * DS, yb = int64_t(K * nb + I) * DS;
    for (int idx = threadIdx.x; idx < GT * DS / VW; idx += kGramThreads) {
      const int r = idx / (DS / VW), p = idx % (DS / VW) * VW;
      const bool xin = v0 + r < m1, yin = u0 + r < m1;
      cp_async<VW>(Xs + r * LD + p, xin ? Pc + (v0 + r) * nn + xb + p : Pc, xin);
      cp_async<VW>(Ys + r * LD + p, yin ? Pc + (u0 + r) * nn + yb + p : Pc, yin);
    }
  };
  // Offsets of depth p in a row of Xs and of Ys.
  const auto xoff = [](int p) { return (p % BI) * BI + ((p % BI) ^ (p / BI)); };
  const auto yoff = [](int p) { return ((p % BI) ^ (p / BI)) * BI + p % BI; };

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row0 = warp * WR;
  const bool live = v0 + row0 < m1;  // a warp wholly past E's rows idles
  typename F::C acc[FM][FN], unit[FM][FN];  // unit: one unit's sums
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) F::zero(acc[fm][fn]);

  const int units = j_hi - j_lo;
  T tr = T(0);  // the trace of row v0 + threadIdx.x over this depth chunk
  int Il = I0, Kl = K0, Ic = I0, Kc = K0;  // next unit to load, to compute
#pragma unroll
  for (int s = 0; s < kGramStages - 1; ++s) {
    if (s < units) {
      load(Il, Kl, s);
      next(Il, Kl);
    }
    cp_commit();
  }
  for (int s = 0; s < units; ++s) {
    const int ahead = s + kGramStages - 1;
    if (ahead < units) {
      load(Il, Kl, ahead % kGramStages);
      next(Il, Kl);
    }
    cp_commit();
    cp_wait<kGramStages - 1>();
    __syncthreads();
    const T* Xs = smem + (s % kGramStages) * gram_stage<T>();
    const T* Ys = Xs + GT * LD;
    const T half = Ic == Kc ? T(0.5) : T(1);
    // The traces: row v's diagonal P_v[i, i] of a diagonal unit lies at
    // (ii, kk) = (ii, ii) of Xs, in the thread of v on a diagonal tile.
    if (Ic == Kc && tv == tu && threadIdx.x < GT) {
#pragma unroll
      for (int ii = 0; ii < BI; ++ii) tr += Xs[threadIdx.x * LD + ii * (BI + 1)];
    }
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
            return half * Xs[(row0 + fm * F::M + r) * LD + xoff(kk * F::K + k)];
          });
        typename F::B b[FN];
#pragma unroll
        for (int fn = 0; fn < FN; ++fn)
          F::load_b(b[fn], lane, [&](int k, int c) {
            return Ys[(fn * F::N + c) * LD + yoff(kk * F::K + k)];
          });
#pragma unroll
        for (int pass = 0; pass < F::kPasses; ++pass)
#pragma unroll
          for (int fn = 0; fn < FN; ++fn)
#pragma unroll
            for (int fm = 0; fm < FM; ++fm)
              F::mma(pass, sums[fm][fn], a[fm], b[fn]);
      }
      if constexpr (F::kUnitSums) {
#pragma unroll
        for (int fm = 0; fm < FM; ++fm)
#pragma unroll
          for (int fn = 0; fn < FN; ++fn) F::add(acc[fm][fn], unit[fm][fn]);
      }
    }
    next(Ic, Kc);
    __syncthreads();
  }

  T* Ms = smem;  // [GT][GT]: the tile of M, over the staging buffer
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn)
      F::store(acc[fm][fn], lane, [&](int r, int c, T x) {
        Ms[(row0 + fm * F::M + r) * GT + fn * F::N + c] = x;
      });
  __syncthreads();
  const int64_t stride = int64_t(m1) * m1 + m1;
  T* prow = part ? part + (cone * D + d) * stride : nullptr;
  const int64_t sc = cone;  // the scenario, when part == nullptr (Bc = 1)
  for (int e = threadIdx.x; e < GT * GT; e += kGramThreads) {
    const int r = e / GT, c = e % GT, v = v0 + r, u = u0 + c;
    if (v >= m1 || u >= m1) continue;
    if (prow) {
      prow[int64_t(v) * m1 + u] = Ms[e];
      continue;
    }
    if (v > u) continue;
    const T x = Ms[e] + Ms[c * GT + r];  // E = M + M^T
    if (u < m) {
      G[(sc * m + v) * m + u] = x;
      G[(sc * m + u) * m + v] = x;
    } else if (v < m) {
      AQc[sc * m + v] = x;
    } else {
      cqc[sc] = x;
    }
  }

  if (tv == tu && threadIdx.x < GT && v0 + int(threadIdx.x) < m1) {
    const int v = v0 + threadIdx.x;
    if (prow) {
      prow[int64_t(m1) * m1 + v] = tr;
    } else if (v < m) {
      AW[sc * m + v] = tr;
    } else {
      wc[sc] = tr;
    }
  }
}

// ---- the sum over cones and depth chunks ----------------------------------

// out[e] of scenario s, summed over its Bc D partial rows: an entry of
// E = M + M^T (the two sums added last) or a trace.  A block takes 32
// outputs, one per lane; warp w sums the w-th eighth of the rows in
// order, and lane e of warp 0 adds the eight sums in warp order.  grid:
// (S, blocks of 32 of the m^2 + 2 m + 2 outputs).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const T* __restrict__ part, int rows, int m, T* __restrict__ G,
              T* __restrict__ AW, T* __restrict__ AQc, T* __restrict__ wc,
              T* __restrict__ cqc) {
  constexpr int kWarps = kReduceThreads / kWarp;
  __shared__ T sums[2][kWarps][kWarp];
  const int64_t s = blockIdx.x;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int e = blockIdx.y * kWarp + lane;
  const int m1 = m + 1, mm = m * m;
  const int64_t stride = int64_t(m1) * m1 + m1;
  const int64_t tr = int64_t(m1) * m1;  // the traces follow M
  int v = -1, u = -1;  // E[v, u], or the trace at tr + v when u < 0
  T* dst = nullptr;
  if (e < mm) {
    v = e / m;
    u = e % m;
    dst = G + s * mm + e;
  } else if (e < mm + m) {
    v = e - mm;
    dst = AW + s * m + v;
  } else if (e < mm + 2 * m) {
    v = e - mm - m;
    u = m;
    dst = AQc + s * m + v;
  } else if (e == mm + 2 * m) {
    v = m;
    dst = wc + s;
  } else if (e == mm + 2 * m + 1) {
    v = u = m;
    dst = cqc + s;
  }
  T a = T(0), b = T(0);
  if (dst) {
    const T* p = part + s * rows * stride;
    const int64_t ia = u < 0 ? tr + v : int64_t(v) * m1 + u;
    const int64_t ib = u < 0 ? ia : int64_t(u) * m1 + v;
    const int j_hi = (warp + 1) * rows / kWarps;
    for (int j = warp * rows / kWarps; j < j_hi; ++j) {
      a += p[j * stride + ia];
      b += p[j * stride + ib];
    }
  }
  sums[0][warp][lane] = a;
  sums[1][warp][lane] = b;
  __syncthreads();
  if (warp == 0 && dst) {
    a = sums[0][0][lane];
    b = sums[1][0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      a += sums[0][w][lane];
      b += sums[1][w][lane];
    }
    *dst = u < 0 ? a : a + b;
  }
}

template <typename T, int VW>
int launch(const T* A, const T* W, const T* C, T* P, T* part, T* G, T* AW,
           T* AQc, T* wc, T* cqc, int S, int Bc, int m, int n, int Q, int D,
           int UC, cudaStream_t stream) {
  const int panel_smem = kPanelStages * panel_stage<T>() * int(sizeof(T));
  const int gram_smem = kGramStages * gram_stage<T>() * int(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      panel_kernel<T, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      panel_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gram_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gram_smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int m1 = m + 1;
  const int tiles = cdiv(m1, GT);
  const int panel_tiles = cdiv(n, PR) * cdiv(n, PC);
  const int64_t cones = int64_t(S) * Bc;
  const bool direct = Bc == 1 && D == 1 && tiles == 1;
  for (int64_t c0 = 0; c0 < cones; c0 += Q) {
    const int count = static_cast<int>(cones - c0 < Q ? cones - c0 : Q);
    panel_kernel<T, VW><<<dim3(count * m1, panel_tiles), kPanelThreads,
                          panel_smem, stream>>>(A, C, W, P, c0, m, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gram_kernel<T><<<dim3(count * D, tiles * tiles), kGramThreads,
                         gram_smem, stream>>>(P, direct ? nullptr : part, G,
                                              AW, AQc, wc, cqc, c0, m, n, D,
                                              UC);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!direct) {
    const dim3 grid(S, cdiv(m * m + 2 * m + 2, kWarp));
    reduce_kernel<T><<<grid, kReduceThreads, 0, stream>>>(part, Bc * D, m, G,
                                                          AW, AQc, wc, cqc);
  }
  return static_cast<int>(cudaGetLastError());
}

// Copies of 16 bytes where every row of A, W, C and P starts on 16 bytes.
template <typename T>
int dispatch(const T* A, const T* W, const T* C, T* P, T* part, T* G, T* AW,
             T* AQc, T* wc, T* cqc, int S, int Bc, int m, int n, int Q, int D,
             int UC, cudaStream_t stream) {
  constexpr int kVec = 16 / int(sizeof(T));
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if (n % kVec == 0 && (addr(A) | addr(W) | addr(C) | addr(P)) % 16 == 0)
    return launch<T, kVec>(A, W, C, P, part, G, AW, AQc, wc, cqc, S, Bc, m, n,
                           Q, D, UC, stream);
  return launch<T, 1>(A, W, C, P, part, G, AW, AQc, wc, cqc, S, Bc, m, n, Q,
                      D, UC, stream);
}

}  // namespace

extern "C" {

// Shapes: A (S, Bc, m, n, n), W and C (S, Bc, n, n); scratch P (Q, m + 1,
// 8 nb, 8 nb), nb = cdiv(n, 8), and, unless the Gram blocks write the
// outputs (Bc = 1, D = 1, m < 64), part (S Bc D, (m + 1)^2 + m + 1);
// outputs G (S, m, m), AW and AQc (S, m), wc and cqc (S,).  Q cones per
// chunk, D depth chunks of UC units (cones/psd_schur.py::schur_plan).  All
// contiguous on the current device.  Returns the first CUDA error, or 0.
int conex_schur_f32(const float* A, const float* W, const float* C, float* P,
                    float* part, float* G, float* AW, float* AQc, float* wc,
                    float* cqc, int S, int Bc, int m, int n, int Q, int D,
                    int UC, void* stream) {
  return dispatch<float>(A, W, C, P, part, G, AW, AQc, wc, cqc, S, Bc, m, n, Q,
                       D, UC, static_cast<cudaStream_t>(stream));
}

int conex_schur_f64(const double* A, const double* W, const double* C,
                    double* P, double* part, double* G, double* AW,
                    double* AQc, double* wc, double* cqc, int S, int Bc,
                    int m, int n, int Q, int D, int UC, void* stream) {
  return dispatch<double>(A, W, C, P, part, G, AW, AQc, wc, cqc, S, Bc, m, n,
                        Q, D, UC, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
