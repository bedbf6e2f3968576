// The four Schur-phase probe kernels (K3-K6), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the probes in benchmarks/:
//   K3  dev_pallas_probe.py::_kernel_a   (fused_a)   A layout
//   K4  dev_pallas_probe.py::_kernel_b   (fused_b)   At layout
//   K5  dev_tpu_probe2.py::_kernel_b2    (fused_b2)  At layout, m padded to 8
//   K6  dev_tpu_probe2.py::_kernel_a2    (fused_a2)  A layout, m padded to 8
// Each forms, for one program of B dense LMI cones b summed into one result,
//
//   G_vu  = tr(A_v W A_u W)        AW_v = tr(A_v W)
//   AQc_v = tr(C W A_v W)          wc   = tr(C W)      cqc = tr(C W C W)
//
// from A (B, m, n, n) (At (B, n, m, n), At[b,i,v,j] = A[b,v,i,j], for K4 and
// K5), W and C (B, n, n).  The wrappers are in
// conex_tpu_torch/benchmarks/dev_pallas_probe.py and dev_tpu_probe2.py.
//
// C W is carried as operator number m beside the A_v, so every output is an
// entry or a trace of one extended (m+1) x (m+1) Gram matrix E:
// G_vu = E_vu, AQc_v = E_vm, cqc = E_mm, AW_v and wc the traces of the left
// panels.  Three launches, each formulation its own:
//
//   1. panel: A layout (K3, K6): the TPU kernel's one product
//      A.reshape(m n, n) @ W, here over (m+1) n rows whose last n are C, into
//      P (B, m+1, n, n), and the same tile transposed (the TPU kernel's
//      minor-dims swap) into PT.  At layout (K4, K5): Pb = At.reshape(n m, n)
//      @ W and Rb = W @ At.reshape(n, m n) into X and Y (B, n, m+1, n), with
//      C W in row m of Pb and its transpose in row m of Rb.
//   2. gram: one block per (cone, 64 x 64 tile of E) takes the depth-n^2 sum
//      E_vu = sum_{i,k} X[v,i,k] Y[u,i,k] of its cone (A layout: P and PT;
//      At layout: Pb and Rb, i.e. sum_i Pb[i] Rb[i]^T) and the traces, and
//      writes them to a partial buffer part (B, (m+1)(m+2)).
//   3. reduce: one thread per output sums the B partials in cone order.
// The TPU grid over cones runs in order and accumulates into its outputs;
// here the cones run in parallel blocks and the sum is a second pass: no
// atomics, so every run gives the same bits.
//
// K5 and K6 are K4 and K3 with the TPU kernels' padding of m to 8: the
// template parameter MPAD rounds the live rows of each Gram tile up to a
// multiple of 8 (56 of 64 at m = 50), and the warps past them skip
// the product; K3 and K4 compute the whole 64-row tile, its ragged rows
// masked to zero.  No operand is padded or copied; masks handle n = 100
// against the 64-wide tiles.
//
// How often A is read.  K3/K6: once per 64-column tile of the panel product,
// twice at n = 100.  K4/K5: the wrapper reads A once and writes At once; Pb
// reads At once per column tile and Rb, which needs a whole column block of
// At for each row block of W, once per row tile: four reads at n = 100.  The
// blocks of one cone are neighbours in the grid and run together, so the
// repeats mostly hit L2, which holds a cone's At (2 MB in f32) many times.
//
// What bounds it.  At the probe shape (B = 256, m = 50, n = 100, f32) the
// work is 2 B (m+1) n^3 = 26.1 GFLOP of panel products and 2 B (m+1)^2 n^2 =
// 13.3 GFLOP of Gram sums over the whole of E (K4/K5 do the panel product
// twice, as their TPU kernels do: 52.2 GFLOP).  E is symmetric for any
// inputs (a trace is unchanged by cycling its factors), so the function
// needs only one triangle of it, 2 B (m+1)(m+2)/2 n^2 = 6.8 GFLOP: 32.9 GFLOP
// in all, against 0.53 GB of A, W and C, about 62 FLOP per byte, far above
// the H100's float32 CUDA-core balance (67 TFLOP/s over 3.35 TB/s, 20
// FLOP/byte).  It is compute-bound: at least 0.49 ms at the published 67
// TFLOP/s, which holds at the card's full 700 W power limit.
// The design spends bytes to keep the arithmetic simple: the panels go
// through device-memory scratch (2 x 0.52 GB written and read once), and the
// products run on CUDA cores from shared memory with a 4 x 4 register tile
// per thread (two shared loads per four multiply-adds).  The cones spread
// over the blocks (B x 160 panel tiles in the A layout, B Gram blocks),
// where K1 at one program loops over all cones in one Gram block.  On an
// H100 80GB HBM3 at 700 W a call takes 5.4 ms (K3, K6) and 8.7 ms (K4, K5),
// the Gram launch 2.8 ms of it at two blocks per SM (PERF.md).  Splitting
// the Gram depth over more blocks, keeping the panels out of device
// memory, the symmetry of E, and the tensor cores (wgmma, TMA) are later
// work.
//
// Arithmetic: every multiply-add is an explicit fmaf / fma call (madd
// below), which the library's -fmad=false leaves fused.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, each owning 4 x 4 outputs
constexpr int TT = 64;         // output tile edge of every product
constexpr int PK = 16;         // panel products: depth of one staged slice
constexpr int GI = 2;          // Gram: one stage holds GI x GK (i, k) pairs
constexpr int GK = 8;
constexpr int GL = GI * GK;
// Shared memory of one block, in elements: the two staged operand slices,
// or the transposed output tile of the A-layout panel.
constexpr int kSmem = TT * (TT + 1) > PK * (2 * TT + 1) ? TT * (TT + 1)
                                                        : PK * (2 * TT + 1);
static_assert(GL == PK, "the Gram and panel stages share one buffer shape");

__device__ __forceinline__ float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return fma(a, b, c);
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Thread (tx, ty) owns rows 4 ty .. 4 ty + 3 and columns tx + 16 p of a
// tile, so warp w owns rows 8 w .. 8 w + 7.
template <typename T>
__device__ __forceinline__ void zero(T (&acc)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[q][p] = T(0);
}

// acc += one staged slice: Xs[l][row] times Ys[l][col] over l < depth.
template <typename T>
__device__ __forceinline__ void mac_slice(T (&acc)[4][4], const T* Xs,
                                          const T* Ys, int depth) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 8
  for (int l = 0; l < depth; ++l) {
    T a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = Xs[l * (TT + 1) + 4 * ty + q];
#pragma unroll
    for (int p = 0; p < 4; ++p) b[p] = Ys[l * TT + tx + 16 * p];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[q][p] = madd(a[q], b[p], acc[q][p]);
  }
}

// acc = the (r0, c0) tile of the product X Y, X (M x K) and Y (K x N),
// whose entries are x(r, k) and y(k, c); the loaders are called only
// inside the bounds.
template <typename T, typename LX, typename LY>
__device__ void product_tile(T (&acc)[4][4], T* smem, int M, int N, int K,
                             int r0, int c0, LX x, LY y) {
  T* Xs = smem;                   // [PK][TT + 1], k-major
  T* Ys = smem + PK * (TT + 1);   // [PK][TT]
  const int tid = threadIdx.x;
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += PK) {
    for (int idx = tid; idx < TT * PK; idx += kThreads) {
      const int kk = idx % PK, rr = idx / PK;
      const int r = r0 + rr, k = k0 + kk;
      Xs[kk * (TT + 1) + rr] = (r < M && k < K) ? x(r, k) : T(0);
    }
    for (int idx = tid; idx < PK * TT; idx += kThreads) {
      const int cc = idx % TT, kk = idx / TT;
      const int c = c0 + cc, k = k0 + kk;
      Ys[kk * TT + cc] = (k < K && c < N) ? y(k, c) : T(0);
    }
    __syncthreads();
    mac_slice(acc, Xs, Ys, PK);
    __syncthreads();
  }
}

// Calls st(r, c, value) for each entry of the (r0, c0) tile inside M x N.
template <typename T, typename ST>
__device__ __forceinline__ void store_tile(const T (&acc)[4][4], int M, int N,
                                           int r0, int c0, ST st) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = r0 + 4 * ty + q, c = c0 + tx + 16 * p;
      if (r < M && c < N) st(r, c, acc[q][p]);
    }
}

// A layout.  Panel P[b] = the ((m+1) n) x n product whose first m n rows
// are A[b].reshape(m n, n) and last n rows C[b], times W[b]; PT[b, v] =
// P[b, v]^T.  grid: (tiles of the product, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_a_kernel(const T* __restrict__ A, const T* __restrict__ W,
               const T* __restrict__ C, T* __restrict__ P,
               T* __restrict__ PT, int m, int n) {
  __shared__ T smem[kSmem];
  const int64_t b = blockIdx.y;
  const int64_t nn = int64_t(n) * n;
  const int tiles_c = cdiv(n, TT);
  const int r0 = (blockIdx.x / tiles_c) * TT, c0 = (blockIdx.x % tiles_c) * TT;
  const int mn = m * n, M = mn + n;
  const T* Ab = A + b * m * nn;
  const T* Cb = C + b * nn;
  const T* Wb = W + b * nn;
  T* Pb = P + b * (m + 1) * nn;
  T* PTb = PT + b * (m + 1) * nn;

  T acc[4][4];
  product_tile(
      acc, smem, M, n, n, r0, c0,
      [&](int r, int k) {
        return r < mn ? Ab[int64_t(r) * n + k] : Cb[int64_t(r - mn) * n + k];
      },
      [&](int k, int c) { return Wb[int64_t(k) * n + c]; });
  store_tile(acc, M, n, r0, c0,
             [&](int r, int c, T v) { Pb[int64_t(r) * n + c] = v; });

  // The transpose goes through shared memory, so that a warp writes
  // neighbouring i of one row of PT[b, v].
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p)
      smem[(tx + 16 * p) * (TT + 1) + 4 * ty + q] = acc[q][p];
  __syncthreads();
  for (int idx = threadIdx.x; idx < TT * TT; idx += kThreads) {
    const int rr = idx % TT, cc = idx / TT;
    const int r = r0 + rr, c = c0 + cc;
    if (r < M && c < n) {
      const int v = r / n, i = r % n;
      PTb[v * nn + int64_t(c) * n + i] = smem[cc * (TT + 1) + rr];
    }
  }
}

// At layout.  X[b] = Pb (n, m+1, n): Pb[i, v] = (A_v W)[i, :] for v < m,
// the product At[b].reshape(n m, n) @ W[b], and Pb[i, m] = (C W)[i, :];
// Y[b] = Rb (n, m+1, n): Rb[i, u] = (W A_u)[i, :], the product W[b] @
// At[b].reshape(n, m n), and Rb[i, m, k] = (C W)[k, i].
// grid: (tiles of Pb's product, then tiles of Rb's, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_b_kernel(const T* __restrict__ At, const T* __restrict__ W,
               const T* __restrict__ C, T* __restrict__ X,
               T* __restrict__ Y, int m, int n) {
  __shared__ T smem[kSmem];
  const int64_t b = blockIdx.y;
  const int64_t nn = int64_t(n) * n;
  const int64_t row = int64_t(m + 1) * n;  // stride of i in X and Y
  const int tiles_n = cdiv(n, TT);
  const int mn = m * n, M = mn + n;
  const int tiles_pb = cdiv(M, TT) * tiles_n;
  const T* Atb = At + b * m * nn;
  const T* Cb = C + b * nn;
  const T* Wb = W + b * nn;
  T* Xb = X + b * (m + 1) * nn;
  T* Yb = Y + b * (m + 1) * nn;

  T acc[4][4];
  if (blockIdx.x < tiles_pb) {
    const int r0 = (blockIdx.x / tiles_n) * TT, c0 = (blockIdx.x % tiles_n) * TT;
    product_tile(
        acc, smem, M, n, n, r0, c0,
        [&](int r, int k) {
          return r < mn ? Atb[int64_t(r) * n + k] : Cb[int64_t(r - mn) * n + k];
        },
        [&](int k, int c) { return Wb[int64_t(k) * n + c]; });
    store_tile(acc, M, n, r0, c0, [&](int r, int c, T v) {
      if (r < mn) {  // row r = i m + v of the product
        Xb[(r / m) * row + int64_t(r % m) * n + c] = v;
      } else {
        const int i = r - mn;
        Xb[i * row + int64_t(m) * n + c] = v;
        Yb[c * row + int64_t(m) * n + i] = v;
      }
    });
  } else {
    const int t = blockIdx.x - tiles_pb;
    const int tiles_c = cdiv(mn, TT);
    const int r0 = (t / tiles_c) * TT, c0 = (t % tiles_c) * TT;
    product_tile(
        acc, smem, n, mn, n, r0, c0,
        [&](int r, int k) { return Wb[int64_t(r) * n + k]; },
        [&](int k, int c) { return Atb[int64_t(k) * mn + c]; });
    // column c = u n + k of the product is Rb[i, u, k]
    store_tile(acc, n, mn, r0, c0,
               [&](int r, int c, T v) { Yb[r * row + c] = v; });
  }
}

// One block per (cone b, tile (v0, u0) of E): E_vu = sum_{i,k} X[v,i,k]
// Y[u,i,k] over the cone, where entry (v, i, k) of a panel lies at
// v sv + i si + k, and the traces sum_i X[v,i,i] in the tile's first
// column of blocks; written to part[b].  grid: (tiles_g^2, B).
template <typename T, int MPAD>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ X, const T* __restrict__ Y,
            T* __restrict__ part, int m, int n, int64_t sv, int64_t si) {
  __shared__ T smem[kSmem];
  const int64_t b = blockIdx.y;
  const int m1 = m + 1;
  const int tiles_g = cdiv(m1, TT);
  const int v0 = (blockIdx.x / tiles_g) * TT, u0 = (blockIdx.x % tiles_g) * TT;
  const int64_t cone = int64_t(m1) * n * n;
  const T* Xb = X + b * cone;
  const T* Yb = Y + b * cone;
  T* pb = part + b * (int64_t(m1) * m1 + m1);
  // MPAD > 1: the live rows of the tile rounded up to a multiple of MPAD;
  // a warp whose eight rows all lie past them skips the product.
  const int live = MPAD > 1 ? min(TT, cdiv(m1 - v0, MPAD) * MPAD) : TT;
  const bool active = 8 * (threadIdx.x / 32) < live;

  T* Xs = smem;                  // [GL][TT + 1]
  T* Ys = smem + GL * (TT + 1);  // [GL][TT]
  const int tid = threadIdx.x;
  T acc[4][4];
  zero(acc);
  for (int i0 = 0; i0 < n; i0 += GI) {
    for (int k0 = 0; k0 < n; k0 += GK) {
      for (int idx = tid; idx < TT * GL; idx += kThreads) {
        const int kk = idx % GK, ii = (idx / GK) % GI, r = idx / GL;
        const int i = i0 + ii, k = k0 + kk;
        const bool in = i < n && k < n;
        const int v = v0 + r, u = u0 + r;
        Xs[(ii * GK + kk) * (TT + 1) + r] =
            (in && v < m1) ? Xb[v * sv + i * si + k] : T(0);
        Ys[(ii * GK + kk) * TT + r] =
            (in && u < m1) ? Yb[u * sv + i * si + k] : T(0);
      }
      __syncthreads();
      if (active) mac_slice(acc, Xs, Ys, GL);
      __syncthreads();
    }
  }
  store_tile(acc, m1, m1, v0, u0,
             [&](int v, int u, T e) { pb[int64_t(v) * m1 + u] = e; });

  if (u0 == 0 && tid < TT) {
    const int v = v0 + tid;
    if (v < m1) {
      T t = T(0);
      for (int i = 0; i < n; ++i) t += Xb[v * sv + i * (si + 1)];
      pb[int64_t(m1) * m1 + v] = t;
    }
  }
}

// out[e] = sum over cones b, in order, of part[b] at e's entry of E or of
// the traces.  grid: enough threads for m^2 + 2 m + 2 outputs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const T* __restrict__ part, int B, int m, T* __restrict__ G,
              T* __restrict__ AW, T* __restrict__ AQc, T* __restrict__ wc,
              T* __restrict__ cqc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int m1 = m + 1, mm = m * m;
  const int64_t stride = int64_t(m1) * m1 + m1;
  const int64_t tr = int64_t(m1) * m1;  // the traces follow E
  int64_t src;
  T* dst;
  if (e < mm) {
    src = int64_t(e / m) * m1 + e % m;
    dst = G + e;
  } else if (e < mm + m) {
    src = tr + (e - mm);
    dst = AW + (e - mm);
  } else if (e < mm + 2 * m) {
    src = int64_t(e - mm - m) * m1 + m;
    dst = AQc + (e - mm - m);
  } else if (e == mm + 2 * m) {
    src = tr + m;
    dst = wc;
  } else if (e == mm + 2 * m + 1) {
    src = int64_t(m) * m1 + m;
    dst = cqc;
  } else {
    return;
  }
  T s = T(0);
  for (int b = 0; b < B; ++b) s += part[b * stride + src];
  *dst = s;
}

template <typename T, bool AT, int MPAD>
int launch(const T* A, const T* W, const T* C, T* X, T* Y, T* part, T* G,
           T* AW, T* AQc, T* wc, T* cqc, int B, int m, int n,
           cudaStream_t stream) {
  const int tiles_n = cdiv(n, TT);
  const int M = (m + 1) * n;
  int64_t sv, si;
  if (AT) {
    const int tiles = cdiv(M, TT) * tiles_n + tiles_n * cdiv(m * n, TT);
    panel_b_kernel<T><<<dim3(tiles, B), kThreads, 0, stream>>>(A, W, C, X, Y,
                                                                m, n);
    sv = n;
    si = int64_t(m + 1) * n;
  } else {
    const int tiles = cdiv(M, TT) * tiles_n;
    panel_a_kernel<T><<<dim3(tiles, B), kThreads, 0, stream>>>(A, W, C, X, Y,
                                                                m, n);
    sv = int64_t(n) * n;
    si = n;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_g = cdiv(m + 1, TT);
  gram_kernel<T, MPAD><<<dim3(tiles_g * tiles_g, B), kThreads, 0, stream>>>(
      X, Y, part, m, n, sv, si);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outs = m * m + 2 * m + 2;
  reduce_kernel<T><<<cdiv(outs, kThreads), kThreads, 0, stream>>>(
      part, B, m, G, AW, AQc, wc, cqc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: A (B, m, n, n) for K3 and K6, At (B, n, m, n) for K4 and K5; W
// and C (B, n, n); scratch X and Y (B, m+1, n, n) elements each and part
// (B, (m+1)(m+2)); outputs G (m, m), AW and AQc (m), wc and cqc (one
// element).  All contiguous on the current device.  Returns
// cudaGetLastError() after the last launch, or after the first that failed.
#define CONEX_PROBE_ENTRY(NAME, T, AT, MPAD)                                  \
  extern "C" int NAME(const T* A, const T* W, const T* C, T* X, T* Y,         \
                      T* part, T* G, T* AW, T* AQc, T* wc, T* cqc, int B,     \
                      int m, int n, void* stream) {                           \
    return launch<T, AT, MPAD>(A, W, C, X, Y, part, G, AW, AQc, wc, cqc, B,   \
                               m, n, static_cast<cudaStream_t>(stream));      \
  }

CONEX_PROBE_ENTRY(conex_probe_a_f32, float, false, 1)    // K3
CONEX_PROBE_ENTRY(conex_probe_a_f64, double, false, 1)
CONEX_PROBE_ENTRY(conex_probe_b_f32, float, true, 1)     // K4
CONEX_PROBE_ENTRY(conex_probe_b_f64, double, true, 1)
CONEX_PROBE_ENTRY(conex_probe_b2_f32, float, true, 8)    // K5
CONEX_PROBE_ENTRY(conex_probe_b2_f64, double, true, 8)
CONEX_PROBE_ENTRY(conex_probe_a2_f32, float, false, 8)   // K6
CONEX_PROBE_ENTRY(conex_probe_a2_f64, double, false, 8)
