// The scalar column steps of the clamped LDLT, one launch per square, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs these steps as XLA ops,
// the fori_loop bodies panel_factor (conex_tpu/solver/kkt.py:124) and
// _ldlt_scalar's body (conex_tpu/solver/kkt.py:53).  On the card the port
// ran them as about 12 torch ops a column (solver/kkt.py::
// _factor_columns_plain): 12,324 launches for one factor of order 1,021,
// most of a pass in the portfolio QP's cell spent launching them.
//
// For every program s (one CTA each) and j = lo .. hi-1, on the square
// M[s, lo:hi, lo:hi] of the contiguous (S, N, N) M, in place:
//
//   d   = clamp(M[j,j])  (|m| < 1e-9 becomes +1e-9 where m >= 0, else
//                          -1e-9; NaN stays NaN)
//   l_i = M[i,j] / d                                  j < i < hi
//   M[i,k] = M[i,k] - (l_i * l_k) * d                 j < i, k < hi
//   M[i,j] = l_i,  M[j,j] = d
//
// Both triangles of the trailing square are updated; row j right of the
// diagonal keeps its stale values.  Each entry sees the operations of the
// plain loop in its order, each rounded on its own (the build's
// -fmad=false keeps the product, the product by d and the subtraction
// apart, as torch's mul and addcmul_ round them), so the factor, its clamp
// decisions and the fail flag read from it are the plain loop's to the
// bit.
//
// What bounds it.  Not the w^3 / 3 multiply-adds of a square of width w
// (about 0.7 million a program at w = 128, 45 million for 64 programs,
// microseconds on the card) nor its 2 w^2 x 8 bytes, but the w steps:
// each needs the previous step's column, so a square is w dependent
// steps, each a division and an update that the next step waits for.  On
// an H100 a square of 128 in f64 takes about 0.12 ms, one program as 64
// (a CTA each): the divisions of a step run one after another in a lane,
// each about nine dependent f64 operations and a branch to its slow
// path, four a lane; then the deferred updates, at the f64 units' rate.
//
// The design.
//  * Widths up to 128 (every panel of the blocked factor): 1,024 threads
//    hold the square in registers, 16 entries a thread, loaded once and
//    stored once, through shared memory so that warps move whole rows.
//    Warp q holds columns 4q .. 4q+3 (group q), lane t rows t, t+32,
//    t+64, t+96.
//  * One barrier per group of four steps, not per step.  Warp q takes the
//    steps of its own group alone: the pivot by a shuffle, the divisions
//    of its column, the update of its group's later columns, with no
//    block barrier between them.  It posts each step's l and d to shared
//    memory; after the barrier every later warp applies the group's four
//    updates to its own columns, in step order, while the next group's
//    warp, having done the same to its columns, goes on to its steps.
//    Each entry still takes its updates one step at a time in the plain
//    loop's order, so deferring them changes no bit.
//  * Wider squares (the supernodal cliques that _ldlt_scalar factors
//    whole): the square stays in global memory (L2), l in shared memory,
//    two barriers a step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerLane = 4;                         // rows t + 32 a
constexpr int kColsPerWarp = 4;                         // columns 4 q + b
constexpr int kWide = kWarp * kRowsPerLane;             // 128
constexpr int kThreads = kWarp * (kWide / kColsPerWarp);  // 1,024
static_assert(kRowsPerLane == 4, "ldlt_square_regs gathers a column of 4");
// Rows of the staged square, one entry longer than the square so that a
// warp reading a column (a lane a row) spreads over the banks.
constexpr int kPitch = kWide + 1;

__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ double magnitude(double x) { return fabs(x); }

// solver/kkt.py::_clamp_pivot; 1e-9 rounded to T, as torch rounds it.
template <typename T>
__device__ __forceinline__ T clamp_pivot(T m) {
  const T c = T(1e-9);
  return magnitude(m) < c ? (m >= T(0) ? c : -c) : m;
}

// x / d, IEEE-rounded.  A zero x over a finite nonzero d is a zero of sign
// x's times d's, which x * d gives exactly; the division itself would
// send that case down its slow path (a zero quotient fails the fast
// path's range check), and most of a KKT matrix's entries are zeros.
template <typename T>
__device__ __forceinline__ T quotient(T x, T d) {
  return x == T(0) && d != T(0) && isfinite(d) ? x * d : x / d;
}

// x[i] for an i that is the same across the warp, from registers.
template <typename T>
__device__ __forceinline__ T pick(const T (&x)[kRowsPerLane], int i) {
  T r = x[0];
#pragma unroll
  for (int k = 1; k < kRowsPerLane; ++k)
    if (i == k) r = x[k];
  return r;
}

// The square of width w <= 128 at A (row stride N) in registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ldlt_square_regs(T* __restrict__ M, int N, int lo, int w) {
  __shared__ T lpanel[2][kColsPerWarp][kWide];  // l of a group's steps, by parity
  __shared__ T dsave[kWide];                     // the clamped pivots

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int col0 = kColsPerWarp * warp;
  T* A = M + static_cast<int64_t>(blockIdx.x) * N * N +
         static_cast<int64_t>(lo) * N + lo;

  // The square goes through shared memory on its way in and out, so that
  // a warp reads and writes whole rows of M.
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);  // kWide rows of kPitch

  // l of rows past w stays 0, so that the entries no one stores stay finite.
  for (int i = threadIdx.x; i < 2 * kColsPerWarp * kWide; i += kThreads)
    (&lpanel[0][0][0])[i] = T(0);
  for (int e = threadIdx.x; e < kWide * kWide; e += kThreads) {
    const int row = e / kWide, col = e % kWide;
    stage[row * kPitch + col] =
        (row < w && col < w) ? A[static_cast<int64_t>(row) * N + col] : T(0);
  }
  __syncthreads();
  T v[kRowsPerLane][kColsPerWarp];
#pragma unroll
  for (int a = 0; a < kRowsPerLane; ++a)
#pragma unroll
    for (int b = 0; b < kColsPerWarp; ++b)
      v[a][b] = stage[(lane + kWarp * a) * kPitch + col0 + b];

  // Group p is warp p's columns 4p .. 4p+3.  In round p, warp p first
  // takes group p-1's steps on its columns, as every later warp does on
  // its own, then takes group p's steps alone; one barrier ends the round.
  const int groups = (w + kColsPerWarp - 1) / kColsPerWarp;
  for (int p = 0; p < groups; ++p) {
    if (p > 0 && warp >= p) {
      const int prev = (p - 1) & 1;
#pragma unroll
      for (int s = 0; s < kColsPerWarp; ++s) {
        const int j = kColsPerWarp * (p - 1) + s;
        if (j < w) {
          const T d = dsave[j];
#pragma unroll
          for (int a = 0; a < kRowsPerLane; ++a) {
            if (kWarp * (a + 1) > j + 1) {  // some row of the block lies below j
              const T lr = lpanel[prev][s][lane + kWarp * a];
              const bool below = lane + kWarp * a > j;
#pragma unroll
              for (int b = 0; b < kColsPerWarp; ++b) {
                const T lc = lpanel[prev][s][col0 + b];
                if (below) v[a][b] = v[a][b] - (lr * lc) * d;
              }
            }
          }
        }
      }
    }
    if (warp == p) {
      const int cur = p & 1;
#pragma unroll
      for (int s = 0; s < kColsPerWarp; ++s) {
        const int j = col0 + s;
        if (j < w) {
          const T column[kRowsPerLane] = {v[0][s], v[1][s], v[2][s], v[3][s]};
          const T d = clamp_pivot(
              __shfl_sync(0xffffffffu, pick(column, j / kWarp), j % kWarp));
          if (lane == 0) dsave[j] = d;
          // A row that takes no l divides 1 and keeps its entry.
          T l[kRowsPerLane];
#pragma unroll
          for (int a = 0; a < kRowsPerLane; ++a) {
            const int row = lane + kWarp * a;
            const bool below = row > j && row < w;
            l[a] = quotient(below ? v[a][s] : T(1), d);
            if (below) {
              v[a][s] = l[a];
              lpanel[cur][s][row] = l[a];
            }
          }
          // The step's update of the group's later columns.
#pragma unroll
          for (int b = s + 1; b < kColsPerWarp; ++b) {
            const int k = col0 + b;
            if (k < w) {
              const T lk = __shfl_sync(0xffffffffu, pick(l, k / kWarp), k % kWarp);
#pragma unroll
              for (int a = 0; a < kRowsPerLane; ++a)
                if (lane + kWarp * a > j) v[a][b] = v[a][b] - (l[a] * lk) * d;
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kRowsPerLane; ++a) {
    const int row = lane + kWarp * a;
#pragma unroll
    for (int b = 0; b < kColsPerWarp; ++b)
      stage[row * kPitch + col0 + b] = row == col0 + b ? dsave[row] : v[a][b];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kWide * kWide; e += kThreads) {
    const int row = e / kWide, col = e % kWide;
    if (row < w && col < w)
      A[static_cast<int64_t>(row) * N + col] = stage[row * kPitch + col];
  }
}

// Any width: the square in global memory, l of the step in shared memory
// (w entries).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ldlt_square_global(T* __restrict__ M, int N, int lo, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* lcol = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  T* A = M + static_cast<int64_t>(blockIdx.x) * N * N +
         static_cast<int64_t>(lo) * N + lo;

  for (int j = 0; j < w; ++j) {
    // M[j,j] is read by every thread here and written after the barrier.
    const T d = clamp_pivot(A[static_cast<int64_t>(j) * N + j]);
    for (int i = j + 1 + threadIdx.x; i < w; i += blockDim.x) {
      T* x = A + static_cast<int64_t>(i) * N + j;
      const T l = quotient(*x, d);
      *x = l;
      lcol[i] = l;
    }
    __syncthreads();
    if (threadIdx.x == 0) A[static_cast<int64_t>(j) * N + j] = d;
    for (int i = j + 1 + warp; i < w; i += warps) {
      const T li = lcol[i];
      T* row = A + static_cast<int64_t>(i) * N;
      for (int k = j + 1 + lane; k < w; k += kWarp)
        row[k] = row[k] - (li * lcol[k]) * d;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(T* M, int S, int N, int lo, int hi, cudaStream_t stream) {
  if (S < 0 || N < 1 || lo < 0 || hi <= lo || hi > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const int w = hi - lo;
  if (w <= kWide) {
    const int smem = kWide * kPitch * static_cast<int>(sizeof(T));
    const cudaError_t err = cudaFuncSetAttribute(
        ldlt_square_regs<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ldlt_square_regs<T><<<S, kThreads, smem, stream>>>(M, N, lo, w);
  } else {
    const size_t smem = static_cast<size_t>(w) * sizeof(T);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          ldlt_square_global<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    ldlt_square_global<T><<<S, kThreads, smem, stream>>>(M, N, lo, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// M (S, N, N) contiguous on the current device; the steps j = lo .. hi-1
// on the square [lo, hi)^2 of every program, in place, 0 <= lo < hi <= N.
// Returns the launch's CUDA error, or 0.
int conex_ldlt_panel_f32(float* M, int S, int N, int lo, int hi, void* stream) {
  return launch<float>(M, S, N, lo, hi, static_cast<cudaStream_t>(stream));
}

int conex_ldlt_panel_f64(double* M, int S, int N, int lo, int hi, void* stream) {
  return launch<double>(M, S, N, lo, hi, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
