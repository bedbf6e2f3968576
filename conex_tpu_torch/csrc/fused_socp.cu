// The whole geodesic interior-point solve of a batch of small SOCPs, a team
// of lanes per scenario, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conex_tpu/parallel/fused_socp.py:234 (the
// inner `kernel` of `_make_kernel`, launched by `_solve_padded` and
// `solve_socp_fused`).  Each scenario s is
//
//   max b_s'y  s.t.  c_sj - A_sj y in Q^{n+1},  j = 0..nc-1,
//
// and one team of TEAM lanes (1, 2, 4, 8, 16 or 32, a template parameter;
// a warp holds 32/TEAM teams; the library holds TEAM 8 and 32, the two the
// plan picks, and a build with CONEX_SOCP_ALL_TEAMS defined holds them all)
// runs its whole solve: per Newton iteration the
// Schur assembly through Q(w^1/2), the m x m Cholesky with its fail flag,
// the triangular solves and refinement, the divergence mu update, the Newton
// solve and the spectral-exp geodesic step, the warmstart abort, the
// statistics and the stall detector, and the merge into the scenario's
// state; after the loop the dual recovery.
//
// Work within a team.  The lanes split the independent outputs of a stage:
// the columns of the panel WA = Q(w^1/2) A, the entries of G's lower
// triangle and of AQc, the rows below the pivot of a Cholesky column, the
// rows of A y - k c, the entries of each cone update and the rows of the
// refinement's G x.  Every sum is still taken by one lane, from zero, left
// to right, in the order of the plain version; the dependent scalar chains
// (cone dots, |x_1|^2, the folds over cones, the mu update, the statistics)
// run on every lane of the team in the same order, so every lane holds the
// same bits and the control flags stay uniform within the team, and the two
// triangular substitutions run on the team's first lane.  Stages are
// separated by __syncwarp over the team's lanes only: a team whose scenario
// is done leaves its loop while the other teams of its warp go on.
//
// Memory.  The plan (parallel/fused_socp.py::socp_plan) chooses the route
// by shape before the launch.  Shared route: each team's working set (A, c,
// b, w, y, w^1/2, WA, WC, d, ms, G, L and five m-vectors) lies in dynamic
// shared memory, at a per-scenario stride of an odd number of elements so
// that the teams of a warp fall on other banks.
// The inputs are read in the caller's layout (S, ...), where a block's
// scenarios are one contiguous range of each input, and staged once per
// solve with cp.async (4 or 8 bytes per element): the bulk copy needs 16-byte
// aligned sources and sizes, and a scenario's inputs at the benchmark shape
// (840 bytes of A, 84 of c and w, 40 of b) put every other scenario off
// that alignment.  Global route, where one scenario's working set exceeds
// the shared memory of a block: the same code with the working arrays in a
// scratch buffer, contiguous per scenario, A, c and b read in place and w
// and y kept in the output tensors.  Either way the team's first lane
// writes each iteration's statistics, and the kernel writes y, w and the
// scalars, straight into the (S, ...) tensors of RawResult.
//
// What bounds it.  At the benchmark shape (nc = 1, n = 20, m = 10, f32) a
// scenario's working set is 3.3 KB, so about 70 scenarios fit on an SM and
// the device-memory traffic of a solve is its inputs and outputs (0.15 GB at
// S = 100,000).  What is left is the latency of the dependent chains (the
// two substitutions, the pivots, the cone dots) and the issue slots they
// take; TEAM trades the two (PERF.md, tools/kernel_costs.py k2).  No tensor
// cores: an mma would change the rounding and the order of G's sums, and
// the kernel's only tight test is its bit-for-bit agreement with the plain
// version.
//
// Determinism: each value is computed by one lane (or by all lanes of a
// team alike) in a fixed order; no atomics.  Built without --use_fast_math
// (sqrt, exp and division are IEEE) and with -fmad=false: every product and
// sum is rounded on its own, in the order of the plain version
// (parallel/fused_socp.py::solve_socp_plain), and the two give the same
// bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Launch bounds: the plan never asks for more threads per block.
constexpr int kMaxThreads = 256;

// Integer parameters, in the order of the host array.
struct IParams {
  int T, fc_steps, init_centering, refine, warmstart, fixed, rescale, dual,
      stall_iters;
};

// Floating-point parameters, in the order of the host array.
struct DParams {
  double kkt_tol, k_max0, k_min_clamp, rank, div_ub, fc_tol, ws_abort_thr,
      stall_tol;
};

// The plan of a launch, in the order of the host array.
struct Plan {
  int team, per_block, shared, stride;
};

template <typename T>
struct Args {
  const T *A, *c, *b, *w0, *k0, *bsc0, *csc0;
  T *y, *w, *k, *kmax, *bsc, *csc, *by, *cx;
  int *fail, *mir, *stall, *niter, *aborted;
  T *stats_k, *stats_d, *scratch;
  int S, nc, n1, m;
  int per_block;  // scenarios per block
  int stride;     // elements of one scenario's region (shared or scratch)
  IParams ip;
  DParams dp;
};

// IEEE math in the working type.
__device__ __forceinline__ float xsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double xsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xabs(float x) { return fabsf(x); }
__device__ __forceinline__ double xabs(double x) { return fabs(x); }
// x - x is 0 exactly for a finite x and NaN for an infinite or NaN one.
template <typename T>
__device__ __forceinline__ bool finite(T x) {
  return x - x == T(0);
}

// jnp.maximum / jnp.minimum: a NaN in either argument gives NaN.
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}

// s + term(lo) + term(lo + 1) + ... + term(hi - 1), added left to right.
// Unrolled by 4, so the loads of the next terms are in flight while the
// chain adds; longer chunks and out-of-line stage functions measured
// slower on an H100 (PERF.md).
template <typename T, typename F>
__device__ __forceinline__ T sum_terms(T s, int lo, int hi, F term) {
#pragma unroll 4
  for (int i = lo; i < hi; ++i) s = s + term(i);
  return s;
}

// s - term(lo) - term(lo + 1) - ... - term(hi - 1), left to right.
template <typename T, typename F>
__device__ __forceinline__ T sub_terms(T s, int lo, int hi, F term) {
#pragma unroll 4
  for (int i = lo; i < hi; ++i) s = s - term(i);
  return s;
}

template <typename T>
__device__ T tail_sq(const T* x, int n1) {
  return sum_terms(T(0), 1, n1, [x](int r) { return x[r] * x[r]; });
}

template <typename T>
__device__ T det(const T* x, int n1) {
  return x[0] * x[0] - tail_sq<T>(x, n1);
}

// The mu fallback chain (conex_tpu/solver/mu.py::mu_from_divergence).
template <typename T>
__device__ bool bound_is_finite(T k, T lmin, T lmax) {
  return nmax(xabs(k * lmax - T(1)), xabs(k * lmin - T(1))) < T(1);
}

template <typename T>
__device__ T mu_from_divergence(T lmin, T lmax, T frob, T trace, T rank,
                                T budget, T rank07) {
  T k1;
  {  // lambda_min branch
    const T a = frob / lmin, b = T(2) * trace / lmin, n = rank / lmin;
    const T c = budget;
    const T ur = b * b + T(2) * b * c + c * c - T(4) * a * n;
    const bool ok = ur >= T(0);
    const T sq = xsqrt(nmax(ur, T(0)));
    const T ka = (b + c + sq) / (T(2) * a), kb = (b + c - sq) / (T(2) * a);
    const T upper = T(2) / (lmax + lmin);
    k1 = (ok && ka >= T(0) && ka <= upper) ? ka : T(-1);
    k1 = (ok && kb >= T(0) && kb <= upper && kb > k1) ? kb : k1;
  }
  T k2;
  {  // lambda_max branch: the rational equation
    const T a = frob, b = T(-2) * trace, c = rank, d = lmax, kk = budget;
    const T ur = b * b - T(4) * a * c + T(8) * a * kk + T(2) * b * d * kk +
                 (d * kk) * (d * kk);
    const T x = -(b + d * kk - xsqrt(ur)) / (T(2) * a);
    k2 = (finite(x) && x >= T(2) / (lmax + lmin)) ? x : T(-1);
  }
  T k = bound_is_finite(k1, lmin, lmax) ? k1 : T(-1);
  k = (k2 > k && bound_is_finite(k2, lmin, lmax)) ? k2 : k;
  // Fallback 1: minimize ||k lam - 1||_inf.
  const T k_minnorm = lmin > T(0) ? T(2) / (lmin + lmax) : T(-1);
  k = (k == T(-1)) ? k_minnorm : k;
  // Fallback 2: a k that satisfies a norm bound.
  const T kstar = trace / frob;
  T nb = T(1.5) * (frob * kstar * kstar - T(2) * trace * kstar + rank);
  nb = nmin(nb, rank07);
  const T a = frob, b = T(-2) * trace, c = rank - nb;
  const T disc = b * b - T(4) * a * c;
  const T kq = disc < T(0) ? trace / frob
                           : (-b + xsqrt(nmax(disc, T(0)))) / (T(2) * a);
  return (k < T(0) && trace > T(1e-12)) ? kq : k;
}

// One scenario, seen by one lane of its team.  Arrays are contiguous per
// scenario: A (nc, n1, m), c, w, wsqrt, WC, d (nc, n1), WA (nc, n1, m), G and
// L (m, m) row-major.  Loops `for (i = lane; i < n; i += TEAM)` give each
// lane its share of a stage's outputs.
template <typename T, int TEAM>
struct Scenario {
  int nc, n1, m, lane;
  unsigned mask;
  const T *A, *c, *b;
  T *w, *y;
  T *wsqrt, *WA, *WC, *d, *ms, *G, *L, *AW, *AQc, *rhs, *x, *tmp;

  __device__ void sync() const {
    if (TEAM > 1) __syncwarp(mask);
  }

  // out = fn(lam1) P1 + fn(lam2) P2 (spin.py::_spectral_apply); out may be x.
  template <typename Fn>
  __device__ void spectral(const T* x, T* out, Fn fn) const {
    const T h = x[0];
    const T nq = xsqrt(tail_sq<T>(x, n1));
    const T f1 = fn(h + nq), f2 = fn(h - nq);
    const T hd = T(0.5) * (f1 - f2);
    sync();  // every lane has read x before out (maybe x) is written
    for (int r = lane; r < n1; r += TEAM) {
      if (r == 0) {
        out[0] = T(0.5) * (f1 + f2);
      } else {
        const T qhat = nq > T(0) ? x[r] / (nq == T(0) ? T(1) : nq) : T(0);
        out[r] = hd * qhat;
      }
    }
    sync();
  }

  // out = Q(x) y = 2 <x,y> x - det(x) R y, plus e if plus_e; out must not
  // alias x or y.
  __device__ void qrep(const T* x, const T* yv, T* out, bool plus_e) const {
    const T dot = sum_terms(T(0), 0, n1, [=](int r) { return x[r] * yv[r]; });
    const T dx = det<T>(x, n1);
    for (int r = lane; r < n1; r += TEAM) {
      if (r == 0) {
        const T o = T(2) * dot * x[0] + dx * -yv[0];
        out[0] = plus_e ? o + T(1) : o;
      } else {
        out[r] = T(2) * dot * x[r] + dx * yv[r];
      }
    }
    sync();
  }

  __device__ void set_identity(int j) const {
    T* wj = w + j * n1;
    for (int r = lane; r < n1; r += TEAM) wj[r] = r == 0 ? T(1) : T(0);
  }

  // Schur-complement contributions summed over the cones
  // (soc_constraint.cc:272-303): w^1/2, WA, WsqrtC, G, AW, AQc.
  __device__ void assemble(T& w_dot_c, T& c_dot_Qc) const {
    T wdc = T(0), cdq = T(0);
    for (int v = lane; v < m; v += TEAM) AW[v] = T(0);
    for (int j = 0; j < nc; ++j) {
      T* ws = wsqrt + j * n1;
      const T* wj = w + j * n1;
      T* wc = WC + j * n1;
      spectral(wj, ws, [](T t) { return xsqrt(t); });
      const T dws = det<T>(ws, n1);
      qrep(ws, c + j * n1, wc, false);
      wdc += wc[0];
      cdq = sum_terms(cdq, 0, n1, [=](int r) { return wc[r] * wc[r]; });
      // Lane by column v of the panel: A[j, :, v] and WA[j, :, v].
      const T* Aj = A + int64_t(j) * n1 * m;
      T* WAj = WA + int64_t(j) * n1 * m;
      for (int v = lane; v < m; v += TEAM) {
        const T* a = Aj + v;
        const T dot = sum_terms(T(0), 0, n1, [=](int r) { return ws[r] * a[r * m]; });
        const T aw = sum_terms(T(0), 0, n1, [=](int r) { return a[r * m] * wj[r]; });
        AW[v] += aw;
        WAj[v] = T(2) * dot * ws[0] + dws * -Aj[v];
        for (int r = 1; r < n1; ++r)
          WAj[r * m + v] = T(2) * dot * ws[r] + dws * Aj[r * m + v];
      }
    }
    for (int v = lane; v < m; v += TEAM) AW[v] = T(2) * AW[v];
    sync();
    // Lane by entry: (v, u), u <= v, of G's lower triangle in row-major
    // order, then the m entries of AQc.
    const int ntri = m * (m + 1) / 2, rows = nc * n1;
    int v = 0, u = lane;
    while (u > v) {
      u -= v + 1;
      ++v;
    }
    for (int e = lane; e < ntri + m; e += TEAM) {
      if (e < ntri) {
        const T *pv = WA + v, *pu = WA + u;
        const int mm = m;
        const T g = sum_terms(T(0), 0, rows, [=](int q) { return pv[q * mm] * pu[q * mm]; });
        G[v * m + u] = T(2) * g;
        G[u * m + v] = T(2) * g;
        u += TEAM;
        while (u > v && v < m) {
          u -= v + 1;
          ++v;
        }
      } else {
        const int a = e - ntri;
        const T *pa = WA + a, *wc = WC;
        const int mm = m;
        const T q = sum_terms(T(0), 0, rows, [=](int r) { return pa[r * mm] * wc[r]; });
        AQc[a] = T(2) * q;
      }
    }
    sync();
    w_dot_c = T(2) * wdc;
    c_dot_Qc = T(2) * cdq;
  }

  // L L^T = G, column by column (fused_socp.py::_chol): a pivot that is not
  // > 0 or not finite fails, and the column goes on with a pivot of 1.
  // Every lane takes the pivot; the lanes split the rows below it.
  __device__ bool cholesky() const {
    bool fail = false;
    for (int j = 0; j < m; ++j) {
      const T* lj = L + j * m;
      const T acc = sum_terms(T(0), 0, j, [=](int t) { return lj[t] * lj[t]; });
      const T piv = G[j * m + j] - acc;
      fail = fail || !(piv > T(0)) || !finite(piv);
      const T dj = xsqrt(piv > T(0) ? piv : T(1));
      if (lane == 0) L[j * m + j] = dj;
      for (int i = j + 1 + lane; i < m; i += TEAM) {
        const T* li = L + i * m;
        const T s = sum_terms(T(0), 0, j, [=](int t) { return li[t] * lj[t]; });
        const T col = G[i * m + j] - s;
        L[i * m + j] = col / dj;
      }
      sync();
    }
    return fail;
  }

  // v <- (L L^T)^{-1} v in place (fused_socp.py::_chol_solve), on the
  // team's first lane.
  __device__ void chol_solve(T* v) const {
    if (lane == 0) {
      const T* l = L;
      const int mm = m;
      for (int j = 0; j < m; ++j) {
        const T* lj = l + j * mm;
        const T s = sub_terms(v[j], 0, j, [=](int t) { return lj[t] * v[t]; });
        v[j] = s / L[j * m + j];
      }
      for (int j = m - 1; j >= 0; --j) {
        const T* lc = l + j;
        const T s = sub_terms(v[j], j + 1, m, [=](int t) { return lc[t * mm] * v[t]; });
        v[j] = s / L[j * m + j];
      }
    }
    sync();
  }

  // x <- G^{-1} rhs with `refine` steps of iterative refinement; rhs must
  // be complete (synced) on entry.
  __device__ void solve_kkt(int refine) const {
    for (int v = lane; v < m; v += TEAM) x[v] = rhs[v];
    sync();
    chol_solve(x);
    for (int it = 0; it < refine; ++it) {
      for (int i = lane; i < m; i += TEAM) {
        const T *gi = G + i * m, *xv = x;
        const T gx = sum_terms(T(0), 0, m, [=](int u) { return gi[u] * xv[u]; });
        tmp[i] = rhs[i] - gx;
      }
      sync();
      chol_solve(tmp);
      for (int v = lane; v < m; v += TEAM) x[v] = x[v] + tmp[v];
      sync();
    }
  }

  // ms <- A_j y - cw c_j (soc_constraint.cc:193-197), lane by row.  Every
  // lane must be done reading ms.
  __device__ void minus_slack(int j, const T* yv, T cw) const {
    const T* cj = c + j * n1;
    for (int r = lane; r < n1; r += TEAM) {
      const T* arow = A + (int64_t(j) * n1 + r) * m;
      const T ay = sum_terms(T(0), 0, m, [=](int v) { return arow[v] * yv[v]; });
      ms[r] = ay - cw * cj[r];
    }
    sync();
  }
};

// cp.async of one element, global to shared (4 or 8 bytes).
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)));
}

// Stage `per` elements of each of `count` scenarios, contiguous from src,
// to dst + q * stride, with every thread of the block.
template <typename T>
__device__ void stage(T* dst, const T* src, int count, int per, int stride) {
  const int total = count * per;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int q = i / per;
    copy_async(dst + q * stride + (i - q * per), src + i);
  }
}

template <typename T, int TEAM, bool SHARED>
__global__ void __launch_bounds__(kMaxThreads) socp_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = a.nc, n1 = a.n1, m = a.m, Tn = a.ip.T;
  const int cn = nc * n1;
  const int team = threadIdx.x / TEAM, lane = threadIdx.x % TEAM;
  const int64_t s0 = int64_t(blockIdx.x) * a.per_block;
  const int count = int(a.S - s0 < a.per_block ? a.S - s0 : a.per_block);
  const int64_t s = s0 + team;

  Scenario<T, TEAM> sc;
  sc.nc = nc;
  sc.n1 = n1;
  sc.m = m;
  sc.lane = lane;
  sc.mask = TEAM == 32 ? 0xffffffffu
                       : ((1u << TEAM) - 1u) << ((threadIdx.x % 32) / TEAM * TEAM);
  T* work;  // w^1/2, WA, WC, d, ms, G, L, AW, AQc, rhs, x, tmp
  if (SHARED) {
    // Region of a scenario: A, c, b, w, y, then the working arrays.
    T* smem = reinterpret_cast<T*>(smem_raw);
    const int offA = 0, offc = cn * m, offb = offc + cn, offw = offb + m;
    stage(smem + offA, a.A + s0 * cn * m, count, cn * m, a.stride);
    stage(smem + offc, a.c + s0 * cn, count, cn, a.stride);
    stage(smem + offb, a.b + s0 * m, count, m, a.stride);
    stage(smem + offw, a.w0 + s0 * cn, count, cn, a.stride);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (team >= count) return;
    T* region = smem + int64_t(team) * a.stride;
    sc.A = region + offA;
    sc.c = region + offc;
    sc.b = region + offb;
    sc.w = region + offw;
    sc.y = sc.w + cn;
    work = sc.y + m;
  } else {
    if (team >= count) return;
    sc.A = a.A + s * cn * m;
    sc.c = a.c + s * cn;
    sc.b = a.b + s * m;
    sc.w = a.w + s * cn;
    sc.y = a.y + s * m;
    work = a.scratch + s * a.stride;
    for (int i = lane; i < cn; i += TEAM) sc.w[i] = a.w0[s * cn + i];
  }
  T* const stats_k = a.stats_k + s * Tn;
  T* const stats_d = a.stats_d + s * Tn;
  {
    T* p = work;
    auto carve = [&p](int64_t n) {
      T* v = p;
      p += n;
      return v;
    };
    sc.wsqrt = carve(cn);
    sc.WA = carve(int64_t(cn) * m);
    sc.WC = carve(cn);
    sc.d = carve(cn);
    sc.ms = carve(n1);
    sc.G = carve(int64_t(m) * m);
    sc.L = carve(int64_t(m) * m);
    sc.AW = carve(m);
    sc.AQc = carve(m);
    sc.rhs = carve(m);
    sc.x = carve(m);
    sc.tmp = carve(m);
  }
  const IParams ip = a.ip;

  // Parameters in the working type (as the JAX kernel's weakly typed
  // Python scalars are).
  const T kkt_tol = T(a.dp.kkt_tol), k_min_clamp = T(a.dp.k_min_clamp);
  const T rank = T(a.dp.rank), fc_tol = T(a.dp.fc_tol);
  const T budget = T(a.dp.div_ub * a.dp.rank), rank07 = T(a.dp.rank * 0.7);
  const T ws_abort_thr = T(a.dp.ws_abort_thr), stall_tol = T(a.dp.stall_tol);
  const bool warmstart = ip.warmstart != 0, fixed = ip.fixed != 0;
  const bool stall_on = ip.stall_iters > 0 && !fixed;

  for (int v = lane; v < m; v += TEAM) sc.y[v] = T(0);
  for (int g = lane; g < Tn; g += TEAM) {
    stats_k[g] = T(0);
    stats_d[g] = T(0);
  }
  sc.sync();
  T k = a.k0[s], k_max = T(a.dp.k_max0), b_sc = a.bsc0[s], c_sc = a.csc0[s];
  T kkt_err = T(0), by = T(-1), cx = T(1), d_inf = T(0);
  int centering = 0, num_iter = 0, stall = 0;
  bool done = false, fail = false, mir = true, aborted = false;

  for (int g = 0; g < Tn && !done; ++g) {
    // --- break-before-assemble (cone_program.cc:331-336) ---
    const bool final_c =
        (k >= k_max) || (kkt_err > kkt_tol) || (g >= Tn - ip.fc_steps);
    const bool stop_centering =
        !fixed && final_c && (centering >= ip.fc_steps);
    if (stop_centering) {
      done = true;
      mir = g >= Tn - 1;
      break;
    }

    // --- run_iteration (cone_program.cc:311-483) ---
    const bool initial_centering = g < ip.init_centering;
    const bool update_mu =
        (g == 0) || !(initial_centering || final_c) || aborted;
    T w_dot_c, c_dot_Qc;
    sc.assemble(w_dot_c, c_dot_Qc);

    T b_sc_n = b_sc, c_sc_n = c_sc, k_max_n = k_max;
    if (ip.rescale && g < 1) {
      if (!warmstart) {  // warmstart keeps the caller's scalings
        const T *bv = sc.b, *qv = sc.AQc;
        const T bb = sum_terms(T(0), 0, m, [=](int v) { return bv[v] * bv[v]; });
        const T qq = sum_terms(T(0), 0, m, [=](int v) { return qv[v] * qv[v]; });
        b_sc_n = T(1) / (T(1) + xsqrt(bb));
        c_sc_n = T(1) / (T(1) + xsqrt(qq));
      }
      const T mu_target = (T(1) / (k_max * k_max)) * b_sc_n * c_sc_n;
      k_max_n = T(1) / xsqrt(mu_target);
    }

    // --- factor; a failure aborts the scenario, or at the first warmstart
    // iteration resets it to the identity (cone_program.cc:360-371) ---
    if (sc.cholesky()) {
      k_max = k_max_n;
      b_sc = b_sc_n;
      c_sc = c_sc_n;
      if (warmstart && g == 0) {
        for (int j = 0; j < nc; ++j) sc.set_identity(j);
        sc.sync();
        aborted = true;
        continue;
      }
      done = true;
      fail = true;
      aborted = false;
      break;
    }

    // --- mu update (divergence mode, cone_program.cc:374-398) ---
    for (int v = lane; v < m; v += TEAM)
      sc.rhs[v] = sc.AQc[v] * c_sc_n - sc.b[v] * b_sc_n;
    sc.sync();
    sc.solve_kkt(ip.refine);
    T lam_min = T(0), lam_max = T(0), frob = T(0), trace = T(0);
    for (int j = 0; j < nc; ++j) {
      sc.minus_slack(j, sc.x, c_sc_n);
      const T *ws = sc.wsqrt + j * n1, *msv = sc.ms;
      const T dot = sum_terms(T(0), 0, n1, [=](int r) { return ws[r] * msv[r]; });
      const T dws = det<T>(ws, n1);
      const T h = T(2) * dot * ws[0] + dws * -sc.ms[0];
      const T tt = sum_terms(T(0), 1, n1, [=](int r) {
        const T e = T(2) * dot * ws[r] + dws * msv[r];
        return e * e;
      });
      sc.sync();  // every lane has read ms
      const T nq = xsqrt(tt);
      const T ev1 = h + nq, ev2 = h - nq;
      const T lmax_c = -nmin(ev1, ev2), lmin_c = -nmax(ev1, ev2);
      lam_min = j ? nmin(lam_min, lmin_c) : lmin_c;
      lam_max = j ? nmax(lam_max, lmax_c) : lmax_c;
      frob += lmax_c * lmax_c + lmin_c * lmin_c;
      trace += lmax_c + lmin_c;
    }
    lam_min = nmin(T(30000), lam_min);
    lam_max = nmax(T(-30000), lam_max);
    const T temp =
        mu_from_divergence(lam_min, lam_max, frob, trace, rank, budget, rank07);
    const T k_mu = temp > T(0) ? temp : k * T(0.5);
    T k_new = update_mu ? k_mu : k;
    const int centering_new =
        update_mu ? centering : centering + (initial_centering ? 0 : 1);
    k_new = nmin(nmax(k_new, k_min_clamp), k_max_n);

    // --- Newton solve + step (cone_program.cc:409-436) ---
    for (int v = lane; v < m; v += TEAM)
      sc.rhs[v] = k_new * (sc.b[v] * b_sc_n + sc.AQc[v] * c_sc_n) -
                  T(2) * sc.AW[v];
    sc.sync();
    sc.solve_kkt(ip.refine);
    const T c_weight = k_new * c_sc_n;
    T norminf = T(0), normsq = T(0);
    for (int j = 0; j < nc; ++j) {
      const T* dj = sc.d + j * n1;
      sc.minus_slack(j, sc.x, c_weight);
      sc.qrep(sc.wsqrt + j * n1, sc.ms, sc.d + j * n1, true);  // d += e
      const T sq = sum_terms(T(0), 0, n1, [=](int r) { return dj[r] * dj[r]; });
      normsq += sq;
      const T nq = xsqrt(tail_sq<T>(dj, n1));
      const T ni = nmax(xabs(dj[0] + nq), xabs(dj[0] - nq));
      norminf = j ? nmax(norminf, ni) : ni;
    }
    normsq = T(2) * normsq;
    const T step = nmin(T(1), T(2) / (norminf * norminf));
    // Warmstart abort on a large first step (cone_program.cc:428-436):
    // reset the iterate, keep everything else from the iteration.
    const bool ws_abort = warmstart && g == 0 && norminf >= ws_abort_thr;
    for (int j = 0; j < nc; ++j) {
      if (ws_abort) {
        sc.set_identity(j);
        continue;
      }
      const T* dj = sc.d + j * n1;
      for (int r = lane; r < n1; r += TEAM) sc.ms[r] = step * dj[r];
      sc.sync();
      sc.spectral(sc.ms, sc.ms, [](T t) { return xexp(t); });
      sc.qrep(sc.wsqrt + j * n1, sc.ms, sc.w + j * n1, false);
    }
    sc.sync();

    // --- statistics (cone_program.cc:439-471) ---
    const T d_2sq = xabs(normsq);
    const T d_inf_new = xabs(norminf);
    const T *bv = sc.b, *qv = sc.AQc, *xv = sc.x;
    const T bx = sum_terms(T(0), 0, m, [=](int v) { return bv[v] * xv[v]; });
    const T qx = sum_terms(T(0), 0, m, [=](int v) { return qv[v] * xv[v]; });
    const T by_new = bx / (k_new * c_sc_n);
    const T cx_new = (T(2) * w_dot_c + qx - k_new * c_dot_Qc * c_sc_n) /
                     (k_new * b_sc_n);
    const T mu = T(1) / (k_new * k_new);
    const T s_dot_x = mu * (rank - d_2sq) / (b_sc_n * c_sc_n);
    const T kkt_err_new = xabs(cx_new - by_new - s_dot_x) / s_dot_x;

    bool stop = !fixed && (final_c || k_new >= k_max_n) && (d_inf_new <= fc_tol);
    int stall_new = stall;
    if (stall_on) {
      const T rel = xabs(k_new - k) / nmax(xabs(k), T(1e-30));
      const bool stalled_now =
          update_mu && !final_c && g > 0 && rel < stall_tol;
      stall_new = stalled_now ? stall + 1 : 0;
      stop = stop || stall_new >= ip.stall_iters;
    }

    // --- merge: the scenario takes the iteration ---
    for (int v = lane; v < m; v += TEAM) sc.y[v] = sc.x[v];
    k = k_new;
    k_max = k_max_n;
    b_sc = b_sc_n;
    c_sc = c_sc_n;
    kkt_err = kkt_err_new;
    centering = centering_new;
    by = by_new;
    cx = cx_new;
    d_inf = d_inf_new;
    done = stop;
    mir = mir && !stop;
    num_iter = g + 1;
    stall = stall_new;
    // one-iteration flag: set on the aborting iteration, cleared by the
    // next completed iteration
    aborted = ws_abort;
    if (lane == 0) {
      stats_k[g] = k;
      stats_d[g] = d_inf;
    }
    sc.sync();
  }

  if (ip.dual && !fail) {
    // Dual recovery (cone_program.cc:500-516): one extra assemble /
    // factor / solve and the first-order step w <- w + Q(w) (A y2).
    T unused0, unused1;
    sc.assemble(unused0, unused1);
    if (!sc.cholesky()) {
      for (int v = lane; v < m; v += TEAM)
        sc.rhs[v] = k * sc.b[v] * b_sc - sc.AW[v];
      sc.sync();
      sc.solve_kkt(ip.refine);
      for (int j = 0; j < nc; ++j) {
        T* wj = sc.w + j * n1;
        sc.minus_slack(j, sc.x, T(0));
        const T* msv = sc.ms;
        const T dot = sum_terms(T(0), 0, n1, [=](int r) { return wj[r] * msv[r]; });
        const T dw = det<T>(wj, n1);
        sc.sync();  // every lane has read w_j and ms
        for (int r = lane; r < n1; r += TEAM) {
          if (r == 0)
            wj[0] = wj[0] + (T(2) * dot * wj[0] + dw * -sc.ms[0]);
          else
            wj[r] = wj[r] + (T(2) * dot * wj[r] + dw * sc.ms[r]);
        }
        sc.sync();
      }
    }
  }

  if (SHARED) {
    for (int i = lane; i < cn; i += TEAM) a.w[s * cn + i] = sc.w[i];
    for (int v = lane; v < m; v += TEAM) a.y[s * m + v] = sc.y[v];
  }
  if (lane == 0) {
    a.k[s] = k;
    a.kmax[s] = k_max;
    a.bsc[s] = b_sc;
    a.csc[s] = c_sc;
    a.by[s] = by;
    a.cx[s] = cx;
    a.fail[s] = fail;
    a.mir[s] = mir;
    a.stall[s] = stall;
    a.niter[s] = num_iter;
    a.aborted[s] = aborted;
  }
}

template <typename T, int TEAM, bool SHARED>
int launch_one(const Args<T>& a, cudaStream_t stream) {
  auto kernel = socp_kernel<T, TEAM, SHARED>;
  const int shared_bytes = SHARED ? a.per_block * a.stride * int(sizeof(T)) : 0;
  if (SHARED) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = int((int64_t(a.S) + a.per_block - 1) / a.per_block);
  kernel<<<blocks, a.per_block * TEAM, shared_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TEAM>
int launch_team(const Args<T>& a, const Plan& p, cudaStream_t stream) {
  return p.shared ? launch_one<T, TEAM, true>(a, stream)
                  : launch_one<T, TEAM, false>(a, stream);
}

template <typename T>
int run(const T* A, const T* c, const T* b, const T* w0, const T* k0,
        const T* bsc0, const T* csc0, T* y, T* w, T* k, T* kmax, T* bsc,
        T* csc, T* by, T* cx, int* fail, int* mir, int* stall, int* niter,
        int* aborted, T* stats_k, T* stats_d, T* scratch, int S, int nc,
        int n1, int m, const int* plan, const int* iparams,
        const double* dparams, void* stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3]};
  if (p.per_block < 1 || p.per_block * p.team > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Args<T> a{A,   c,     b,    w0,    k0,      bsc0,    csc0,    y,
            w,   k,     kmax, bsc,   csc,     by,      cx,      fail,
            mir, stall, niter, aborted, stats_k, stats_d, scratch, S,
            nc,  n1,    m,    p.per_block, p.stride, {},      {}};
  a.ip = IParams{iparams[0], iparams[1], iparams[2], iparams[3], iparams[4],
                 iparams[5], iparams[6], iparams[7], iparams[8]};
  a.dp = DParams{dparams[0], dparams[1], dparams[2], dparams[3],
                 dparams[4], dparams[5], dparams[6], dparams[7]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.team) {
    case 8: return launch_team<T, 8>(a, p, st);
    case 32: return launch_team<T, 32>(a, p, st);
#ifdef CONEX_SOCP_ALL_TEAMS
    case 1: return launch_team<T, 1>(a, p, st);
    case 2: return launch_team<T, 2>(a, p, st);
    case 4: return launch_team<T, 4>(a, p, st);
    case 16: return launch_team<T, 16>(a, p, st);
#endif
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The build compiles this file once per working type, in parallel:
// CONEX_SOCP_PART 1 defines the float32 entry point only, 2 the float64 one
// only, and 0 (or none) both.
#ifndef CONEX_SOCP_PART
#define CONEX_SOCP_PART 0
#endif

extern "C" {

// Shapes, scenario-first and contiguous on the current device, as
// RawResult holds them: A (S, nc, n1, m); c, w0 and w (S, nc, n1); b and y
// (S, m); k0, bsc0, csc0 and the scalar outputs (S,); fail, mir, stall,
// niter, aborted int32 (S,); stats_k, stats_d (S, T); scratch (S, stride)
// on the global route, unused (may be null) on the shared route.
// plan (host, 4 ints): TEAM (8 or 32; any other raises
// cudaErrorInvalidValue unless built with CONEX_SOCP_ALL_TEAMS), scenarios
// per block, shared route (1) or global (0), the per-scenario stride in
// elements.  iparams (host, 9 ints):
// T, final_centering_steps, initial centering steps, refinement steps,
// warmstart, fixed_iterations, enable_rescaling, prepare_dual_variables,
// mu_stall_iterations.  dparams (host, 8 doubles): kkt_error_tolerance,
// inv_sqrt_mu_max, the k clamp floor, rank, divergence_upper_bound,
// final_centering_tolerance, warmstart_abort_threshold, mu_stall_tolerance.
// Returns the error of cudaFuncSetAttribute or cudaGetLastError().
#if CONEX_SOCP_PART != 2
int conex_socp_fused_f32(const float* A, const float* c, const float* b,
                         const float* w0, const float* k0, const float* bsc0,
                         const float* csc0, float* y, float* w, float* k,
                         float* kmax, float* bsc, float* csc, float* by,
                         float* cx, int* fail, int* mir, int* stall,
                         int* niter, int* aborted, float* stats_k,
                         float* stats_d, float* scratch, int S, int nc,
                         int n1, int m, const int* plan, const int* iparams,
                         const double* dparams, void* stream) {
  return run<float>(A, c, b, w0, k0, bsc0, csc0, y, w, k, kmax, bsc, csc, by,
                    cx, fail, mir, stall, niter, aborted, stats_k, stats_d,
                    scratch, S, nc, n1, m, plan, iparams, dparams, stream);
}
#endif

#if CONEX_SOCP_PART != 1
int conex_socp_fused_f64(const double* A, const double* c, const double* b,
                         const double* w0, const double* k0,
                         const double* bsc0, const double* csc0, double* y,
                         double* w, double* k, double* kmax, double* bsc,
                         double* csc, double* by, double* cx, int* fail,
                         int* mir, int* stall, int* niter, int* aborted,
                         double* stats_k, double* stats_d, double* scratch,
                         int S, int nc, int n1, int m, const int* plan,
                         const int* iparams, const double* dparams,
                         void* stream) {
  return run<double>(A, c, b, w0, k0, bsc0, csc0, y, w, k, kmax, bsc, csc, by,
                     cx, fail, mir, stall, niter, aborted, stats_k, stats_d,
                     scratch, S, nc, n1, m, plan, iparams, dparams, stream);
}
#endif

}  // extern "C"
