// The whole geodesic interior-point solve of a batch of small SOCPs, one
// scenario per thread, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conex_tpu/parallel/fused_socp.py:234 (the
// inner `kernel` of `_make_kernel`, launched by `_solve_padded` and
// `solve_socp_fused`).  Each scenario s is
//
//   max b_s'y  s.t.  c_sj - A_sj y in Q^{n+1},  j = 0..nc-1,
//
// and one thread runs its whole solve: per Newton iteration the Schur
// assembly through Q(w^1/2), the m x m Cholesky with its fail flag, the
// triangular solves and refinement, the divergence mu update, the Newton
// solve and the spectral-exp geodesic step, the warmstart abort, the
// statistics and the stall detector, and the masked merge into the
// scenario's state; after the loop the dual recovery.  The arithmetic and
// the order of each expression follow the JAX kernel; sums are taken left
// to right.  A thread whose scenario is done leaves its loop: the
// JAX loop's block-wide condition only keeps finished lanes frozen, so
// every scenario's result is the same.
//
// Layout.  The wrapper (conex_tpu_torch/parallel/fused_socp.py) permutes
// every input to a scenario-last layout, A (nc, n+1, m, S), c and w
// (nc, n+1, S), b and y (m, S), stats (T, S), so the 32 threads of a warp
// read 32 neighbouring addresses.  Per-scenario working arrays (w^1/2, the
// panel WA = Q(w^1/2) A, G, its Cholesky factor L, the right-hand sides)
// live in one scratch buffer the wrapper allocates, in the same layout:
// there is no cap on m or n, and no per-thread local memory.
//
// What bounds it.  At the benchmark shape (nc = 1, n = 20, m = 10, f32)
// a scenario makes about 6,900 loads and stores of A and its scratch per
// iteration (27.6 KB), a third of them the Gram sum over the panel WA,
// against a few thousand floating-point operations: far below the card's
// balance of operations to bytes.  Below about 10,000 scenarios there are
// too few threads to hide the latency of that chain of accesses (one block
// of 128 threads per SM at most), and the time does not grow with S; on an
// H100 a 30-iteration solve takes about 4.5 ms at S = 1,000 and at
// S = 10,000, and 21 ms at S = 100,000, where the traffic (about 4 TB/s)
// is served partly by L1 and L2 and partly by device memory.  The design
// keeps every access coalesced and reads A in place; accumulating G from
// one row of WA at a time in registers, and a warp per scenario at small
// S, are later work.
//
// Determinism: each value is computed by one thread in a fixed order; no
// atomics.  Built without --use_fast_math (sqrt, exp and division are IEEE)
// and with -fmad=false: every product and sum is rounded on its own, in the
// order of the plain version (parallel/fused_socp.py::solve_socp_plain),
// and in float64 the two give the same bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

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

template <typename T>
struct Args {
  const T *A, *c, *b, *w0, *k0, *bsc0, *csc0;
  T *y, *w, *k, *kmax, *bsc, *csc, *by, *cx;
  int *fail, *mir, *stall, *niter, *aborted;
  T *stats_k, *stats_d, *scratch;
  int S, nc, n1, m;
  IParams ip;
  DParams dp;
};

// One scenario's view of a scenario-last array: element j is p[j * S].
template <typename P>
struct Lane {
  P* p;
  int64_t st;
  __device__ P& operator[](int64_t j) const { return p[j * st]; }
  __device__ Lane at(int64_t j) const { return Lane{p + j * st, st}; }
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

template <typename T, typename X>
__device__ T tail_sq(X x, int n1) {
  T ss = T(0);
  for (int r = 1; r < n1; ++r) ss += x[r] * x[r];
  return ss;
}

// out = fn(lam1) P1 + fn(lam2) P2 (spin.py::_spectral_apply); out may be x.
template <typename T, typename X, typename Fn>
__device__ void spectral(X x, Lane<T> out, int n1, Fn fn) {
  const T h = x[0];
  const T nq = xsqrt(tail_sq<T>(x, n1));
  const T f1 = fn(h + nq), f2 = fn(h - nq);
  const T hd = T(0.5) * (f1 - f2);
  out[0] = T(0.5) * (f1 + f2);
  for (int r = 1; r < n1; ++r) {
    const T qhat = nq > T(0) ? x[r] / (nq == T(0) ? T(1) : nq) : T(0);
    out[r] = hd * qhat;
  }
}

template <typename T, typename X>
__device__ T det(X x, int n1) {
  return x[0] * x[0] - tail_sq<T>(x, n1);
}

// out = Q(x) y = 2 <x,y> x - det(x) R y; out must not alias x or y.
template <typename T, typename X, typename Y>
__device__ void qrep(X x, Y y, Lane<T> out, int n1) {
  T dot = T(0);
  for (int r = 0; r < n1; ++r) dot += x[r] * y[r];
  const T dx = det<T>(x, n1);
  out[0] = T(2) * dot * x[0] + dx * -y[0];
  for (int r = 1; r < n1; ++r) out[r] = T(2) * dot * x[r] + dx * y[r];
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

template <typename T>
struct Scenario {
  int nc, n1, m;
  Lane<const T> A, c, b;
  Lane<T> w, y;
  // scratch
  Lane<T> wsqrt, WA, WC, d, ms, G, L, AW, AQc, rhs, x, tmp;

  __device__ Lane<const T> Acol(int j, int v) const {  // A[j, :, v]
    return Lane<const T>{A.p + (int64_t(j) * n1 * m + v) * A.st, A.st * m};
  }
  __device__ Lane<T> WAcol(int j, int v) const {
    return Lane<T>{WA.p + (int64_t(j) * n1 * m + v) * WA.st, WA.st * m};
  }
  __device__ Lane<const T> ccone(int j) const { return c.at(int64_t(j) * n1); }
  __device__ Lane<T> cone(Lane<T> v, int j) const { return v.at(int64_t(j) * n1); }

  // Schur-complement contributions summed over the cones
  // (soc_constraint.cc:272-303): w^1/2, WA, WsqrtC, G, AW, AQc.
  __device__ void assemble(T& w_dot_c, T& c_dot_Qc) {
    T wdc = T(0), cdq = T(0);
    for (int v = 0; v < m; ++v) AW[v] = T(0);
    for (int j = 0; j < nc; ++j) {
      const Lane<T> ws = cone(wsqrt, j), wj = cone(w, j), wc = cone(WC, j);
      spectral<T>(wj, ws, n1, [](T t) { return xsqrt(t); });
      const T dws = det<T>(ws, n1);
      qrep<T>(ws, ccone(j), wc, n1);
      wdc += wc[0];
      for (int r = 0; r < n1; ++r) cdq += wc[r] * wc[r];
      for (int v = 0; v < m; ++v) {
        const Lane<const T> a = Acol(j, v);
        const Lane<T> wa = WAcol(j, v);
        T dot = T(0), aw = T(0);
        for (int r = 0; r < n1; ++r) {
          dot += ws[r] * a[r];
          aw += a[r] * wj[r];
        }
        AW[v] += aw;
        wa[0] = T(2) * dot * ws[0] + dws * -a[0];
        for (int r = 1; r < n1; ++r) wa[r] = T(2) * dot * ws[r] + dws * a[r];
      }
    }
    for (int v = 0; v < m; ++v) {
      AW[v] = T(2) * AW[v];
      for (int u = 0; u <= v; ++u) {
        T g = T(0);
        for (int j = 0; j < nc; ++j) {
          const Lane<T> pv = WAcol(j, v), pu = WAcol(j, u);
          for (int r = 0; r < n1; ++r) g += pv[r] * pu[r];
        }
        G[int64_t(v) * m + u] = T(2) * g;
        G[int64_t(u) * m + v] = T(2) * g;
      }
      T q = T(0);
      for (int j = 0; j < nc; ++j) {
        const Lane<T> pv = WAcol(j, v), wc = cone(WC, j);
        for (int r = 0; r < n1; ++r) q += pv[r] * wc[r];
      }
      AQc[v] = T(2) * q;
    }
    w_dot_c = T(2) * wdc;
    c_dot_Qc = T(2) * cdq;
  }

  // L L^T = G, column by column (fused_socp.py::_chol): a pivot that is not
  // > 0 or not finite fails, and the column goes on with a pivot of 1.
  __device__ bool cholesky() {
    bool fail = false;
    for (int j = 0; j < m; ++j) {
      T d = T(1);
      for (int i = j; i < m; ++i) {
        T acc = T(0);
        for (int t = 0; t < j; ++t) acc += L[int64_t(i) * m + t] * L[int64_t(j) * m + t];
        const T col = G[int64_t(i) * m + j] - acc;
        if (i == j) {
          fail = fail || !(col > T(0)) || !finite(col);
          d = xsqrt(col > T(0) ? col : T(1));
          L[int64_t(j) * m + j] = d;
        } else {
          L[int64_t(i) * m + j] = col / d;
        }
      }
    }
    return fail;
  }

  // v <- (L L^T)^{-1} v in place (fused_socp.py::_chol_solve).
  __device__ void chol_solve(Lane<T> v) {
    for (int j = 0; j < m; ++j) {
      T s = v[j];
      for (int t = 0; t < j; ++t) s = s - L[int64_t(j) * m + t] * v[t];
      v[j] = s / L[int64_t(j) * m + j];
    }
    for (int j = m - 1; j >= 0; --j) {
      T s = v[j];
      for (int t = j + 1; t < m; ++t) s = s - L[int64_t(t) * m + j] * v[t];
      v[j] = s / L[int64_t(j) * m + j];
    }
  }

  // x <- G^{-1} rhs with `refine` steps of iterative refinement.
  __device__ void solve_kkt(int refine) {
    for (int v = 0; v < m; ++v) x[v] = rhs[v];
    chol_solve(x);
    for (int it = 0; it < refine; ++it) {
      for (int i = 0; i < m; ++i) {
        T gx = T(0);
        for (int u = 0; u < m; ++u) gx += G[int64_t(i) * m + u] * x[u];
        tmp[i] = rhs[i] - gx;
      }
      chol_solve(tmp);
      for (int v = 0; v < m; ++v) x[v] = x[v] + tmp[v];
    }
  }

  // ms <- A_j y - cw c_j (soc_constraint.cc:193-197).
  __device__ void minus_slack(int j, Lane<T> yv, T cw) {
    const Lane<const T> cj = ccone(j);
    for (int r = 0; r < n1; ++r) {
      const Lane<const T> arow = A.at((int64_t(j) * n1 + r) * m);
      T ay = T(0);
      for (int v = 0; v < m; ++v) ay += arow[v] * yv[v];
      ms[r] = ay - cw * cj[r];
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) socp_kernel(const Args<T> a) {
  const int64_t s = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= a.S) return;
  const int64_t S = a.S;
  const int nc = a.nc, n1 = a.n1, m = a.m;
  const IParams ip = a.ip;
  const int Tn = ip.T;

  Scenario<T> sc;
  sc.nc = nc;
  sc.n1 = n1;
  sc.m = m;
  sc.A = Lane<const T>{a.A + s, S};
  sc.c = Lane<const T>{a.c + s, S};
  sc.b = Lane<const T>{a.b + s, S};
  sc.w = Lane<T>{a.w + s, S};
  sc.y = Lane<T>{a.y + s, S};
  int64_t off = 0;
  auto carve = [&](int64_t n) {
    Lane<T> v{a.scratch + off * S + s, S};
    off += n;
    return v;
  };
  const int64_t cn = int64_t(nc) * n1;
  sc.wsqrt = carve(cn);
  sc.WA = carve(cn * m);
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
  const Lane<T> stats_k{a.stats_k + s, S}, stats_d{a.stats_d + s, S};

  // Parameters in the working type (as the JAX kernel's weakly typed
  // Python scalars are).
  const T kkt_tol = T(a.dp.kkt_tol), k_min_clamp = T(a.dp.k_min_clamp);
  const T rank = T(a.dp.rank), fc_tol = T(a.dp.fc_tol);
  const T budget = T(a.dp.div_ub * a.dp.rank), rank07 = T(a.dp.rank * 0.7);
  const T ws_abort_thr = T(a.dp.ws_abort_thr), stall_tol = T(a.dp.stall_tol);
  const bool warmstart = ip.warmstart != 0, fixed = ip.fixed != 0;
  const bool stall_on = ip.stall_iters > 0 && !fixed;

  auto set_identity = [&](int j) {
    const Lane<T> wj = sc.cone(sc.w, j);
    wj[0] = T(1);
    for (int r = 1; r < n1; ++r) wj[r] = T(0);
  };

  for (int64_t i = 0; i < cn; ++i) sc.w[i] = a.w0[i * S + s];
  for (int v = 0; v < m; ++v) sc.y[v] = T(0);
  for (int g = 0; g < Tn; ++g) {
    stats_k[g] = T(0);
    stats_d[g] = T(0);
  }
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
        T bb = T(0), qq = T(0);
        for (int v = 0; v < m; ++v) {
          bb += sc.b[v] * sc.b[v];
          qq += sc.AQc[v] * sc.AQc[v];
        }
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
        for (int j = 0; j < nc; ++j) set_identity(j);
        aborted = true;
        continue;
      }
      done = true;
      fail = true;
      aborted = false;
      break;
    }

    // --- mu update (divergence mode, cone_program.cc:374-398) ---
    for (int v = 0; v < m; ++v)
      sc.rhs[v] = sc.AQc[v] * c_sc_n - sc.b[v] * b_sc_n;
    sc.solve_kkt(ip.refine);
    T lam_min = T(0), lam_max = T(0), frob = T(0), trace = T(0);
    for (int j = 0; j < nc; ++j) {
      sc.minus_slack(j, sc.x, c_sc_n);
      const Lane<T> ws = sc.cone(sc.wsqrt, j);
      T dot = T(0);
      for (int r = 0; r < n1; ++r) dot += ws[r] * sc.ms[r];
      const T dws = det<T>(ws, n1);
      const T h = T(2) * dot * ws[0] + dws * -sc.ms[0];
      T tt = T(0);
      for (int r = 1; r < n1; ++r) {
        const T e = T(2) * dot * ws[r] + dws * sc.ms[r];
        tt += e * e;
      }
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
    for (int v = 0; v < m; ++v)
      sc.rhs[v] = k_new * (sc.b[v] * b_sc_n + sc.AQc[v] * c_sc_n) -
                  T(2) * sc.AW[v];
    sc.solve_kkt(ip.refine);
    const T c_weight = k_new * c_sc_n;
    T norminf = T(0), normsq = T(0);
    for (int j = 0; j < nc; ++j) {
      const Lane<T> dj = sc.cone(sc.d, j);
      sc.minus_slack(j, sc.x, c_weight);
      qrep<T>(sc.cone(sc.wsqrt, j), sc.ms, dj, n1);
      dj[0] = dj[0] + T(1);  // d += e
      T sq = T(0);
      for (int r = 0; r < n1; ++r) sq += dj[r] * dj[r];
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
        set_identity(j);
        continue;
      }
      const Lane<T> dj = sc.cone(sc.d, j);
      for (int r = 0; r < n1; ++r) sc.ms[r] = step * dj[r];
      spectral<T>(sc.ms, sc.ms, n1, [](T t) { return xexp(t); });
      qrep<T>(sc.cone(sc.wsqrt, j), sc.ms, sc.cone(sc.w, j), n1);
    }

    // --- statistics (cone_program.cc:439-471) ---
    const T d_2sq = xabs(normsq);
    const T d_inf_new = xabs(norminf);
    T bx = T(0), qx = T(0);
    for (int v = 0; v < m; ++v) {
      bx += sc.b[v] * sc.x[v];
      qx += sc.AQc[v] * sc.x[v];
    }
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
    for (int v = 0; v < m; ++v) sc.y[v] = sc.x[v];
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
    stats_k[g] = k;
    stats_d[g] = d_inf;
  }

  if (ip.dual && !fail) {
    // Dual recovery (cone_program.cc:500-516): one extra assemble /
    // factor / solve and the first-order step w <- w + Q(w) (A y2).
    T unused0, unused1;
    sc.assemble(unused0, unused1);
    if (!sc.cholesky()) {
      for (int v = 0; v < m; ++v)
        sc.rhs[v] = k * sc.b[v] * b_sc - sc.AW[v];
      sc.solve_kkt(ip.refine);
      for (int j = 0; j < nc; ++j) {
        const Lane<T> wj = sc.cone(sc.w, j);
        sc.minus_slack(j, sc.x, T(0));
        T dot = T(0);
        for (int r = 0; r < n1; ++r) dot += wj[r] * sc.ms[r];
        const T dw = det<T>(wj, n1);
        wj[0] = wj[0] + (T(2) * dot * wj[0] + dw * -sc.ms[0]);
        for (int r = 1; r < n1; ++r)
          wj[r] = wj[r] + (T(2) * dot * wj[r] + dw * sc.ms[r]);
      }
    }
  }

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

template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  const int blocks = (a.S + kThreads - 1) / kThreads;
  socp_kernel<T><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const T* A, const T* c, const T* b, const T* w0, const T* k0,
        const T* bsc0, const T* csc0, T* y, T* w, T* k, T* kmax, T* bsc,
        T* csc, T* by, T* cx, int* fail, int* mir, int* stall, int* niter,
        int* aborted, T* stats_k, T* stats_d, T* scratch, int S, int nc,
        int n1, int m, const int* iparams, const double* dparams,
        void* stream) {
  Args<T> a{A,   c,     b,    w0,    k0,      bsc0,    csc0,    y,
            w,   k,     kmax, bsc,   csc,     by,      cx,      fail,
            mir, stall, niter, aborted, stats_k, stats_d, scratch, S,
            nc,  n1,    m,    {},    {}};
  a.ip = IParams{iparams[0], iparams[1], iparams[2], iparams[3], iparams[4],
                 iparams[5], iparams[6], iparams[7], iparams[8]};
  a.dp = DParams{dparams[0], dparams[1], dparams[2], dparams[3],
                 dparams[4], dparams[5], dparams[6], dparams[7]};
  return launch<T>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Shapes, all scenario-last and contiguous on the current device:
// A (nc, n1, m, S); c, w0 and w (nc, n1, S); b and y (m, S); k0, bsc0,
// csc0 and the scalar outputs (S,); fail, mir, stall, niter, aborted int32
// (S,); stats_k, stats_d (T, S); scratch (nc*n1*(3+m) + n1 + 2m^2 + 5m, S).
// iparams (host, 9 ints): T, final_centering_steps, initial centering
// steps, refinement steps, warmstart, fixed_iterations, enable_rescaling,
// prepare_dual_variables, mu_stall_iterations.  dparams (host, 8 doubles):
// kkt_error_tolerance, inv_sqrt_mu_max, the k clamp floor, rank,
// divergence_upper_bound, final_centering_tolerance,
// warmstart_abort_threshold, mu_stall_tolerance.  Returns
// cudaGetLastError().
int conex_socp_fused_f32(const float* A, const float* c, const float* b,
                         const float* w0, const float* k0, const float* bsc0,
                         const float* csc0, float* y, float* w, float* k,
                         float* kmax, float* bsc, float* csc, float* by,
                         float* cx, int* fail, int* mir, int* stall,
                         int* niter, int* aborted, float* stats_k,
                         float* stats_d, float* scratch, int S, int nc,
                         int n1, int m, const int* iparams,
                         const double* dparams, void* stream) {
  return run<float>(A, c, b, w0, k0, bsc0, csc0, y, w, k, kmax, bsc, csc, by,
                    cx, fail, mir, stall, niter, aborted, stats_k, stats_d,
                    scratch, S, nc, n1, m, iparams, dparams, stream);
}

int conex_socp_fused_f64(const double* A, const double* c, const double* b,
                         const double* w0, const double* k0,
                         const double* bsc0, const double* csc0, double* y,
                         double* w, double* k, double* kmax, double* bsc,
                         double* csc, double* by, double* cx, int* fail,
                         int* mir, int* stall, int* niter, int* aborted,
                         double* stats_k, double* stats_d, double* scratch,
                         int S, int nc, int n1, int m, const int* iparams,
                         const double* dparams, void* stream) {
  return run<double>(A, c, b, w0, k0, bsc0, csc0, y, w, k, kmax, bsc, csc, by,
                     cx, fail, mir, stall, niter, aborted, stats_k, stats_d,
                     scratch, S, nc, n1, m, iparams, dparams, stream);
}

}  // extern "C"
