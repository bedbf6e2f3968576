// Tensor-core and cp.async helpers shared by the port's kernels
// (csrc/schur.cu, csrc/schur_probes.cu), for Hopper (sm_90a).
//
// Included once per compilation unit, inside its anonymous namespace,
// after <cuda_runtime.h> and <cstdint>.

#pragma once

// ---- cp.async -------------------------------------------------------------

// Copy VW elements global -> shared (16 bytes aligned when VW > 1), or
// write zeros when !in.
template <int VW, typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool in) {
  constexpr int kBytes = VW * int(sizeof(T));
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(in ? kBytes : 0));
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- tensor-core fragments ------------------------------------------------

// tf32(x) rounded to nearest, ties away from zero, on the 13 dropped bits.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f64(double* c, double a, double b) {
  asm(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// One warp's M x N x K product step.  load_a(a, lane, f) fills the A
// fragment from f(row, k), load_b(b, lane, f) the B fragment from f(k, col),
// store(c, lane, f) hands each accumulator to f(row, col, value); the
// (row, col) of each register are those of the PTX ISA's fragment layouts.
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int M = 16, N = 8, K = 8;
  static constexpr int KS = 32;  // panel slab depth
  // The tensor cores add into an f32 accumulator rounding toward zero, so
  // a long sum drifts; the Gram sums each unit apart and adds the units
  // on CUDA cores, rounded to nearest.
  static constexpr bool kUnitSums = true;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  struct C { float c[4]; };
  __device__ static void zero(C& c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) c.c[r] = 0.0f;
  }
  __device__ static void add(C& c, const C& x) {
#pragma unroll
    for (int r = 0; r < 4; ++r) c.c[r] += x.c[r];
  }
  template <class F>
  __device__ static void load_a(A& a, int lane, F f) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split(f(g + 8 * (r & 1), t + 4 * (r >> 1)), a.hi[r], a.lo[r]);
  }
  template <class F>
  __device__ static void load_b(B& b, int lane, F f) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) split(f(t + 4 * r, g), b.hi[r], b.lo[r]);
  }
  // Pass 0, 1, 2 adds lo*hi, hi*lo, hi*hi: the small terms first.  The
  // kernels run each pass over all their fragments before the next, so
  // that no product waits on the one before it.
  static constexpr int kPasses = 3;
  __device__ static void mma(int pass, C& c, const A& a, const B& b) {
    if (pass == 0) {
      mma_tf32(c.c, a.lo, b.hi);
    } else if (pass == 1) {
      mma_tf32(c.c, a.hi, b.lo);
    } else {
      mma_tf32(c.c, a.hi, b.hi);
    }
  }
  template <class F>
  __device__ static void store(const C& c, int lane, F f) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 4; ++r) f(g + 8 * (r >> 1), 2 * t + (r & 1), c.c[r]);
  }
  // f(row, col, x at col, x at col + 1), col even.
  template <class F>
  __device__ static void store_pairs(const C& c, int lane, F f) {
    const int g = lane >> 2, t = lane & 3;
    f(g, 2 * t, c.c[0], c.c[1]);
    f(g + 8, 2 * t, c.c[2], c.c[3]);
  }
};

template <>
struct Mma<double> {
  static constexpr int M = 8, N = 8, K = 4;
  static constexpr int KS = 16;
  static constexpr bool kUnitSums = false;  // DMMA rounds to nearest
  struct A { double x; };
  struct B { double x; };
  struct C { double c[2]; };
  __device__ static void zero(C& c) { c.c[0] = c.c[1] = 0.0; }
  __device__ static void add(C& c, const C& x) {
    c.c[0] += x.c[0];
    c.c[1] += x.c[1];
  }
  template <class F>
  __device__ static void load_a(A& a, int lane, F f) {
    a.x = f(lane >> 2, lane & 3);
  }
  template <class F>
  __device__ static void load_b(B& b, int lane, F f) {
    b.x = f(lane & 3, lane >> 2);
  }
  static constexpr int kPasses = 1;
  __device__ static void mma(int, C& c, const A& a, const B& b) {
    mma_f64(c.c, a.x, b.x);
  }
  template <class F>
  __device__ static void store(const C& c, int lane, F f) {
    const int g = lane >> 2, t = lane & 3;
    f(g, 2 * t, c.c[0]);
    f(g, 2 * t + 1, c.c[1]);
  }
  template <class F>
  __device__ static void store_pairs(const C& c, int lane, F f) {
    f(lane >> 2, 2 * (lane & 3), c.c[0], c.c[1]);
  }
};

// a if kFirst, else b.
template <bool kFirst, class X>
__device__ __forceinline__ X& pick(X& a, X& b) {
  if constexpr (kFirst) {
    return a;
  } else {
    return b;
  }
}
