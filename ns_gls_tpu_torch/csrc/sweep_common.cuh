// Helpers shared by the fused sweeps that walk slabs (prism.cu,
// structured.cu, patch3d.cu): cp.async copies from device to shared
// memory, block-strided loops whose items advance as mixed-radix digits,
// and rows of the 1D tables held in registers.
#pragma once

// The degrees a library of the fused sweeps holds an instance of: 1-6 in
// the library every run builds, or the one degree NS_KERNEL_DEGREE in a
// library built for it alone (utils/cuda_build.py, at the first table
// build of a degree above 6).  X(P) expands once per degree.
#ifdef NS_KERNEL_DEGREE
#define NS_FOR_DEGREES(X) X(NS_KERNEL_DEGREE)
#else
#define NS_FOR_DEGREES(X) X(1) X(2) X(3) X(4) X(5) X(6)
#endif

#ifndef SWEEP_HOST_REHEARSAL
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
// 16 bytes; both addresses 16-byte aligned (cached in L2 only)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#endif

namespace {

// Blocks per SM the fused sweeps' launch bounds ask for: two up to degree
// 4 (at most 128 registers a thread), one above, where the 1D tables
// alone take 2 (P+1)^2 registers a thread.
template <int P>
constexpr int kMinBlocks = P <= 4 ? 2 : 1;

// The items of a block-strided loop (item = threadIdx.x, then + blockDim.x;
// or from v in steps of st) as digits of a mixed radix, digit 0 fastest,
// advanced without a division per item (the divisions of a runtime radix
// cost more than a light item's work).  The last digit is not reduced: the
// loop ends when it reaches its radix.
template <int N>
struct StridedDigits {
  int d[N], s[N], r[N];
  __device__ explicit StridedDigits(const int (&radix)[N])
      : StridedDigits(radix, threadIdx.x, blockDim.x) {}
  __device__ StridedDigits(const int (&radix)[N], int v, int st) {
#pragma unroll
    for (int k = 0; k < N - 1; ++k) {
      r[k] = radix[k];
      d[k] = v % r[k];
      v /= r[k];
      s[k] = st % r[k];
      st /= r[k];
    }
    r[N - 1] = radix[N - 1];
    d[N - 1] = v;
    s[N - 1] = st;
  }
  __device__ bool valid() const { return d[N - 1] < r[N - 1]; }
  __device__ void next() {
    int c = 0;
#pragma unroll
    for (int k = 0; k < N - 1; ++k) {
      d[k] += s[k] + c;
      c = d[k] >= r[k];
      if (c) d[k] -= r[k];
    }
    d[N - 1] += s[N - 1] + c;
  }
};

// row q of a 1D table held in registers, q not a compile-time index
template <int NQ, int N1>
__device__ __forceinline__ void table_row(const float (&t)[NQ][N1], int q,
                                          float (&row)[N1]) {
#pragma unroll
  for (int j = 0; j < N1; ++j) {
    float v = t[0][j];
#pragma unroll
    for (int a = 1; a < NQ; ++a) v = q == a ? t[a][j] : v;
    row[j] = v;
  }
}

}  // namespace
