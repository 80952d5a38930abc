// Deterministic seam sums for Hopper (sm_90a): the sum, per node, of the
// rows of a fused sweep's output tiles that hold a part of that node.
//
// A fused sweep writes the integrals of each node's test functions over
// one tile (a cell row of a patch, or of one x brick of it) at a time; a
// node on a row, brick or patch seam appears in several tiles.  This
// kernel adds those parts: for node n, the rows src[sources[k]] for k =
// offsets[n] .. offsets[n+1]-1, in that order (the table lists each
// node's positions in ascending order), so two launches give the same
// bits and the plain version in utils/segment.py seam_sum_plain gives the
// same sums.  A row is the C floats of one node: C = 4 (3D, read as one
// 16-byte word) or C = 3 (2D).
//
// It replaces the class-grouped gathers and sums (utils/segment.py
// class_sum) that followed the TPU kernels
// ns_gls_tpu/ops/patch3d.py:_make_patch3d_kernel and
// ns_gls_tpu/ops/patch2d.py:_make_patch2d_kernel as their seam compress.
// Bound: bytes, the tiles read once (4*C bytes per row), the table (4
// bytes per row and per node) and the node-major output (4*C bytes per
// node): at the finest input/sphere_amg.json level (332,928 rows, 202,818
// nodes, C = 4) 10.7 MB -> 3.2 us at 3.35 TB/s.  Design: one thread per
// node, a loop over its sources; the gathers are scattered by nature, and
// at most a few hundred thousand nodes keep the launch short.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int C>
__global__ void __launch_bounds__(kThreads)
seam_sum_kernel(const float* __restrict__ src,
                const int* __restrict__ offsets,
                const int* __restrict__ sources, float* __restrict__ out,
                int n_out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_out) return;
  const int k1 = __ldg(offsets + n + 1);
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int k = __ldg(offsets + n); k < k1; ++k) {
    const size_t r = (size_t)__ldg(sources + k) * C;
    if constexpr (C == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + r));
      acc[0] += v.x;
      acc[1] += v.y;
      acc[2] += v.z;
      acc[3] += v.w;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += __ldg(src + r + c);
    }
  }
  if constexpr (C == 4) {
    reinterpret_cast<float4*>(out)[n] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) out[(size_t)n * C + c] = acc[c];
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes) -------------
// src (n_rows, C), offsets (n_out + 1), sources (offsets[n_out]) int32,
// out (n_out, C), C = 3 or 4; with C = 4 src and out 16-byte aligned.
// Returns 0 or a CUDA error code (1, cudaErrorInvalidValue, for another C,
// a misaligned or a negative input).
extern "C" int seam_sum_launch(const float* src, const int* offsets,
                               const int* sources, float* out, int n_out,
                               int C, void* stream) {
  if (n_out < 0 || (C != 3 && C != 4)) return (int)cudaErrorInvalidValue;
  if (C == 4 && ((reinterpret_cast<size_t>(src) & 15) ||
                 (reinterpret_cast<size_t>(out) & 15)))
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  const int blocks = (n_out + kThreads - 1) / kThreads;
  if (C == 4) {
    seam_sum_kernel<4><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        src, offsets, sources, out, n_out);
  } else {
    seam_sum_kernel<3><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        src, offsets, sources, out, n_out);
  }
  return (int)cudaGetLastError();
}
