// Deterministic seam sums for Hopper (sm_90a): the sum, per node, of the
// rows of a fused sweep's output tiles that hold a part of that node.
//
// A fused sweep writes the integrals of each node's test functions over
// one tile (a cell row of a patch) at a time; a node on a row or patch
// seam appears in several tiles.  This kernel adds those parts: for node
// n, the rows src[sources[k]] for k = offsets[n] .. offsets[n+1]-1, in
// that order (the table lists each node's positions in ascending order),
// so two launches give the same bits and the plain version in
// utils/segment.py seam_sum_plain gives the same sums.  A row is four
// floats (the components of one node), read as one 16-byte word.
//
// It replaces, on the patch-3D path, the class-grouped gathers and sums
// (utils/segment.py class_sum) that followed the TPU kernel
// ns_gls_tpu/ops/patch3d.py:_make_patch3d_kernel as its seam compress.
// Bound: bytes, the tiles read once (16 bytes per row), the table (4 bytes
// per row and per node) and the node-major output (16 bytes per node):
// at the finest input/sphere_amg.json level (332,928 rows, 202,818 nodes)
// 10.7 MB -> 3.2 us at 3.35 TB/s.  Design: one thread per node, a loop
// over its sources; the gathers are scattered by nature, and at most a few
// hundred thousand nodes keep the launch short.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
seam_sum_kernel(const float4* __restrict__ src,
                const int* __restrict__ offsets,
                const int* __restrict__ sources, float4* __restrict__ out,
                int n_out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_out) return;
  const int k1 = __ldg(offsets + n + 1);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = __ldg(offsets + n); k < k1; ++k) {
    const float4 v = __ldg(src + __ldg(sources + k));
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[n] = acc;
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes) -------------
// src (n_rows, 4), offsets (n_out + 1), sources (offsets[n_out]) int32,
// out (n_out, 4); src and out 16-byte aligned.  Returns 0 or a CUDA error
// code (1, cudaErrorInvalidValue, for a misaligned or negative input).
extern "C" int seam_sum_launch(const float* src, const int* offsets,
                               const int* sources, float* out, int n_out,
                               void* stream) {
  if (n_out < 0 || (reinterpret_cast<size_t>(src) & 15) ||
      (reinterpret_cast<size_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  seam_sum_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0,
                    (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(src), offsets, sources,
      reinterpret_cast<float4*>(out), n_out);
  return (int)cudaGetLastError();
}
