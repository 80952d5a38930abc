// Fused patch-2D GLS sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel ns_gls_tpu/ops/patch2d.py:_make_patch2d_kernel
// (the Pallas body of Patch2DSweep).  It computes the same function:
// for every patch (an m x m lattice of curved quad cells with
// (P*m+1)^2 nodes) evaluate u, u_lin and vec_old at all Gauss points
// (values and reference gradients from the 1D Lagrange tables), map the
// gradients with the per-cell, per-q inverse Jacobian, compute
// delta_1/delta_2 (cell-wise or per q), apply the GLS q-point physics of
// gls_qpoint.cuh (fixed / increment / residual flavor) and integrate the
// test-function weights back onto the patch's node tile.  Neighbouring
// patches share seam nodes; the caller sums the tiles (seam compress).
//
// Layout (per patch; the TPU's G x H patch groups, banded MXU matmuls,
// (8,128) padding and bf16 pass splitting are not carried over):
//   u     (3, n_p, Xn, Xn)      node tiles, [y][x]
//   ul    (3 or 2, n_p, Xn, Xn)  linearization point (3 in increment)
//   vo    (2, n_p, Xn, Xn)      BDF history sum
//   jinv  (n_p, 4, Lq, Lq)      entry r*2+x = dxi_r/dx_x at q (iy, ix)
//   jxw   (n_p, Lq, Lq)         |det J| * weight
//   h     (n_p, 2, m, m)        per cell: h_min_vertex, measure-based h
//   out   (3, n_p, Xn, Xn)
// with Xn = P*m + 1, Lq = NQ*m, q-point row iy = ey*NQ + qy and column
// ix = ex*NQ + qx.
//
// What bounds the function on an H100, at the Turek 2D ref-3 shapes
// (P = 2, NQ = 3, m = 8: 289 nodes and 576 q-points per patch, 88
// patches, 22,992 nodes), increment flavor with the history term
// (chip_smoke.py patch2d_cost):
//   bytes: per patch u 3468 + u_lin 3468 + vec_old 2312 + jinv 9216
//          + jxw 2304 + h 512 = 21.3 KB, x 88, plus the seam-compressed
//          output 3 x 22,992 floats: 2.15 MB -> 0.64 us at 3.35 TB/s
//   flops: a sum-factorized evaluation and integration plus the q-point
//          geometry, delta and physics: 21 MFLOP -> 0.31 us at
//          67 TFLOP/s (f32); this design's loops do about 39 MFLOP
// so the work itself is well under a microsecond: the call is bound by
// latency (one launch, a few dependent phases per block), not by bytes
// or flops.  The design keeps it to one launch and keeps every
// intermediate on chip: one thread block per patch stages the node
// tiles in shared memory, one thread per q-point evaluates from its
// cell's (P+1)^2 nodes, runs the physics in registers and writes its
// nine test-function weights to shared memory, and one thread per node
// integrates from the (at most four) cells around it.  Device memory
// sees each input once and each output once.  The grid is small:
// Turek 2D has 88 patches at every refinement, so one block per patch
// fills 88 of the 132 SMs; splitting a patch over several blocks (or
// batching levels) is later work.
#include <cuda_runtime.h>

#include "gls_qpoint.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
patch2d_kernel(const float* __restrict__ u, const float* __restrict__ ul,
               const float* __restrict__ vo, const float* __restrict__ jinv,
               const float* __restrict__ jxw, const float* __restrict__ hcell,
               const float* __restrict__ S1g, const float* __restrict__ D1g,
               float* __restrict__ out, int n_p, int P, int NQ, int m,
               int flavor, int consider_dt, int cell_wise, GlsScalars sc) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const int n1 = P + 1;
  const int Xn = P * m + 1;
  const int NN = Xn * Xn;
  const int Lq = NQ * m;
  const int NQQ = Lq * Lq;
  const bool incr = flavor == GLS_INCREMENT;
  const int lead_ul = incr ? 3 : 2;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);

  float* sS1 = smem;                 // (NQ, P+1)
  float* sD1 = sS1 + NQ * n1;        // (NQ, P+1)
  float* su = sD1 + NQ * n1;         // (3, NN)
  float* sul = su + 3 * NN;          // (3, NN)
  float* svo = sul + 3 * NN;         // (2, NN)
  float* susq = svo + 2 * NN;        // (NQQ) |u*|^2 per q-point
  float* sw = susq + NQQ;            // (9, NQQ) test-function weights

  // ---- phase 0: stage tables and this patch's node tiles --------------
  for (int i = threadIdx.x; i < NQ * n1; i += blockDim.x) {
    sS1[i] = S1g[i];
    sD1[i] = D1g[i];
  }
  const size_t tile = (size_t)p * NN;
  const size_t cstride = (size_t)n_p * NN;
  for (int i = threadIdx.x; i < NN; i += blockDim.x) {
#pragma unroll
    for (int c = 0; c < 3; ++c) su[c * NN + i] = u[c * cstride + tile + i];
    for (int c = 0; c < lead_ul; ++c) sul[c * NN + i] = ul[c * cstride + tile + i];
    if (need_dt_old) {
      svo[i] = vo[tile + i];
      svo[NN + i] = vo[cstride + tile + i];
    }
  }
  __syncthreads();

  // ---- phase 1 (cell-wise delta): |u*|^2 at every q-point -------------
  if (cell_wise) {
    for (int q = threadIdx.x; q < NQQ; q += blockDim.x) {
      const int iy = q / Lq, ix = q - (q / Lq) * Lq;
      const int ey = iy / NQ, qy = iy - ey * NQ;
      const int ex = ix / NQ, qx = ix - ex * NQ;
      float us0 = 0.f, us1 = 0.f;
      for (int j = 0; j < n1; ++j) {
        const float sy = sS1[qy * n1 + j];
        const int row = (P * ey + j) * Xn + P * ex;
        for (int i = 0; i < n1; ++i) {
          const float s = sS1[qx * n1 + i] * sy;
          us0 += s * sul[row + i];
          us1 += s * sul[NN + row + i];
        }
      }
      susq[q] = us0 * us0 + us1 * us1;
    }
    __syncthreads();
  }

  // ---- phase 2: evaluate, physics, test-function weights per q-point --
  const float* ji = jinv + (size_t)p * 4 * NQQ;
  const float* jw = jxw + (size_t)p * NQQ;
  const float* hp = hcell + (size_t)p * 2 * m * m;
  for (int q = threadIdx.x; q < NQQ; q += blockDim.x) {
    const int iy = q / Lq, ix = q - (q / Lq) * Lq;
    const int ey = iy / NQ, qy = iy - ey * NQ;
    const int ex = ix / NQ, qx = ix - ex * NQ;

    float uv[3] = {0.f, 0.f, 0.f}, udx[3] = {0.f, 0.f, 0.f},
          udy[3] = {0.f, 0.f, 0.f};
    float lv[3] = {0.f, 0.f, 0.f}, ldx[3] = {0.f, 0.f, 0.f},
          ldy[3] = {0.f, 0.f, 0.f};
    float dto[2] = {0.f, 0.f};
    for (int j = 0; j < n1; ++j) {
      const float sy = sS1[qy * n1 + j];
      const float dy = sD1[qy * n1 + j];
      const int row = (P * ey + j) * Xn + P * ex;
      for (int i = 0; i < n1; ++i) {
        const float sx = sS1[qx * n1 + i];
        const float dx = sD1[qx * n1 + i];
        const float s = sx * sy, gx = dx * sy, gy = sx * dy;
        const int n = row + i;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float a = su[c * NN + n];
          uv[c] += s * a;
          udx[c] += gx * a;
          udy[c] += gy * a;
        }
        if (incr) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float a = sul[c * NN + n];
            lv[c] += s * a;
            ldx[c] += gx * a;
            ldy[c] += gy * a;
          }
        } else {
          lv[0] += s * sul[n];
          lv[1] += s * sul[NN + n];
        }
        if (need_dt_old) {
          dto[0] += s * svo[n];
          dto[1] += s * svo[NN + n];
        }
      }
    }

    // stabilization parameters
    const int cell = ey * m + ex;
    float d1, d2;
    if (cell_wise) {
      float msq = 0.f;
      for (int b = 0; b < NQ; ++b)
        for (int a = 0; a < NQ; ++a)
          msq = fmaxf(msq, susq[(ey * NQ + b) * Lq + ex * NQ + a]);
      gls_delta_cell(sc, hp[cell], msq, d1, d2);
    } else {
      gls_delta_q(sc, hp[m * m + cell], lv[0] * lv[0] + lv[1] * lv[1], d1, d2);
    }

    // reference -> physical gradients
    const float j0 = ji[q], j1 = ji[NQQ + q], j2 = ji[2 * NQQ + q],
                j3 = ji[3 * NQQ + q];
    float ug[2][2], pg[2], gus[2][2] = {{0.f, 0.f}, {0.f, 0.f}},
                           gps[2] = {0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      ug[a][0] = udx[a] * j0 + udy[a] * j2;
      ug[a][1] = udx[a] * j1 + udy[a] * j3;
    }
    pg[0] = udx[2] * j0 + udy[2] * j2;
    pg[1] = udx[2] * j1 + udy[2] * j3;
    if (incr) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        gus[a][0] = ldx[a] * j0 + ldy[a] * j2;
        gus[a][1] = ldx[a] * j1 + ldy[a] * j3;
      }
      gps[0] = ldx[2] * j0 + ldy[2] * j2;
      gps[1] = ldx[2] * j1 + ldy[2] * j3;
    }

    float vr[3], gr[3][2];
    const float uvel[2] = {uv[0], uv[1]};
    const float us[2] = {lv[0], lv[1]};
    gls_physics<2>(flavor, consider_dt != 0, need_dt_old, sc, uvel, ug, uv[2],
                   pg, us, gus, gps, dto, d1, d2, vr, gr);

    const float w = jw[q];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sw[c * NQQ + q] = vr[c] * w;
      sw[(3 + c) * NQQ + q] = (gr[c][0] * j0 + gr[c][1] * j1) * w;
      sw[(6 + c) * NQQ + q] = (gr[c][0] * j2 + gr[c][1] * j3) * w;
    }
  }
  __syncthreads();

  // ---- phase 3: integrate onto the node tile ------------------------
  for (int n = threadIdx.x; n < NN; n += blockDim.x) {
    const int y = n / Xn, x = n - (n / Xn) * Xn;
    const int ex_lo = x > 0 ? (x - 1) / P : 0;
    const int ex_hi = min(x / P, m - 1);
    const int ey_lo = y > 0 ? (y - 1) / P : 0;
    const int ey_hi = min(y / P, m - 1);
    float acc[3] = {0.f, 0.f, 0.f};
    for (int ey = ey_lo; ey <= ey_hi; ++ey) {
      const int j = y - P * ey;
      for (int ex = ex_lo; ex <= ex_hi; ++ex) {
        const int i = x - P * ex;
        for (int qy = 0; qy < NQ; ++qy) {
          const float sy = sS1[qy * n1 + j];
          const float dy = sD1[qy * n1 + j];
          const int qrow = (ey * NQ + qy) * Lq + ex * NQ;
          for (int qx = 0; qx < NQ; ++qx) {
            const float sx = sS1[qx * n1 + i];
            const float dx = sD1[qx * n1 + i];
            const float s = sx * sy, gx = dx * sy, gy = sx * dy;
            const int q = qrow + qx;
#pragma unroll
            for (int c = 0; c < 3; ++c)
              acc[c] += s * sw[c * NQQ + q] + gx * sw[(3 + c) * NQQ + q] +
                        gy * sw[(6 + c) * NQQ + q];
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c * cstride + tile + n] = acc[c];
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes) -------------
extern "C" int patch2d_sweep_launch(
    const float* u, const float* ul, const float* vo, const float* jinv,
    const float* jxw, const float* h, const float* S1, const float* D1,
    float* out, int n_p, int P, int NQ, int m, int flavor, int consider_dt,
    int cell_wise, float weight, float stau, float nu, float c1, float c2,
    void* stream) {
  const int n1 = P + 1;
  const int Xn = P * m + 1;
  const int Lq = NQ * m;
  const size_t floats = 2 * (size_t)NQ * n1 + 8 * (size_t)Xn * Xn +
                        10 * (size_t)Lq * Lq;
  const size_t bytes = floats * sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(patch2d_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_p == 0) return 0;
  GlsScalars sc{weight, stau, nu, c1, c2};
  patch2d_kernel<<<n_p, kThreads, bytes, (cudaStream_t)stream>>>(
      u, ul, vo, jinv, jxw, h, S1, D1, out, n_p, P, NQ, m, flavor, consider_dt,
      cell_wise, sc);
  return (int)cudaGetLastError();
}
