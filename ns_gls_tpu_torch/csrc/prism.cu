// Fused prism GLS sweep for Hopper (sm_90a): extruded 3D meshes.
//
// Replaces the TPU kernel ns_gls_tpu/ops/prism.py:_make_prism_kernel (the
// Pallas body of PrismSweep).  It computes the same function: for every
// patch column (an m x m lattice of cells, curved in x-y and straight in
// z, times nz cell layers) evaluate u, u_lin and vec_old at every Gauss
// point (values and reference gradients from the 1D Lagrange tables), map
// the gradients with the per-2D-cell, per-q J2d^-1 and 1/dz, compute
// delta_1/delta_2 (cell-wise over the cell's NQ^3 q-points, or per q),
// apply the 3D GLS q-point physics of gls_qpoint.cuh (fixed / increment /
// residual flavor) and integrate the test-function weights back onto the
// nodes.
//
// Layout (per patch; the TPU's G-patch row groups, block-diagonal bands,
// class-grouped lattice order and (8,128) padding are not carried over):
//   u     (4, n_p, Xn, Xn, Nzn)      node tiles, [y][x][z], z fastest
//   ul    (4 or 3, n_p, Xn, Xn, Nzn)  linearization point (4 in increment)
//   vo    (3, n_p, Xn, Xn, Nzn)      BDF history sum
//   jinv  (n_p, 5, Lq, Lq)           J00 J01 J10 J11 of J2d^-1, then 1/dz
//   jxw   (n_p, Lq, Lq)              2D factor of |det J| * weight
//   h     (n_p, 2, m, m)             per 2D cell: h_min_vertex, hq
//   wz    (NQ)                       z Gauss weights
//   out   (4, n_p, m, P+1, Xn, Nzn)  cell-row tiles: row (ey, j) holds
//                                    node row P*ey + j integrated over
//                                    cell row ey only
// with Xn = P*m + 1, Nzn = P*nz + 1, Lq = NQ*m, q-point row iy = ey*NQ+qy,
// column ix = ex*NQ + qx.
//
// Design.  One thread block per (patch, cell row ey).  The block walks up
// the z column in slabs of ZS cell layers: it stages the slab's (P+1)
// node rows x Xn x (P*ZS+1) z-planes of u, u_lin and vec_old in shared
// memory, one thread per q-point evaluates from its cell's (P+1)^3 nodes,
// runs the physics in registers and writes its 16 test-function weights
// to shared memory, then one thread per node integrates from the (at most
// four) cells of the slab around it.  The z-plane shared by two slabs is
// carried to the next slab in shared memory and added there, in a fixed
// order; node rows shared by two cell rows (and patch seams) are left to
// the caller's seam compress, which sums whole z-runs in a fixed order.
// No atomics: two launches on the same inputs give the same bits.
//
// What bounds the function on an H100, at the Turek 3D ref-3 shapes
// (P = 2, NQ = 3, m = 8, nz = 32: Xn = 17, Nzn = 65, 100 patches, 204,800
// cells), increment flavor with the history term (chip_smoke.py
// prism_cost):
//   bytes: u 4 + u_lin 4 + vec_old 3 node tiles of 100 x 17^2 x 65 floats
//          = 82.6 MB, the seam-compressed output 4 x 1,697,280 floats
//          = 27.2 MB, geometry 1.4 MB: 111 MB -> 33 us at 3.35 TB/s;
//   flops of a sum-factorized evaluation and integration on the patch
//          columns (z, then y, then x; each q-point touches 3 nodes per
//          axis) plus ~270 per q-point of geometry, delta and physics:
//          22 kFLOP per cell x 204,800 = 4.56 GFLOP -> 68 us at
//          67 TFLOP/s f32.
// So the function is bound by operations, about twice the bytes' time.
// This design does no sum factorization: each q-point thread sums over
// its cell's 27 nodes, and each node thread over the 27 q-points of up to
// four cells, about 93 kFLOP per cell, four times what the function
// needs; evaluating along one axis at a time, as the TPU kernel's band
// matmuls do, is later work.
#include <cuda_runtime.h>

#include "gls_qpoint.cuh"

namespace {

constexpr int kThreads = 256;
// q-points per slab the launcher aims for (about two per thread)
constexpr int kSlabQ = 512;

struct PrismDims {
  int n_p, P, NQ, m, nz, ZS;
};

__global__ void __launch_bounds__(kThreads)
prism_kernel(const float* __restrict__ u, const float* __restrict__ ul,
             const float* __restrict__ vo, const float* __restrict__ jinv,
             const float* __restrict__ jxw, const float* __restrict__ hcell,
             const float* __restrict__ S1g, const float* __restrict__ D1g,
             const float* __restrict__ wzg, float* __restrict__ out,
             PrismDims dm, int flavor, int consider_dt, int cell_wise,
             GlsScalars sc) {
  extern __shared__ float smem[];
  const int P = dm.P, NQ = dm.NQ, m = dm.m, nz = dm.nz, ZS = dm.ZS;
  const int p = blockIdx.x / m;
  const int ey = blockIdx.x - p * m;
  const int n1 = P + 1;
  const int Xn = P * m + 1;
  const int Nzn = P * nz + 1;
  const int Lq = NQ * m;
  const int NQ3 = NQ * NQ * NQ;
  const int ZN = P * ZS + 1;      // z-planes staged per slab (at most)
  const int NR = n1 * Xn;         // nodes per z-plane of the block's rows
  const int NS = NR * ZN;         // nodes staged per slab (at most)
  const int QS = m * ZS * NQ3;    // q-points per slab (at most)
  const bool incr = flavor == GLS_INCREMENT;
  const int lead_ul = incr ? 4 : 3;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);

  float* sS1 = smem;                 // (NQ, P+1)
  float* sD1 = sS1 + NQ * n1;        // (NQ, P+1)
  float* swz = sD1 + NQ * n1;        // (NQ)
  float* su = swz + NQ;              // (4, NS)  [c][(j*Xn + x)*ZN + zl]
  float* sul = su + 4 * NS;          // (4, NS)
  float* svo = sul + 4 * NS;         // (3, NS)
  float* susq = svo + 3 * NS;        // (QS) |u*|^2 per q-point
  float* sw = susq + QS;             // (16, QS) test-function weights
  float* scarry = sw + 16 * QS;      // (2, 4, NR) z-seam carry, two buffers

  for (int i = threadIdx.x; i < NQ * n1; i += blockDim.x) {
    sS1[i] = S1g[i];
    sD1[i] = D1g[i];
  }
  for (int i = threadIdx.x; i < NQ; i += blockDim.x) swz[i] = wzg[i];

  const size_t cstride = (size_t)dm.n_p * Xn * Xn * Nzn;
  const size_t ptile = (size_t)p * Xn * Xn * Nzn;
  const float* ji = jinv + (size_t)p * 5 * Lq * Lq;
  const float* jw = jxw + (size_t)p * Lq * Lq;
  const float* hp = hcell + (size_t)p * 2 * m * m;
  const size_t ostride = (size_t)dm.n_p * m * NR * Nzn;
  const size_t orow = ((size_t)p * m + ey) * NR * Nzn;

  int slab = 0;
  for (int z0 = 0; z0 < nz; z0 += ZS, ++slab) {
    const int zs = min(ZS, nz - z0);   // cell layers in this slab
    const int zn = P * zs + 1;         // z-planes in this slab
    const int nq = m * zs * NQ3;
    const int nn = NR * zn;
    const bool last = z0 + zs >= nz;

    // ---- phase 0: stage the slab's node tiles -------------------------
    for (int i = threadIdx.x; i < nn; i += blockDim.x) {
      const int r = i / zn, zl = i - r * zn;     // r = j*Xn + x
      const int j = r / Xn, x = r - j * Xn;
      const size_t g = ptile + ((size_t)(P * ey + j) * Xn + x) * Nzn +
                       P * z0 + zl;
      const int s = r * ZN + zl;
#pragma unroll
      for (int c = 0; c < 4; ++c) su[c * NS + s] = u[c * cstride + g];
      for (int c = 0; c < lead_ul; ++c) sul[c * NS + s] = ul[c * cstride + g];
      if (need_dt_old) {
#pragma unroll
        for (int c = 0; c < 3; ++c) svo[c * NS + s] = vo[c * cstride + g];
      }
    }
    __syncthreads();

    // q-point q of the slab: q = (((ezl*NQ + qz)*NQ + qy)*m + ex)*NQ + qx

    // ---- phase 1 (cell-wise delta): |u*|^2 at every q-point -----------
    if (cell_wise) {
      for (int q = threadIdx.x; q < nq; q += blockDim.x) {
        int t = q;
        const int qx = t % NQ; t /= NQ;
        const int ex = t % m; t /= m;
        const int qy = t % NQ; t /= NQ;
        const int qz = t % NQ;
        const int ezl = t / NQ;
        float us[3] = {0.f, 0.f, 0.f};
        for (int k = 0; k < n1; ++k) {
          const float sz = sS1[qz * n1 + k];
          for (int j = 0; j < n1; ++j) {
            const float syz = sS1[qy * n1 + j] * sz;
            const int row = (j * Xn + P * ex) * ZN + P * ezl + k;
            for (int i = 0; i < n1; ++i) {
              const float s = sS1[qx * n1 + i] * syz;
              const int n = row + i * ZN;
#pragma unroll
              for (int c = 0; c < 3; ++c) us[c] += s * sul[c * NS + n];
            }
          }
        }
        susq[q] = us[0] * us[0] + us[1] * us[1] + us[2] * us[2];
      }
      __syncthreads();
    }

    // ---- phase 2: evaluate, physics, test-function weights ------------
    for (int q = threadIdx.x; q < nq; q += blockDim.x) {
      int t = q;
      const int qx = t % NQ; t /= NQ;
      const int ex = t % m; t /= m;
      const int qy = t % NQ; t /= NQ;
      const int qz = t % NQ;
      const int ezl = t / NQ;

      float uv[4] = {0.f, 0.f, 0.f, 0.f}, udx[4] = {0.f, 0.f, 0.f, 0.f},
            udy[4] = {0.f, 0.f, 0.f, 0.f}, udz[4] = {0.f, 0.f, 0.f, 0.f};
      float lv[4] = {0.f, 0.f, 0.f, 0.f}, ldx[4] = {0.f, 0.f, 0.f, 0.f},
            ldy[4] = {0.f, 0.f, 0.f, 0.f}, ldz[4] = {0.f, 0.f, 0.f, 0.f};
      float dto[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < n1; ++k) {
        const float sz = sS1[qz * n1 + k];
        const float dz = sD1[qz * n1 + k];
        for (int j = 0; j < n1; ++j) {
          const float sy = sS1[qy * n1 + j];
          const float dy = sD1[qy * n1 + j];
          const int row = (j * Xn + P * ex) * ZN + P * ezl + k;
          for (int i = 0; i < n1; ++i) {
            const float sx = sS1[qx * n1 + i];
            const float dx = sD1[qx * n1 + i];
            const float s = sx * sy * sz, gx = dx * sy * sz,
                        gy = sx * dy * sz, gz = sx * sy * dz;
            const int n = row + i * ZN;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float a = su[c * NS + n];
              uv[c] += s * a;
              udx[c] += gx * a;
              udy[c] += gy * a;
              udz[c] += gz * a;
            }
            if (incr) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float a = sul[c * NS + n];
                lv[c] += s * a;
                ldx[c] += gx * a;
                ldy[c] += gy * a;
                ldz[c] += gz * a;
              }
            } else {
#pragma unroll
              for (int c = 0; c < 3; ++c) lv[c] += s * sul[c * NS + n];
            }
            if (need_dt_old) {
#pragma unroll
              for (int c = 0; c < 3; ++c) dto[c] += s * svo[c * NS + n];
            }
          }
        }
      }

      // stabilization parameters
      const int cell2d = ey * m + ex;
      float d1, d2;
      if (cell_wise) {
        float msq = 0.f;
        const int cq0 = ezl * NQ3 * m;   // q of (ezl, qz=0, qy=0, ex=0)
        for (int c = 0; c < NQ * NQ; ++c)       // (qz, qy)
          for (int a = 0; a < NQ; ++a)
            msq = fmaxf(msq, susq[cq0 + (c * m + ex) * NQ + a]);
        gls_delta_cell(sc, hp[cell2d], msq, d1, d2);
      } else {
        gls_delta_q(sc, hp[m * m + cell2d],
                    lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2], d1, d2);
      }

      // reference -> physical gradients (prismatic J)
      const int q2 = (ey * NQ + qy) * Lq + ex * NQ + qx;
      const int LL = Lq * Lq;
      const float a00 = ji[q2], a01 = ji[LL + q2], a10 = ji[2 * LL + q2],
                  a11 = ji[3 * LL + q2], idz = ji[4 * LL + q2];
      float ug[3][3], pg[3];
      float gus[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
      float gps[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        ug[a][0] = udx[a] * a00 + udy[a] * a10;
        ug[a][1] = udx[a] * a01 + udy[a] * a11;
        ug[a][2] = udz[a] * idz;
      }
      pg[0] = udx[3] * a00 + udy[3] * a10;
      pg[1] = udx[3] * a01 + udy[3] * a11;
      pg[2] = udz[3] * idz;
      if (incr) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          gus[a][0] = ldx[a] * a00 + ldy[a] * a10;
          gus[a][1] = ldx[a] * a01 + ldy[a] * a11;
          gus[a][2] = ldz[a] * idz;
        }
        gps[0] = ldx[3] * a00 + ldy[3] * a10;
        gps[1] = ldx[3] * a01 + ldy[3] * a11;
        gps[2] = ldz[3] * idz;
      }

      float vr[4], gr[4][3];
      const float uvel[3] = {uv[0], uv[1], uv[2]};
      const float us[3] = {lv[0], lv[1], lv[2]};
      gls_physics<3>(flavor, consider_dt != 0, need_dt_old, sc, uvel, ug,
                     uv[3], pg, us, gus, gps, dto, d1, d2, vr, gr);

      const float w = jw[q2] * swz[qz];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sw[c * QS + q] = vr[c] * w;
        sw[(4 + c) * QS + q] = (gr[c][0] * a00 + gr[c][1] * a01) * w;
        sw[(8 + c) * QS + q] = (gr[c][0] * a10 + gr[c][1] * a11) * w;
        sw[(12 + c) * QS + q] = (gr[c][2] * idz) * w;
      }
    }
    __syncthreads();

    // ---- phase 3: integrate onto the slab's nodes ---------------------
    const float* cin = scarry + (slab & 1) * 4 * NR;
    float* cout = scarry + ((slab + 1) & 1) * 4 * NR;
    for (int i = threadIdx.x; i < nn; i += blockDim.x) {
      const int r = i / zn, zl = i - r * zn;
      const int j = r / Xn, x = r - j * Xn;
      const int ex_lo = x > 0 ? (x - 1) / P : 0;
      const int ex_hi = min(x / P, m - 1);
      const int ez_lo = zl > 0 ? (zl - 1) / P : 0;
      const int ez_hi = min(zl / P, zs - 1);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ezl = ez_lo; ezl <= ez_hi; ++ezl) {
        const int k = zl - P * ezl;
        for (int ex = ex_lo; ex <= ex_hi; ++ex) {
          const int ii = x - P * ex;
          for (int qz = 0; qz < NQ; ++qz) {
            const float sz = sS1[qz * n1 + k];
            const float dz = sD1[qz * n1 + k];
            for (int qy = 0; qy < NQ; ++qy) {
              const float sy = sS1[qy * n1 + j];
              const float dy = sD1[qy * n1 + j];
              const int qrow = (((ezl * NQ + qz) * NQ + qy) * m + ex) * NQ;
              for (int qx = 0; qx < NQ; ++qx) {
                const float sx = sS1[qx * n1 + ii];
                const float dx = sD1[qx * n1 + ii];
                const float s = sx * sy * sz, gx = dx * sy * sz,
                            gy = sx * dy * sz, gz = sx * sy * dz;
                const int q = qrow + qx;
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  acc[c] += s * sw[c * QS + q] + gx * sw[(4 + c) * QS + q] +
                            gy * sw[(8 + c) * QS + q] +
                            gz * sw[(12 + c) * QS + q];
              }
            }
          }
        }
      }
      if (zl == 0 && z0 > 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += cin[c * NR + r];
      }
      if (zl == zn - 1 && !last) {
#pragma unroll
        for (int c = 0; c < 4; ++c) cout[c * NR + r] = acc[c];
      } else {
        const size_t o = orow + (size_t)r * Nzn + P * z0 + zl;
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c * ostride + o] = acc[c];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes) -------------
extern "C" int prism_sweep_launch(
    const float* u, const float* ul, const float* vo, const float* jinv,
    const float* jxw, const float* h, const float* S1, const float* D1,
    const float* wz, float* out, int n_p, int P, int NQ, int m, int nz,
    int flavor, int consider_dt, int cell_wise, float weight, float stau,
    float nu, float c1, float c2, void* stream) {
  const int n1 = P + 1;
  const int Xn = P * m + 1;
  const int NQ3 = NQ * NQ * NQ;
  int ZS = kSlabQ / (m * NQ3);
  ZS = ZS < 1 ? 1 : (ZS > nz ? nz : ZS);
  const int ZN = P * ZS + 1;
  const size_t NR = (size_t)n1 * Xn;
  const size_t NS = NR * ZN;
  const size_t QS = (size_t)m * ZS * NQ3;
  const size_t floats = 2 * (size_t)NQ * n1 + NQ + 11 * NS + 17 * QS + 8 * NR;
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
    err = cudaFuncSetAttribute(prism_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_p == 0 || nz == 0) return 0;
  GlsScalars sc{weight, stau, nu, c1, c2};
  PrismDims dm{n_p, P, NQ, m, nz, ZS};
  prism_kernel<<<n_p * m, kThreads, bytes, (cudaStream_t)stream>>>(
      u, ul, vo, jinv, jxw, h, S1, D1, wz, out, dm, flavor, consider_dt,
      cell_wise, sc);
  return (int)cudaGetLastError();
}
