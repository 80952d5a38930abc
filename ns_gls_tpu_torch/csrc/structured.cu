// Fused structured-lattice GLS sweeps for Hopper (sm_90a): 2D, 3D, and the
// 3D variant that contracts all components together.
//
// Replaces the TPU kernels of ns_gls_tpu/ops/structured.py:
//   structured2d_kernel          <- _make_kernel_2d
//   structured3d_kernel          <- _make_kernel_3d
//   structured3d_batched_kernel  <- _make_kernel_3d_batched
// (the Pallas bodies of StructuredSweep).  Each computes the whole operator
// apply on an affine lattice of cells: unfold the node lattice into cells,
// evaluate u, u_lin and vec_old at every Gauss point (values and reference
// gradients from the 1D Lagrange tables S1/D1), map the gradients with the
// cell's full J^-1, compute delta_1/delta_2 (cell-wise over the cell's
// NQ^d q-points, or per q), apply the GLS q-point physics of
// gls_qpoint.cuh (fixed / increment / residual flavor) and integrate the
// test-function weights back onto the nodes.
//
// Layout (the TPU's banded MXU matrices, lane-tiled cell tables, bf16
// splits and z-slab grid are not carried over):
//   u, ul  (C, Zr, Yr, Nx)   node lattices, C = d + 1, x fastest; y and z
//                            class-grouped (cg_index below);
//                            2D: (C, Yr, 1, Nx)
//   vo     (d, Zr, Yr, Nx)   BDF history sum
//   jinv   (n_c, d*d)        entry r*d + x = dxi_r/dx_x, cells in lattice
//                            order (x fastest, then y, then z)
//   jxw    (n_c, NQ^d)       q = qx + NQ*qy (+ NQ^2*qz)
//   h      (n_c, 2)          h_min_vertex, measure-based h / P
//   out    (C, n_rows, R, Nx)  cell-row tiles: a cell row is the line of nx
//                            cells at one (ey) or (ez, ey), R = (P+1)^(d-1)
//                            its node rows (k, j); row (row, r) holds node
//                            row r integrated over that cell row only
// with Nx = P*nx + 1, Yr = P*ny + 1, Zr = P*nz + 1.
//
// Design.  One thread block per (x segment, cell row).  The block walks
// along x in chunks of XS cells.  Per chunk it stages the R node rows x
// (P*XS+1) nodes of every field in shared memory and sum-factorizes:
//   1. x contraction: per (field, node row, cell, qx) the S1- and D1-
//      weighted sums over the cell's P+1 nodes in x;
//   2. one thread per q-point contracts the R node rows with products of
//      the 1D tables (tabulated once per block), maps to physical
//      gradients, runs the physics in registers and writes its (1+d)*C
//      test-function weights to shared memory;
//   3. the adjoint of 2 over the NQ^(d-1) q-rows, per (component, node
//      row, cell, qx);
//   4. the adjoint of 1, one thread per node: the node shared by two
//      chunks is carried to the next chunk in shared memory and added
//      there; the result goes to the block's cell-row tile.
// Segments give coarse levels and 2D lattices enough blocks: a segment
// that does not start at x = 0 first recomputes the one cell to its left,
// only for the carry into its first node column, and leaves its last node
// column to the next segment.  Node rows shared by two cell rows appear in
// both tiles; the caller sums them by slicing (ops/structured.py
// fold_classes), in a fixed order.  No atomics anywhere: two launches on
// the same inputs give the same bits.
//
// The 3D and 2D kernels take one component at a time through steps 1-4
// (tables re-read per component); the batched kernel takes all components
// of a work item together, one read of a table row serving all of them.
//
// What bounds the function on an H100, at the channel's finest 3D level
// (P = 2, NQ = 3, 128 x 32 x 32 cells, 257 x 65 x 65 nodes), increment
// flavor with the history term (utils/roofline.py structured_cost):
//   bytes: u 4 + u_lin 4 + vec_old 3 + out 4 lattices of 1,085,825 floats
//          = 65.1 MB, cell tables 131,072 x 38 floats = 19.9 MB: 85 MB
//          -> 25 us at 3.35 TB/s;
//   flops: a sum-factorized evaluation and integration plus ~400 per
//          q-point of geometry, delta and physics: 24 kFLOP per cell
//          x 131,072 = 3.15 GFLOP -> 47 us at 67 TFLOP/s f32.
// So the function is bound by operations (in 2D, at 1024 x 256 cells of
// Q2, by bytes: 62 MB -> 18.5 us against 0.94 GFLOP -> 14 us).  This
// design factorizes along x only: step 2 sums over (P+1)^2 node rows per
// q-point and step 3 over NQ^2 q-rows per node row, about 37 kFLOP per
// cell, and every operand of those sums is a shared-memory read.
// Factorizing y and z as well, and keeping a q-column in registers, is
// later work.
#include <cuda_runtime.h>

#include "gls_qpoint.cuh"

namespace {

constexpr int kThreads = 256;
// q-points per chunk the launcher aims for (one per thread)
constexpr int kChunkQ = 256;
// blocks the launcher aims for when it splits cell rows into x segments
constexpr int kTargetBlocks = 528;

struct SDims {
  int P, NQ, nx, ny, nz, XS, nseg, seg_cells;
};

// Class-grouped position of local node j of cell e on an axis of n cells:
// classes 1..P-1 of n entries each, then class 0 of n + 1 entries.
GLS_HD int cg_index(int P, int n, int e, int j) {
  const int k = j % P;
  return (k >= 1 ? (k - 1) * n : (P - 1) * n) + e + (j == P ? 1 : 0);
}

template <int D>
GLS_HD int ipow(int b) {
  int r = 1;
#pragma unroll
  for (int i = 0; i < D; ++i) r *= b;
  return r;
}

// The sweep of one block.  BATCHED: all components of a work item go
// through each contraction together.
template <int D, bool BATCHED>
__device__ __forceinline__ void structured_body(
    const float* __restrict__ u, const float* __restrict__ ul,
    const float* __restrict__ vo, const float* __restrict__ jinv,
    const float* __restrict__ jxw, const float* __restrict__ hcell,
    const float* __restrict__ S1g, const float* __restrict__ D1g,
    float* __restrict__ out, const SDims dm, const int flavor,
    const int consider_dt, const int cell_wise, const GlsScalars sc) {
  extern __shared__ float smem[];
  constexpr int C = D + 1;
  constexpr int T = D + 1;  // weight kinds per component: value, d/dxi_r
  const int P = dm.P, NQ = dm.NQ, nx = dm.nx, ny = dm.ny, XS = dm.XS;
  const int n1 = P + 1;
  const int R = ipow<D - 1>(n1);    // node rows of a cell row
  const int QR = ipow<D - 1>(NQ);   // q-rows of a cell row
  const int NQD = QR * NQ;          // q-points per cell
  const int Nx = P * nx + 1;
  const int Yr = P * ny + 1;
  const int XN = P * XS + 1;        // nodes staged per row (at most)
  const int LX = NQ * XS;           // (cell, qx) columns per chunk (at most)
  const int QS = QR * LX;           // q-points per chunk (at most)
  const int RX = R * XN;
  const int RL = R * LX;
  const bool incr = flavor == GLS_INCREMENT;
  const int lead_ul = incr ? C : D;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);

  const int seg = blockIdx.x % dm.nseg;
  const int row = blockIdx.x / dm.nseg;   // cell row: ey, or ez*ny + ey
  const int ey = row % ny;
  const int ez = row / ny;
  const int n_rows = ny * dm.nz;
  const size_t nn = (size_t)Nx * Yr * (D == 3 ? (size_t)(P * dm.nz + 1) : 1);

  float* sS1 = smem;                  // (NQ, n1)
  float* sD1 = sS1 + NQ * n1;         // (NQ, n1)
  float* sW = sD1 + NQ * n1;          // (D, QR, R): row weights; 0: values,
                                      //   a >= 1: derivative along axis a
  float* su = sW + D * QR * R;        // (C, R, XN) staged nodes
  float* sul = su + C * RX;           // (C, R, XN)
  float* svo = sul + C * RX;          // (D, R, XN)
  float* sAu = svo + D * RX;          // (2, C, R, LX) x-contracted u: S, D;
                                      //   reused for the adjoint (GS, GD)
  float* sAl = sAu + 2 * C * RL;      // (2, C, R, LX) x-contracted u_lin
  float* sAv = sAl + 2 * C * RL;      // (D, R, LX) x-contracted vec_old
  float* susq = sAv + D * RL;         // (QS) |u*|^2 per q-point
  float* sw = susq + QS;              // (T, C, QS) test-function weights
  float* scarry = sw + T * C * QS;    // (2, C, R) x-seam carry, two buffers
  int* sRow = reinterpret_cast<int*>(scarry + 2 * C * R);  // (R) row offsets

  for (int i = threadIdx.x; i < NQ * n1; i += blockDim.x) {
    sS1[i] = S1g[i];
    sD1[i] = D1g[i];
  }
  // node row r = j (2D) or k*n1 + j (3D); q-row qr = qy or qz*NQ + qy
  for (int i = threadIdx.x; i < QR * R; i += blockDim.x) {
    const int qr = i / R, r = i - qr * R;
    if (D == 2) {
      sW[i] = S1g[qr * n1 + r];
      sW[QR * R + i] = D1g[qr * n1 + r];
    } else {
      const int qz = qr / NQ, qy = qr - qz * NQ;
      const int k = r / n1, j = r - k * n1;
      const float sy = S1g[qy * n1 + j], dy = D1g[qy * n1 + j];
      const float sz = S1g[qz * n1 + k], dz = D1g[qz * n1 + k];
      sW[i] = sz * sy;
      sW[QR * R + i] = sz * dy;
      sW[2 * QR * R + i] = dz * sy;
    }
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    if (D == 2) {
      sRow[r] = cg_index(P, ny, ey, r) * Nx;
    } else {
      const int k = r / n1, j = r - k * n1;
      sRow[r] = (cg_index(P, dm.nz, ez, k) * Yr + cg_index(P, ny, ey, j)) * Nx;
    }
  }
  __syncthreads();

  // this block's cells [x0, x1) of the cell row; a later segment starts
  // with the cell left of x0, for the carry only
  const int x0 = seg * dm.seg_cells;
  const int x1 = min(nx, x0 + dm.seg_cells);
  bool halo = seg > 0;
  int cx = halo ? x0 - 1 : x0;
  const int cx_first = cx;
  const size_t cell_row0 = (size_t)row * nx;
  int chunk = 0;

  while (cx < x1) {
    const int xs = halo ? 1 : min(XS, x1 - cx);  // cells in this chunk
    const int xn = P * xs + 1;                   // nodes per row
    const int lxn = NQ * xs;                     // (cell, qx) columns
    const int nq = QR * lxn;                     // q = qr*lxn + ex*NQ + qx

    // ---- phase 0: stage the chunk's node rows --------------------------
    for (int i = threadIdx.x; i < R * xn; i += blockDim.x) {
      const int r = i / xn, xl = i - r * xn;
      const size_t g = (size_t)sRow[r] + P * cx + xl;
      const int s = r * XN + xl;
#pragma unroll
      for (int c = 0; c < C; ++c) su[c * RX + s] = u[c * nn + g];
      for (int c = 0; c < lead_ul; ++c) sul[c * RX + s] = ul[c * nn + g];
      if (need_dt_old) {
#pragma unroll
        for (int c = 0; c < D; ++c) svo[c * RX + s] = vo[c * nn + g];
      }
    }
    __syncthreads();

    // ---- phase 1: x contraction ----------------------------------------
    if (BATCHED) {
      for (int i = threadIdx.x; i < R * lxn; i += blockDim.x) {
        const int r = i / lxn, lx = i - r * lxn;
        const int ex = lx / NQ, qx = lx - ex * NQ;
        const int s0 = r * XN + P * ex;
        const int a = r * LX + lx;
        float vS[C], vD[C], lS[C], lD[C], oS[D];
#pragma unroll
        for (int c = 0; c < C; ++c) vS[c] = vD[c] = lS[c] = lD[c] = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) oS[c] = 0.f;
        for (int ii = 0; ii < n1; ++ii) {
          const float s = sS1[qx * n1 + ii], dd = sD1[qx * n1 + ii];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float t = su[c * RX + s0 + ii];
            vS[c] += s * t;
            vD[c] += dd * t;
          }
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (c < lead_ul) {
              const float t = sul[c * RX + s0 + ii];
              lS[c] += s * t;
              lD[c] += dd * t;
            }
          }
          if (need_dt_old) {
#pragma unroll
            for (int c = 0; c < D; ++c) oS[c] += s * svo[c * RX + s0 + ii];
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          sAu[c * RL + a] = vS[c];
          sAu[(C + c) * RL + a] = vD[c];
          sAl[c * RL + a] = lS[c];
          sAl[(C + c) * RL + a] = lD[c];
        }
#pragma unroll
        for (int c = 0; c < D; ++c) sAv[c * RL + a] = oS[c];
      }
    } else {
      // one (field, component) at a time: u, then u_lin, then vec_old
      const int per = R * lxn;
      const int nf = C + lead_ul + (need_dt_old ? D : 0);
      for (int i = threadIdx.x; i < nf * per; i += blockDim.x) {
        const int f = i / per;
        const int rem = i - f * per;
        const int r = rem / lxn, lx = rem - r * lxn;
        const int ex = lx / NQ, qx = lx - ex * NQ;
        const float* src;
        float* dS;
        float* dD;
        if (f < C) {
          src = su + f * RX;
          dS = sAu + f * RL;
          dD = sAu + (C + f) * RL;
        } else if (f < C + lead_ul) {
          src = sul + (f - C) * RX;
          dS = sAl + (f - C) * RL;
          dD = sAl + f * RL;   // (C + (f - C)): the D half
        } else {
          src = svo + (f - C - lead_ul) * RX;
          dS = sAv + (f - C - lead_ul) * RL;
          dD = nullptr;
        }
        src += r * XN + P * ex;
        float aS = 0.f, aD = 0.f;
        for (int ii = 0; ii < n1; ++ii) {
          const float t = src[ii];
          aS += sS1[qx * n1 + ii] * t;
          aD += sD1[qx * n1 + ii] * t;
        }
        dS[r * LX + lx] = aS;
        if (dD != nullptr) dD[r * LX + lx] = aD;
      }
    }
    __syncthreads();

    // ---- phase 2a (cell-wise delta): |u*|^2 at every q-point -----------
    if (cell_wise) {
      for (int q = threadIdx.x; q < nq; q += blockDim.x) {
        const int qr = q / lxn, lx = q - qr * lxn;
        float us[D];
#pragma unroll
        for (int a = 0; a < D; ++a) us[a] = 0.f;
        for (int r = 0; r < R; ++r) {
          const float w0 = sW[qr * R + r];
#pragma unroll
          for (int a = 0; a < D; ++a) us[a] += w0 * sAl[a * RL + r * LX + lx];
        }
        float s2 = us[0] * us[0];
#pragma unroll
        for (int a = 1; a < D; ++a) s2 += us[a] * us[a];
        susq[q] = s2;
      }
      __syncthreads();
    }

    // ---- phase 2: evaluate, physics, test-function weights -------------
    for (int q = threadIdx.x; q < nq; q += blockDim.x) {
      const int qr = q / lxn, lx = q - qr * lxn;
      const int ex = lx / NQ, qx = lx - ex * NQ;

      // values and reference gradients (direction 0 = x, then the row axes)
      float uv[C], ud[C][D], lv[C], ld[C][D], dto[D];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        uv[c] = lv[c] = 0.f;
#pragma unroll
        for (int a = 0; a < D; ++a) ud[c][a] = ld[c][a] = 0.f;
      }
#pragma unroll
      for (int a = 0; a < D; ++a) dto[a] = 0.f;

      if (BATCHED) {
        for (int r = 0; r < R; ++r) {
          float w[D];
#pragma unroll
          for (int a = 0; a < D; ++a) w[a] = sW[(a * QR + qr) * R + r];
          const int a0 = r * LX + lx;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float aS = sAu[c * RL + a0], aD = sAu[(C + c) * RL + a0];
            uv[c] += w[0] * aS;
            ud[c][0] += w[0] * aD;
#pragma unroll
            for (int a = 1; a < D; ++a) ud[c][a] += w[a] * aS;
          }
          if (incr) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float aS = sAl[c * RL + a0], aD = sAl[(C + c) * RL + a0];
              lv[c] += w[0] * aS;
              ld[c][0] += w[0] * aD;
#pragma unroll
              for (int a = 1; a < D; ++a) ld[c][a] += w[a] * aS;
            }
          } else {
#pragma unroll
            for (int c = 0; c < D; ++c) lv[c] += w[0] * sAl[c * RL + a0];
          }
          if (need_dt_old) {
#pragma unroll
            for (int c = 0; c < D; ++c) dto[c] += w[0] * sAv[c * RL + a0];
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          for (int r = 0; r < R; ++r) {
            const int a0 = c * RL + r * LX + lx;
            const float w0 = sW[qr * R + r];
            const float aS = sAu[a0], aD = sAu[C * RL + a0];
            uv[c] += w0 * aS;
            ud[c][0] += w0 * aD;
#pragma unroll
            for (int a = 1; a < D; ++a)
              ud[c][a] += sW[(a * QR + qr) * R + r] * aS;
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (c < lead_ul) {
            for (int r = 0; r < R; ++r) {
              const int a0 = c * RL + r * LX + lx;
              const float w0 = sW[qr * R + r];
              const float aS = sAl[a0];
              lv[c] += w0 * aS;
              if (incr) {
                ld[c][0] += w0 * sAl[C * RL + a0];
#pragma unroll
                for (int a = 1; a < D; ++a)
                  ld[c][a] += sW[(a * QR + qr) * R + r] * aS;
              }
            }
          }
        }
        if (need_dt_old) {
#pragma unroll
          for (int c = 0; c < D; ++c)
            for (int r = 0; r < R; ++r)
              dto[c] += sW[qr * R + r] * sAv[c * RL + r * LX + lx];
        }
      }

      // cell geometry
      const size_t cell = cell_row0 + cx + ex;
      float ji[D * D];
#pragma unroll
      for (int e = 0; e < D * D; ++e) ji[e] = jinv[cell * (D * D) + e];

      // stabilization parameters
      float d1, d2;
      if (cell_wise) {
        float msq = 0.f;
        for (int qq = 0; qq < QR; ++qq)
          for (int a = 0; a < NQ; ++a)
            msq = fmaxf(msq, susq[qq * lxn + ex * NQ + a]);
        gls_delta_cell(sc, hcell[cell * 2], msq, d1, d2);
      } else {
        float s2 = lv[0] * lv[0];
#pragma unroll
        for (int a = 1; a < D; ++a) s2 += lv[a] * lv[a];
        gls_delta_q(sc, hcell[cell * 2 + 1], s2, d1, d2);
      }

      // reference -> physical gradients: g[x] = sum_r ref[r] * ji[r*D + x]
      float ug[D][D], pg[D], gus[D][D], gps[D], uvel[D], us[D];
#pragma unroll
      for (int x = 0; x < D; ++x) {
#pragma unroll
        for (int a = 0; a < D; ++a) {
          float g = 0.f, gl = 0.f;
#pragma unroll
          for (int r = 0; r < D; ++r) {
            g += ud[a][r] * ji[r * D + x];
            gl += ld[a][r] * ji[r * D + x];
          }
          ug[a][x] = g;
          gus[a][x] = gl;
        }
        float g = 0.f, gl = 0.f;
#pragma unroll
        for (int r = 0; r < D; ++r) {
          g += ud[D][r] * ji[r * D + x];
          gl += ld[D][r] * ji[r * D + x];
        }
        pg[x] = g;
        gps[x] = gl;
        uvel[x] = uv[x];
        us[x] = lv[x];
      }

      float vr[C], gr[C][D];
      gls_physics<D>(flavor, consider_dt != 0, need_dt_old, sc, uvel, ug,
                     uv[D], pg, us, gus, gps, dto, d1, d2, vr, gr);

      const float w = jxw[cell * NQD + qx + NQ * qr];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        sw[c * QS + q] = vr[c] * w;
#pragma unroll
        for (int r = 0; r < D; ++r) {
          float g = 0.f;
#pragma unroll
          for (int x = 0; x < D; ++x) g += gr[c][x] * ji[r * D + x];
          sw[((1 + r) * C + c) * QS + q] = g * w;
        }
      }
    }
    __syncthreads();

    // ---- phase 3: adjoint over the q-rows ------------------------------
    // GS (values along x) -> sAu[c], GD (x-derivatives) -> sAu[C + c]
    if (BATCHED) {
      for (int i = threadIdx.x; i < R * lxn; i += blockDim.x) {
        const int r = i / lxn, lx = i - r * lxn;
        float gS[C], gD[C];
#pragma unroll
        for (int c = 0; c < C; ++c) gS[c] = gD[c] = 0.f;
        for (int qr = 0; qr < QR; ++qr) {
          float w[D];
#pragma unroll
          for (int a = 0; a < D; ++a) w[a] = sW[(a * QR + qr) * R + r];
          const int q = qr * lxn + lx;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float t = w[0] * sw[c * QS + q];
#pragma unroll
            for (int a = 1; a < D; ++a)
              t += w[a] * sw[((1 + a) * C + c) * QS + q];
            gS[c] += t;
            gD[c] += w[0] * sw[(C + c) * QS + q];
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          sAu[c * RL + r * LX + lx] = gS[c];
          sAu[(C + c) * RL + r * LX + lx] = gD[c];
        }
      }
    } else {
      const int per = R * lxn;
      for (int i = threadIdx.x; i < C * per; i += blockDim.x) {
        const int c = i / per;
        const int rem = i - c * per;
        const int r = rem / lxn, lx = rem - r * lxn;
        float gS = 0.f, gD = 0.f;
        for (int qr = 0; qr < QR; ++qr) {
          const int q = qr * lxn + lx;
          const float w0 = sW[qr * R + r];
          float t = w0 * sw[c * QS + q];
#pragma unroll
          for (int a = 1; a < D; ++a)
            t += sW[(a * QR + qr) * R + r] * sw[((1 + a) * C + c) * QS + q];
          gS += t;
          gD += w0 * sw[(C + c) * QS + q];
        }
        sAu[c * RL + r * LX + lx] = gS;
        sAu[(C + c) * RL + r * LX + lx] = gD;
      }
    }
    __syncthreads();

    // ---- phase 4: x adjoint, carry, write ------------------------------
    const float* cin = scarry + (chunk & 1) * C * R;
    float* cout = scarry + ((chunk + 1) & 1) * C * R;
    const bool have_carry = cx > cx_first;
    const bool row_end = cx + xs >= nx;   // the cell row's last chunk
    const int n_items = BATCHED ? R * xn : C * R * xn;
    for (int i = threadIdx.x; i < n_items; i += blockDim.x) {
      const int c_lo = BATCHED ? 0 : i / (R * xn);
      const int c_hi = BATCHED ? C : c_lo + 1;
      const int rem = BATCHED ? i : i - c_lo * (R * xn);
      const int r = rem / xn, xl = rem - r * xn;
      const int ex_lo = xl > 0 ? (xl - 1) / P : 0;
      const int ex_hi = min(xl / P, xs - 1);
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
      for (int ex = ex_lo; ex <= ex_hi; ++ex) {
        const int ii = xl - P * ex;
        for (int qx = 0; qx < NQ; ++qx) {
          const float s = sS1[qx * n1 + ii], dd = sD1[qx * n1 + ii];
          const int a0 = r * LX + ex * NQ + qx;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (c >= c_lo && c < c_hi)
              acc[c] += s * sAu[c * RL + a0] + dd * sAu[(C + c) * RL + a0];
          }
        }
      }
      const bool seam_out = xl == xn - 1 && !row_end;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c >= c_lo && c < c_hi) {
          float v = acc[c];
          if (xl == 0 && have_carry) v += cin[c * R + r];
          if (seam_out) {
            cout[c * R + r] = v;
          } else if (!halo) {
            out[(((size_t)c * n_rows + row) * R + r) * Nx + P * cx + xl] = v;
          }
        }
      }
    }
    __syncthreads();

    cx += xs;
    halo = false;
    ++chunk;
  }
}

#define STRUCTURED_ARGS                                                      \
  const float *__restrict__ u, const float *__restrict__ ul,                 \
      const float *__restrict__ vo, const float *__restrict__ jinv,          \
      const float *__restrict__ jxw, const float *__restrict__ hcell,        \
      const float *__restrict__ S1g, const float *__restrict__ D1g,          \
      float *__restrict__ out, SDims dm, int flavor, int consider_dt,        \
      int cell_wise, GlsScalars sc
#define STRUCTURED_PASS                                                      \
  u, ul, vo, jinv, jxw, hcell, S1g, D1g, out, dm, flavor, consider_dt,       \
      cell_wise, sc

__global__ void __launch_bounds__(kThreads)
structured2d_kernel(STRUCTURED_ARGS) {
  structured_body<2, false>(STRUCTURED_PASS);
}

__global__ void __launch_bounds__(kThreads)
structured3d_kernel(STRUCTURED_ARGS) {
  structured_body<3, false>(STRUCTURED_PASS);
}

__global__ void __launch_bounds__(kThreads)
structured3d_batched_kernel(STRUCTURED_ARGS) {
  structured_body<3, true>(STRUCTURED_PASS);
}

int ipow_host(int b, int e) {
  int r = 1;
  for (int i = 0; i < e; ++i) r *= b;
  return r;
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes) -------------
// Returns 0, a CUDA error code, or 1 (cudaErrorInvalidValue) when the
// chunk's tiles exceed the card's shared memory per block.
extern "C" int structured_sweep_launch(
    const float* u, const float* ul, const float* vo, const float* jinv,
    const float* jxw, const float* h, const float* S1, const float* D1,
    float* out, int dim, int P, int NQ, int nx, int ny, int nz, int flavor,
    int consider_dt, int cell_wise, int batched, float weight, float stau,
    float nu, float c1, float c2, void* stream) {
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  if (dim == 2) nz = 1;
  const int C = dim + 1, T = dim + 1;
  const int n1 = P + 1;
  const int R = ipow_host(n1, dim - 1);
  const int QR = ipow_host(NQ, dim - 1);
  int XS = kChunkQ / (QR * NQ);
  XS = XS < 1 ? 1 : (XS > nx ? nx : XS);
  const int n_rows = ny * nz;
  // x segments: enough blocks for the card, each segment at least two
  // chunks long (a later segment recomputes one cell)
  int nseg = (kTargetBlocks + n_rows - 1) / (n_rows > 0 ? n_rows : 1);
  const int max_seg = nx / (2 * XS) > 1 ? nx / (2 * XS) : 1;
  nseg = nseg < 1 ? 1 : (nseg > max_seg ? max_seg : nseg);
  const int seg_cells = (nx + nseg - 1) / nseg;
  nseg = (nx + seg_cells - 1) / (seg_cells > 0 ? seg_cells : 1);

  const size_t XN = (size_t)P * XS + 1;
  const size_t LX = (size_t)NQ * XS;
  const size_t QS = QR * LX;
  const size_t RX = R * XN, RL = R * LX;
  const size_t floats = 2 * (size_t)NQ * n1 + (size_t)dim * QR * R +
                        (2 * C + dim) * RX + (4 * C + dim) * RL + QS +
                        (size_t)T * C * QS + 2 * (size_t)C * R + R;
  const size_t bytes = floats * sizeof(float);

  const void* fn = (const void*)structured3d_kernel;
  if (dim == 2) fn = (const void*)structured2d_kernel;
  else if (batched) fn = (const void*)structured3d_batched_kernel;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_rows == 0 || nx == 0) return 0;
  GlsScalars sc{weight, stau, nu, c1, c2};
  SDims dm{P, NQ, nx, ny, nz, XS, nseg, seg_cells};
  const dim3 grid(nseg * n_rows), block(kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (dim == 2) {
    structured2d_kernel<<<grid, block, bytes, st>>>(
        u, ul, vo, jinv, jxw, h, S1, D1, out, dm, flavor, consider_dt,
        cell_wise, sc);
  } else if (batched) {
    structured3d_batched_kernel<<<grid, block, bytes, st>>>(
        u, ul, vo, jinv, jxw, h, S1, D1, out, dm, flavor, consider_dt,
        cell_wise, sc);
  } else {
    structured3d_kernel<<<grid, block, bytes, st>>>(
        u, ul, vo, jinv, jxw, h, S1, D1, out, dm, flavor, consider_dt,
        cell_wise, sc);
  }
  return (int)cudaGetLastError();
}
