// Fused structured-lattice GLS sweeps for Hopper (sm_90a): 2D, 3D, and the
// 3D variant that contracts all components together.
//
// Replaces the TPU kernels of ns_gls_tpu/ops/structured.py:
//   structured2d_kernel<P>       <- _make_kernel_2d
//   structured3d_kernel<P>       <- _make_kernel_3d
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
// Inputs (the TPU's banded MXU matrices, lane-tiled cell tables, bf16
// splits and z-slab grid are not carried over):
//   u, ul  (C, Zr, Yr, Nx)   node lattices, C = d + 1, x fastest; y and z
//                            class-grouped (cg_index below);
//                            2D: (C, Yr, 1, Nx)
//   vo     (d, Zr, Yr, Nx)   BDF history sum
//   jinv   (n_c, d*d)        entry r*d + x = dxi_r/dx_x, cells in lattice
//                            order (x fastest, then y, then z)
//   jxw    (n_c, NQ^d)       q = qx + NQ*qy (+ NQ^2*qz)
//   h      (n_c, 2)          h_min_vertex, measure-based h / P
// with Nx = P*nx + 1, Yr = P*ny + 1, Zr = P*nz + 1.
//
// Each kernel's output and design are described at its code: the batched
// 3D kernel (structured_body: sum-factorized along x only, cell-row tiles),
// the 3D kernel and the 2D kernel (sum-factorized along every axis, the
// node plane or row shared along the walk axis carried in a register, the
// next slab copied while this one computes).  No atomics anywhere: two
// launches on the same inputs give the same bits; what two thread blocks
// share is summed by the caller (ops/structured.py) in a fixed order.
#include <cuda_runtime.h>

#include "gls_qpoint.cuh"

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;
// q-points per chunk the batched launcher aims for (one per thread)
constexpr int kChunkQ = 256;
// blocks the batched launcher aims for when it splits cell rows into x
// segments
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

// ===========================================================================
// structured3d_batched_kernel: the 3D sweep factorized along x only, all
// components of a work item through each contraction together
// ===========================================================================
//
// Output: cell-row tiles out (C, nz, ny, R, Nx), R = (P+1)^2: a cell row is
// the line of nx cells at one (ez, ey), (k, j) its node rows; row (row, r)
// holds node row r integrated over that cell row only.  ops/structured.py
// fold_tiles sums the node rows shared by two cell rows (fold_classes).
//
// Design.  One thread block per (x segment, cell row).  The block walks
// along x in chunks of XS cells.  Per chunk it stages the R node rows x
// (P*XS+1) nodes of every field in shared memory and sum-factorizes:
//   1. x contraction: per (node row, cell, qx) the S1- and D1-weighted
//      sums over the cell's P+1 nodes in x, every component of every field;
//   2. one thread per q-point contracts the R node rows with products of
//      the 1D tables (tabulated once per block), maps to physical
//      gradients, runs the physics in registers and writes its 4*C
//      test-function weights to shared memory;
//   3. the adjoint of 2 over the NQ^2 q-rows, per (node row, cell, qx);
//   4. the adjoint of 1, one thread per node: the node shared by two
//      chunks is carried to the next chunk in shared memory and added
//      there; the result goes to the block's cell-row tile.
// Segments give coarse levels enough blocks: a segment that does not start
// at x = 0 first recomputes the one cell to its left, only for the carry
// into its first node column, and leaves its last node column to the next
// segment.  It sums over (P+1)^2 node rows per q-point in step 2 and over
// NQ^2 q-rows per node row in step 3, about 37 kFLOP per cell at P = 2,
// every operand a shared-memory read.  Any degree.  No driver path selects
// it (as in the JAX package); the gls-vmult lane `--batched` does.

// The sweep of one block of the batched 3D kernel.
__device__ __forceinline__ void structured_body(
    const float* __restrict__ u, const float* __restrict__ ul,
    const float* __restrict__ vo, const float* __restrict__ jinv,
    const float* __restrict__ jxw, const float* __restrict__ hcell,
    const float* __restrict__ S1g, const float* __restrict__ D1g,
    float* __restrict__ out, const SDims dm, const int flavor,
    const int consider_dt, const int cell_wise, const GlsScalars sc) {
  extern __shared__ float smem[];
  constexpr int D = 3;
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
  const int row = blockIdx.x / dm.nseg;   // cell row: ez*ny + ey
  const int ey = row % ny;
  const int ez = row / ny;
  const int n_rows = ny * dm.nz;
  const size_t nn = (size_t)Nx * Yr * (size_t)(P * dm.nz + 1);

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
  // node row r = k*n1 + j; q-row qr = qz*NQ + qy
  for (int i = threadIdx.x; i < QR * R; i += blockDim.x) {
    const int qr = i / R, r = i - qr * R;
    const int qz = qr / NQ, qy = qr - qz * NQ;
    const int k = r / n1, j = r - k * n1;
    const float sy = S1g[qy * n1 + j], dy = D1g[qy * n1 + j];
    const float sz = S1g[qz * n1 + k], dz = D1g[qz * n1 + k];
    sW[i] = sz * sy;
    sW[QR * R + i] = sz * dy;
    sW[2 * QR * R + i] = dz * sy;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int k = r / n1, j = r - k * n1;
    sRow[r] = (cg_index(P, dm.nz, ez, k) * Yr + cg_index(P, ny, ey, j)) * Nx;
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
    __syncthreads();

    // ---- phase 4: x adjoint, carry, write ------------------------------
    const float* cin = scarry + (chunk & 1) * C * R;
    float* cout = scarry + ((chunk + 1) & 1) * C * R;
    const bool have_carry = cx > cx_first;
    const bool row_end = cx + xs >= nx;   // the cell row's last chunk
    for (int i = threadIdx.x; i < R * xn; i += blockDim.x) {
      const int r = i / xn, xl = i - r * xn;
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
          for (int c = 0; c < C; ++c)
            acc[c] += s * sAu[c * RL + a0] + dd * sAu[(C + c) * RL + a0];
        }
      }
      const bool seam_out = xl == xn - 1 && !row_end;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v = acc[c];
        if (xl == 0 && have_carry) v += cin[c * R + r];
        if (seam_out) {
          cout[c * R + r] = v;
        } else if (!halo) {
          out[(((size_t)c * n_rows + row) * R + r) * Nx + P * cx + xl] = v;
        }
      }
    }
    __syncthreads();

    cx += xs;
    halo = false;
    ++chunk;
  }
}

__global__ void __launch_bounds__(kThreads)
structured3d_batched_kernel(
    const float* __restrict__ u, const float* __restrict__ ul,
    const float* __restrict__ vo, const float* __restrict__ jinv,
    const float* __restrict__ jxw, const float* __restrict__ hcell,
    const float* __restrict__ S1g, const float* __restrict__ D1g,
    float* __restrict__ out, SDims dm, int flavor, int consider_dt,
    int cell_wise, GlsScalars sc) {
  structured_body(u, ul, vo, jinv, jxw, hcell, S1g, D1g, out, dm, flavor,
                  consider_dt, cell_wise, sc);
}

// ===========================================================================
// structured3d_kernel: the 3D sweep, sum-factorized along z, x and y
// ===========================================================================
//
// Output (in place of the cell-row tiles above; ops/structured.py
// fold_bricks sums it into the lattice):
//   tiles  (C, Zr, ny, P+1, Nx)  node plane (class-grouped z), cell row
//                                ey, its node row j, node x: the integrals
//                                over cell row ey only, x seams excepted
//   seams  (C, Zr, ny, P+1, nbx) the first node column of brick b > 0 (the
//                                x seam it shares with brick b - 1, whose
//                                part is in the tile)
// z has no seam: a block walks its whole z column and carries the plane
// shared by two cell layers in a register.
//
// Design.  The lattice is the prism kernel's case (csrc/prism.cu) with one
// patch and a per-cell J: one thread block per (x brick of XB cells, cell
// row ey, z chunk), which walks its z chunk in slabs of ZS cell layers.
//  - Sum factorization along every axis: a slab is evaluated along z
//    (E1), then x (E2), then y (E3, one thread per q-point, which then
//    runs the physics in registers); the test-function weights are
//    integrated back along y (I3), x (I2) and z (I1).  About 24 kFLOP per
//    cell, the function's count.  P is a template parameter (NQ = P + 1),
//    so the 1D tables and the short contractions live in registers.
//  - All components together: the E1 and E2 items take every component
//    of one field (u, u_lin, vec_old) through the contraction, the I3 and
//    I2 items all four test-function components; the items are split over
//    cell layers and node rows so that a slab still gives every thread
//    work.  I1 keeps one (component, node row, node) column per thread, for
//    its z carry.
//  - z in registers: in I1 a thread keeps the node plane shared by two cell
//    layers in a register, across slabs too, and writes finished planes to
//    the tile.  A z chunk that does not start the column first evaluates
//    the cell layer below it, for the carry only, and writes only its own
//    planes: the plane on a chunk seam gets both layers' parts in the order
//    of one walk, so the output does not depend on the chunking.
//  - Overlapped loads: the next slab's node planes and its cells'
//    geometry (the full J^-1, h, JxW: read once per cell) are copied to
//    shared memory with cp.async (double buffer) while this slab computes.
//  - The loops over a stage's items advance their indices as mixed-radix
//    digits (StridedDigits), with no runtime division per item; the
//    class-grouped y rows and the field pointers come from per-block
//    tables.
//  - The cell-wise delta needs the maximum of |u*|^2 over the cell's NQ^3
//    q-points before the physics: E3a gives each cell one warp, which
//    evaluates u* at the cell's q-points and reduces with shuffles.
//  - Exact f32 FMAs, no tensor cores, no atomics: two launches on the same
//    inputs give the same bits; the x seams are added by the caller in a
//    fixed order.
// The brick, slab and chunk sizes come from the caller (ops/structured.py
// brick_plan: the brick shape and z chunking of least estimated waves x
// slabs x slab time); the launcher refuses what does not fit.  Launch: 256
// threads, at most 128 registers (two blocks per SM), no spills; at the
// channel's finest level bricks of 8 cells, slabs of 2 layers (432
// q-points), 512 blocks of ~100 KB of shared memory.
//
// Measured (tools/structured_levels.py, device time by torch.profiler,
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6): 370.1 us at 128 x
// 32 x 32 cells of Q2 (the x-only design 1,328.4 us and the batched kernel
// 667.6 us in the same process), 7.9x the 47.0 us bound.  The kernel is bound by
// latency, not by its arithmetic: tools/structured_ablation.py times it
// with the slab copies or the physics taken out, and
// tools/structured_stage_clocks.py counts the cycles of each stage.  Tried
// and dropped (PERF.md): per-component items (no faster), 16-byte copies
// of aligned windows around the rows (slower: more index work per copy),
// the x and y contractions fused into one stage with float4 q-point values
// (slower: longer chains per item), 224 threads (slower).

// I1 columns (4 components x node rows x brick nodes) a thread may own
constexpr int kMaxCols3 = 2;

struct S3Dims {
  int nx, ny, nz;
  int XB;    // cells per brick along x (the last brick may hold fewer)
  int nbx;   // bricks per cell row
  int ZS;    // cell layers per slab
  int ZC;    // cell layers per z chunk
  int nzb;   // z chunks per column
};

// shared-memory regions of one block, in floats: the staged node planes
// and the cells' geometry (two buffers each), region 1 (A, Az -> W -> V),
// region 2 (X, XD, XZ -> Y) and the cells' max |u*|^2
struct S3Smem {
  size_t in, geo, r1, r2, cells;
  __host__ __device__ size_t total() const {
    return in + geo + r1 + r2 + cells;
  }
};

__host__ __device__ inline size_t s3_max(size_t a, size_t b) {
  return a > b ? a : b;
}

__host__ __device__ inline S3Smem s3_smem(int P, int XB, int ZS, int NF,
                                          int NG) {
  const size_t n1 = P + 1, NQ = P + 1;
  const size_t XN = (size_t)P * XB + 1, LX = NQ * XB;
  const size_t ZN = (size_t)P * ZS + 1, LZ = NQ * ZS;
  const size_t PL = n1 * XN;          // one node plane of the brick: (j, x)
  const size_t QS = LZ * NQ * LX;     // q-points per slab
  const size_t XF = LZ * n1 * LX;     // one field's X
  const size_t cells = (size_t)ZS * XB;
  return S3Smem{2 * NF * ZN * PL, 2 * cells * (11 + NQ * NQ * NQ),
                s3_max(s3_max((NF + NG) * LZ * PL, 16 * QS), 8 * LZ * PL),
                s3_max((NF + 2 * NG) * XF, 12 * XF), cells};
}

template <int P>
__global__ void __launch_bounds__(kThreads, 2)
structured3d_kernel(const float* __restrict__ u, const float* __restrict__ ul,
                    const float* __restrict__ vo,
                    const float* __restrict__ jinv,
                    const float* __restrict__ jxw,
                    const float* __restrict__ hcell,
                    const float* __restrict__ S1g,
                    const float* __restrict__ D1g, float* __restrict__ tiles,
                    float* __restrict__ seams, S3Dims dm, int flavor,
                    int consider_dt, int cell_wise, GlsScalars sc) {
  extern __shared__ float smem[];
  constexpr int n1 = P + 1, NQ = P + 1, NQ3 = NQ * NQ * NQ;
  const int nx = dm.nx, ny = dm.ny, nz = dm.nz, XB = dm.XB, ZS = dm.ZS;
  int blk = blockIdx.x;
  const int kz = blk % dm.nzb;
  blk /= dm.nzb;
  const int bx = blk % dm.nbx;
  const int ey = blk / dm.nbx;
  const int x0 = bx * XB;
  const int xb = min(XB, nx - x0);   // cells in this brick
  const int xn = P * xb + 1;         // its nodes along x
  const int Nx = P * nx + 1, Yr = P * ny + 1, Zr = P * nz + 1;
  const int XN = P * XB + 1, LX = NQ * XB, ZN = P * ZS + 1, LZ = NQ * ZS;
  const int PL = n1 * XN;
  const int QS = LZ * NQ * LX;
  const int XF = LZ * n1 * LX;
  const bool incr = flavor == GLS_INCREMENT;
  const int lead_ul = incr ? 4 : 3;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  const int NF = 4 + lead_ul + (need_dt_old ? 3 : 0);   // staged fields
  const int NG = incr ? 8 : 4;                         // fields with grads
  const int NK = need_dt_old ? 3 : 2;   // field kinds: u, u_lin, vec_old

  // the z chunk: owned layers [zb, ze), walked from lo (one layer below
  // zb when the chunk does not start the column)
  const int zb = kz * dm.ZC;
  const int ze = min(zb + dm.ZC, nz);
  const int lo = zb > 0 ? zb - 1 : 0;

  // 1D tables in registers
  float S1[NQ][n1], D1[NQ][n1];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < n1; ++i) {
      S1[q][i] = __ldg(S1g + q * n1 + i);
      D1[q][i] = __ldg(D1g + q * n1 + i);
    }

  const S3Smem sm = s3_smem(P, XB, ZS, NF, NG);
  const int GB = ZS * XB * (11 + NQ3);   // one geometry buffer
  float* sIn = smem;                     // (2, NF, ZN, n1, XN)
  float* sGeo = sIn + sm.in;             // (2, [ZS, XB, 9 | ZS, XB, 2 |
                                         //      ZS, XB, NQ^3])
  float* sA = sGeo + sm.geo;             // (NF, LZ, n1, XN)
  float* sAz = sA + NF * LZ * PL;        // (NG, LZ, n1, XN)
  float* sW = sA;                        // (4 kinds, 4 c, QS)
  float* sV = sA;                        // (4 c, 2, LZ, n1, XN)
  float* sX = sA + sm.r1;                // (NF, LZ, n1, LX)
  float* sXD = sX + NF * XF;             // (NG, LZ, n1, LX)
  float* sXZ = sXD + NG * XF;            // (NG, LZ, n1, LX)
  float* sY = sX;                        // (4 c, 3, LZ, n1, LX)
  float* scell = sX + sm.r2;             // (ZS, XB) max |u*|^2 per cell

  // the brick's first node of every staged field, and the class-grouped
  // offset of each node row j of cell row ey
  __shared__ const float* sField[11];
  __shared__ int sRow[n1];
  const size_t nn = (size_t)Nx * Yr * Zr;
  if (threadIdx.x < NF) {
    const int f = threadIdx.x;
    sField[f] = (f < 4 ? u + f * nn
                       : (f < 4 + lead_ul ? ul + (f - 4) * nn
                                          : vo + (f - 4 - lead_ul) * nn)) +
                P * x0;
  }
  if (threadIdx.x < n1)
    sRow[threadIdx.x] = cg_index(P, ny, ey, threadIdx.x) * Nx;
  __syncthreads();

  // the node copies of a slab: thread group tg (of n_grp) keeps one node
  // (row j, x) of the brick's planes and walks its share of the (plane,
  // field) pairs
  const int nrx = n1 * xn;
  const int n_grp = blockDim.x / nrx;
  const int tg = threadIdx.x / nrx;
  const int t_j = (threadIdx.x - tg * nrx) / xn;
  const int t_x = threadIdx.x - tg * nrx - t_j * xn;
  const int t_src = sRow[t_j] + t_x;
  const int YN = Yr * Nx;

  // copy the node planes and cell geometry of the slab starting at cell
  // layer zl0 into buffer buf (cp.async; the caller commits)
  auto stage = [&](int zl0, int zs, int buf) {
    const int zn = P * zs + 1;
    if (tg < n_grp) {
      float* dst0 = sIn + buf * NF * ZN * PL + t_j * XN + t_x;
      for (StridedDigits<2> e({zn, NF}, tg, n_grp); e.valid(); e.next()) {
        const int zl = e.d[0], f = e.d[1];
        cp_async4(dst0 + (f * ZN + zl) * PL,
                  sField[f] +
                      (cg_index(P, nz, zl0 + zl / P, zl % P) * YN + t_src));
      }
    }
    float* gJ = sGeo + buf * GB;
    float* gH = gJ + ZS * XB * 9;
    float* gQ = gH + ZS * XB * 2;
    const size_t c0 = ((size_t)zl0 * ny + ey) * nx + x0;
    const size_t lay = (size_t)ny * nx;   // cells per layer
    for (StridedDigits<2> e({xb * 9, zs}); e.valid(); e.next())
      cp_async4(gJ + e.d[1] * XB * 9 + e.d[0],
                jinv + (c0 + e.d[1] * lay) * 9 + e.d[0]);
    for (StridedDigits<2> e({xb * 2, zs}); e.valid(); e.next())
      cp_async4(gH + e.d[1] * XB * 2 + e.d[0],
                hcell + (c0 + e.d[1] * lay) * 2 + e.d[0]);
    for (StridedDigits<2> e({xb * NQ3, zs}); e.valid(); e.next())
      cp_async4(gQ + e.d[1] * XB * NQ3 + e.d[0],
                jxw + (c0 + e.d[1] * lay) * NQ3 + e.d[0]);
  };

  // the z carries of the I1 columns this thread owns, (c, j, x) =
  // threadIdx.x + k * blockDim.x, fixed for the whole walk
  const int n_cols = 4 * n1 * xn;
  float carry[kMaxCols3];
#pragma unroll
  for (int k = 0; k < kMaxCols3; ++k) carry[k] = 0.f;

  const int n_slabs = (ze - lo + ZS - 1) / ZS;
  stage(lo, min(ZS, ze - lo), 0);
  cp_async_commit();
  for (int s = 0; s < n_slabs; ++s) {
    const int zl0 = lo + s * ZS;
    const int zs = min(ZS, ze - zl0);   // cell layers in this slab
    const int lz = NQ * zs;             // q-point layers in this slab
    const int lx = NQ * xb;             // q-point columns of the brick
    if (s + 1 < n_slabs) {
      const int z1 = zl0 + ZS;
      stage(z1, min(ZS, ze - z1), (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sbuf = sIn + (s & 1) * NF * ZN * PL;
    const float* gJ = sGeo + (s & 1) * GB;
    const float* gH = gJ + ZS * XB * 9;
    const float* gQ = gH + ZS * XB * 2;

    // ---- E1: along z; items (node x, node row j, cell layer, field) ----
    for (StridedDigits<4> it({xn, n1, zs, NK}); it.valid(); it.next()) {
      const int xl = it.d[0], j = it.d[1], ezl = it.d[2], g = it.d[3];
      const int f0 = g == 0 ? 0 : (g == 1 ? 4 : 4 + lead_ul);
      const int nc = g == 0 ? 4 : (g == 1 ? lead_ul : 3);
      const bool grads = f0 < NG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nc) break;
        const int f = f0 + c;
        const float* col = sbuf + ((f * ZN + P * ezl) * n1 + j) * XN + xl;
        float nd[n1];
#pragma unroll
        for (int k = 0; k < n1; ++k) nd[k] = col[k * PL];
#pragma unroll
        for (int qz = 0; qz < NQ; ++qz) {
          float v = 0.f, d = 0.f;
#pragma unroll
          for (int k = 0; k < n1; ++k) {
            v = fmaf(S1[qz][k], nd[k], v);
            d = fmaf(D1[qz][k], nd[k], d);
          }
          const int o = ((f * LZ + ezl * NQ + qz) * n1 + j) * XN + xl;
          sA[o] = v;
          if (grads) sAz[o] = d;
        }
      }
    }
    __syncthreads();

    // ---- E2: along x; items (cell ex, node row j, q layer iz, field) ---
    for (StridedDigits<4> it({xb, n1, lz, NK}); it.valid(); it.next()) {
      const int ex = it.d[0], j = it.d[1], iz = it.d[2], g = it.d[3];
      const int f0 = g == 0 ? 0 : (g == 1 ? 4 : 4 + lead_ul);
      const int nc = g == 0 ? 4 : (g == 1 ? lead_ul : 3);
      const bool grads = f0 < NG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nc) break;
        const int f = f0 + c;
        const int a0 = ((f * LZ + iz) * n1 + j) * XN + P * ex;
        const int o = ((f * LZ + iz) * n1 + j) * LX + ex * NQ;
        float av[n1];
#pragma unroll
        for (int i = 0; i < n1; ++i) av[i] = sA[a0 + i];
#pragma unroll
        for (int qx = 0; qx < NQ; ++qx) {
          float v = 0.f;
#pragma unroll
          for (int i = 0; i < n1; ++i) v = fmaf(S1[qx][i], av[i], v);
          sX[o + qx] = v;
        }
        if (grads) {
          float zv[n1];
#pragma unroll
          for (int i = 0; i < n1; ++i) zv[i] = sAz[a0 + i];
#pragma unroll
          for (int qx = 0; qx < NQ; ++qx) {
            float dx = 0.f, dz = 0.f;
#pragma unroll
            for (int i = 0; i < n1; ++i) {
              dx = fmaf(D1[qx][i], av[i], dx);
              dz = fmaf(S1[qx][i], zv[i], dz);
            }
            sXD[o + qx] = dx;
            sXZ[o + qx] = dz;
          }
        }
      }
    }
    __syncthreads();

    // ---- E3a (cell-wise delta): max |u*|^2 over each cell's NQ^3
    // q-points, one warp per cell and a shuffle reduction -> scell
    if (cell_wise) {
      const int lane = threadIdx.x & 31;
      for (int w = threadIdx.x >> 5; w < zs * xb; w += blockDim.x >> 5) {
        const int ezl = w / xb, ex = w - ezl * xb;
        float m = 0.f;
        for (int t = lane; t < NQ3; t += 32) {
          const int qz = t / (NQ * NQ), qy = (t / NQ) % NQ, qx = t % NQ;
          const float* xr = sX + ((4 * LZ + ezl * NQ + qz) * n1) * LX +
                            ex * NQ + qx;
          float Sy[n1];
          table_row(S1, qy, Sy);
          float us = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float v = 0.f;
#pragma unroll
            for (int j = 0; j < n1; ++j)
              v = fmaf(Sy[j], xr[c * XF + j * LX], v);
            us = fmaf(v, v, us);
          }
          m = fmaxf(m, us);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0) scell[ezl * XB + ex] = m;
      }
      __syncthreads();
    }

    // q-point q of the slab: q = (iz * NQ + qy) * LX + ix
    // ---- E3b: along y, delta, physics, test-function weights ----------
    for (StridedDigits<3> it({lx, NQ, lz}); it.valid(); it.next()) {
      const int ix = it.d[0], qy = it.d[1], iz = it.d[2];
      const int q = (iz * NQ + qy) * LX + ix;
      const int ex = ix / NQ, qx = ix - ex * NQ;
      const int ezl = iz / NQ, qz = iz - ezl * NQ;
      // this q-point's row of the 1D tables
      float Sy[n1], Dy[n1];
      table_row(S1, qy, Sy);
      table_row(D1, qy, Dy);

      // value and reference gradients (x, y, z) of field f at this q-point
      auto eval = [&](int f, float& v, float (&gr)[3], bool grads) {
        const int o = (f * LZ + iz) * n1 * LX + ix;
        v = gr[0] = gr[1] = gr[2] = 0.f;
#pragma unroll
        for (int j = 0; j < n1; ++j) {
          const float xv = sX[o + j * LX];
          v = fmaf(Sy[j], xv, v);
          if (grads) {
            gr[0] = fmaf(Sy[j], sXD[o + j * LX], gr[0]);
            gr[1] = fmaf(Dy[j], xv, gr[1]);
            gr[2] = fmaf(Sy[j], sXZ[o + j * LX], gr[2]);
          }
        }
      };
      float uv[4], ud[4][3];
      float lv[4] = {0.f, 0.f, 0.f, 0.f};
      float ld[4][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f},
                        {0.f, 0.f, 0.f}};
      float dto[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 4; ++c) eval(c, uv[c], ud[c], true);
      if (incr) {
#pragma unroll
        for (int c = 0; c < 4; ++c) eval(4 + c, lv[c], ld[c], true);
      } else {
        float g3[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) eval(4 + c, lv[c], g3, false);
      }
      if (need_dt_old) {
        float g3[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) eval(4 + lead_ul + c, dto[c], g3, false);
      }

      // the cell's geometry, staged with the slab
      const int cl = ezl * XB + ex;
      float ji[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) ji[e] = gJ[cl * 9 + e];

      // stabilization parameters
      float d1, d2;
      if (cell_wise) {
        gls_delta_cell(sc, gH[cl * 2], scell[cl], d1, d2);
      } else {
        gls_delta_q(sc, gH[cl * 2 + 1],
                    lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2], d1, d2);
      }

      // reference -> physical gradients: g[x] = sum_r ref[r] * ji[r*3 + x]
      float ug[3][3], pg[3];
      float gus[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
      float gps[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int x = 0; x < 3; ++x) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float g = 0.f, gl = 0.f;
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            g += ud[a][r] * ji[r * 3 + x];
            gl += ld[a][r] * ji[r * 3 + x];
          }
          ug[a][x] = g;
          gus[a][x] = gl;
        }
        float g = 0.f, gl = 0.f;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          g += ud[3][r] * ji[r * 3 + x];
          gl += ld[3][r] * ji[r * 3 + x];
        }
        pg[x] = g;
        gps[x] = gl;
      }

      float vr[4], gr[4][3];
      const float uvel[3] = {uv[0], uv[1], uv[2]};
      const float us[3] = {lv[0], lv[1], lv[2]};
      gls_physics<3>(flavor, consider_dt != 0, need_dt_old, sc, uvel, ug,
                     uv[3], pg, us, gus, gps, dto, d1, d2, vr, gr);

      const float w = gQ[cl * NQ3 + qx + NQ * (qy + NQ * qz)];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sW[c * QS + q] = vr[c] * w;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          float g = 0.f;
#pragma unroll
          for (int x = 0; x < 3; ++x) g += gr[c][x] * ji[r * 3 + x];
          sW[((1 + r) * 4 + c) * QS + q] = g * w;
        }
      }
    }
    __syncthreads();

    // ---- I3: along y; items (q column ix, q layer iz) -> node rows j ---
    const int YS = LZ * n1 * LX;   // Y kinds: value -> x -> z
    for (StridedDigits<2> it({lx, lz}); it.valid(); it.next()) {
      const int ix = it.d[0], iz = it.d[1];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float wv[NQ], wx[NQ], wy[NQ], wz[NQ];
#pragma unroll
        for (int qy = 0; qy < NQ; ++qy) {
          const int q = (iz * NQ + qy) * LX + ix;
          wv[qy] = sW[c * QS + q];
          wx[qy] = sW[(4 + c) * QS + q];
          wy[qy] = sW[(8 + c) * QS + q];
          wz[qy] = sW[(12 + c) * QS + q];
        }
#pragma unroll
        for (int j = 0; j < n1; ++j) {
          float yv = 0.f, yx = 0.f, yz = 0.f;
#pragma unroll
          for (int qy = 0; qy < NQ; ++qy) {
            yv = fmaf(S1[qy][j], wv[qy], yv);
            yv = fmaf(D1[qy][j], wy[qy], yv);
            yx = fmaf(S1[qy][j], wx[qy], yx);
            yz = fmaf(S1[qy][j], wz[qy], yz);
          }
          const int o = ((c * 3 * LZ + iz) * n1 + j) * LX + ix;
          sY[o] = yv;
          sY[o + YS] = yx;
          sY[o + 2 * YS] = yz;
        }
      }
    }
    __syncthreads();

    // ---- I2: along x; items (cell ex, node row j, q layer iz) -> nodes
    // P*ex .. P*ex+P-1 (and P*xb for the brick's last cell); the left node
    // also takes cell ex-1's part
    const int VS = LZ * PL;        // V kinds: value -> z
    for (StridedDigits<3> it({xb, n1, lz}); it.valid(); it.next()) {
      const int ex = it.d[0], j = it.d[1], iz = it.d[2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = ((c * 3 * LZ + iz) * n1 + j) * LX + ex * NQ;
        float yv[NQ], yx[NQ], yz[NQ];
#pragma unroll
        for (int qx = 0; qx < NQ; ++qx) {
          yv[qx] = sY[o + qx];
          yx[qx] = sY[o + qx + YS];
          yz[qx] = sY[o + qx + 2 * YS];
        }
        float lv = 0.f, lzv = 0.f;   // cell ex-1 at its local node P
        if (ex > 0) {
#pragma unroll
          for (int qx = 0; qx < NQ; ++qx) {
            const int ol = o - NQ + qx;
            lv = fmaf(S1[qx][P], sY[ol], lv);
            lv = fmaf(D1[qx][P], sY[ol + YS], lv);
            lzv = fmaf(S1[qx][P], sY[ol + 2 * YS], lzv);
          }
        }
        float* vvp = sV + ((c * 2 * LZ + iz) * n1 + j) * XN + P * ex;
#pragma unroll
        for (int i = 0; i < n1; ++i) {
          if (i == P && ex != xb - 1) break;
          float vv = 0.f, vz = 0.f;
#pragma unroll
          for (int qx = 0; qx < NQ; ++qx) {
            vv = fmaf(S1[qx][i], yv[qx], vv);
            vv = fmaf(D1[qx][i], yx[qx], vv);
            vz = fmaf(S1[qx][i], yz[qx], vz);
          }
          if (i == 0) {
            vv = lv + vv;
            vz = lzv + vz;
          }
          vvp[i] = vv;
          vvp[i + VS] = vz;
        }
      }
    }
    __syncthreads();

    // ---- I1: along z, one column (c, j, x) per thread, carry in registers
#pragma unroll
    for (int k = 0; k < kMaxCols3; ++k) {
      const int it = threadIdx.x + k * blockDim.x;
      if (it < n_cols) {
        const int c = it / (n1 * xn);
        const int r = it - c * (n1 * xn);
        const int j = r / xn, xl = r - j * xn;
        const float* vvp = sV + ((c * 2 * LZ) * n1 + j) * XN + xl;
        // where plane `plane` goes: the tile, or the seam entry of the
        // brick's first node column
        auto put = [&](int plane, float v) {
          const size_t o =
              (((size_t)c * Zr + cg_index(P, nz, plane / P, plane % P)) * ny +
               ey) * n1 + j;
          if (xl == 0 && bx > 0) {
            seams[o * dm.nbx + bx] = v;
          } else {
            tiles[o * Nx + P * x0 + xl] = v;
          }
        };
        for (int ezl = 0; ezl < zs; ++ezl) {
          const int zg = zl0 + ezl;            // global cell layer
          float vv[NQ], vz[NQ];
#pragma unroll
          for (int qz = 0; qz < NQ; ++qz) {
            vv[qz] = vvp[(ezl * NQ + qz) * PL];
            vz[qz] = vvp[(ezl * NQ + qz) * PL + VS];
          }
#pragma unroll
          for (int kk = 0; kk <= P; ++kk) {
            float acc = 0.f;
#pragma unroll
            for (int qz = 0; qz < NQ; ++qz) {
              acc = fmaf(S1[qz][kk], vv[qz], acc);
              acc = fmaf(D1[qz][kk], vz[qz], acc);
            }
            if (kk == 0) {
              acc += carry[k];
              if (zg >= zb) put(P * zg, acc);
            } else if (kk < P) {
              if (zg >= zb) put(P * zg + kk, acc);
            } else {
              carry[k] = acc;
            }
          }
        }
        if (s == n_slabs - 1 && ze == nz) put(P * nz, carry[k]);
      }
    }
    // the next iteration's barrier orders I1's reads of sV before E1
    // rewrites that region
  }
}

// ===========================================================================
// structured2d_kernel<P>: the 2D sweep, sum-factorized along y and x
// ===========================================================================
//
// Output (ops/structured.py fold_seams_2d adds the seams in place):
//   out    (C, Yr, 1, Nx)  the lattice itself (class-grouped y): every node
//                          complete but the x seams between bricks
//   seams  (C, Yr, nbx)    the first node column of brick b > 0 (the x
//                          seam it shares with brick b - 1, whose part is
//                          in out)
// y has no seam and there are no cell-row tiles: a block walks its y chunk
// and carries the node row shared by two cell rows in a register.
//
// Design.  The 3D kernel's design with one axis fewer: one thread block per
// (x brick of XB cells, y chunk of YC cell rows), which walks its chunk in
// slabs of YS cell rows.
//  - Sum factorization along both axes: a slab is evaluated along y (E1:
//    an item takes every component of one field, u, u_lin or vec_old,
//    through the (P+1) -> NQ contraction of one node column), then along x
//    by one thread per q-point, which goes on to the physics in registers
//    (E2); the test-function weights are integrated back along x (I2, an
//    item per cell, q-row and component: the three test-function kinds
//    together) and along y (I1).  P is a template parameter (NQ = P + 1),
//    so the 1D tables and the (P+1)-term sums live in registers.
//  - y in registers: in I1 a thread keeps one (component, node column) for
//    the whole walk, and the node row shared by two cell rows in a register
//    across slabs; finished rows go straight into the lattice at their
//    class-grouped y.  A y chunk that does not start at row 0 first
//    evaluates the cell row below it, for the carry only, and writes only
//    its own rows: the row on a chunk seam gets both cell rows' parts in
//    the order of one walk, so the output does not depend on the chunking.
//  - Overlapped loads: the next slab's node rows of every field and its
//    cells' geometry (J^-1 4, h 2 and JxW NQ^2 floats, read once per cell)
//    are copied to shared memory with cp.async (double buffer) while this
//    slab computes.  Four barriers per slab.
//  - E2 gives a warp whole cells (32 / NQ^2 of them, each cell's q-points on
//    consecutive lanes; up to four passes a slab), so the cell-wise delta's
//    max of |u*|^2 over the cell's q-points is a shuffle among those lanes:
//    no barrier, no second evaluation.
//  - Loop indices advance as mixed-radix digits (StridedDigits); a
//    thread's q-point, I1 columns and copy column are fixed for the walk.
//  - Exact f32 FMAs, no tensor cores, no atomics.
// What bounds the function on an H100 at the channel's finest 2D level
// (1024 x 256 cells of Q2, increment flavor with the history;
// utils/roofline.py structured_cost): bytes, 62 MB -> 18.5 us at 3.35 TB/s,
// against 0.94 GFLOP -> 14 us at 67 TFLOP/s f32.  The kernel reads each
// node row once per slab that holds it (the row shared by two slabs twice),
// each cell's geometry once, and writes every node once, close to that
// count; like the 3D kernel it is bound by latency, so the plan
// (ops/structured.py slab_plan_2d: brick, slab and y chunking of least
// estimated waves x slabs x slab time) keeps every block's walk short
// while the blocks fill the card.  The launcher refuses what does not fit.
// Launch: 256 threads, at most 128 registers (two blocks per SM); at the
// channel's finest level bricks of 12 cells, slabs of 8 rows (864
// q-points), 3 y chunks: 258 blocks of 103,424 B of shared memory, 128
// registers and no spills at P = 2.
//
// Measured (tools/structured_levels.py --dim 2, device time by
// torch.profiler, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6):
// 114.5 us at 1024 x 256 cells of Q2 (the x-only design with cell-row
// tiles 510.0 us in the same process), 6.2x the 18.5 us bound; the sweep
// with its seam add 119.0 us (527.8 with the tiles' fold).  Tried and
// dropped (PERF.md): three blocks per SM (80 registers, spills; slower),
// the 1D tables in shared memory (slower), E2 limited to two passes (slabs
// of 48 cells; 8% slower than four), E2's pass loop unrolled (slower).

// I1 columns (3 components x brick nodes) a thread may own
constexpr int kMaxCols2 = 2;
// passes of E2 over a slab's cells (each warp takes 32 / NQ^2 cells a pass)
constexpr int kMaxPass2 = 4;

struct S2Dims {
  int nx, ny;
  int XB;    // cells per brick along x (the last brick may hold fewer)
  int nbx;   // bricks per cell row
  int YS;    // cell rows per slab
  int YC;    // cell rows per y chunk
};

// shared-memory regions of one block, in floats: the staged node rows and
// the cells' geometry (two buffers each), the y-contracted fields (A, Ay;
// then the x adjoint V) and the test-function weights W
struct S2Smem {
  size_t in, geo, a, w;
  __host__ __device__ size_t total() const { return in + geo + a + w; }
};

__host__ __device__ inline S2Smem s2_smem(int P, int XB, int YS, int NF,
                                          int NG) {
  const size_t NQ = P + 1;
  const size_t XN = (size_t)P * XB + 1, LX = NQ * XB;
  const size_t YN = (size_t)P * YS + 1, LY = NQ * YS;
  const size_t cells = (size_t)YS * XB;
  return S2Smem{2 * NF * YN * XN, 2 * cells * (6 + NQ * NQ),
                s3_max((NF + NG) * LY * XN, 6 * LY * XN), 9 * LY * LX};
}

template <int P>
__global__ void __launch_bounds__(kThreads, 2)
structured2d_kernel(const float* __restrict__ u, const float* __restrict__ ul,
                    const float* __restrict__ vo,
                    const float* __restrict__ jinv,
                    const float* __restrict__ jxw,
                    const float* __restrict__ hcell,
                    const float* __restrict__ S1g,
                    const float* __restrict__ D1g, float* __restrict__ out,
                    float* __restrict__ seams, S2Dims dm, int flavor,
                    int consider_dt, int cell_wise, GlsScalars sc) {
  extern __shared__ float smem[];
  constexpr int n1 = P + 1, NQ = P + 1, NQ2 = NQ * NQ;
  constexpr int CPW = 32 / NQ2;   // cells per warp in E2
  const int nx = dm.nx, ny = dm.ny, XB = dm.XB, YS = dm.YS;
  const int bx = blockIdx.x % dm.nbx;
  const int ky = blockIdx.x / dm.nbx;
  const int x0 = bx * XB;
  const int xb = min(XB, nx - x0);   // cells in this brick
  const int xn = P * xb + 1;         // its nodes along x
  const int Nx = P * nx + 1, Yr = P * ny + 1;
  const int XN = P * XB + 1, LX = NQ * XB, YN = P * YS + 1, LY = NQ * YS;
  const int QS = LY * LX;            // q-points of a slab (at most)
  const int AF = LY * XN;            // one field's A
  const bool incr = flavor == GLS_INCREMENT;
  const int lead_ul = incr ? 3 : 2;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  const int NF = 3 + lead_ul + (need_dt_old ? 2 : 0);   // staged fields
  const int NG = incr ? 6 : 3;                         // fields with grads
  const int NK = need_dt_old ? 3 : 2;   // field kinds: u, u_lin, vec_old

  // the y chunk: owned cell rows [yb, ye), walked from lo (one row below
  // yb when the chunk does not start at row 0)
  const int yb = ky * dm.YC;
  const int ye = min(yb + dm.YC, ny);
  const int lo = yb > 0 ? yb - 1 : 0;

  // 1D tables in registers
  float S1[NQ][n1], D1[NQ][n1];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < n1; ++i) {
      S1[q][i] = __ldg(S1g + q * n1 + i);
      D1[q][i] = __ldg(D1g + q * n1 + i);
    }

  const S2Smem sm = s2_smem(P, XB, YS, NF, NG);
  const int GB = YS * XB * (6 + NQ2);   // one geometry buffer
  float* sIn = smem;                    // (2, NF, YN, XN)
  float* sGeo = sIn + sm.in;            // (2, [YS, XB, 4 | YS, XB, 2 |
                                        //      YS, XB, NQ^2])
  float* sA = sGeo + sm.geo;            // (NF, LY, XN) values along y
  float* sAy = sA + NF * AF;            // (NG, LY, XN) y-derivatives
  float* sV = sA;                       // (3 c, 2, LY, XN) x adjoint:
                                        //   value -> y
  float* sW = sA + sm.a;                // (3 kinds, 3 c, QS) weights:
                                        //   value, d/dxi_x, d/dxi_y

  // the brick's first node of every staged field
  __shared__ const float* sField[8];
  const size_t nn = (size_t)Nx * Yr;
  if (threadIdx.x < NF) {
    const int f = threadIdx.x;
    sField[f] = (f < 3 ? u + f * nn
                       : (f < 3 + lead_ul ? ul + (f - 3) * nn
                                          : vo + (f - 3 - lead_ul) * nn)) +
                P * x0;
  }
  __syncthreads();

  // the node copies of a slab: thread group tg (of n_grp) keeps node column
  // t_x of the brick and walks its share of the (node row, field) pairs
  const int n_grp = blockDim.x / xn;
  const int tg = threadIdx.x / xn;
  const int t_x = threadIdx.x - tg * xn;

  // copy the node rows and cell geometry of the slab starting at cell row
  // y0 into buffer buf (cp.async; the caller commits)
  auto stage = [&](int y0, int ys, int buf) {
    const int yn = P * ys + 1;
    if (tg < n_grp) {
      float* dst0 = sIn + buf * NF * YN * XN + t_x;
      for (StridedDigits<2> e({yn, NF}, tg, n_grp); e.valid(); e.next()) {
        const int r = e.d[0], f = e.d[1];
        cp_async4(dst0 + (f * YN + r) * XN,
                  sField[f] + (cg_index(P, ny, y0 + r / P, r % P) * Nx + t_x));
      }
    }
    float* gJ = sGeo + buf * GB;
    float* gH = gJ + YS * XB * 4;
    float* gQ = gH + YS * XB * 2;
    const size_t c0 = (size_t)y0 * nx + x0;
    for (StridedDigits<2> e({xb * 4, ys}); e.valid(); e.next())
      cp_async4(gJ + e.d[1] * XB * 4 + e.d[0],
                jinv + (c0 + (size_t)e.d[1] * nx) * 4 + e.d[0]);
    for (StridedDigits<2> e({xb * 2, ys}); e.valid(); e.next())
      cp_async4(gH + e.d[1] * XB * 2 + e.d[0],
                hcell + (c0 + (size_t)e.d[1] * nx) * 2 + e.d[0]);
    for (StridedDigits<2> e({xb * NQ2, ys}); e.valid(); e.next())
      cp_async4(gQ + e.d[1] * XB * NQ2 + e.d[0],
                jxw + (c0 + (size_t)e.d[1] * nx) * NQ2 + e.d[0]);
  };

  // E2: this thread's q-point (qx, qy) of the cell cw of its warp's group,
  // and its rows of the 1D tables along x
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int cw = lane / NQ2;
  const int qxy = lane - cw * NQ2;
  const int qx = qxy % NQ, qy = qxy / NQ;
  float Sx[n1], Dx[n1];
  table_row(S1, qx, Sx);
  table_row(D1, qx, Dx);

  // I1: the (component, node column) = threadIdx.x + k * blockDim.x this
  // thread owns (c = 3: none), and their y carries
  int col_c[kMaxCols2], col_x[kMaxCols2];
  float carry[kMaxCols2];
#pragma unroll
  for (int k = 0; k < kMaxCols2; ++k) {
    const int it = threadIdx.x + k * blockDim.x;
    col_c[k] = it < 3 * xn ? it / xn : 3;
    col_x[k] = it - col_c[k] * xn;
    carry[k] = 0.f;
  }
  // where node row `row` (class-grouped) of column (c, xl) goes: the
  // lattice, or the seam entry of the brick's first node column
  auto put = [&](int c, int xl, int row, float v) {
    const size_t o = (size_t)c * Yr + row;
    if (xl == 0 && bx > 0) {
      seams[o * dm.nbx + bx] = v;
    } else {
      out[o * Nx + P * x0 + xl] = v;
    }
  };

  const int n_slabs = (ye - lo + YS - 1) / YS;
  stage(lo, min(YS, ye - lo), 0);
  cp_async_commit();
  for (int s = 0; s < n_slabs; ++s) {
    const int y0 = lo + s * YS;
    const int ys = min(YS, ye - y0);   // cell rows in this slab
    const int ly = NQ * ys;            // q-point rows in this slab
    if (s + 1 < n_slabs) {
      const int y1 = y0 + YS;
      stage(y1, min(YS, ye - y1), (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sbuf = sIn + (s & 1) * NF * YN * XN;
    const float* gJ = sGeo + (s & 1) * GB;
    const float* gH = gJ + YS * XB * 4;
    const float* gQ = gH + YS * XB * 2;

    // ---- E1: along y; items (node x, cell row, field) ------------------
    for (StridedDigits<3> it({xn, ys, NK}); it.valid(); it.next()) {
      const int xl = it.d[0], eyl = it.d[1], g = it.d[2];
      const int f0 = g == 0 ? 0 : (g == 1 ? 3 : 3 + lead_ul);
      const int nc = g == 0 ? 3 : (g == 1 ? lead_ul : 2);
      const bool grads = f0 < NG;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c >= nc) break;
        const int f = f0 + c;
        const float* col = sbuf + (f * YN + P * eyl) * XN + xl;
        float nd[n1];
#pragma unroll
        for (int k = 0; k < n1; ++k) nd[k] = col[k * XN];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float v = 0.f, d = 0.f;
#pragma unroll
          for (int k = 0; k < n1; ++k) {
            v = fmaf(S1[q][k], nd[k], v);
            d = fmaf(D1[q][k], nd[k], d);
          }
          const int o = (f * LY + eyl * NQ + q) * XN + xl;
          sA[o] = v;
          if (grads) sAy[o] = d;
        }
      }
    }
    __syncthreads();

    // ---- E2: along x, delta, physics, test-function weights; a warp
    // takes CPW cells a pass, one q-point per lane (lanes past CPW * NQ2,
    // and cells past the slab's, compute cell 0 and write nothing)
    const int n_cells = ys * xb;
#pragma unroll 1
    for (int pass = 0; pass < kMaxPass2; ++pass) {
      const int grp = warp + pass * n_warps;   // warp-uniform
      if (grp * CPW >= n_cells) break;
      const int cl_lin = grp * CPW + cw;
      const bool valid = cw < CPW && cl_lin < n_cells;
      const int cll = valid ? cl_lin : 0;
      const int eyl = cll / xb, ex = cll - eyl * xb;
      const int ix = ex * NQ + qx, iy = eyl * NQ + qy;
      const int ao = iy * XN + P * ex;

      // value and reference gradients (x, y) of field f at this q-point
      auto eval = [&](int f, float& v, float (&gr)[2], bool grads) {
        const float* a = sA + f * AF + ao;
        float av[n1];
#pragma unroll
        for (int i = 0; i < n1; ++i) av[i] = a[i];
        v = 0.f;
#pragma unroll
        for (int i = 0; i < n1; ++i) v = fmaf(Sx[i], av[i], v);
        if (grads) {
          const float* ay = sAy + f * AF + ao;
          gr[0] = gr[1] = 0.f;
#pragma unroll
          for (int i = 0; i < n1; ++i) {
            gr[0] = fmaf(Dx[i], av[i], gr[0]);
            gr[1] = fmaf(Sx[i], ay[i], gr[1]);
          }
        }
      };
      float uv[3], ud[3][2];
      float lv[3] = {0.f, 0.f, 0.f};
      float ld[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      float dto[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 3; ++c) eval(c, uv[c], ud[c], true);
      if (incr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) eval(3 + c, lv[c], ld[c], true);
      } else {
        float g2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) eval(3 + c, lv[c], g2, false);
      }
      if (need_dt_old) {
        float g2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) eval(3 + lead_ul + c, dto[c], g2, false);
      }

      // the cell's geometry, staged with the slab
      const int cl = eyl * XB + ex;
      float ji[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ji[e] = gJ[cl * 4 + e];

      // stabilization parameters; cell-wise: the max of |u*|^2 over the
      // cell's NQ2 lanes
      const float usq = lv[0] * lv[0] + lv[1] * lv[1];
      float d1, d2;
      if (cell_wise) {
        const float m = valid ? usq : 0.f;
        const int base = cw * NQ2;
        float msq = 0.f;
#pragma unroll
        for (int k = 0; k < NQ2; ++k)
          msq = fmaxf(msq, __shfl_sync(0xffffffffu, m, base + k));
        gls_delta_cell(sc, gH[cl * 2], msq, d1, d2);
      } else {
        gls_delta_q(sc, gH[cl * 2 + 1], usq, d1, d2);
      }

      // reference -> physical gradients: g[x] = sum_r ref[r] * ji[r*2 + x]
      float ug[2][2], pg[2];
      float gus[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      float gps[2] = {0.f, 0.f};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          ug[a][x] = ud[a][0] * ji[x] + ud[a][1] * ji[2 + x];
          gus[a][x] = ld[a][0] * ji[x] + ld[a][1] * ji[2 + x];
        }
        pg[x] = ud[2][0] * ji[x] + ud[2][1] * ji[2 + x];
        gps[x] = ld[2][0] * ji[x] + ld[2][1] * ji[2 + x];
      }

      float vr[3], gr[3][2];
      const float uvel[2] = {uv[0], uv[1]};
      const float us[2] = {lv[0], lv[1]};
      gls_physics<2>(flavor, consider_dt != 0, need_dt_old, sc, uvel, ug,
                     uv[2], pg, us, gus, gps, dto, d1, d2, vr, gr);

      if (valid) {
        const float w = gQ[cl * NQ2 + qxy];
        const int q = iy * LX + ix;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sW[c * QS + q] = vr[c] * w;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            sW[((1 + r) * 3 + c) * QS + q] =
                (gr[c][0] * ji[r * 2] + gr[c][1] * ji[r * 2 + 1]) * w;
        }
      }
    }
    __syncthreads();

    // ---- I2: along x; items (cell ex, q-row iy, component c) -> nodes
    // P*ex .. P*ex+P-1 (and P*xb for the brick's last cell); the left node
    // also takes cell ex-1's part
    const int VS = LY * XN;   // V kinds: value -> y
    for (StridedDigits<3> it({xb, ly, 3}); it.valid(); it.next()) {
      const int ex = it.d[0], iy = it.d[1], c = it.d[2];
      const int o = c * QS + iy * LX + ex * NQ;
      float wv[NQ], wx[NQ], wy[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        wv[q] = sW[o + q];
        wx[q] = sW[o + 3 * QS + q];
        wy[q] = sW[o + 6 * QS + q];
      }
      float lv = 0.f, lyv = 0.f;   // cell ex-1 at its local node P
      if (ex > 0) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int ol = o - NQ + q;
          lv = fmaf(S1[q][P], sW[ol], lv);
          lv = fmaf(D1[q][P], sW[ol + 3 * QS], lv);
          lyv = fmaf(S1[q][P], sW[ol + 6 * QS], lyv);
        }
      }
      float* vvp = sV + (c * 2 * LY + iy) * XN + P * ex;
#pragma unroll
      for (int i = 0; i < n1; ++i) {
        if (i == P && ex != xb - 1) break;
        float vv = 0.f, vy = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          vv = fmaf(S1[q][i], wv[q], vv);
          vv = fmaf(D1[q][i], wx[q], vv);
          vy = fmaf(S1[q][i], wy[q], vy);
        }
        if (i == 0) {
          vv = lv + vv;
          vy = lyv + vy;
        }
        vvp[i] = vv;
        vvp[i + VS] = vy;
      }
    }
    __syncthreads();

    // ---- I1: along y, one column (c, x) per thread, carry in registers
#pragma unroll
    for (int k = 0; k < kMaxCols2; ++k) {
      const int c = col_c[k], xl = col_x[k];
      if (c < 3) {
        const float* vvp = sV + (c * 2 * LY) * XN + xl;
        for (int eyl = 0; eyl < ys; ++eyl) {
          const int eg = y0 + eyl;   // global cell row
          float vv[NQ], vy[NQ];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            vv[q] = vvp[(eyl * NQ + q) * XN];
            vy[q] = vvp[(eyl * NQ + q) * XN + VS];
          }
#pragma unroll
          for (int kk = 0; kk <= P; ++kk) {
            float acc = 0.f;
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              acc = fmaf(S1[q][kk], vv[q], acc);
              acc = fmaf(D1[q][kk], vy[q], acc);
            }
            if (kk == 0) {
              acc += carry[k];
              if (eg >= yb) put(c, xl, cg_index(P, ny, eg, 0), acc);
            } else if (kk < P) {
              if (eg >= yb) put(c, xl, cg_index(P, ny, eg, kk), acc);
            } else {
              carry[k] = acc;
            }
          }
        }
      }
    }
    // the next iteration's barrier orders I1's reads of sV before E1
    // rewrites that region
  }
  // the lattice's top node row, when this chunk ends the lattice
  if (ye == ny) {
#pragma unroll
    for (int k = 0; k < kMaxCols2; ++k)
      if (col_c[k] < 3)
        put(col_c[k], col_x[k], cg_index(P, ny, ny - 1, P), carry[k]);
  }
}

int ipow_host(int b, int e) {
  int r = 1;
  for (int i = 0; i < e; ++i) r *= b;
  return r;
}

}  // namespace

// ---- host side: the launchers (the host C++ rehearsal of the kernel
// bodies runs its own) ----------------------------------------------------
#ifndef SWEEP_HOST_REHEARSAL
namespace {

// The launcher of structured3d_kernel<P>: validates the plan, sets the
// kernel's dynamic shared-memory limit once, launches.
template <int P>
int launch3d(const float* u, const float* ul, const float* vo,
             const float* jinv, const float* jxw, const float* h,
             const float* S1, const float* D1, float* tiles, float* seams,
             int nx, int ny, int nz, int flavor, int consider_dt,
             int cell_wise, GlsScalars sc, int XB, int ZS, int nzb,
             cudaStream_t stream) {
  if (nx < 1 || ny < 1 || nz < 1 || XB < 1 || ZS < 1 || nzb < 1 ||
      nzb > nz)
    return (int)cudaErrorInvalidValue;
  if (4 * (P + 1) * (P * XB + 1) > kMaxCols3 * kThreads)
    return (int)cudaErrorInvalidValue;
  // node offsets inside one field are 32-bit
  const size_t nn = (size_t)(P * nx + 1) * (P * ny + 1) * (P * nz + 1);
  if (nn > (size_t)0x7fffffff) return (int)cudaErrorInvalidValue;
  const int ZC = (nz + nzb - 1) / nzb;
  if ((nzb - 1) * ZC >= nz) return (int)cudaErrorInvalidValue;
  const int nbx = (nx + XB - 1) / XB;
  const bool incr = flavor == GLS_INCREMENT;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  const int NF = 4 + (incr ? 4 : 3) + (need_dt_old ? 3 : 0);
  const int NG = incr ? 8 : 4;
  const size_t bytes = s3_smem(P, XB, ZS, NF, NG).total() * sizeof(float);
  static int max_optin = 0;
  static size_t attr_bytes = 0;
  cudaError_t err;
  if (max_optin == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // (the field pointer and row tables are static shared memory beside it)
  if (bytes + 11 * sizeof(float*) + (P + 1) * sizeof(int) > (size_t)max_optin)
    return (int)cudaErrorInvalidValue;
  if (bytes > attr_bytes) {
    err = cudaFuncSetAttribute(structured3d_kernel<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = bytes;
  }
  S3Dims dm{nx, ny, nz, XB, nbx, ZS, ZC, nzb};
  structured3d_kernel<P><<<nbx * ny * nzb, kThreads, bytes, stream>>>(
      u, ul, vo, jinv, jxw, h, S1, D1, tiles, seams, dm, flavor, consider_dt,
      cell_wise, sc);
  return (int)cudaGetLastError();
}

// The launcher of structured2d_kernel<P>: validates the plan, sets the
// kernel's dynamic shared-memory limit once, launches.
template <int P>
int launch2d(const float* u, const float* ul, const float* vo,
             const float* jinv, const float* jxw, const float* h,
             const float* S1, const float* D1, float* out, float* seams,
             int nx, int ny, int flavor, int consider_dt, int cell_wise,
             GlsScalars sc, int XB, int YS, int nyb, cudaStream_t stream) {
  if (nx < 1 || ny < 1 || XB < 1 || YS < 1 || nyb < 1 || nyb > ny)
    return (int)cudaErrorInvalidValue;
  // I1 columns and E2 passes per thread
  if (3 * (P * XB + 1) > kMaxCols2 * kThreads)
    return (int)cudaErrorInvalidValue;
  const int cpw = 32 / ((P + 1) * (P + 1));
  if ((YS * XB + cpw - 1) / cpw > kMaxPass2 * (kThreads / 32))
    return (int)cudaErrorInvalidValue;
  // node offsets inside one field are 32-bit
  const size_t nn = (size_t)(P * nx + 1) * (P * ny + 1);
  if (nn > (size_t)0x7fffffff) return (int)cudaErrorInvalidValue;
  const int YC = (ny + nyb - 1) / nyb;
  if ((nyb - 1) * YC >= ny) return (int)cudaErrorInvalidValue;
  const int nbx = (nx + XB - 1) / XB;
  const bool incr = flavor == GLS_INCREMENT;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  const int NF = 3 + (incr ? 3 : 2) + (need_dt_old ? 2 : 0);
  const size_t bytes =
      s2_smem(P, XB, YS, NF, incr ? 6 : 3).total() * sizeof(float);
  static int max_optin = 0;
  static size_t attr_bytes = 0;
  cudaError_t err;
  if (max_optin == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // (the field pointer table is static shared memory beside it)
  if (bytes + 8 * sizeof(float*) > (size_t)max_optin)
    return (int)cudaErrorInvalidValue;
  if (bytes > attr_bytes) {
    err = cudaFuncSetAttribute(structured2d_kernel<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = bytes;
  }
  S2Dims dm{nx, ny, XB, nbx, YS, YC};
  structured2d_kernel<P><<<nbx * nyb, kThreads, bytes, stream>>>(
      u, ul, vo, jinv, jxw, h, S1, D1, out, seams, dm, flavor, consider_dt,
      cell_wise, sc);
  return (int)cudaGetLastError();
}

}  // namespace


// ---- host launchers (plain C interface, bound with ctypes) ------------
// The batched 3D kernel, any degree.  Returns 0, a CUDA error code, or 1
// (cudaErrorInvalidValue) when the chunk's tiles exceed the card's shared
// memory per block.
extern "C" int structured3d_batched_launch(
    const float* u, const float* ul, const float* vo, const float* jinv,
    const float* jxw, const float* h, const float* S1, const float* D1,
    float* out, int P, int NQ, int nx, int ny, int nz, int flavor,
    int consider_dt, int cell_wise, float weight, float stau, float nu,
    float c1, float c2, void* stream) {
  constexpr int dim = 3;
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

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(structured3d_batched_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_rows == 0 || nx == 0) return 0;
  GlsScalars sc{weight, stau, nu, c1, c2};
  SDims dm{P, NQ, nx, ny, nz, XS, nseg, seg_cells};
  structured3d_batched_kernel<<<nseg * n_rows, kThreads, bytes,
                                (cudaStream_t)stream>>>(
      u, ul, vo, jinv, jxw, h, S1, D1, out, dm, flavor, consider_dt,
      cell_wise, sc);
  return (int)cudaGetLastError();
}

// The 2D kernel, degrees 1-4 with NQ = P + 1 Gauss points: xb cells per
// brick, ys cell rows per slab, nyb y chunks (ops/structured.py
// slab_plan_2d).  out (3, Yr, 1, Nx), seams (3, Yr, nbx).  Returns 0, a
// CUDA error code, or 1 (cudaErrorInvalidValue) for a degree, plan or shape
// it does not take.
extern "C" int structured2d_launch(
    const float* u, const float* ul, const float* vo, const float* jinv,
    const float* jxw, const float* h, const float* S1, const float* D1,
    float* out, float* seams, int P, int NQ, int nx, int ny, int flavor,
    int consider_dt, int cell_wise, float weight, float stau, float nu,
    float c1, float c2, int xb, int ys, int nyb, void* stream) {
  GlsScalars sc{weight, stau, nu, c1, c2};
  cudaStream_t st = (cudaStream_t)stream;
#define S2_CASE(PP)                                                        \
  if (P == PP && NQ == PP + 1)                                             \
    return launch2d<PP>(u, ul, vo, jinv, jxw, h, S1, D1, out, seams, nx,   \
                        ny, flavor, consider_dt, cell_wise, sc, xb, ys,    \
                        nyb, st);
  S2_CASE(1)
  S2_CASE(2)
  S2_CASE(3)
  S2_CASE(4)
#undef S2_CASE
  return (int)cudaErrorInvalidValue;
}

// What the compiler gave structured2d_kernel<P>: registers per thread,
// local memory (spills) and static shared memory per thread block in
// bytes; and the dynamic shared memory of one block in bytes for bricks of
// xb cells, slabs of ys rows and the flavor's fields.  Returns 0 or a CUDA
// error code.
extern "C" int structured2d_attributes(int P, int xb, int ys, int flavor,
                                       int consider_dt, int* regs,
                                       int* local_bytes, int* static_smem,
                                       long long* dynamic_smem) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaErrorInvalidValue;
  if (P == 1) err = cudaFuncGetAttributes(&a, structured2d_kernel<1>);
  if (P == 2) err = cudaFuncGetAttributes(&a, structured2d_kernel<2>);
  if (P == 3) err = cudaFuncGetAttributes(&a, structured2d_kernel<3>);
  if (P == 4) err = cudaFuncGetAttributes(&a, structured2d_kernel<4>);
  if (err != cudaSuccess) return (int)err;
  const bool incr = flavor == GLS_INCREMENT;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  const int NF = 3 + (incr ? 3 : 2) + (need_dt_old ? 2 : 0);
  *dynamic_smem = (long long)(s2_smem(P, xb, ys, NF, incr ? 6 : 3).total() *
                              sizeof(float));
  return 0;
}

// The 3D kernel, degrees 1-4 with NQ = P + 1 Gauss points: xb cells per
// brick, zs cell layers per slab, nzb z chunks per column (ops/
// structured.py brick_plan).  Returns 0, a CUDA error code, or 1
// (cudaErrorInvalidValue) for a degree, plan or shape it does not take.
extern "C" int structured3d_launch(
    const float* u, const float* ul, const float* vo, const float* jinv,
    const float* jxw, const float* h, const float* S1, const float* D1,
    float* tiles, float* seams, int P, int NQ, int nx, int ny, int nz,
    int flavor, int consider_dt, int cell_wise, float weight, float stau,
    float nu, float c1, float c2, int xb, int zs, int nzb, void* stream) {
  GlsScalars sc{weight, stau, nu, c1, c2};
  cudaStream_t st = (cudaStream_t)stream;
#define S3_CASE(PP)                                                        \
  if (P == PP && NQ == PP + 1)                                             \
    return launch3d<PP>(u, ul, vo, jinv, jxw, h, S1, D1, tiles, seams, nx, \
                        ny, nz, flavor, consider_dt, cell_wise, sc, xb, zs, \
                        nzb, st);
  S3_CASE(1)
  S3_CASE(2)
  S3_CASE(3)
  S3_CASE(4)
#undef S3_CASE
  return (int)cudaErrorInvalidValue;
}

// What the compiler gave structured3d_kernel<P>: registers per thread,
// local memory (spills) and static shared memory per thread block in
// bytes; and the dynamic shared memory of one block in bytes for a brick
// of xb cells, slabs of zs layers and the flavor's fields.  Returns 0 or a
// CUDA error code.
extern "C" int structured3d_attributes(int P, int xb, int zs, int flavor,
                                       int consider_dt, int* regs,
                                       int* local_bytes, int* static_smem,
                                       long long* dynamic_smem) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaErrorInvalidValue;
  if (P == 1) err = cudaFuncGetAttributes(&a, structured3d_kernel<1>);
  if (P == 2) err = cudaFuncGetAttributes(&a, structured3d_kernel<2>);
  if (P == 3) err = cudaFuncGetAttributes(&a, structured3d_kernel<3>);
  if (P == 4) err = cudaFuncGetAttributes(&a, structured3d_kernel<4>);
  if (err != cudaSuccess) return (int)err;
  const bool incr = flavor == GLS_INCREMENT;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  const int NF = 4 + (incr ? 4 : 3) + (need_dt_old ? 3 : 0);
  *dynamic_smem =
      (long long)(s3_smem(P, xb, zs, NF, incr ? 8 : 4).total() * sizeof(float));
  return 0;
}
#endif  // SWEEP_HOST_REHEARSAL
