// Fused structured-lattice GLS sweeps for Hopper (sm_90a): 2D, 3D, and the
// 3D variant that contracts all components together.
//
// Replaces the TPU kernels of ns_gls_tpu/ops/structured.py:
//   structured2d_kernel<P>         <- _make_kernel_2d
//   structured3d_kernel<P>         <- _make_kernel_3d
//   structured3d_batched_kernel<P> <- _make_kernel_3d_batched
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
// Each kernel's output and design are described at its code: the 3D
// kernel, the batched 3D kernel and the 2D kernel (sum-factorized along
// every axis, the node plane or row shared along the walk axis carried in
// a register, the next slab copied while this one computes).  No atomics anywhere: two
// launches on the same inputs give the same bits; what two thread blocks
// share is summed by the caller (ops/structured.py) in a fixed order.
#include <cuda_runtime.h>

#include "gls_qpoint.cuh"

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;

// Class-grouped position of local node j of cell e on an axis of n cells:
// classes 1..P-1 of n entries each, then class 0 of n + 1 entries.
GLS_HD int cg_index(int P, int n, int e, int j) {
  const int k = j % P;
  return (k >= 1 ? (k - 1) * n : (P - 1) * n) + e + (j == P ? 1 : 0);
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
// 32 x 32 cells of Q2 (the x-only design 1,328.4 us and the first batched
// design 667.6 us in the same process), 7.9x the 47.0 us bound.  The kernel is bound by
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
__global__ void __launch_bounds__(kThreads, kMinBlocks<P>)
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
// structured3d_batched_kernel<P>: the 3D sweep, sum-factorized along z, x
// and y, every 1D contraction one product over all components stacked
// ===========================================================================
//
// Output: that of structured3d_kernel above, tiles (C, Zr, ny, P+1, Nx)
// and seams (C, Zr, ny, P+1, nbx), summed by ops/structured.py
// fold_bricks.
//
// Replaces _make_kernel_3d_batched (ns_gls_tpu/ops/structured.py:910):
// the 3D kernel's function, with all components through each contraction
// together.  No driver path of either package selects it
// (StructuredSweep(..., batched=True) and the bench_gpu.py --batched
// lanes do).
//
// What bounds it: the function's operations (utils/roofline.py
// structured_cost; about 24 kFLOP a cell of Q2 at the f32 peak, 67
// TFLOP/s: 11.8 us at 32^3 cells, 47.0 us at 128 x 32 x 32, increment
// flavor with the history).
//
// Design.  The walk, output and loads are structured3d_kernel's: one
// thread block per (x brick, cell row, z chunk) of a plan made at table
// build (ops/structured.py batched_plan), walking its chunk in slabs; the
// next slab's node planes and cell geometry are copied with cp.async into
// a second buffer while this slab computes (TMA was not taken: the planes
// are gathered through class-grouped y and z rows, one box per node row,
// and the copies' issue is about 13% of the stage clocks); the node plane
// shared by two cell layers is carried in a register, and fold_bricks sums
// the x seams and the node rows shared by two cell rows.  Sum-factorized
// along z, x and y and back (about 24 kFLOP a cell at P = 2), P a template
// parameter (NQ = P + 1).  Each of the six 1D contractions is one product
// C = A B over a slab: A's rows stack every field's components (E1-E3: u,
// u_lin, vec_old, then their z- and x-derivatives; I3-I1: the four
// test-function components and their weight kinds), K the P + 1 nodes
// (2 NQ q-points going back), N both tables at once, [S1^T | D1^T] (its
// transpose going back).  The physics runs per q-point in f32 registers
// (gls_qpoint.cuh); the cell-wise delta takes a warp per cell.  No
// atomics: two launches on the same inputs give the same bits.
//
// Tensor cores or FMAs, per stage (kSbFma), by the stage clocks
// (tools/structured_stage_clocks.py --batched, NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md section 7): a product on the f64 tensor cores
// (mma.sync.m16n8k4, f32 operands widened exactly, one rounding a stage;
// the padded products use 25-100% of the forward MMAs and 25-77% of the
// adjoint ones, 56% and 28% at P = 2) took 1.3-11x the cycles of the same
// product on f32 FMAs in every stage at every degree 1-6 (FMA over tensor
// cores 0.09-0.75; at P = 2 on 128 x 32 x 32 cells 0.15-0.44).  So every
// stage runs on FMAs.  Why (tools/dmma_probe.py, same card): the products
// are tiny (K <= 14, N <= 14), their operands live in f32 shared memory,
// and a conversion to f64 and back runs at 20 a clock per SM against 116
// f32 FMAs, so the conversions alone cost more than the FMAs they
// replace; keeping the intermediates in f64 instead would double the
// shared-memory bytes each stage moves, which bound it.
//
// Measured (tools/structured_levels.py --batched-baseline, device time by
// torch.profiler, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6):
// 133.9 us at 32^3 cells of Q2 (the x-only design it replaces 166.3 us,
// structured3d_kernel 98.7 us, in the same process), 528.2 us at 128 x 32
// x 32 (663.2 and 367.3 us): 11.4x the bound, no stage above 17% of the
// cycles (the physics, the y contraction and the slab copies' issue the
// largest).  Launch: 256 threads, 102 registers at P = 2, no spills; two
// blocks per SM below P = 6 (101 KB at P = 2 in bricks of 4 cells, slabs
// of 3 layers), one block of 115 KB at P = 6.

// the six 1D contraction stages, in the order they run
enum SbStage { SB_E1 = 0, SB_E2, SB_E3, SB_I3, SB_I2, SB_I1 };

// Stages (a bit per SbStage) that run as f32 FMAs, one thread a row, in
// place of f64 products on the tensor cores: every stage, at every degree,
// by the stage clocks (the note above).  tools/structured_stage_clocks.py
// builds the kernel with SB_FMA_MASK set to time every stage both ways.
#ifdef SB_FMA_MASK
constexpr unsigned kSbFma = SB_FMA_MASK;
#else
constexpr unsigned kSbFma = 0x3Fu;
#endif

// Cycles per stage, for tools/structured_stage_clocks.py (built with
// SB_STAGE_CLOCKS): thread 0 of every block reads clock64() after each
// stage's barrier and adds the differences to g_sb_stage at the end.
#ifdef SB_STAGE_CLOCKS
__device__ unsigned long long g_sb_stage[11];
#define SB_CLOCK_BEGIN \
  long long sb_st[11] = {0}; \
  long long sb_t0 = clock64();
#define SB_MARK(k)                      \
  if (threadIdx.x == 0) {               \
    const long long sb_t1 = clock64();  \
    sb_st[k] += sb_t1 - sb_t0;          \
    sb_t0 = sb_t1;                      \
  }
#define SB_MARK_SYNC(k) \
  __syncthreads();      \
  SB_MARK(k)
#define SB_CLOCK_END                                               \
  if (threadIdx.x == 0)                                            \
    for (int q = 0; q < 11; ++q)                                   \
      atomicAdd(&g_sb_stage[q], (unsigned long long)sb_st[q]);
#else
#define SB_CLOCK_BEGIN
#define SB_MARK(k)
#define SB_MARK_SYNC(k)
#define SB_CLOCK_END
#endif

#ifndef SWEEP_HOST_REHEARSAL
// c += a b on the tensor cores in f64, one warp: A 16 x 4 (this lane: rows
// g and g + 8 of column t), B 4 x 8 (row t, column g), C 16 x 8 (rows g and
// g + 8 of columns 2t and 2t + 1); g = lane / 4, t = lane % 4
__device__ __forceinline__ void dmma_16x8x4(double (&c)[4], double a0,
                                            double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}
#endif

// C = A B over the n_rows rows of one contraction stage St, B the K x N
// table tab(k, n).  On the tensor cores: a warp takes 16 rows at a time,
// the f32 operands widened to f64 (exactly), summed in f64 and rounded to
// f32 once.  With kFma: one thread a row, f32 FMAs.  St gives a row's
// state (St::Row: the stage's digits from row v on in steps of st, ok
// while the row exists), a(r, k) (0 for a row past the end) and c(r, n, v)
// (drops what the stage does not keep).
template <int K, int N, bool kFma, class St, class Tab>
__device__ __forceinline__ void sb_product(const St& st, int n_rows,
                                           Tab tab) {
  if constexpr (kFma) {
    float bt[K][N];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int n = 0; n < N; ++n) bt[k][n] = tab(k, n);
    for (auto r = st.row(threadIdx.x, blockDim.x); r.ok; st.next(r)) {
      float a[K];
#pragma unroll
      for (int k = 0; k < K; ++k) a[k] = (float)st.a(r, k);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc = fmaf(bt[k][n], a[k], acc);
        st.c(r, n, (double)acc);
      }
    }
  } else {
    constexpr int KS = (K + 3) / 4, NB = (N + 7) / 8;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int w0 = (threadIdx.x >> 5) * 16, step = (blockDim.x >> 5) * 16;
    double b[KS][NB];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int k = 4 * ks + t, n = 8 * nb + g;
        b[ks][nb] = k < K && n < N ? (double)tab(k, n) : 0.0;
      }
    auto r0 = st.row(w0 + g, step);
    auto r1 = st.row(w0 + g + 8, step);
    for (int m = w0; m < n_rows; m += step) {   // warp-uniform
      double a0[KS], a1[KS];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int k = 4 * ks + t;
        a0[ks] = k < K ? st.a(r0, k) : 0.0;
        a1[ks] = k < K ? st.a(r1, k) : 0.0;
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        double c[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          dmma_16x8x4(c, a0[ks], a1[ks], b[ks][nb]);
        const int n = 8 * nb + 2 * t;
        if (n < N) {
          st.c(r0, n, c[0]);
          st.c(r1, n, c[2]);
        }
        if (n + 1 < N) {
          st.c(r0, n + 1, c[1]);
          st.c(r1, n + 1, c[3]);
        }
      }
      st.next(r0);
      st.next(r1);
    }
  }
}

// The stages.  Shared-memory layouts, floats, every extent padded to the
// plan's brick (XB cells, XN = P XB + 1 nodes, LX = NQ XB q-columns) and
// slab (ZS layers, ZN = P ZS + 1 node planes, LZ = NQ ZS q-layers); a row
// in the padding computes values nothing reads.
//   in   (NF, ZN, n1, XN)           staged node planes of every field
//   A    (NF + NG, LZ, n1, XN)      along z: values, then z-derivatives of
//                                   the NG fields with gradients
//   X    (NF + 2 NG, LZ, n1, LX)    along x: A's planes, then XD
//                                   (x-derivatives of the NG fields)
//   Q    (NF + 3 NG, QS)            along y, at the q-points q = (iz NQ +
//                                   qy) LX + ix: values (NF), d/dz, d/dx,
//                                   d/dy (NG each)
//   W    (4 kinds, 4 c, QS)         test-function weights: value, d/dxi_x,
//                                   d/dxi_y, d/dxi_z
//   Y    (4 c, 3, LZ, n1, LX)       back along y: value (with the y
//                                   weights), x, z
//   V    (4 c, 2, LZ, n1, XB, n1)   back along x, per cell: value (with
//                                   the x weights), z
//   O    (4 c, n1, ZS, XN, n1)      back along z, per cell layer
// The forward stages' table is [S1^T | D1^T] (K = P + 1 nodes, N = 2 NQ),
// the adjoint stages' its transpose (K = 2 NQ, N = P + 1).

// E1, along z: row (m, e, f): node m = j XN + x of a plane, cell layer e,
// field f; A: the layer's P + 1 node planes; C: S into A, D into Az
template <int P>
struct SbE1 {
  static constexpr int NQ = P + 1;
  const float* in;
  float* out;
  int PL, ZN, LZ, zs, NF, NG, AZ;
  struct Row {
    StridedDigits<3> d;
    int ia, ic;
    bool ok, grads;
  };
  __device__ void set(Row& r) const {
    const int m = r.d.d[0], e = r.d.d[1], f = r.d.d[2];
    r.ok = r.d.valid();
    r.grads = f < NG;
    r.ia = (f * ZN + P * e) * PL + m;
    r.ic = (f * LZ + NQ * e) * PL + m;
  }
  __device__ Row row(int v, int st) const {
    Row r{StridedDigits<3>({PL, zs, NF}, v, st)};
    set(r);
    return r;
  }
  __device__ void next(Row& r) const {
    r.d.next();
    set(r);
  }
  __device__ double a(const Row& r, int k) const {
    return r.ok ? (double)in[r.ia + k * PL] : 0.0;
  }
  __device__ void c(const Row& r, int n, double v) const {
    if (!r.ok) return;
    if (n < NQ) {
      out[r.ic + n * PL] = (float)v;
    } else if (r.grads) {
      out[AZ + r.ic + (n - NQ) * PL] = (float)v;
    }
  }
};

// E2, along x: row (ex, L): cell ex of the brick, line L = (plane, q-layer,
// node row) of A and Az; A: the cell's P + 1 nodes; C: S into X (plane for
// plane), D into XD (the fields with gradients)
template <int P>
struct SbE2 {
  static constexpr int NQ = P + 1;
  const float* in;
  float* out;
  int XN, LX, xb, nL, nG, XD;
  struct Row {
    StridedDigits<2> d;
    int ia, ic;
    bool ok, grads;
  };
  __device__ void set(Row& r) const {
    const int ex = r.d.d[0], L = r.d.d[1];
    r.ok = r.d.valid();
    r.grads = L < nG;
    r.ia = L * XN + P * ex;
    r.ic = L * LX + NQ * ex;
  }
  __device__ Row row(int v, int st) const {
    Row r{StridedDigits<2>({xb, nL}, v, st)};
    set(r);
    return r;
  }
  __device__ void next(Row& r) const {
    r.d.next();
    set(r);
  }
  __device__ double a(const Row& r, int k) const {
    return r.ok ? (double)in[r.ia + k] : 0.0;
  }
  __device__ void c(const Row& r, int n, double v) const {
    if (!r.ok) return;
    if (n < NQ) {
      out[r.ic + n] = (float)v;
    } else if (r.grads) {
      out[XD + r.ic + n - NQ] = (float)v;
    }
  }
};

// E3, along y: row (ix, M): q-column ix, M = plane p LZ + q-layer of X;
// A: the P + 1 node rows; C: S into Q plane p, D into the y-derivatives
// (p < NG)
template <int P>
struct SbE3 {
  static constexpr int NQ = P + 1;
  const float* in;
  float* out;
  int LX, lx, nM, mG, QD;
  struct Row {
    StridedDigits<2> d;
    int ia, ic;
    bool ok, grads;
  };
  __device__ void set(Row& r) const {
    const int ix = r.d.d[0], M = r.d.d[1];
    r.ok = r.d.valid();
    r.grads = M < mG;
    r.ia = M * (P + 1) * LX + ix;
    r.ic = M * NQ * LX + ix;
  }
  __device__ Row row(int v, int st) const {
    Row r{StridedDigits<2>({lx, nM}, v, st)};
    set(r);
    return r;
  }
  __device__ void next(Row& r) const {
    r.d.next();
    set(r);
  }
  __device__ double a(const Row& r, int k) const {
    return r.ok ? (double)in[r.ia + k * LX] : 0.0;
  }
  __device__ void c(const Row& r, int n, double v) const {
    if (!r.ok) return;
    if (n < NQ) {
      out[r.ic + n * LX] = (float)v;
    } else if (r.grads) {
      out[QD + r.ic + (n - NQ) * LX] = (float)v;
    }
  }
};

// I3, back along y: row (ix, iz, ck), ck = c * 3 + kind (0: the values
// with the d/dxi_y weights, 1: d/dxi_x, 2: d/dxi_z); A: the kind's
// weights at the NQ q-rows (kind 0: then the y weights); C into Y
template <int P>
struct SbI3 {
  static constexpr int NQ = P + 1;
  const float* in;
  float* out;
  int LX, lx, LZ, QS;
  struct Row {
    StridedDigits<3> d;
    int ia, ic;
    bool ok, val;
  };
  __device__ void set(Row& r) const {
    const int ix = r.d.d[0], iz = r.d.d[1], ck = r.d.d[2];
    const int c = ck / 3, kd = ck - 3 * c;
    r.ok = r.d.valid();
    r.val = kd == 0;
    r.ia = ((kd == 2 ? 3 : kd) * 4 + c) * QS + iz * NQ * LX + ix;
    r.ic = (ck * LZ + iz) * (P + 1) * LX + ix;
  }
  __device__ Row row(int v, int st) const {
    Row r{StridedDigits<3>({lx, LZ, 12}, v, st)};
    set(r);
    return r;
  }
  __device__ void next(Row& r) const {
    r.d.next();
    set(r);
  }
  __device__ double a(const Row& r, int k) const {
    if (!r.ok) return 0.0;
    if (k < NQ) return (double)in[r.ia + k * LX];
    return r.val ? (double)in[r.ia + 8 * QS + (k - NQ) * LX] : 0.0;
  }
  __device__ void c(const Row& r, int n, double v) const {
    if (r.ok) out[r.ic + n * LX] = (float)v;
  }
};

// I2, back along x: row (ex, izj, cz): cell ex, izj = q-layer n1 + node
// row, cz = c * 2 + kind (0: values with the x weights, 1: z); A: Y at the
// cell's NQ q-columns; C: the cell's P + 1 nodes into V
template <int P>
struct SbI2 {
  static constexpr int NQ = P + 1;
  const float* in;
  float* out;
  int LX, XB, xb, LZn1, YS;
  struct Row {
    StridedDigits<3> d;
    int ia, ic;
    bool ok, val;
  };
  __device__ void set(Row& r) const {
    const int ex = r.d.d[0], izj = r.d.d[1], cz = r.d.d[2];
    const int c = cz >> 1, kz = cz & 1;
    r.ok = r.d.valid();
    r.val = kz == 0;
    r.ia = ((c * 3 + 2 * kz) * LZn1 + izj) * LX + NQ * ex;
    r.ic = ((cz * LZn1 + izj) * XB + ex) * (P + 1);
  }
  __device__ Row row(int v, int st) const {
    Row r{StridedDigits<3>({xb, LZn1, 8}, v, st)};
    set(r);
    return r;
  }
  __device__ void next(Row& r) const {
    r.d.next();
    set(r);
  }
  __device__ double a(const Row& r, int k) const {
    if (!r.ok) return 0.0;
    if (k < NQ) return (double)in[r.ia + k];
    return r.val ? (double)in[r.ia + YS + k - NQ] : 0.0;
  }
  __device__ void c(const Row& r, int n, double v) const {
    if (r.ok) out[r.ic + n] = (float)v;
  }
};

// I1, back along z: row (x, j, e, c): node x of the brick, node row j,
// cell layer e, component c; A: V's values then z weights at the layer's
// NQ q-layers, node x's parts from the cells on both sides summed (in
// f64, exactly); C: the layer's P + 1 node planes into O
template <int P>
struct SbI1 {
  static constexpr int NQ = P + 1;
  const float* in;
  float* out;
  int xn, xb, zs, ZS, XN, VJ, VI, VK;
  struct Row {
    StridedDigits<4> d;
    int ia, ic;
    bool ok, left;
  };
  __device__ void set(Row& r) const {
    const int x = r.d.d[0], j = r.d.d[1], e = r.d.d[2], c = r.d.d[3];
    const int ex = min(x / P, xb - 1), i = x - P * ex;
    r.ok = r.d.valid();
    r.left = i == 0 && ex > 0;
    r.ia = 2 * c * VK + e * NQ * VI + j * VJ + ex * (P + 1) + i;
    r.ic = (((c * (P + 1) + j) * ZS + e) * XN + x) * (P + 1);
  }
  __device__ Row row(int v, int st) const {
    Row r{StridedDigits<4>({xn, P + 1, zs, 4}, v, st)};
    set(r);
    return r;
  }
  __device__ void next(Row& r) const {
    r.d.next();
    set(r);
  }
  __device__ double a(const Row& r, int k) const {
    if (!r.ok) return 0.0;
    const int o = r.ia + (k < NQ ? k * VI : VK + (k - NQ) * VI);
    const double v = (double)in[o];
    return r.left ? v + (double)in[o - 1] : v;
  }
  __device__ void c(const Row& r, int n, double v) const {
    if (r.ok) out[r.ic + n] = (float)v;
  }
};

// shared-memory regions of one block, in floats: the staged node planes
// and the cells' geometry (two buffers each), region 1 (A -> Q -> Y -> O),
// region 2 (X -> W -> V) and the cells' max |u*|^2
struct SbSmem {
  size_t in, geo, r1, r2, cells;
  __host__ __device__ size_t total() const {
    return in + geo + r1 + r2 + cells;
  }
};

__host__ __device__ inline SbSmem sb_smem(int P, int XB, int ZS, int NF,
                                          int NG) {
  const size_t n1 = P + 1, NQ = P + 1;
  const size_t XN = (size_t)P * XB + 1, LX = NQ * XB;
  const size_t ZN = (size_t)P * ZS + 1, LZ = NQ * ZS;
  const size_t PL = n1 * XN, QS = LZ * NQ * LX, XF = LZ * n1 * LX;
  const size_t cells = (size_t)ZS * XB;
  return SbSmem{
      2 * NF * ZN * PL, 2 * cells * (11 + NQ * NQ * NQ),
      s3_max(s3_max((NF + NG) * LZ * PL, (NF + 3 * NG) * QS),
             s3_max(12 * XF, 4 * n1 * ZS * XN * n1)),
      s3_max(s3_max((NF + 2 * NG) * XF, 16 * QS), 8 * LZ * n1 * XB * n1),
      cells};
}

template <int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks<P>)
structured3d_batched_kernel(
    const float* __restrict__ u, const float* __restrict__ ul,
    const float* __restrict__ vo, const float* __restrict__ jinv,
    const float* __restrict__ jxw, const float* __restrict__ hcell,
    const float* __restrict__ S1g, const float* __restrict__ D1g,
    float* __restrict__ tiles, float* __restrict__ seams, S3Dims dm,
    int flavor, int consider_dt, int cell_wise, GlsScalars sc) {
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
  const bool incr = flavor == GLS_INCREMENT;
  const int lead_ul = incr ? 4 : 3;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  const int NF = 4 + lead_ul + (need_dt_old ? 3 : 0);   // staged fields
  const int NG = incr ? 8 : 4;                         // fields with grads

  // the z chunk: owned layers [zb, ze), walked from lo (one layer below
  // zb when the chunk does not start the column)
  const int zb = kz * dm.ZC;
  const int ze = min(zb + dm.ZC, nz);
  const int lo = zb > 0 ? zb - 1 : 0;

  const SbSmem sm = sb_smem(P, XB, ZS, NF, NG);
  const int GB = ZS * XB * (11 + NQ3);   // one geometry buffer
  float* sIn = smem;                     // (2, NF, ZN, n1, XN)
  float* sGeo = sIn + sm.in;             // (2, [ZS, XB, 9 | ZS, XB, 2 |
                                         //      ZS, XB, NQ^3])
  float* sR1 = sGeo + sm.geo;            // A -> Q -> Y -> O
  float* sR2 = sR1 + sm.r1;              // X -> W -> V
  float* scell = sR2 + sm.r2;            // (ZS, XB) max |u*|^2 per cell

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

  // the 1D tables as the stages' B: forward [S1^T | D1^T] (nodes -> q-
  // point values, derivatives), adjoint its transpose
  auto fwd = [&](int k, int n) {
    return n < NQ ? __ldg(S1g + n * n1 + k) : __ldg(D1g + (n - NQ) * n1 + k);
  };
  auto adj = [&](int k, int n) {
    return k < NQ ? __ldg(S1g + k * n1 + n) : __ldg(D1g + (k - NQ) * n1 + n);
  };

  // the z carries of the output columns this thread owns, (c, j, x) =
  // threadIdx.x + k * blockDim.x, fixed for the whole walk
  const int n_cols = 4 * n1 * xn;
  float carry[kMaxCols3];
#pragma unroll
  for (int k = 0; k < kMaxCols3; ++k) carry[k] = 0.f;

  const int n_slabs = (ze - lo + ZS - 1) / ZS;
  SB_CLOCK_BEGIN
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
    }
    SB_MARK(0)
    if (s + 1 < n_slabs) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    SB_MARK(1)
    const float* sbuf = sIn + (s & 1) * NF * ZN * PL;
    const float* gJ = sGeo + (s & 1) * GB;
    const float* gH = gJ + ZS * XB * 9;
    const float* gQ = gH + ZS * XB * 2;

    // ---- E1: along z, in -> A, Az -------------------------------------
    sb_product<n1, 2 * NQ, ((kSbFma >> SB_E1) & 1) != 0>(
        SbE1<P>{sbuf, sR1, PL, ZN, LZ, zs, NF, NG, NF * LZ * PL},
        PL * zs * NF, fwd);
    __syncthreads();
    SB_MARK(2)

    // ---- E2: along x, A, Az -> X, XZ, XD -------------------------------
    const int XF = LZ * n1 * LX;
    sb_product<n1, 2 * NQ, ((kSbFma >> SB_E2) & 1) != 0>(
        SbE2<P>{sR1, sR2, XN, LX, xb, (NF + NG) * LZ * n1, NG * LZ * n1,
                (NF + NG) * XF},
        xb * (NF + NG) * LZ * n1, fwd);
    __syncthreads();
    SB_MARK(3)

    // ---- E3: along y, X -> Q -------------------------------------------
    sb_product<n1, 2 * NQ, ((kSbFma >> SB_E3) & 1) != 0>(
        SbE3<P>{sR2, sR1, LX, lx, (NF + 2 * NG) * LZ, NG * LZ,
                (NF + 2 * NG) * QS},
        lx * (NF + 2 * NG) * LZ, fwd);
    __syncthreads();
    SB_MARK(4)
    const float* sQ = sR1;
    float* sW = sR2;

    // ---- E3a (cell-wise delta): max |u*|^2 over each cell's NQ^3
    // q-points, one warp per cell and a shuffle reduction -> scell
    if (cell_wise) {
      const int lane = threadIdx.x & 31;
      for (int w = threadIdx.x >> 5; w < zs * xb; w += blockDim.x >> 5) {
        const int ezl = w / xb, ex = w - ezl * xb;
        float m = 0.f;
        for (int t = lane; t < NQ3; t += 32) {
          const int qz = t / (NQ * NQ), qy = (t / NQ) % NQ, qx = t % NQ;
          const int q = ((ezl * NQ + qz) * NQ + qy) * LX + ex * NQ + qx;
          float us = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float v = sQ[(4 + c) * QS + q];
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
    SB_MARK(5)

    // ---- physics: delta, the q-point algebra, test-function weights ----
    for (StridedDigits<3> it({lx, NQ, lz}); it.valid(); it.next()) {
      const int ix = it.d[0], qy = it.d[1], iz = it.d[2];
      const int q = (iz * NQ + qy) * LX + ix;
      const int ex = ix / NQ, qx = ix - ex * NQ;
      const int ezl = iz / NQ, qz = iz - ezl * NQ;

      // value and reference gradients (x, y, z) of field f at this q-point
      auto val = [&](int f) { return sQ[f * QS + q]; };
      auto grad = [&](int f, float (&gr)[3]) {
        gr[0] = sQ[(NF + NG + f) * QS + q];
        gr[1] = sQ[(NF + 2 * NG + f) * QS + q];
        gr[2] = sQ[(NF + f) * QS + q];
      };
      float uv[4], ud[4][3];
      float lv[4] = {0.f, 0.f, 0.f, 0.f};
      float ld[4][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f},
                        {0.f, 0.f, 0.f}};
      float dto[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uv[c] = val(c);
        grad(c, ud[c]);
      }
      if (incr) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lv[c] = val(4 + c);
          grad(4 + c, ld[c]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) lv[c] = val(4 + c);
      }
      if (need_dt_old) {
#pragma unroll
        for (int c = 0; c < 3; ++c) dto[c] = val(4 + lead_ul + c);
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
    SB_MARK(6)

    // ---- I3: back along y, W -> Y --------------------------------------
    sb_product<2 * NQ, n1, ((kSbFma >> SB_I3) & 1) != 0>(
        SbI3<P>{sR2, sR1, LX, lx, LZ, QS}, lx * LZ * 12, adj);
    __syncthreads();
    SB_MARK(7)

    // ---- I2: back along x, Y -> V (per cell) ---------------------------
    sb_product<2 * NQ, n1, ((kSbFma >> SB_I2) & 1) != 0>(
        SbI2<P>{sR1, sR2, LX, XB, xb, LZ * n1, LZ * n1 * LX},
        xb * LZ * n1 * 8, adj);
    __syncthreads();
    SB_MARK(8)

    // ---- I1: back along z, V -> O (per cell layer) ---------------------
    const int VJ = XB * n1, VI = n1 * VJ;
    sb_product<2 * NQ, n1, ((kSbFma >> SB_I1) & 1) != 0>(
        SbI1<P>{sR2, sR1, xn, xb, zs, ZS, XN, VJ, VI, LZ * VI},
        xn * n1 * zs * 4, adj);
    __syncthreads();
    SB_MARK(9)

    // ---- the output, one column (c, j, x) per thread: the node plane
    // shared by two cell layers summed with the carry in a register
    const float* sO = sR1;
#pragma unroll
    for (int k = 0; k < kMaxCols3; ++k) {
      const int it = threadIdx.x + k * blockDim.x;
      if (it < n_cols) {
        const int c = it / (n1 * xn);
        const int r = it - c * (n1 * xn);
        const int j = r / xn, xl = r - j * xn;
        const float* op = sO + ((c * n1 + j) * ZS * XN + xl) * n1;
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
          const float* ol = op + ezl * XN * n1;
#pragma unroll
          for (int kk = 0; kk <= P; ++kk) {
            const float v = ol[kk];
            if (kk == 0) {
              if (zg >= zb) put(P * zg, v + carry[k]);
            } else if (kk < P) {
              if (zg >= zb) put(P * zg + kk, v);
            } else {
              carry[k] = v;
            }
          }
        }
        if (s == n_slabs - 1 && ze == nz) put(P * nz, carry[k]);
      }
    }
    SB_MARK_SYNC(10)
    // the next iteration's barrier orders these reads of O before E1
    // rewrites that region
  }
  SB_CLOCK_END
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
//    no barrier, no second evaluation.  A cell of more than 32 q-points
//    (P = 5, 6) takes a whole warp, each lane its q-points in rounds; the
//    cell-wise max is then taken over the warp first (u* alone at each of
//    the lane's q-points) and the physics runs round by round.
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
// passes of E2 over a slab's cells (each warp takes 32 / NQ^2 cells a pass,
// one cell above 32 q-points)
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
__global__ void __launch_bounds__(kThreads, kMinBlocks<P>)
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
  // cells per warp in E2, and each lane's q-point rounds per cell (more
  // than one only for a cell of more than 32 q-points)
  constexpr int CPW = NQ2 <= 32 ? 32 / NQ2 : 1;
  constexpr int NSUB = (NQ2 + 31) / 32;
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
    // and cells past the slab's, compute cell 0 and write nothing); a
    // cell of more than 32 q-points (P >= 5) takes the whole warp, each
    // lane NSUB of its q-points in turn
    const int n_cells = ys * xb;
#pragma unroll 1
    for (int pass = 0; pass < kMaxPass2; ++pass) {
      const int grp = warp + pass * n_warps;   // warp-uniform
      if (grp * CPW >= n_cells) break;
      const int cl_lin = grp * CPW + cw;
      const bool cell_ok = cw < CPW && cl_lin < n_cells;
      const int cll = cell_ok ? cl_lin : 0;
      const int eyl = cll / xb, ex = cll - eyl * xb;
      // the cell's geometry, staged with the slab
      const int cl = eyl * XB + ex;

      // cell-wise delta over NSUB > 1 rounds: the max of |u*|^2 over the
      // cell's q-points, each lane's rounds then a shuffle over the warp
      float msq_warp = 0.f;
      if (NSUB > 1 && cell_wise) {
        for (int sub = 0; sub < NSUB; ++sub) {
          const int t = lane + 32 * sub;
          if (t < NQ2) {
            float St[n1];
            table_row(S1, t % NQ, St);
            const float* a = sA + 3 * AF + (eyl * NQ + t / NQ) * XN + P * ex;
            float l0 = 0.f, l1 = 0.f;
#pragma unroll
            for (int i = 0; i < n1; ++i) {
              l0 = fmaf(St[i], a[i], l0);
              l1 = fmaf(St[i], a[AF + i], l1);
            }
            msq_warp = fmaxf(msq_warp, l0 * l0 + l1 * l1);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          msq_warp = fmaxf(msq_warp,
                           __shfl_xor_sync(0xffffffffu, msq_warp, o));
      }

#pragma unroll 1
      for (int sub = 0; sub < NSUB; ++sub) {
        // this round's q-point (qs_x, qs_y) of the cell and its rows of
        // the 1D tables along x
        const int t = NSUB == 1 ? qxy : lane + 32 * sub;
        const bool valid = cell_ok && t < NQ2;
        const int tq = t < NQ2 ? t : 0;
        const int qs_x = NSUB == 1 ? qx : tq % NQ;
        const int qs_y = NSUB == 1 ? qy : tq / NQ;
        float Sq[n1], Dq[n1];
        if (NSUB == 1) {
#pragma unroll
          for (int i = 0; i < n1; ++i) {
            Sq[i] = Sx[i];
            Dq[i] = Dx[i];
          }
        } else {
          table_row(S1, qs_x, Sq);
          table_row(D1, qs_x, Dq);
        }
        const int ix = ex * NQ + qs_x, iy = eyl * NQ + qs_y;
        const int ao = iy * XN + P * ex;

        // value and reference gradients (x, y) of field f at this q-point
        auto eval = [&](int f, float& v, float (&gr)[2], bool grads) {
          const float* a = sA + f * AF + ao;
          float av[n1];
#pragma unroll
          for (int i = 0; i < n1; ++i) av[i] = a[i];
          v = 0.f;
#pragma unroll
          for (int i = 0; i < n1; ++i) v = fmaf(Sq[i], av[i], v);
          if (grads) {
            const float* ay = sAy + f * AF + ao;
            gr[0] = gr[1] = 0.f;
#pragma unroll
            for (int i = 0; i < n1; ++i) {
              gr[0] = fmaf(Dq[i], av[i], gr[0]);
              gr[1] = fmaf(Sq[i], ay[i], gr[1]);
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
          for (int c = 0; c < 2; ++c)
            eval(3 + lead_ul + c, dto[c], g2, false);
        }

        float ji[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) ji[e] = gJ[cl * 4 + e];

        // stabilization parameters; cell-wise: the max of |u*|^2 over the
        // cell's NQ2 lanes (over the warp's rounds when NSUB > 1)
        const float usq = lv[0] * lv[0] + lv[1] * lv[1];
        float d1, d2;
        if (cell_wise) {
          float msq = msq_warp;
          if (NSUB == 1) {
            const float m = valid ? usq : 0.f;
            const int base = cw * NQ2;
            msq = 0.f;
#pragma unroll
            for (int k = 0; k < NQ2; ++k)
              msq = fmaxf(msq, __shfl_sync(0xffffffffu, m, base + k));
          }
          gls_delta_cell(sc, gH[cl * 2], msq, d1, d2);
        } else {
          gls_delta_q(sc, gH[cl * 2 + 1], usq, d1, d2);
        }

        // reference -> physical gradients: g[x] = sum_r ref[r] * ji[r*2+x]
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
          const float w = gQ[cl * NQ2 + t];
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

// The launcher of structured3d_batched_kernel<P>: validates the plan as
// launch3d does, sets the kernel's dynamic shared-memory limit once,
// launches.
template <int P>
int launch3d_batched(const float* u, const float* ul, const float* vo,
                     const float* jinv, const float* jxw, const float* h,
                     const float* S1, const float* D1, float* tiles,
                     float* seams, int nx, int ny, int nz, int flavor,
                     int consider_dt, int cell_wise, GlsScalars sc, int XB,
                     int ZS, int nzb, cudaStream_t stream) {
  if (nx < 1 || ny < 1 || nz < 1 || XB < 1 || ZS < 1 || nzb < 1 ||
      nzb > nz)
    return (int)cudaErrorInvalidValue;
  // output columns per thread, and the node copies' thread groups
  if (4 * (P + 1) * (P * XB + 1) > kMaxCols3 * kThreads ||
      (P + 1) * (P * XB + 1) > kThreads)
    return (int)cudaErrorInvalidValue;
  // offsets inside one field and inside shared memory are 32-bit
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
  const size_t bytes = sb_smem(P, XB, ZS, NF, NG).total() * sizeof(float);
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
    err = cudaFuncSetAttribute(structured3d_batched_kernel<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = bytes;
  }
  S3Dims dm{nx, ny, nz, XB, nbx, ZS, ZC, nzb};
  structured3d_batched_kernel<P><<<nbx * ny * nzb, kThreads, bytes, stream>>>(
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
  const int nq2 = (P + 1) * (P + 1);
  const int cpw = nq2 <= 32 ? 32 / nq2 : 1;
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
#ifdef SB_STAGE_CLOCKS
// the batched kernel's cycles per stage summed over its blocks since the
// last stage_zero (tools/structured_stage_clocks.py)
extern "C" int stage_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_sb_stage, sizeof(g_sb_stage));
}
extern "C" int stage_zero() {
  unsigned long long z[11] = {0};
  return (int)cudaMemcpyToSymbol(g_sb_stage, z, sizeof(z));
}
#endif

// The batched 3D kernel, degrees 1-6 with NQ = P + 1 Gauss points: xb
// cells per brick, zs cell layers per slab, nzb z chunks per column (ops/
// structured.py batched_plan).  Returns 0, a CUDA error code, or 1
// (cudaErrorInvalidValue) for a degree, plan or shape it does not take.
extern "C" int structured3d_batched_launch(
    const float* u, const float* ul, const float* vo, const float* jinv,
    const float* jxw, const float* h, const float* S1, const float* D1,
    float* tiles, float* seams, int P, int NQ, int nx, int ny, int nz,
    int flavor, int consider_dt, int cell_wise, float weight, float stau,
    float nu, float c1, float c2, int xb, int zs, int nzb, void* stream) {
  GlsScalars sc{weight, stau, nu, c1, c2};
  cudaStream_t st = (cudaStream_t)stream;
#define SB_CASE(PP)                                                         \
  if (P == PP && NQ == PP + 1)                                              \
    return launch3d_batched<PP>(u, ul, vo, jinv, jxw, h, S1, D1, tiles,     \
                                seams, nx, ny, nz, flavor, consider_dt,     \
                                cell_wise, sc, xb, zs, nzb, st);
  SB_CASE(1)
  SB_CASE(2)
  SB_CASE(3)
  SB_CASE(4)
  SB_CASE(5)
  SB_CASE(6)
#undef SB_CASE
  return (int)cudaErrorInvalidValue;
}

// What the compiler gave structured3d_batched_kernel<P>: registers per
// thread, local memory (spills) and static shared memory per thread block
// in bytes; and the dynamic shared memory of one block in bytes for a
// brick of xb cells, slabs of zs layers and the flavor's fields.  Returns
// 0 or a CUDA error code.
extern "C" int structured3d_batched_attributes(int P, int xb, int zs,
                                               int flavor, int consider_dt,
                                               int* regs, int* local_bytes,
                                               int* static_smem,
                                               long long* dynamic_smem) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaErrorInvalidValue;
  if (P == 1) err = cudaFuncGetAttributes(&a, structured3d_batched_kernel<1>);
  if (P == 2) err = cudaFuncGetAttributes(&a, structured3d_batched_kernel<2>);
  if (P == 3) err = cudaFuncGetAttributes(&a, structured3d_batched_kernel<3>);
  if (P == 4) err = cudaFuncGetAttributes(&a, structured3d_batched_kernel<4>);
  if (P == 5) err = cudaFuncGetAttributes(&a, structured3d_batched_kernel<5>);
  if (P == 6) err = cudaFuncGetAttributes(&a, structured3d_batched_kernel<6>);
  if (err != cudaSuccess) return (int)err;
  const bool incr = flavor == GLS_INCREMENT;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  const int NF = 4 + (incr ? 4 : 3) + (need_dt_old ? 3 : 0);
  *dynamic_smem =
      (long long)(sb_smem(P, xb, zs, NF, incr ? 8 : 4).total() * sizeof(float));
  return 0;
}

// The 2D kernel, degrees 1-6 with NQ = P + 1 Gauss points: xb cells per
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
  S2_CASE(5)
  S2_CASE(6)
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
  if (P == 5) err = cudaFuncGetAttributes(&a, structured2d_kernel<5>);
  if (P == 6) err = cudaFuncGetAttributes(&a, structured2d_kernel<6>);
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

// The 3D kernel, degrees 1-6 with NQ = P + 1 Gauss points: xb cells per
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
  S3_CASE(5)
  S3_CASE(6)
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
  if (P == 5) err = cudaFuncGetAttributes(&a, structured3d_kernel<5>);
  if (P == 6) err = cudaFuncGetAttributes(&a, structured3d_kernel<6>);
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
