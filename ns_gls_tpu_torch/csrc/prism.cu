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
//   out   (4, n_p, m, nbx, P+1, XN, Nzn)  cell-row tiles: row (ey, bx, j)
//                                    holds node row P*ey + j of x brick bx
//                                    (nodes P*xb*bx .. P*xb*(bx+1))
//                                    integrated over the cells of cell row
//                                    ey in that brick only
// with Xn = P*m + 1, XN = P*xb + 1, Nzn = P*nz + 1, Lq = NQ*m, q-point row
// iy = ey*NQ+qy, column ix = ex*NQ + qx.  Node rows shared by two cell
// rows, node columns shared by two bricks, and patch seams are left to the
// caller's seam compress, which sums whole z-runs in a fixed order.
//
// What bounds the function on an H100, at the Turek 3D ref-3 shapes
// (P = 2, NQ = 3, m = 8, nz = 32: Xn = 17, Nzn = 65, 100 patches, 204,800
// cells), increment flavor with the history term (utils/roofline.py
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
// The previous design of this file summed, per q-point, over the cell's
// 27 nodes and, per node, over 27 q-points of up to four cells: 93 kFLOP
// per cell, every operand a shared-memory load; it took 2,016.9-2,030.6
// us per launch at that shape (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// section 6), 29.7x the bound.
//
// Design.  One thread block per (patch, cell row ey, x brick, z chunk);
// it walks its chunk of the z column in slabs of ZS cell layers.  A brick
// of xb cells (the whole cell row where it fits) bounds every shared
// region and the I1 columns per thread whatever the patch size m.
//  - Sum factorization one axis at a time, the order of the TPU kernel's
//    band products: a slab is evaluated along z (E1), then x (E2), then
//    y (E3, one thread per q-point, which then runs the physics in
//    registers); the test-function weights are integrated back along y
//    (I3), x (I2) and z (I1).  About 22 kFLOP per cell, a quarter of the
//    previous design's.  P and NQ are template parameters, so the 1D
//    tables and the short contractions live in registers.
//  - z in registers: prismatic geometry makes z separate.  In I1 one
//    thread owns a (component, node row j, node x) column for the whole
//    walk and keeps the z-plane shared by two cell layers in a register
//    (the carry), across slabs too; it writes its finished planes
//    straight to the output tile.
//  - Overlapped slab loads: the next slab's node tiles are copied to
//    shared memory with cp.async (double buffer) while this slab computes.
//  - z chunks: the plan splits each z column in two when each half still
//    holds two slabs; the shorter walks and twice the blocks cut the time
//    at m = 4 and 8.  A chunk's block also evaluates the cell layer
//    just below it and writes only the z-planes it owns (the plane on a
//    chunk seam gets both layers' contributions in the same order as in
//    one walk), so the output layout, the seam compress and the plain
//    version are those of one walk.
//  - Exact f32 FMAs, no tensor cores, no atomics: two launches on the
//    same inputs give the same bits.
// Launch: 256 threads, at most 128 registers (two blocks per SM).  The
// brick, slab depth and z chunks come from the caller (ops/prism.py
// prism_plan, made when the tables are built); the launcher refuses a
// degree, plan or input it does not take.  At the ref-3 shape: the whole
// cell row as one brick, slabs of 2 cell layers (432 q-points) and each
// column in two z chunks: 1,600 blocks of ~100 KB of shared memory.
//
// The loops over a stage's items advance their indices as mixed-radix
// digits (StridedDigits) and the slab copies take their field's first
// row from a per-block table: runtime divisions and 64-bit address math
// per item cost more than the items' own work.
//
// Measured (tools/prism_levels.py, device time by torch.profiler, NVIDIA
// H100 80GB HBM3, 700.00 W): 586.2 us at m = 8 (the previous design
// 2,013.4 us in the same process), 8.6x the bound; 89.0 us at m = 4
// (290.1), 14.1 us at m = 2 (35.7), 5.6 us at m = 1 (13.1).  Other slab
// depths and chunk counts were slower (its --sweep).  With the x bricks
// (the whole row one brick on every Turek 3D level): 592.3 us at m = 8
// against 589.9 for the revision without them in the same process, the
// same bits; 89-91 us at the shapes it refused before, (P, m) = (3, 16),
// (4, 8), (4, 16) with 16 layers (PERF.md section 6).  The kernel is bound
// by latency (barriers, the physics' dependency chains at 16 warps per
// SM), not by the FMA units or shared-memory bandwidth;
// tools/prism_stage_clocks.py counts the cycles of each stage.
#include <cuda_runtime.h>

#include "gls_qpoint.cuh"

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;
// I1 columns (4 components x node rows x nodes) a thread may own
constexpr int kMaxCols = 4;

struct PrismDims {
  int n_p, m, nz;
  int xb;    // cells per x brick
  int nbx;   // bricks per cell row
  int ZS;    // cell layers per slab
  int ZC;    // cell layers per z chunk (a block's share of the column)
  int nzb;   // z chunks per column
};

// shared-memory regions of one block, in floats: the staged slabs (two
// buffers), region 1 (A, Az -> W -> V), region 2 (X, XD, XZ -> Y) and
// |u*|^2 per q-point
struct PrismSmem {
  size_t in, r1, r2, qs;
  __host__ __device__ size_t total() const { return in + r1 + r2 + qs; }
};

__host__ __device__ inline size_t max2(size_t a, size_t b) {
  return a > b ? a : b;
}

// (xb: the brick's cells along x)
__host__ __device__ inline PrismSmem prism_smem(int P, int NQ, int xb,
                                                int ZS, int NF, int NG) {
  const size_t n1 = P + 1, XN = P * xb + 1, LX = NQ * xb;
  const size_t NR = n1 * XN, ZN = P * ZS + 1, LZ = NQ * ZS;
  const size_t QS = NQ * LX * LZ, XS = n1 * LX * LZ;
  return PrismSmem{2 * NF * NR * ZN,
                   max2(max2((NF + NG) * NR * LZ, 16 * QS), 8 * NR * LZ),
                   max2((NF + 2 * NG) * XS, 12 * XS), QS};
}

template <int P, int NQ>
__global__ void __launch_bounds__(kThreads, kMinBlocks<P>)
prism_kernel(const float* __restrict__ u, const float* __restrict__ ul,
             const float* __restrict__ vo, const float* __restrict__ jinv,
             const float* __restrict__ jxw, const float* __restrict__ hcell,
             const float* __restrict__ S1g, const float* __restrict__ D1g,
             const float* __restrict__ wzg, float* __restrict__ out,
             PrismDims dm, int flavor, int consider_dt, int cell_wise,
             GlsScalars sc) {
  extern __shared__ float smem[];
  constexpr int n1 = P + 1;
  const int m = dm.m, nz = dm.nz, ZS = dm.ZS, xb = dm.xb;
  int b = blockIdx.x;
  const int kz = b % dm.nzb;
  b /= dm.nzb;
  const int bx = b % dm.nbx;
  b /= dm.nbx;
  const int ey = b % m;
  const int p = b / m;
  const int Xn = P * m + 1;       // the patch's nodes along x and y
  const int XN = P * xb + 1;      // the brick's nodes along x
  const int Nzn = P * nz + 1;
  const int Lq = NQ * m;          // the patch's q-points along x and y
  const int LX = NQ * xb;         // the brick's q-points along x
  const int ex0 = bx * xb;        // the brick's first cell
  const int NR = n1 * XN;
  const int ZN = P * ZS + 1;
  const int LZ = NQ * ZS;
  const int QS = NQ * LX * LZ;
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

  // 1D tables in registers
  float S1[NQ][n1], D1[NQ][n1];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < n1; ++i) {
      S1[q][i] = __ldg(S1g + q * n1 + i);
      D1[q][i] = __ldg(D1g + q * n1 + i);
    }

  const PrismSmem sm = prism_smem(P, NQ, xb, ZS, NF, NG);
  const int XS = n1 * LX * LZ;                        // one field's X
  float* sIn = smem;                                  // (2, NF, NR, ZN)
  float* sA = sIn + sm.in;                            // (NF, NR, LZ)
  float* sAz = sA + NF * NR * LZ;                     // (NG, NR, LZ)
  float* sW = sA;                                     // (4 k, 4 c, QS)
  float* sV = sA;                                     // (4 c, 2, NR, LZ)
  float* sX = sA + sm.r1;                             // (NF, n1, LX, LZ)
  float* sXD = sX + NF * XS;                          // (NG, n1, LX, LZ)
  float* sXZ = sXD + NG * XS;                         // (NG, n1, LX, LZ)
  float* sY = sX;                                     // (4 c, 3, n1, LX, LZ)
  float* susq = sX + sm.r2;                           // (QS)

  const size_t cstride = (size_t)dm.n_p * Xn * Xn * Nzn;
  // row j = 0, node x = the brick's first of the block's node rows
  const size_t rows0 =
      ((size_t)p * Xn + (size_t)P * ey) * Xn + (size_t)P * ex0;
  // the brick's first q-point column and cell of the patch tables
  const float* ji = jinv + (size_t)p * 5 * Lq * Lq + ex0 * NQ;
  const float* jw = jxw + (size_t)p * Lq * Lq + ex0 * NQ;
  const float* hp = hcell + (size_t)p * 2 * m * m + ex0;
  const size_t ostride = (size_t)dm.n_p * m * dm.nbx * NR * Nzn;
  const size_t orow = (((size_t)p * m + ey) * dm.nbx + bx) * NR * Nzn;
  const int LL = Lq * Lq;

  // the block's first node row of every staged field
  __shared__ const float* sField[11];
  if (threadIdx.x < NF) {
    const int f = threadIdx.x;
    sField[f] = (f < 4 ? u + f * cstride
                       : (f < 4 + lead_ul ? ul + (f - 4) * cstride
                                          : vo + (f - 4 - lead_ul) * cstride)) +
                rows0 * Nzn;
  }
  __syncthreads();

  // copy the node tiles of the slab starting at cell layer zl0 into
  // buffer buf (cp.async; the caller commits): node column (j, x) of the
  // brick is node row j, node P*ex0 + x of the patch tile
  auto stage = [&](int zl0, int zs, int buf) {
    const int zn = P * zs + 1;
    float* dst0 = sIn + buf * NF * NR * ZN;
    for (StridedDigits<4> e({zn, XN, n1, NF}); e.valid(); e.next()) {
      const int zl = e.d[0], x = e.d[1], j = e.d[2], f = e.d[3];
      cp_async4(dst0 + (f * NR + j * XN + x) * ZN + zl,
                sField[f] + ((j * Xn + x) * Nzn + P * zl0 + zl));
    }
  };

  // I1 columns owned by this thread and their z carries
  float carry[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) carry[k] = 0.f;

  const int n_slabs = (ze - lo + ZS - 1) / ZS;
  stage(lo, min(ZS, ze - lo), 0);
  cp_async_commit();
  for (int s = 0; s < n_slabs; ++s) {
    const int zl0 = lo + s * ZS;
    const int zs = min(ZS, ze - zl0);   // cell layers in this slab
    const int lz = NQ * zs;             // q-point layers in this slab
    if (s + 1 < n_slabs) {
      const int z1 = zl0 + ZS;
      stage(z1, min(ZS, ze - z1), (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sbuf = sIn + (s & 1) * NF * NR * ZN;

    // ---- E1: along z, node columns (f, r) ------------------------------
    for (StridedDigits<2> it({NR, NF}); it.valid(); it.next()) {
      const int f = it.d[1], row = f * NR + it.d[0];
      const float* col = sbuf + row * ZN;
      float* a = sA + row * LZ;
      float* az = sAz + row * LZ;
      for (int ezl = 0; ezl < zs; ++ezl) {
        float nd[n1];
#pragma unroll
        for (int k = 0; k < n1; ++k) nd[k] = col[P * ezl + k];
#pragma unroll
        for (int qz = 0; qz < NQ; ++qz) {
          float v = 0.f, d = 0.f;
#pragma unroll
          for (int k = 0; k < n1; ++k) {
            v = fmaf(S1[qz][k], nd[k], v);
            d = fmaf(D1[qz][k], nd[k], d);
          }
          a[ezl * NQ + qz] = v;
          if (f < NG) az[ezl * NQ + qz] = d;
        }
      }
    }
    __syncthreads();

    // ---- E2: along x, items (f, j, ex, iz) -> NQ q-columns each --------
    for (StridedDigits<4> it({lz, xb, n1, NF}); it.valid(); it.next()) {
      const int iz = it.d[0], ex = it.d[1], j = it.d[2], f = it.d[3];
      const int a0 = (f * NR + j * XN + P * ex) * LZ + iz;
      float av[n1];
#pragma unroll
      for (int i = 0; i < n1; ++i) av[i] = sA[a0 + i * LZ];
      const int x0 = ((f * n1 + j) * LX + ex * NQ) * LZ + iz;
#pragma unroll
      for (int qx = 0; qx < NQ; ++qx) {
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < n1; ++i) v = fmaf(S1[qx][i], av[i], v);
        sX[x0 + qx * LZ] = v;
      }
      if (f < NG) {
        float zv[n1];
#pragma unroll
        for (int i = 0; i < n1; ++i) zv[i] = sAz[a0 + i * LZ];
#pragma unroll
        for (int qx = 0; qx < NQ; ++qx) {
          float dx = 0.f, dz = 0.f;
#pragma unroll
          for (int i = 0; i < n1; ++i) {
            dx = fmaf(D1[qx][i], av[i], dx);
            dz = fmaf(S1[qx][i], zv[i], dz);
          }
          sXD[x0 + qx * LZ] = dx;
          sXZ[x0 + qx * LZ] = dz;
        }
      }
    }
    __syncthreads();

    // q-point q of the slab: q = (qy * LX + ix) * lz + iz, ix the brick's
    // ---- E3a (cell-wise delta): |u*|^2 at every q-point ---------------
    if (cell_wise) {
      for (StridedDigits<3> it({lz, LX, NQ}); it.valid(); it.next()) {
        const int iz = it.d[0], ix = it.d[1], qy = it.d[2];
        const int q = (qy * LX + ix) * lz + iz;
        float Sy[n1];
#pragma unroll
        for (int j = 0; j < n1; ++j) Sy[j] = __ldg(S1g + qy * n1 + j);
        float us = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float* xr = sX + ((4 + c) * n1 * LX + ix) * LZ + iz;
          float v = 0.f;
#pragma unroll
          for (int j = 0; j < n1; ++j) v = fmaf(Sy[j], xr[j * LX * LZ], v);
          us = fmaf(v, v, us);
        }
        susq[q] = us;
      }
      __syncthreads();
    }

    // ---- E3b: along y, delta, physics, test-function weights ----------
    for (StridedDigits<3> it({lz, LX, NQ}); it.valid(); it.next()) {
      const int iz = it.d[0], ix = it.d[1], qy = it.d[2];
      const int q = (qy * LX + ix) * lz + iz;
      const int ex = ix / NQ;
      const int ezl = iz / NQ, qz = iz - ezl * NQ;
      // this q-point's row of the 1D tables (qy is not a compile-time
      // index, so it is not taken from the register copies)
      float Sy[n1], Dy[n1];
#pragma unroll
      for (int j = 0; j < n1; ++j) {
        Sy[j] = __ldg(S1g + qy * n1 + j);
        Dy[j] = __ldg(D1g + qy * n1 + j);
      }

      // value and reference gradients of field f at this q-point
      auto eval = [&](int f, float& v, float& gx, float& gy, float& gz,
                      bool grads) {
        const int o = (f * n1 * LX + ix) * LZ + iz;
        v = gx = gy = gz = 0.f;
#pragma unroll
        for (int j = 0; j < n1; ++j) {
          const float xv = sX[o + j * LX * LZ];
          v = fmaf(Sy[j], xv, v);
          if (grads) {
            gy = fmaf(Dy[j], xv, gy);
            gx = fmaf(Sy[j], sXD[o + j * LX * LZ], gx);
            gz = fmaf(Sy[j], sXZ[o + j * LX * LZ], gz);
          }
        }
      };
      float uv[4], udx[4], udy[4], udz[4];
      float lv[4] = {0.f, 0.f, 0.f, 0.f}, ldx[4] = {0.f, 0.f, 0.f, 0.f},
            ldy[4] = {0.f, 0.f, 0.f, 0.f}, ldz[4] = {0.f, 0.f, 0.f, 0.f};
      float dto[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 4; ++c) eval(c, uv[c], udx[c], udy[c], udz[c], true);
      if (incr) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          eval(4 + c, lv[c], ldx[c], ldy[c], ldz[c], true);
      } else {
        float g0, g1, g2;
#pragma unroll
        for (int c = 0; c < 3; ++c) eval(4 + c, lv[c], g0, g1, g2, false);
      }
      if (need_dt_old) {
        float g0, g1, g2;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          eval(4 + lead_ul + c, dto[c], g0, g1, g2, false);
      }

      // stabilization parameters
      const int cell2d = ey * m + ex;
      float d1, d2;
      if (cell_wise) {
        float msq = 0.f;
        for (int a = 0; a < NQ; ++a)            // qy'
#pragma unroll
          for (int bq = 0; bq < NQ; ++bq)       // qx'
#pragma unroll
            for (int c = 0; c < NQ; ++c)        // qz'
              msq = fmaxf(msq, susq[(a * LX + ex * NQ + bq) * lz +
                                    ezl * NQ + c]);
        gls_delta_cell(sc, __ldg(hp + cell2d), msq, d1, d2);
      } else {
        gls_delta_q(sc, __ldg(hp + m * m + cell2d),
                    lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2], d1, d2);
      }

      // reference -> physical gradients (prismatic J)
      const int q2 = (ey * NQ + qy) * Lq + ix;
      const float a00 = __ldg(ji + q2), a01 = __ldg(ji + LL + q2),
                  a10 = __ldg(ji + 2 * LL + q2),
                  a11 = __ldg(ji + 3 * LL + q2),
                  idz = __ldg(ji + 4 * LL + q2);
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

      const float w = __ldg(jw + q2) * __ldg(wzg + qz);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sW[c * QS + q] = vr[c] * w;
        sW[(4 + c) * QS + q] = (gr[c][0] * a00 + gr[c][1] * a01) * w;
        sW[(8 + c) * QS + q] = (gr[c][0] * a10 + gr[c][1] * a11) * w;
        sW[(12 + c) * QS + q] = (gr[c][2] * idz) * w;
      }
    }
    __syncthreads();

    // ---- I3: along y, items (c, ix, iz) -> node rows j -----------------
    for (StridedDigits<3> it({lz, LX, 4}); it.valid(); it.next()) {
      const int iz = it.d[0], ix = it.d[1], c = it.d[2];
      float wv[NQ], wx[NQ], wy[NQ], wzv[NQ];
#pragma unroll
      for (int qy = 0; qy < NQ; ++qy) {
        const int q = (qy * LX + ix) * lz + iz;
        wv[qy] = sW[c * QS + q];
        wx[qy] = sW[(4 + c) * QS + q];
        wy[qy] = sW[(8 + c) * QS + q];
        wzv[qy] = sW[(12 + c) * QS + q];
      }
#pragma unroll
      for (int j = 0; j < n1; ++j) {
        float yv = 0.f, yx = 0.f, yz = 0.f;
#pragma unroll
        for (int qy = 0; qy < NQ; ++qy) {
          yv = fmaf(S1[qy][j], wv[qy], yv);
          yv = fmaf(D1[qy][j], wy[qy], yv);
          yx = fmaf(S1[qy][j], wx[qy], yx);
          yz = fmaf(S1[qy][j], wzv[qy], yz);
        }
        const int o = ((c * 3 * n1 + j) * LX + ix) * LZ + iz;
        sY[o] = yv;
        sY[o + n1 * LX * LZ] = yx;
        sY[o + 2 * n1 * LX * LZ] = yz;
      }
    }
    __syncthreads();

    // ---- I2: along x, items (c, j, ex, iz) -> nodes P*ex .. P*ex+P-1 --
    // (and P*xb for the brick's last cell); the left node also takes cell
    // ex-1's
    for (StridedDigits<4> it({lz, xb, n1, 4}); it.valid(); it.next()) {
      const int iz = it.d[0], ex = it.d[1], j = it.d[2], c = it.d[3];
      const int o = ((c * 3 * n1 + j) * LX + ex * NQ) * LZ + iz;
      const int YS = n1 * LX * LZ;   // Yv -> Yx -> Yz
      float yv[NQ], yx[NQ], yz[NQ];
#pragma unroll
      for (int qx = 0; qx < NQ; ++qx) {
        yv[qx] = sY[o + qx * LZ];
        yx[qx] = sY[o + qx * LZ + YS];
        yz[qx] = sY[o + qx * LZ + 2 * YS];
      }
      float lv = 0.f, lzv = 0.f;     // cell ex-1 at its local node P
      if (ex > 0) {
#pragma unroll
        for (int qx = 0; qx < NQ; ++qx) {
          const int ol = o - NQ * LZ + qx * LZ;
          lv = fmaf(S1[qx][P], sY[ol], lv);
          lv = fmaf(D1[qx][P], sY[ol + YS], lv);
          lzv = fmaf(S1[qx][P], sY[ol + 2 * YS], lzv);
        }
      }
      float* vvp = sV + ((c * 2) * NR + j * XN + P * ex) * LZ + iz;
      float* vzp = vvp + NR * LZ;
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
        vvp[i * LZ] = vv;
        vzp[i * LZ] = vz;
      }
    }
    __syncthreads();

    // ---- I1: along z, one column (c, r) per thread, carry in registers -
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int it = threadIdx.x + k * blockDim.x;
      if (it < 4 * NR) {
        const int c = it / NR, r = it - c * NR;
        const float* vvp = sV + ((c * 2) * NR + r) * LZ;
        const float* vzp = sV + ((c * 2 + 1) * NR + r) * LZ;
        float* o = out + c * ostride + orow + (size_t)r * Nzn;
        for (int ezl = 0; ezl < zs; ++ezl) {
          const int zg = zl0 + ezl;            // global cell layer
          float vv[NQ], vz[NQ];
#pragma unroll
          for (int qz = 0; qz < NQ; ++qz) {
            vv[qz] = vvp[ezl * NQ + qz];
            vz[qz] = vzp[ezl * NQ + qz];
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
              if (zg >= zb) o[P * zg] = acc;
            } else if (kk < P) {
              if (zg >= zb) o[P * zg + kk] = acc;
            } else {
              carry[k] = acc;
            }
          }
        }
        if (s == n_slabs - 1 && ze == nz) o[P * nz] = carry[k];
      }
    }
    // the next iteration's barrier orders I1's reads of sV before E1
    // rewrites that region
  }
}

template <int P, int NQ>
int launch_tp(const float* u, const float* ul, const float* vo,
              const float* jinv, const float* jxw, const float* h,
              const float* S1, const float* D1, const float* wz, float* out,
              int n_p, int m, int nz, int flavor, int consider_dt,
              int cell_wise, GlsScalars sc, int xb, int ZS, int nzb,
              cudaStream_t stream) {
  if (n_p < 0 || m < 1 || nz < 1 || xb < 1 || m % xb != 0 || ZS < 1 ||
      ZS > nz || nzb < 1 || nzb > nz)
    return (int)cudaErrorInvalidValue;
  if (4 * (P + 1) * (P * xb + 1) > kMaxCols * kThreads)
    return (int)cudaErrorInvalidValue;
  const int ZC = (nz + nzb - 1) / nzb;
  if ((nzb - 1) * ZC >= nz) return (int)cudaErrorInvalidValue;
  const bool incr = flavor == GLS_INCREMENT;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  const int NF = 4 + (incr ? 4 : 3) + (need_dt_old ? 3 : 0);
  const int NG = incr ? 8 : 4;
  const size_t bytes =
      prism_smem(P, NQ, xb, ZS, NF, NG).total() * sizeof(float);
  // the opt-in limit and the kernel's dynamic shared-memory attribute are
  // looked up and raised once, not at every launch
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
  if (bytes + 11 * sizeof(float*) > (size_t)max_optin)
    return (int)cudaErrorInvalidValue;
  if (bytes > attr_bytes) {
    err = cudaFuncSetAttribute(prism_kernel<P, NQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = bytes;
  }
  if (n_p == 0) return 0;
  PrismDims dm{n_p, m, nz, xb, m / xb, ZS, ZC, nzb};
  prism_kernel<P, NQ><<<n_p * m * (m / xb) * nzb, kThreads, bytes,
                        stream>>>(u, ul, vo, jinv, jxw, h, S1, D1, wz, out,
                                  dm, flavor, consider_dt, cell_wise, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- host launcher (plain C interface, bound with ctypes) -------------
// xb, zs, nzb: cells per x brick (a divisor of m), cell layers per slab and
// z chunks per column (ops/prism.py prism_plan).  The library's degrees
// (NS_FOR_DEGREES) with NQ = P + 1 Gauss points.  Returns 0, a CUDA error
// code, or 1 (cudaErrorInvalidValue) for a degree, plan or input it does
// not take.
extern "C" int prism_sweep_launch(
    const float* u, const float* ul, const float* vo, const float* jinv,
    const float* jxw, const float* h, const float* S1, const float* D1,
    const float* wz, float* out, int n_p, int P, int NQ, int m, int nz,
    int flavor, int consider_dt, int cell_wise, float weight, float stau,
    float nu, float c1, float c2, int xb, int zs, int nzb, void* stream) {
  GlsScalars sc{weight, stau, nu, c1, c2};
  cudaStream_t st = (cudaStream_t)stream;
#define PRISM_CASE(PP)                                                      \
  if (P == PP && NQ == PP + 1)                                              \
    return launch_tp<PP, PP + 1>(u, ul, vo, jinv, jxw, h, S1, D1, wz, out,  \
                                 n_p, m, nz, flavor, consider_dt, cell_wise, \
                                 sc, xb, zs, nzb, st);
  NS_FOR_DEGREES(PRISM_CASE)
#undef PRISM_CASE
  return (int)cudaErrorInvalidValue;
}
