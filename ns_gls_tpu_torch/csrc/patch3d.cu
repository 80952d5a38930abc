// Fused patch-3D GLS sweep for Hopper (sm_90a): general 3D hex meshes.
//
// Replaces the TPU kernel ns_gls_tpu/ops/patch3d.py:_make_patch3d_kernel
// (the Pallas body of Patch3DSweep).  It computes the same function: for
// every patch (a coarse cell refined into an m x m x m lattice of cells,
// curved, in the coarse cell's own frame) evaluate u, u_lin and vec_old at
// every Gauss point (values and reference gradients from the 1D Lagrange
// tables), map the gradients with the full per-cell, per-q J^-1, compute
// delta_1/delta_2 (cell-wise over the cell's NQ^3 q-points, or per q),
// apply the 3D GLS q-point physics of gls_qpoint.cuh (fixed / increment /
// residual flavor) and integrate the test-function weights back onto the
// nodes with J^-T * |det J| * weight.
//
// Layout (the TPU's (G, H) patch grouping on rows and lanes, block-
// diagonal band matrices, class-grouped y planes and (8,128) padding are
// not carried over):
//   u, ul, vo  (n_nodes, 4)        node-major vectors (u_lin: 4 components
//                                  read in increment, 3 otherwise; vec_old:
//                                  3), read through the patch lattices
//   pnodes     (n_p, Xn, Xn, Xn)   int32 node id of lattice node [y][x][z]
//   jinv       (n_p, m, nbx, 9, QB)  per cell row ey and x brick bx:
//                                  entry r*3 + x of J^-1
//   jxw        (n_p, m, nbx, QB)   |det J| * weight
//   h          (n_p, m, nbx, 2, m*xb)  per cell ez*xb + ex of the brick's
//                                  row: h_min_vertex, hq
//   tiles      (n_p, m, nbx, Xn, P+1, XN, 4)  cell-row tiles: cell row ey,
//                                  x brick bx, node plane z, its node row
//                                  j, node P*xb*bx + x, component: the
//                                  integrals over the cells of cell row ey
//                                  in brick bx only
// with Xn = P*m + 1, XN = P*xb + 1, QB = m*NQ^3*xb and the q-points of a
// brick's cell row in the order (((ez*NQ + qz)*NQ + qy)*xb + ex)*NQ + qx.
// Node rows shared by two cell rows, node columns shared by two bricks,
// and the patch seams, are summed by one launch of the seam-sum kernel
// (csrc/seam_sum.cu: per node, its tile positions in a fixed order).
//
// What bounds the function on an H100, at the sphere's finest level
// (input/sphere_amg.json: P = 2, NQ = 3, m = 8, Xn = 17, 48 patches,
// 24,576 cells, 202,818 nodes), increment flavor without the history
// term (the config is stationary; utils/roofline.py patch3d_cost):
//   bytes: u 4 + u_lin 4 node tiles of 48 x 17^3 floats = 7.5 MB, the
//          seam-compressed output 4 x 202,818 floats = 3.2 MB, geometry
//          (9 jinv entries + jxw at 663,552 q-points, h) 26.7 MB:
//          37.5 MB -> 11.2 us at 3.35 TB/s (reading u and u_lin node-major
//          through the int32 lattice ids instead of as tiles moves 0.4 MB
//          more);
//   flops of a sum-factorized evaluation and integration on the patch
//          lattices plus ~370 per q-point of geometry, delta and physics:
//          0.58 GFLOP -> 8.7 us at 67 TFLOP/s f32.
// So the function is bound by bytes, most of them the geometry.  The
// previous design of this file summed, per q-point, over the cell's 27
// nodes and, per node, over the 27 q-points of up to four cells, every
// operand a shared-memory load, with synchronous slab copies: 218.0 us per
// launch at that shape (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section
// 6), 19.5x the bound; the gather of u into tiles and the seam sums around
// it added 0.85x the kernel's time.
//
// Design: the prism kernel's (csrc/prism.cu) and the 3D structured one's
// (csrc/structured.cu structured3d_kernel), with the geometry read per
// q-point.  One thread block per (patch, cell row ey, x brick, z chunk);
// it walks its chunk in slabs of ZS cell layers.  A brick of xb cells (the
// whole cell row where it fits) bounds every shared region and the I1
// columns per thread whatever the patch size m.
//  - Sum factorization along every axis: a slab is evaluated along z
//    (E1), then x (E2), then y (E3, one thread per q-point, which maps the
//    reference gradients with its own 3 x 3 J^-1 and runs the physics in
//    registers); the test-function weights are integrated back along y
//    (I3), x (I2) and z (I1).  P is a template parameter (degrees 1-4,
//    NQ = P + 1), so the 1D tables and the short contractions live in
//    registers.
//  - All components together: E1 and E2 take every component of one field
//    through a contraction (E1 reads a node's four components as one
//    16-byte word), I3 and I2 all four test-function components.
//  - The gather folded in: the block loads the int32 lattice ids of its
//    node rows once, and each slab copies every node's u, u_lin (and
//    vec_old) as one 16-byte cp.async each from the node-major vectors, so
//    no tile of u is made per apply.
//  - The geometry stream, 10 floats per q-point and most of the bytes: a
//    slab's q-points are consecutive in the tables, so each of the ten
//    entries is one contiguous run, copied with 16-byte cp.async (4-byte
//    where m*NQ^3 is not a multiple of 4) in the tables' order, and E3's
//    thread for q-point q reads entry e at e*QS + q (consecutive threads,
//    consecutive words).  The next slab's geometry is copied as soon as E3
//    has read this slab's, so the copy overlaps I3, I2, I1 and the next
//    slab's E1 and E2; one buffer, not two, keeps a block within the
//    ~113 KB that lets two blocks share an SM.  The node slabs are double-
//    buffered: the next slab's nodes are copied while this one computes.
//  - z in registers: in I1 a thread keeps the node plane shared by two cell
//    layers in a register, across slabs too, and writes finished planes to
//    the tile.  A z chunk that does not start the column first evaluates
//    the cell layer below it, for the carry only, and writes only its own
//    planes: the output does not depend on the chunking.
//  - The cell-wise delta needs the maximum of |u*|^2 over the cell's NQ^3
//    q-points before the physics: E3a gives each cell one warp, which
//    evaluates u* at the cell's q-points and reduces with shuffles.
//  - The loops over a stage's items advance their indices as mixed-radix
//    digits (StridedDigits), with no runtime division per item.
//  - Exact f32 FMAs, no tensor cores, no atomics: two launches on the same
//    inputs give the same bits.
// The brick, slab depth and z chunks come from the caller (ops/patch3d.py
// patch3d_brick, patch3d_plan: least estimated waves x slabs x slab time,
// made when the tables are built); the launcher refuses a degree, plan or
// input it does not take.  Launch: 256 threads,
// at most 128 registers (two blocks per SM).
//
// Measured (tools/patch3d_levels.py, device time by torch.profiler, the
// sphere path's case, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6):
// 68.4 us at m = 8 (the previous design 215.8 us in the same process),
// 6.1x the bound, 73.9 us with the seam sums (the previous gather, kernel
// and class sums 402.9); 489.8 us at m = 16 (1,422.0), 12.6 at m = 4
// (37.2), 6.9 at m = 2 (16.0).  Other slab depths and chunkings were
// slower (its --sweep).  With the x bricks (the whole row one brick on
// every sphere level): 67.0 us at m = 8 against 68.2 for the revision
// without them in the same process, the same bits; 21.9-278.6 us at the
// single-patch shapes it refused before (PERF.md section 6).
#include <cuda_runtime.h>

#include "gls_qpoint.cuh"

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;
// I1 columns (4 components x node rows x nodes) a thread may own
constexpr int kMaxCols = 2;

struct P3Dims {
  int n_p, m;
  int xb;      // cells per x brick
  int nbx;     // bricks per cell row
  int ZS;      // cell layers per slab
  int ZC;      // cell layers per z chunk
  int nzb;     // z chunks per column
  int geo16;   // geometry runs 16-byte aligned: 16-byte copies
};

// shared-memory regions of one block, in 4-byte words: the staged node
// slabs (two buffers, 4 components a node), the slab's geometry, region 1
// (A, Az -> W -> V), region 2 (X, XD, XZ -> Y), the cells' max |u*|^2 and
// the lattice ids of the block's walk
struct P3Smem {
  size_t in, geo, r1, r2, cells, idx;
  __host__ __device__ size_t total() const {
    return in + geo + r1 + r2 + cells + idx;
  }
};

__host__ __device__ inline size_t p3_max(size_t a, size_t b) {
  return a > b ? a : b;
}

__host__ __device__ inline size_t p3_round4(size_t a) {
  return (a + 3) / 4 * 4;
}

// xb: the brick's cells along x; walk: the most cell layers a block walks
// (its chunk and the layer below)
__host__ __device__ inline P3Smem p3_smem(int P, int xb, int ZS, int walk,
                                          int NK, int NF, int NG) {
  const size_t n1 = P + 1, NQ = P + 1;
  const size_t Xn = (size_t)P * xb + 1, LX = NQ * xb;
  const size_t ZN = (size_t)P * ZS + 1, LZ = NQ * ZS;
  const size_t PL = n1 * Xn;          // one node plane of the cell row
  const size_t QS = LZ * NQ * LX;     // q-points per slab
  const size_t XF = LZ * n1 * LX;     // one field's X
  return P3Smem{2 * NK * 4 * ZN * PL,
                p3_round4(10 * QS),
                p3_round4(p3_max(p3_max((NF + NG) * LZ * PL, 16 * QS),
                                 8 * LZ * PL)),
                p3_round4(p3_max((NF + 2 * NG) * XF, 12 * XF)),
                p3_round4((size_t)ZS * xb),
                ((size_t)P * walk + 1) * PL};
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

template <int P>
__global__ void __launch_bounds__(kThreads, 2)
patch3d_kernel(const float* __restrict__ u, const float* __restrict__ ul,
               const float* __restrict__ vo, const int* __restrict__ pnodes,
               const float* __restrict__ jinv, const float* __restrict__ jxw,
               const float* __restrict__ hcell,
               const float* __restrict__ S1g, const float* __restrict__ D1g,
               float* __restrict__ tiles, P3Dims dm, int flavor,
               int consider_dt, int cell_wise, GlsScalars sc) {
  extern __shared__ __align__(16) float smem[];
  constexpr int n1 = P + 1, NQ = P + 1, NQ3 = NQ * NQ * NQ;
  const int m = dm.m, ZS = dm.ZS, xb = dm.xb;
  int blk = blockIdx.x;
  const int kz = blk % dm.nzb;
  blk /= dm.nzb;
  const int bx = blk % dm.nbx;
  blk /= dm.nbx;
  const int ey = blk % m;
  const int p = blk / m;
  const int XP = P * m + 1;          // the patch's nodes per lattice axis
  const int Xn = P * xb + 1;         // the brick's nodes along x
  const int LX = NQ * xb, ZN = P * ZS + 1, LZ = NQ * ZS;
  const int PL = n1 * Xn;            // one node plane of the brick's row
  const int QS = LZ * NQ * LX;
  const int XF = LZ * n1 * LX;
  const int QB = m * NQ3 * xb;
  const bool incr = flavor == GLS_INCREMENT;
  const int lead_ul = incr ? 4 : 3;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  const int NF = 4 + lead_ul + (need_dt_old ? 3 : 0);   // fields
  const int NG = incr ? 8 : 4;                         // fields with grads
  const int NK = need_dt_old ? 3 : 2;   // staged vectors: u, u_lin, vec_old

  // the z chunk: owned layers [zb, ze), walked from lo (one layer below
  // zb when the chunk does not start the column)
  const int zb = kz * dm.ZC;
  const int ze = min(zb + dm.ZC, m);
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

  const P3Smem sm =
      p3_smem(P, xb, ZS, dm.ZC + (dm.nzb > 1 ? 1 : 0), NK, NF, NG);
  float* sIn = smem;                     // (2, NK, ZN, n1, Xn, 4)
  float* sGeo = sIn + sm.in;             // (10, QS): J^-1 entries, JxW
  float* sA = sGeo + sm.geo;             // (NF, LZ, n1, Xn)
  float* sAz = sA + NF * LZ * PL;        // (NG, LZ, n1, Xn)
  float* sW = sA;                        // (4 kinds, 4 c, QS)
  float* sV = sA;                        // (4 c, 2, LZ, n1, Xn)
  float* sX = sA + sm.r1;                // (NF, LZ, n1, LX)
  float* sXD = sX + NF * XF;             // (NG, LZ, n1, LX)
  float* sXZ = sXD + NG * XF;            // (NG, LZ, n1, LX)
  float* sY = sX;                        // (4 c, 3, LZ, n1, LX)
  float* scell = sX + sm.r2;             // (ZS, xb) max |u*|^2 per cell
  int* sIdx = reinterpret_cast<int*>(scell + sm.cells);  // (planes, n1, Xn)

  // the lattice ids of the walk's node planes of rows P*ey .. P*ey + P
  // and the brick's nodes: sIdx[zz * PL + j * Xn + x] is node (y = P*ey +
  // j, x = P*xb*bx + x, z = P*lo + zz)
  {
    const size_t row0 = ((size_t)p * XP + (size_t)P * ey) * XP +
                        (size_t)P * xb * bx;
    const int nzp = P * (ze - lo) + 1;
    for (StridedDigits<3> e({nzp, Xn, n1}); e.valid(); e.next())
      sIdx[e.d[0] * PL + e.d[2] * Xn + e.d[1]] =
          __ldg(pnodes + (row0 + (size_t)e.d[2] * XP + e.d[1]) * XP +
                P * lo + e.d[0]);
  }
  __syncthreads();

  // copy the nodes of the slab starting at cell layer zl0 into buffer buf:
  // one 16-byte cp.async per node and vector (the caller commits)
  const int VB = ZN * PL * 4;            // one vector's staged slab
  auto stage = [&](int zl0, int zs, int buf) {
    const int zn = P * zs + 1;
    float* dst0 = sIn + buf * NK * VB;
    const int* ids = sIdx + P * (zl0 - lo) * PL;
    for (StridedDigits<2> e({PL, zn}); e.valid(); e.next()) {
      const int o = e.d[1] * PL + e.d[0];
      const size_t g = (size_t)ids[o] * 4;
      float* d = dst0 + o * 4;
      cp_async16(d, u + g);
      cp_async16(d + VB, ul + g);
      if (NK == 3) cp_async16(d + 2 * VB, vo + g);
    }
  };

  // copy the geometry of the slab starting at cell layer zl0: ten runs of
  // its q-points, in the tables' order (the caller commits)
  const size_t grow = ((size_t)p * m + ey) * dm.nbx + bx;
  const float* jiRow = jinv + grow * 9 * QB;
  const float* jwRow = jxw + grow * QB;
  const float* hRow = hcell + grow * 2 * m * xb;
  auto stage_geo = [&](int zl0, int zs) {
    const int nq = zs * NQ3 * xb;
    const int q0 = zl0 * NQ3 * xb;
    if (dm.geo16) {
      for (StridedDigits<2> e({nq / 4, 10}); e.valid(); e.next()) {
        const int i = 4 * e.d[0], k = e.d[1];
        cp_async16(sGeo + k * QS + i,
                   (k < 9 ? jiRow + (size_t)k * QB : jwRow) + q0 + i);
      }
    } else {
      for (StridedDigits<2> e({nq, 10}); e.valid(); e.next()) {
        const int i = e.d[0], k = e.d[1];
        cp_async4(sGeo + k * QS + i,
                  (k < 9 ? jiRow + (size_t)k * QB : jwRow) + q0 + i);
      }
    }
  };

  // the z carries of the I1 columns this thread owns, (j, x, c) =
  // threadIdx.x + k * blockDim.x with c fastest, fixed for the whole walk
  const int n_cols = 4 * PL;
  float carry[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) carry[k] = 0.f;
  float* tileRow = tiles + grow * XP * PL * 4;   // (plane, j, x, c)

  const int n_slabs = (ze - lo + ZS - 1) / ZS;
  stage(lo, min(ZS, ze - lo), 0);
  stage_geo(lo, min(ZS, ze - lo));
  cp_async_commit();
  for (int s = 0; s < n_slabs; ++s) {
    const int zl0 = lo + s * ZS;
    const int zs = min(ZS, ze - zl0);   // cell layers in this slab
    const int lz = NQ * zs;             // q-point layers in this slab
    if (s + 1 < n_slabs) {
      const int z1 = zl0 + ZS;
      stage(z1, min(ZS, ze - z1), (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();   // this slab's nodes and geometry
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sbuf = sIn + (s & 1) * NK * VB;

    // ---- E1: along z; items (node x, node row j, cell layer, vector) ---
    for (StridedDigits<4> it({Xn, n1, zs, NK}); it.valid(); it.next()) {
      const int xl = it.d[0], j = it.d[1], ezl = it.d[2], g = it.d[3];
      const int f0 = g == 0 ? 0 : (g == 1 ? 4 : 4 + lead_ul);
      const int nc = g == 0 ? 4 : (g == 1 ? lead_ul : 3);
      const bool grads = f0 < NG;
      const float4* col = reinterpret_cast<const float4*>(sbuf + g * VB) +
                          (P * ezl * n1 + j) * Xn + xl;
      float4 nd[n1];
#pragma unroll
      for (int k = 0; k < n1; ++k) nd[k] = col[k * PL];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nc) break;
        const int f = f0 + c;
#pragma unroll
        for (int qz = 0; qz < NQ; ++qz) {
          float v = 0.f, d = 0.f;
#pragma unroll
          for (int k = 0; k < n1; ++k) {
            const float a = lane_of(nd[k], c);
            v = fmaf(S1[qz][k], a, v);
            d = fmaf(D1[qz][k], a, d);
          }
          const int o = ((f * LZ + ezl * NQ + qz) * n1 + j) * Xn + xl;
          sA[o] = v;
          if (grads) sAz[o] = d;
        }
      }
    }
    __syncthreads();

    // ---- E2: along x; items (cell ex, node row j, q layer iz, vector) --
    for (StridedDigits<4> it({xb, n1, lz, NK}); it.valid(); it.next()) {
      const int ex = it.d[0], j = it.d[1], iz = it.d[2], g = it.d[3];
      const int f0 = g == 0 ? 0 : (g == 1 ? 4 : 4 + lead_ul);
      const int nc = g == 0 ? 4 : (g == 1 ? lead_ul : 3);
      const bool grads = f0 < NG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nc) break;
        const int f = f0 + c;
        const int a0 = ((f * LZ + iz) * n1 + j) * Xn + P * ex;
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
        float mx = 0.f;
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
          mx = fmaxf(mx, us);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (lane == 0) scell[ezl * xb + ex] = mx;
      }
      __syncthreads();
    }

    // q-point q of the slab: q = (iz * NQ + qy) * LX + ix, the tables'
    // order of the slab's q-points
    // ---- E3b: along y, delta, physics, test-function weights ----------
    for (StridedDigits<3> it({LX, NQ, lz}); it.valid(); it.next()) {
      const int ix = it.d[0], qy = it.d[1], iz = it.d[2];
      const int q = (iz * NQ + qy) * LX + ix;
      const int ex = ix / NQ;
      const int ezl = iz / NQ;
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

      // this q-point's geometry, staged with the slab
      float ji[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) ji[e] = sGeo[e * QS + q];

      // stabilization parameters
      const int cell = (zl0 + ezl) * xb + ex;
      float d1, d2;
      if (cell_wise) {
        gls_delta_cell(sc, __ldg(hRow + cell), scell[ezl * xb + ex], d1, d2);
      } else {
        gls_delta_q(sc, __ldg(hRow + m * xb + cell),
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

      const float w = sGeo[9 * QS + q];
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

    // the next slab's geometry, now that E3b has read this one's
    if (s + 1 < n_slabs) {
      const int z1 = zl0 + ZS;
      stage_geo(z1, min(ZS, ze - z1));
      cp_async_commit();
    }

    // ---- I3: along y; items (q column ix, q layer iz) -> node rows j ---
    const int YS = LZ * n1 * LX;   // Y kinds: value -> x -> z
    for (StridedDigits<2> it({LX, lz}); it.valid(); it.next()) {
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
        float* vvp = sV + ((c * 2 * LZ + iz) * n1 + j) * Xn + P * ex;
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

    // ---- I1: along z, one column (j, x, c) per thread, carry in registers
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int it = threadIdx.x + k * blockDim.x;
      if (it < n_cols) {
        const int c = it & 3;
        const int r = it >> 2;           // j * Xn + x
        const float* vvp = sV + c * 2 * VS + r;
        float* o = tileRow + it;
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
              if (zg >= zb) o[(size_t)P * zg * n_cols] = acc;
            } else if (kk < P) {
              if (zg >= zb) o[(size_t)(P * zg + kk) * n_cols] = acc;
            } else {
              carry[k] = acc;
            }
          }
        }
        if (s == n_slabs - 1 && ze == m) o[(size_t)P * m * n_cols] = carry[k];
      }
    }
    // the next iteration's barrier orders I1's reads of sV before E1
    // rewrites that region
  }
}

}  // namespace

// ---- host side: the launcher (the host C++ rehearsal of the kernel body
// runs its own) --------------------------------------------------------
#ifndef SWEEP_HOST_REHEARSAL
namespace {

bool aligned16(const void* ptr) {
  return (reinterpret_cast<size_t>(ptr) & 15) == 0;
}

template <int P>
int launch_tp(const float* u, const float* ul, const float* vo,
              const int* pnodes, const float* jinv, const float* jxw,
              const float* h, const float* S1, const float* D1, float* tiles,
              int n_p, int m, int flavor, int consider_dt, int cell_wise,
              GlsScalars sc, int xb, int ZS, int nzb, cudaStream_t stream) {
  constexpr int NQ3 = (P + 1) * (P + 1) * (P + 1);
  if (n_p < 0 || m < 1 || xb < 1 || m % xb != 0 || ZS < 1 || ZS > m ||
      nzb < 1 || nzb > m)
    return (int)cudaErrorInvalidValue;
  if (4 * (P + 1) * (P * xb + 1) > kMaxCols * kThreads)
    return (int)cudaErrorInvalidValue;
  const int ZC = (m + nzb - 1) / nzb;
  if ((nzb - 1) * ZC >= m) return (int)cudaErrorInvalidValue;
  // the node vectors are read 16 bytes a node
  if (!aligned16(u) || !aligned16(ul) || !aligned16(vo))
    return (int)cudaErrorInvalidValue;
  const int geo16 = (NQ3 * xb) % 4 == 0 && aligned16(jinv) && aligned16(jxw);
  const bool incr = flavor == GLS_INCREMENT;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  const int NF = 4 + (incr ? 4 : 3) + (need_dt_old ? 3 : 0);
  const int NK = need_dt_old ? 3 : 2;
  const size_t bytes =
      p3_smem(P, xb, ZS, ZC + (nzb > 1 ? 1 : 0), NK, NF, incr ? 8 : 4)
          .total() * sizeof(float);
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
  if (bytes > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  if (bytes > attr_bytes) {
    err = cudaFuncSetAttribute(patch3d_kernel<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = bytes;
  }
  if (n_p == 0) return 0;
  P3Dims dm{n_p, m, xb, m / xb, ZS, ZC, nzb, geo16};
  patch3d_kernel<P><<<n_p * m * (m / xb) * nzb, kThreads, bytes, stream>>>(
      u, ul, vo, pnodes, jinv, jxw, h, S1, D1, tiles, dm, flavor,
      consider_dt, cell_wise, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- host launchers (plain C interface, bound with ctypes) ------------
// Degrees 1-4 with NQ = P + 1 Gauss points; xb cells per x brick (a
// divisor of m), zs cell layers per slab and nzb z chunks per column
// (ops/patch3d.py patch3d_plan).  Returns 0, a CUDA error code, or 1
// (cudaErrorInvalidValue) for a degree, plan or input it does not take.
extern "C" int patch3d_sweep_launch(
    const float* u, const float* ul, const float* vo, const int* pnodes,
    const float* jinv, const float* jxw, const float* h, const float* S1,
    const float* D1, float* tiles, int n_p, int P, int NQ, int m, int flavor,
    int consider_dt, int cell_wise, float weight, float stau, float nu,
    float c1, float c2, int xb, int zs, int nzb, void* stream) {
  GlsScalars sc{weight, stau, nu, c1, c2};
  cudaStream_t st = (cudaStream_t)stream;
#define P3_CASE(PP)                                                         \
  if (P == PP && NQ == PP + 1)                                              \
    return launch_tp<PP>(u, ul, vo, pnodes, jinv, jxw, h, S1, D1, tiles,    \
                         n_p, m, flavor, consider_dt, cell_wise, sc, xb,    \
                         zs, nzb, st);
  P3_CASE(1)
  P3_CASE(2)
  P3_CASE(3)
  P3_CASE(4)
#undef P3_CASE
  return (int)cudaErrorInvalidValue;
}

// What the compiler gave patch3d_kernel<P>: registers per thread, local
// memory (spills) and static shared memory per thread block in bytes; and
// the dynamic shared memory of one block in bytes for the plan (xb, zs,
// nzb) on patches of m cells a side and the flavor's fields.  Returns 0 or
// a CUDA error code.
extern "C" int patch3d_attributes(int P, int m, int xb, int zs, int nzb,
                                  int flavor, int consider_dt, int* regs,
                                  int* local_bytes, int* static_smem,
                                  long long* dynamic_smem) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaErrorInvalidValue;
  if (P == 1) err = cudaFuncGetAttributes(&a, patch3d_kernel<1>);
  if (P == 2) err = cudaFuncGetAttributes(&a, patch3d_kernel<2>);
  if (P == 3) err = cudaFuncGetAttributes(&a, patch3d_kernel<3>);
  if (P == 4) err = cudaFuncGetAttributes(&a, patch3d_kernel<4>);
  if (err != cudaSuccess) return (int)err;
  if (m < 1 || xb < 1 || m % xb != 0 || nzb < 1 || nzb > m)
    return (int)cudaErrorInvalidValue;
  const bool incr = flavor == GLS_INCREMENT;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  const int ZC = (m + nzb - 1) / nzb;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  *dynamic_smem = (long long)(
      p3_smem(P, xb, zs, ZC + (nzb > 1 ? 1 : 0), need_dt_old ? 3 : 2,
              4 + (incr ? 4 : 3) + (need_dt_old ? 3 : 0), incr ? 8 : 4)
          .total() * sizeof(float));
  return 0;
}
#endif  // SWEEP_HOST_REHEARSAL
