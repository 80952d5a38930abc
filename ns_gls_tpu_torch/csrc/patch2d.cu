// Fused patch-2D GLS sweep for Hopper (sm_90a): general 2D quad meshes.
//
// Replaces the TPU kernel ns_gls_tpu/ops/patch2d.py:_make_patch2d_kernel
// (the Pallas body of Patch2DSweep).  It computes the same function: for
// every patch (a coarse cell refined into an m x m lattice of curved quad
// cells with (P*m+1)^2 nodes, in the coarse cell's own frame) evaluate u,
// u_lin and vec_old at every Gauss point (values and reference gradients
// from the 1D Lagrange tables), map the gradients with the per-cell,
// per-q inverse Jacobian, compute delta_1/delta_2 (cell-wise over the
// cell's NQ^2 q-points, or per q), apply the GLS q-point physics of
// gls_qpoint.cuh (fixed / increment / residual flavor) and integrate the
// test-function weights back onto the nodes with J^-T * |det J| * weight.
//
// Layout (the TPU's G x H patch groups, banded MXU matmuls, (8,128)
// padding and class-grouped seam compress are not carried over):
//   u, ul, vo  (n_nodes, 3)       node-major vectors (u_lin: 3 components
//                                 read in increment, 2 otherwise; vec_old:
//                                 2), read through the patch lattices
//   pnodes     (n_p, Xn, Xn)      int32 node id of lattice node [y][x]
//   jinv       (n_p, 4, Lq, Lq)   entry r*2+x = dxi_r/dx_x at q (iy, ix)
//   jxw        (n_p, Lq, Lq)      |det J| * weight
//   h          (n_p, 2, m, m)     per cell: h_min_vertex, measure-based h
//   tiles      (n_p, m, nbx, P+1, XN, 3)  cell-row tiles: cell row ey, x
//                                 brick bx of XB cells, its node row j,
//                                 node x of the brick, component: the
//                                 integrals over cell row ey of brick bx
//                                 only
// with Xn = P*m + 1, Lq = NQ*m, q-point row iy = ey*NQ + qy and column
// ix = ex*NQ + qx, XN = P*XB + 1 and nbx = m / XB.  Node rows shared by
// two cell rows, node columns shared by two bricks, and the patch seams
// are summed by one launch of the seam-sum kernel (csrc/seam_sum.cu: per
// node, its tile rows in a fixed order).
//
// What bounds the function on an H100, at the Turek 2D ref-3 shapes
// (P = 2, NQ = 3, m = 8: 289 nodes and 576 q-points per patch, 88
// patches, 22,992 nodes), increment flavor with the history term
// (utils/roofline.py patch2d_cost):
//   bytes: per patch u 3468 + u_lin 3468 + vec_old 2312 + jinv 9216
//          + jxw 2304 + h 512 = 21.3 KB, x 88, plus the seam-compressed
//          output 3 x 22,992 floats: 2.15 MB -> 0.64 us at 3.35 TB/s
//   flops: a sum-factorized evaluation and integration plus the q-point
//          geometry, delta and physics: 21 MFLOP -> 0.31 us at 67 TFLOP/s
// so the work is well under a microsecond: at the main path's shapes the
// call is bound by latency (a launch and a few dependent stages per
// block), not by bytes or flops.  The previous design of this file staged
// a patch's whole tile and all of its q-point weights in shared memory,
// one block per patch (88 blocks for 132 SMs), summed per q-point over the
// cell's nodes and per node over the q-points of up to four cells, every
// operand a shared-memory load, and could not launch at all past ~227 KB
// a patch (P = 2 at m = 32, P = 3 at m = 16); its sweep also gathered u
// into tiles and summed the seams by multiplicity classes around it.
//
// Design: the 2D structured kernel's (csrc/structured.cu
// structured2d_kernel) with the patch-3D kernel's per-q-point geometry
// stream and node-major reads (csrc/patch3d.cu).  One thread block per
// (patch, x brick of XB cells, y chunk of YC cell rows); it walks its
// chunk in slabs of YS cell rows.  A block's shared memory grows with its
// brick, slab and chunk, which the plan sizes, never with the patch, so
// every m launches.
//  - Sum factorization along both axes: a slab is evaluated along y (E1:
//    an item takes every component of one field, u, u_lin or vec_old,
//    through the (P+1) -> NQ contraction of one node column), then along
//    x by one thread per q-point, which maps the reference gradients with
//    its own J^-1 and goes on to the physics in registers (E2); the
//    test-function weights are integrated back along x (I2, an item per
//    cell, q-row and component: the three test-function kinds together)
//    and along y (I1, one (node column, component) per thread).  P is a
//    template parameter (NQ = P + 1), so the 1D tables and the (P+1)-term
//    sums live in registers.
//  - Cell-row tiles: I1 writes each cell row's P+1 node rows to its own
//    tile, so a block needs no neighbour and no carry, and the y chunking
//    changes no bit of the output.
//  - The gather folded in: the block loads the int32 lattice ids of its
//    chunk's node rows once, and each slab copies every node's components
//    with 4-byte cp.async straight from the node-major vectors.
//  - The geometry stream (5 floats per q-point, most of the bytes): a
//    slab's q-rows are contiguous runs of the tables, copied with 16-byte
//    cp.async where NQ*XB is a multiple of 4 (4-byte otherwise) in the
//    tables' order, with its cells' h; E2's thread for q-point q reads
//    entry e at e*QS + q.  The first slab's geometry is in flight while the
//    block loads its lattice ids; the next slab's is copied as soon as E2
//    has read this one's, so the copy overlaps I2, I1 and the next slab's
//    E1; the node slabs are double-buffered.
//  - E2 gives a warp whole cells (32 / NQ^2 of them, each cell's q-points
//    on consecutive lanes; up to four passes a slab), so the cell-wise
//    delta's max of |u*|^2 over the cell's q-points is a shuffle among
//    those lanes: no barrier, no second evaluation.  A cell of more than
//    32 q-points (P = 5, 6) takes a whole warp, each lane its q-points in
//    rounds; the cell-wise max is then taken over the warp first (u* alone
//    at each of the lane's q-points) and the physics runs round by round.
//  - Loop indices advance as mixed-radix digits (StridedDigits); a
//    thread's q-point and I1 columns are fixed for the walk.
//  - Exact f32 FMAs, no tensor cores, no atomics: two launches on the same
//    inputs give the same bits.
// The brick, slab depth and y chunks come from the caller (ops/patch2d.py
// patch2d_plan: least estimated waves x slabs x slab time; the brick is
// fixed per tables, since it sets the tiles' layout); the launcher refuses
// a degree, plan or input it does not take.  Launch: 256 threads, at most
// 128 registers (two blocks per SM).
//
// Measured (tools/patch2d_levels.py, device time by torch.profiler, the
// Turek path's case, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6):
// 6.27 us at m = 8 (the previous design 12.70 us in the same process),
// 9.8x the bound, 8.75 us with the seam sum (the previous gather, kernel
// and class sums 40.51); 4.2-4.6 us at m = 1-4, 12.85 us at m = 16 and
// 49.8 us at m = 32 (refused before), where ~8 ns per q-point per SM, not
// latency, bounds it.
#include <cuda_runtime.h>

#include "gls_qpoint.cuh"

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;
// I1 columns (brick nodes x 3 components) a thread may own
constexpr int kMaxCols = 2;
// passes of E2 over a slab's cells (each warp takes 32 / NQ^2 cells a pass,
// one cell above 32 q-points)
constexpr int kMaxPass = 4;

struct P2Dims {
  int n_p, m;
  int XB;      // cells per x brick (divides m)
  int nbx;     // bricks per cell row
  int YS;      // cell rows per slab
  int YC;      // cell rows per y chunk
  int nyb;     // y chunks per patch
  int geo16;   // geometry rows 16-byte aligned: 16-byte copies
};

// shared-memory regions of one block, in 4-byte words: the staged node
// rows (two buffers), the slab's geometry (J^-1 and JxW per q-point, h per
// cell), the y-contracted fields (A, Ay; then the x adjoint V), the
// test-function weights W and the lattice ids of the chunk's node rows
struct P2Smem {
  size_t in, geo, a, w, idx;
  __host__ __device__ size_t total() const { return in + geo + a + w + idx; }
};

__host__ __device__ inline size_t p2_max(size_t a, size_t b) {
  return a > b ? a : b;
}

__host__ __device__ inline size_t p2_round4(size_t a) {
  return (a + 3) / 4 * 4;
}

__host__ __device__ inline P2Smem p2_smem(int P, int XB, int YS, int YC,
                                          int NF, int NG) {
  const size_t NQ = P + 1;
  const size_t XN = (size_t)P * XB + 1, LX = NQ * XB;
  const size_t YN = (size_t)P * YS + 1, LY = NQ * YS;
  const size_t QS = LY * LX;   // q-points of a slab
  return P2Smem{p2_round4(2 * NF * YN * XN),
                p2_round4(5 * QS + 2 * (size_t)YS * XB),
                p2_round4(p2_max((NF + NG) * LY * XN, 6 * LY * XN)),
                p2_round4(9 * QS), ((size_t)P * YC + 1) * XN};
}

template <int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks<P>)
patch2d_kernel(const float* __restrict__ u, const float* __restrict__ ul,
               const float* __restrict__ vo, const int* __restrict__ pnodes,
               const float* __restrict__ jinv, const float* __restrict__ jxw,
               const float* __restrict__ hcell,
               const float* __restrict__ S1g, const float* __restrict__ D1g,
               float* __restrict__ tiles, P2Dims dm, int flavor,
               int consider_dt, int cell_wise, GlsScalars sc) {
  extern __shared__ __align__(16) float smem[];
  constexpr int n1 = P + 1, NQ = P + 1, NQ2 = NQ * NQ;
  // cells per warp in E2, and each lane's q-point rounds per cell (more
  // than one only for a cell of more than 32 q-points)
  constexpr int CPW = NQ2 <= 32 ? 32 / NQ2 : 1;
  constexpr int NSUB = (NQ2 + 31) / 32;
  const int m = dm.m, XB = dm.XB, YS = dm.YS;
  int blk = blockIdx.x;
  const int ky = blk % dm.nyb;
  blk /= dm.nyb;
  const int bx = blk % dm.nbx;
  const int p = blk / dm.nbx;
  const int x0 = bx * XB;            // the brick's first cell
  const int Xn = P * m + 1, Lq = NQ * m;
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

  // the y chunk: cell rows [yb, ye)
  const int yb = ky * dm.YC;
  const int ye = min(yb + dm.YC, m);

  // 1D tables in registers
  float S1[NQ][n1], D1[NQ][n1];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < n1; ++i) {
      S1[q][i] = __ldg(S1g + q * n1 + i);
      D1[q][i] = __ldg(D1g + q * n1 + i);
    }

  const P2Smem sm = p2_smem(P, XB, YS, dm.YC, NF, NG);
  float* sIn = smem;                    // (2, NF, YN, XN)
  float* sGeo = sIn + sm.in;            // (5, QS): J^-1 entries, JxW;
  float* sH = sGeo + 5 * QS;            //   then (2, YS, XB): h1, hq
  float* sA = sGeo + sm.geo;            // (NF, LY, XN) values along y
  float* sAy = sA + NF * AF;            // (NG, LY, XN) y-derivatives
  float* sV = sA;                       // (3 c, 2, LY, XN) x adjoint:
                                        //   value -> y
  float* sW = sA + sm.a;                // (3 kinds, 3 c, QS) weights:
                                        //   value, d/dxi_x, d/dxi_y
  int* sIdx = reinterpret_cast<int*>(sW + sm.w);   // (rows, XN)

  // copy the geometry of the slab starting at cell row y0: for each of the
  // five entries, its q-rows' runs over the brick, in the tables' order,
  // and its cells' h (the caller commits)
  const size_t LL = (size_t)Lq * Lq;
  const float* jiP = jinv + (size_t)p * 4 * LL;
  const float* jwP = jxw + (size_t)p * LL;
  const float* hP = hcell + (size_t)p * 2 * m * m;
  auto stage_geo = [&](int y0, int ys) {
    const int ly = NQ * ys;
    const size_t q0 = (size_t)y0 * NQ * Lq + (size_t)x0 * NQ;
    if (dm.geo16) {
      for (StridedDigits<3> e({LX / 4, ly, 5}); e.valid(); e.next()) {
        const int i = 4 * e.d[0], iy = e.d[1], k = e.d[2];
        cp_async16(sGeo + k * QS + iy * LX + i,
                   (k < 4 ? jiP + k * LL : jwP) + q0 + (size_t)iy * Lq + i);
      }
    } else {
      for (StridedDigits<3> e({LX, ly, 5}); e.valid(); e.next()) {
        const int i = e.d[0], iy = e.d[1], k = e.d[2];
        cp_async4(sGeo + k * QS + iy * LX + i,
                  (k < 4 ? jiP + k * LL : jwP) + q0 + (size_t)iy * Lq + i);
      }
    }
    for (StridedDigits<3> e({XB, ys, 2}); e.valid(); e.next())
      cp_async4(sH + (e.d[2] * YS + e.d[1]) * XB + e.d[0],
                hP + (e.d[2] * m + y0 + e.d[1]) * m + x0 + e.d[0]);
  };

  // the first slab's geometry is in flight while the lattice ids load:
  // sIdx[r * XN + x] is node (P*yb + r, P*x0 + x) of the chunk's node rows
  // P*yb .. P*ye over the brick's node columns
  stage_geo(yb, min(YS, ye - yb));
  {
    const int nr = P * (ye - yb) + 1;
    const int* src = pnodes + ((size_t)p * Xn + (size_t)P * yb) * Xn + P * x0;
    for (StridedDigits<2> e({XN, nr}); e.valid(); e.next())
      sIdx[e.d[1] * XN + e.d[0]] = __ldg(src + (size_t)e.d[1] * Xn + e.d[0]);
  }
  __syncthreads();

  // copy the nodes of the slab starting at cell row y0 into buffer buf:
  // one 4-byte cp.async per staged component (the caller commits)
  const int VB = YN * XN;               // one field's staged slab
  auto stage = [&](int y0, int ys, int buf) {
    const int yn = P * ys + 1;
    float* dst0 = sIn + buf * NF * VB;
    const int* ids = sIdx + P * (y0 - yb) * XN;
    for (StridedDigits<2> e({XN, yn}); e.valid(); e.next()) {
      const int o = e.d[1] * XN + e.d[0];
      const size_t g = (size_t)ids[o] * 3;
      float* d = dst0 + o;
#pragma unroll
      for (int c = 0; c < 3; ++c) cp_async4(d + c * VB, u + g + c);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (c < lead_ul) cp_async4(d + (3 + c) * VB, ul + g + c);
      if (need_dt_old) {
        cp_async4(d + (3 + lead_ul) * VB, vo + g);
        cp_async4(d + (4 + lead_ul) * VB, vo + g + 1);
      }
    }
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

  // I1: the (node column, component) = threadIdx.x + k * blockDim.x this
  // thread owns (x = XN: none), component fastest
  int col_x[kMaxCols], col_c[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int it = threadIdx.x + k * blockDim.x;
    col_x[k] = it < 3 * XN ? it / 3 : XN;
    col_c[k] = it - 3 * col_x[k];
  }
  // the tiles of this brick: row (ey, j) at ((ey * nbx) * n1 + j) * XN * 3
  const int TR = XN * 3;                // one tile row
  float* tileB = tiles + ((size_t)p * m * dm.nbx + bx) * n1 * TR;

  const int n_slabs = (ye - yb + YS - 1) / YS;
  stage(yb, min(YS, ye - yb), 0);
  cp_async_commit();
  for (int s = 0; s < n_slabs; ++s) {
    const int y0 = yb + s * YS;
    const int ys = min(YS, ye - y0);   // cell rows in this slab
    const int ly = NQ * ys;            // q-point rows in this slab
    if (s + 1 < n_slabs) {
      const int y1 = y0 + YS;
      stage(y1, min(YS, ye - y1), (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();   // this slab's nodes and geometry
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sbuf = sIn + (s & 1) * NF * VB;

    // ---- E1: along y; items (node x, cell row, field) ------------------
    for (StridedDigits<3> it({XN, ys, NK}); it.valid(); it.next()) {
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
    const int n_cells = ys * XB;
#pragma unroll 1
    for (int pass = 0; pass < kMaxPass; ++pass) {
      const int grp = warp + pass * n_warps;   // warp-uniform
      if (grp * CPW >= n_cells) break;
      const int cl_lin = grp * CPW + cw;
      const bool cell_ok = cw < CPW && cl_lin < n_cells;
      const int cll = cell_ok ? cl_lin : 0;
      const int eyl = cll / XB, ex = cll - eyl * XB;
      const float h = sH[((cell_wise ? 0 : 1) * YS + eyl) * XB + ex];

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
        const int q = iy * LX + ix;        // this q-point in the slab

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

        // this q-point's geometry, staged with the slab
        float ji[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) ji[e] = sGeo[e * QS + q];

        // stabilization parameters; cell-wise: the max of |u*|^2 over the
        // cell's NQ2 lanes (over the warp's rounds when NSUB > 1)
        const float usq = lv[0] * lv[0] + lv[1] * lv[1];
        float d1, d2;
        if (cell_wise) {
          float msq = msq_warp;
          if (NSUB == 1) {
            const float mine = valid ? usq : 0.f;
            const int base = cw * NQ2;
            msq = 0.f;
#pragma unroll
            for (int k = 0; k < NQ2; ++k)
              msq = fmaxf(msq, __shfl_sync(0xffffffffu, mine, base + k));
          }
          gls_delta_cell(sc, h, msq, d1, d2);
        } else {
          gls_delta_q(sc, h, usq, d1, d2);
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
          const float w = sGeo[4 * QS + q];
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

    // the next slab's geometry, now that E2 has read this one's
    if (s + 1 < n_slabs) {
      const int y1 = y0 + YS;
      stage_geo(y1, min(YS, ye - y1));
      cp_async_commit();
    }

    // ---- I2: along x; items (cell ex, q-row iy, component c) -> nodes
    // P*ex .. P*ex+P-1 (and P*XB for the brick's last cell); the left node
    // also takes cell ex-1's part
    const int VS = LY * XN;   // V kinds: value -> y
    for (StridedDigits<3> it({XB, ly, 3}); it.valid(); it.next()) {
      const int ex = it.d[0], iy = it.d[1], c = it.d[2];
      const int o = c * QS + iy * LX + ex * NQ;
      float wv[NQ], wx[NQ], wy[NQ];
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        wv[k] = sW[o + k];
        wx[k] = sW[o + 3 * QS + k];
        wy[k] = sW[o + 6 * QS + k];
      }
      float lv = 0.f, lyv = 0.f;   // cell ex-1 at its local node P
      if (ex > 0) {
#pragma unroll
        for (int k = 0; k < NQ; ++k) {
          const int ol = o - NQ + k;
          lv = fmaf(S1[k][P], sW[ol], lv);
          lv = fmaf(D1[k][P], sW[ol + 3 * QS], lv);
          lyv = fmaf(S1[k][P], sW[ol + 6 * QS], lyv);
        }
      }
      float* vvp = sV + (c * 2 * LY + iy) * XN + P * ex;
#pragma unroll
      for (int i = 0; i < n1; ++i) {
        if (i == P && ex != XB - 1) break;
        float vv = 0.f, vy = 0.f;
#pragma unroll
        for (int k = 0; k < NQ; ++k) {
          vv = fmaf(S1[k][i], wv[k], vv);
          vv = fmaf(D1[k][i], wx[k], vv);
          vy = fmaf(S1[k][i], wy[k], vy);
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

    // ---- I1: along y, one (node column, component) per thread; each
    // cell row's P+1 node rows go to its own tile
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int xl = col_x[k], c = col_c[k];
      if (xl < XN) {
        const float* vvp = sV + (c * 2 * LY) * XN + xl;
        for (int eyl = 0; eyl < ys; ++eyl) {
          float vv[NQ], vy[NQ];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            vv[q] = vvp[(eyl * NQ + q) * XN];
            vy[q] = vvp[(eyl * NQ + q) * XN + VS];
          }
          float* o = tileB + (size_t)(y0 + eyl) * dm.nbx * n1 * TR +
                     3 * xl + c;
#pragma unroll
          for (int kk = 0; kk <= P; ++kk) {
            float acc = 0.f;
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              acc = fmaf(S1[q][kk], vv[q], acc);
              acc = fmaf(D1[q][kk], vy[q], acc);
            }
            o[kk * TR] = acc;
          }
        }
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

// the plan's checks (ops/patch2d.py patch2d_plan makes plans that pass
// them); returns the y chunk's rows, or 0 for a plan the kernel does not
// take
int plan_rows(int P, int m, int XB, int YS, int nyb) {
  if (m < 1 || XB < 1 || m % XB != 0 || YS < 1 || nyb < 1 || nyb > m)
    return 0;
  // I1 columns and E2 passes per thread
  if (3 * (P * XB + 1) > kMaxCols * kThreads) return 0;
  const int nq2 = (P + 1) * (P + 1);
  const int cpw = nq2 <= 32 ? 32 / nq2 : 1;
  if ((YS * XB + cpw - 1) / cpw > kMaxPass * (kThreads / 32)) return 0;
  const int YC = (m + nyb - 1) / nyb;
  if ((nyb - 1) * YC >= m || YS > YC) return 0;
  return YC;
}

template <int P>
int launch_tp(const float* u, const float* ul, const float* vo,
              const int* pnodes, const float* jinv, const float* jxw,
              const float* h, const float* S1, const float* D1, float* tiles,
              int n_p, int m, int flavor, int consider_dt, int cell_wise,
              GlsScalars sc, int XB, int YS, int nyb, cudaStream_t stream) {
  const int YC = plan_rows(P, m, XB, YS, nyb);
  if (n_p < 0 || YC == 0) return (int)cudaErrorInvalidValue;
  const int geo16 =
      ((P + 1) * XB) % 4 == 0 && aligned16(jinv) && aligned16(jxw);
  const bool incr = flavor == GLS_INCREMENT;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  const int NF = 3 + (incr ? 3 : 2) + (need_dt_old ? 2 : 0);
  const size_t bytes =
      p2_smem(P, XB, YS, YC, NF, incr ? 6 : 3).total() * sizeof(float);
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
    err = cudaFuncSetAttribute(patch2d_kernel<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = bytes;
  }
  if (n_p == 0) return 0;
  P2Dims dm{n_p, m, XB, m / XB, YS, YC, nyb, geo16};
  patch2d_kernel<P><<<n_p * dm.nbx * nyb, kThreads, bytes, stream>>>(
      u, ul, vo, pnodes, jinv, jxw, h, S1, D1, tiles, dm, flavor,
      consider_dt, cell_wise, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- host launchers (plain C interface, bound with ctypes) ------------
// The library's degrees (NS_FOR_DEGREES) with NQ = P + 1 Gauss points; x
// bricks of xb cells, ys cell rows per slab and nyb y chunks per patch
// (ops/patch2d.py patch2d_plan).
// Returns 0, a CUDA error code, or 1 (cudaErrorInvalidValue) for a degree,
// plan or input it does not take.
extern "C" int patch2d_sweep_launch(
    const float* u, const float* ul, const float* vo, const int* pnodes,
    const float* jinv, const float* jxw, const float* h, const float* S1,
    const float* D1, float* tiles, int n_p, int P, int NQ, int m, int flavor,
    int consider_dt, int cell_wise, float weight, float stau, float nu,
    float c1, float c2, int xb, int ys, int nyb, void* stream) {
  GlsScalars sc{weight, stau, nu, c1, c2};
  cudaStream_t st = (cudaStream_t)stream;
#define P2_CASE(PP)                                                         \
  if (P == PP && NQ == PP + 1)                                              \
    return launch_tp<PP>(u, ul, vo, pnodes, jinv, jxw, h, S1, D1, tiles,    \
                         n_p, m, flavor, consider_dt, cell_wise, sc, xb,    \
                         ys, nyb, st);
  NS_FOR_DEGREES(P2_CASE)
#undef P2_CASE
  return (int)cudaErrorInvalidValue;
}

// What the compiler gave patch2d_kernel<P>: registers per thread, local
// memory (spills) and static shared memory per thread block in bytes; and
// the dynamic shared memory of one block in bytes for bricks of xb cells,
// slabs of ys and y chunks of yc cell rows in the flavor's fields.
// Returns 0 or a CUDA error code.
extern "C" int patch2d_attributes(int P, int xb, int ys, int yc, int flavor,
                                  int consider_dt, int* regs,
                                  int* local_bytes, int* static_smem,
                                  long long* dynamic_smem) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaErrorInvalidValue;
#define P2_ATTR(PP) \
  if (P == PP) err = cudaFuncGetAttributes(&a, patch2d_kernel<PP>);
  NS_FOR_DEGREES(P2_ATTR)
#undef P2_ATTR
  if (err != cudaSuccess) return (int)err;
  if (xb < 1 || ys < 1 || yc < ys) return (int)cudaErrorInvalidValue;
  const bool incr = flavor == GLS_INCREMENT;
  const bool need_dt_old =
      consider_dt && (flavor == GLS_INCREMENT || flavor == GLS_RESIDUAL);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  *dynamic_smem = (long long)(
      p2_smem(P, xb, ys, yc, 3 + (incr ? 3 : 2) + (need_dt_old ? 2 : 0),
              incr ? 6 : 3)
          .total() * sizeof(float));
  return 0;
}
#endif  // SWEEP_HOST_REHEARSAL
