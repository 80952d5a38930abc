"""Patch-lattice fused GLS sweep for GENERAL 2D meshes.

Port of ``ns_gls_tpu/ops/patch2d.py``.  The mesh is tiled into
per-coarse-cell refinement PATCHES (``fem/space.py``
``_build_patch2d_numbering``): an m x m lattice of cells whose
(P*m+1)^2 nodes form a dense lattice.  Every patch lies in its coarse
cell's own frame, so neighbours meet under any orientation and a node
may lie in any number of patches: the lattice ids, not index
arithmetic, decide which nodes meet.  One fused sweep evaluates u, u_lin
and vec_old at every quadrature point of a patch (values and reference
gradients from the 1D Lagrange tables), maps gradients with the
per-cell, per-q ``jinv`` (curved cells cost nothing extra), computes
delta_1/delta_2 and the GLS q-point physics, and integrates back onto
the nodes.

Layout (per patch, no TPU grouping or padding):

- the node vectors u, u_lin and vec_old stay node-major ``(n_nodes, 3)``:
  the kernel reads them through the patch lattices ``patch_nodes
  (n_patches, Yn, Xn)`` (int32 node ids, Xn = Yn = P*m + 1), so no tile
  is gathered per apply,
- geometry ``jinv (n_patches, 4, Lq, Lq)`` (entry r*2+x = dxi_r/dx_x),
  ``jxw (n_patches, Lq, Lq)`` with Lq = NQ*m in natural order (q-point
  row iy = ey*NQ + qy, column ix = ex*NQ + qx), and the cell sizes
  ``h (n_patches, 2, m, m)`` (h_min_vertex, measure-based h),
- output CELL-ROW tiles ``(n_patches, m, nbx, P+1, XN, 3)``: cell row
  ey, x brick bx of ``xb`` cells (XN = P*xb + 1 nodes, the plan's), its
  node row j (patch node row P*ey + j), node P*xb*bx + x, the three
  components: the integrals over the cells of cell row ey in brick bx
  only.  Node rows shared by two cell rows and node columns shared by two
  bricks appear in both; one seam-sum launch (``utils/segment.py``
  ``seam_sum``, a fixed order per node) adds them together with the
  patch seams.

The sweep is the CUDA kernel ``csrc/patch2d.cu`` for tensors on the card
and :func:`patch2d_sweep_plain` (its plain PyTorch version, the same
arithmetic with dense 1D band matrices) for tensors on the CPU;
:func:`patch2d_plan` splits the work into the kernel's thread blocks.

The mesh tiles into patch FAMILIES, one per patch size m (``fem/space.py``
``patch2d_families``): one on a uniformly refined mesh, several on an
adaptive one.  Each family has its own tables and plan; an apply
launches the kernel once per family, each writing its own contiguous
range of one tile buffer, and then one seam-sum launch over the whole
buffer (:class:`Patch2DFamilies`, the JAX package's
``Patch2DTablesAdaptive``): n_families + 1 launches.

Supported: dim 2, any degree (the kernel: 1-6), any m, curved cells,
BDF/stationary (theta = 1), cell- or q-wise stabilization,
fixed/increment/residual flavors, f32, one or several patch families.
The operator uses the general sweep for anything else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ns_gls_tpu_torch.ops.prism import band_1d, tile_nodes
from ns_gls_tpu_torch.ops.structured import _delta, _physics, check_degree
from ns_gls_tpu_torch.utils.segment import SeamSums, seam_sum, seam_sums

FLAVORS = ("fixed", "increment", "residual")


# ---------------------------------------------------------------------------
# the kernel's split into thread blocks
# ---------------------------------------------------------------------------
class Patch2DPlan(NamedTuple):
    """One block per (patch, x brick of ``xb`` cells, y chunk of ``yc``
    cell rows), walking its chunk in slabs of ``ys`` cell rows.  The brick
    sets the output tiles' layout; slabs and chunks do not change a bit of
    the output."""

    xb: int     # cells per x brick (divides m)
    nbx: int    # bricks per cell row
    ys: int     # cell rows per slab
    yc: int     # cell rows per y chunk
    nyb: int    # y chunks per patch


# SMs of an H100 SXM
N_SM = 132
SMEM_PER_BLOCK = 232448        # the opt-in limit of one block
# a slab's fixed time, in q-points' time (tools/patch2d_levels.py --sweep
# on the Turek 2D levels: one slab costs ~2 us, a q-point ~7 ns, and a
# second block on an SM shares its issue slots rather than hiding its
# latency)
SLAB_FIXED = 128
THREADS = 256
MAX_COLS = 2                   # I1 columns (component, node) per thread
MAX_PASSES = 4                 # E2 passes over a slab's cells


def smem_bytes(P: int, xb: int, ys: int, yc: int, flavor: str,
               consider_dt: bool) -> int:
    """Dynamic shared memory of one block (``csrc/patch2d.cu`` p2_smem):
    two buffers of a slab's node rows of every staged field, one of its
    q-points' geometry and cells' h, the y-contracted fields, the
    test-function weights and the lattice ids of the chunk's node rows."""
    incr = flavor == "increment"
    dt_old = consider_dt and flavor in ("increment", "residual")
    nf = 3 + (3 if incr else 2) + (2 if dt_old else 0)
    ng = 6 if incr else 3
    nq = P + 1
    xn, lx = P * xb + 1, nq * xb
    yn, ly = P * ys + 1, nq * ys
    qs = ly * lx

    def r4(a):
        return -(-a // 4) * 4

    words = (r4(2 * nf * yn * xn) + r4(5 * qs + 2 * ys * xb)
             + r4(max((nf + ng) * ly * xn, 6 * ly * xn)) + r4(9 * qs)
             + (P * yc + 1) * xn)
    return 4 * words


def _plan_ok(P: int, xb: int, ys: int) -> bool:
    """The launcher's limits: I1 columns and E2 passes per thread."""
    cpw = max(1, 32 // (P + 1) ** 2)
    return (3 * (P * xb + 1) <= MAX_COLS * THREADS
            and -(-ys * xb // cpw) <= MAX_PASSES * (THREADS // 32))


@functools.lru_cache(maxsize=64)
def patch2d_plan(P: int, m: int, n_patches: int) -> Patch2DPlan:
    """The kernel's blocks for ``n_patches`` patches of m x m cells of
    degree P: of the bricks (divisors of m), slab depths and y chunkings
    within the launcher's limits and the shared memory of the largest
    flavor (increment with the history), the one of least estimated time,
    blocks per SM x slabs per block x a slab's time (``SLAB_FIXED`` plus
    its q-points); ties go to fewer blocks, then longer bricks, then
    deeper slabs.  Raises for a degree the kernel does not take or a
    shape nothing fits."""
    check_degree("patch-2D", P)
    nq2 = (P + 1) ** 2
    best = None
    for xb in (d for d in range(m, 0, -1) if m % d == 0):
        nbx = m // xb
        yc_seen = set()
        for nyb in range(1, m + 1):
            yc = -(-m // nyb)
            if yc in yc_seen:
                continue
            yc_seen.add(yc)
            n_chunks = -(-m // yc)
            for ys in range(1, yc + 1):
                if not _plan_ok(P, xb, ys):
                    break
                if smem_bytes(P, xb, ys, yc, "increment",
                              True) > SMEM_PER_BLOCK:
                    continue
                blocks = n_patches * nbx * n_chunks
                cost = (-(-blocks // N_SM) * -(-yc // ys)
                        * (SLAB_FIXED + ys * xb * nq2), blocks, -xb, -ys)
                if best is None or cost < best[0]:
                    best = (cost, Patch2DPlan(xb, nbx, ys, yc, n_chunks))
    if best is None:
        raise ValueError(f"no patch-2D plan fits: P={P}, m={m}")
    return best[1]


class Patch2DTables(NamedTuple):
    """Device tables of one patch family (per-patch layout) under its
    plan."""

    P: int
    NQ: int
    m: int
    n_nodes: int
    plan: Patch2DPlan
    S1: torch.Tensor        # (NQ, P+1) 1D values at the Gauss points
    D1: torch.Tensor        # (NQ, P+1) 1D derivatives
    bS: torch.Tensor        # (Lq, Xn) patch band: bS[e*NQ+q, P*e+l]
    bD: torch.Tensor        # (Lq, Xn)
    xS: torch.Tensor        # (NQ*xb, P*xb+1) the band of one x brick
    xD: torch.Tensor
    jinv: torch.Tensor      # (n_patches, 4, Lq, Lq)
    jxw: torch.Tensor       # (n_patches, Lq, Lq)
    h: torch.Tensor         # (n_patches, 2, m, m)  (h_min_vertex, hq)
    patch_nodes: torch.Tensor   # (n_patches, Yn, Xn) int32 node ids


class Patch2DFamilies(NamedTuple):
    """Device tables of the patch-2D sweep: one :class:`Patch2DTables`
    per patch family, and ONE seam table over the concatenation of every
    family's cell-row tiles in family order (the index into the
    concatenation is the global row)."""

    fams: tuple             # Patch2DTables per family
    n_nodes: int
    seams: SeamSums         # rows of the concatenated tiles -> nodes


def _with_plan(tables: Patch2DTables, plan: Patch2DPlan) -> Patch2DTables:
    """``tables`` under ``plan``, with the band of its x brick."""
    _, _, _, xS, xD = band_1d(tables.P, tables.NQ, plan.xb)
    dev = tables.jinv.device
    return tables._replace(
        plan=plan,
        xS=torch.as_tensor(np.asarray(xS, np.float32), device=dev),
        xD=torch.as_tensor(np.asarray(xD, np.float32), device=dev))


def _tile_targets(tables: Patch2DTables) -> np.ndarray:
    """The node of every cell-row tile row of ``tables``, flat."""
    pn = tables.patch_nodes.cpu().numpy().astype(np.int64)
    return tile_nodes(pn, tables.P, tables.m, tables.plan.xb).reshape(-1)


def families(fams, n_nodes: int, every_node: bool = True
              ) -> Patch2DFamilies:
    """The per-family tables ``fams`` with the seam table of their
    concatenated tiles, in the layouts their plans set (``every_node``:
    see ``utils/segment.py`` ``seam_sums``)."""
    targets = np.concatenate([_tile_targets(t) for t in fams])
    return Patch2DFamilies(tuple(fams), n_nodes, seam_sums(
        targets, n_nodes, fams[0].jinv.device, every_node))


def replan(tables: Patch2DFamilies, plan: Patch2DPlan) -> Patch2DFamilies:
    """One-family ``tables`` under ``plan``: with the band of its x brick
    and the seam table of the tiles' layout it sets."""
    (t,) = tables.fams
    return families((_with_plan(t, plan),), tables.n_nodes)


def tile_shape(tables: Patch2DTables) -> tuple:
    """Shape of the cell-row tiles of one sweep over ``tables``: (n_p, m,
    nbx, P+1, XN, 3)."""
    plan = tables.plan
    return (tables.jinv.shape[0], tables.m, plan.nbx, tables.P + 1,
            tables.P * plan.xb + 1, 3)


def tile_rows(tables: Patch2DTables) -> int:
    """Rows (node, 3 components) of the cell-row tiles of ``tables``."""
    return int(np.prod(tile_shape(tables)[:-1]))


def family_tables(space, fam, dev, n_nodes=None) -> Patch2DTables:
    """Tables of one patch family under its plan.  ``fam`` holds the
    family's patch size, cells (ids in ``space``), each cell's patch and
    lattice position and the patch lattices; ``n_nodes`` (by default the
    space's) is the length of the vectors the lattice ids index."""
    P = space.degree
    NQ = space.n_q1d
    m = int(fam["m"])
    pn = np.asarray(fam["patch_nodes"], np.int32)     # (n_patches, Yn, Xn)
    n_patches = pn.shape[0]
    Lq = NQ * m

    S1, D1, _, bS, bD = band_1d(P, NQ, m)

    cells = np.asarray(fam["cells"])
    patch = np.asarray(fam["patch_of_cell"])
    lat = np.asarray(fam["lattice_of_cell"])          # (n_c, 2) = (ex, ey)
    n_c = len(cells)
    jinv = np.asarray(space.jinv)[cells]              # (c, q, r, x)
    jxw = np.asarray(space.jxw)[cells]                # (c, q)
    h1 = np.asarray(space.cell_h_min_vertex)[cells]
    hq = (np.sqrt(4.0 * space.cell_measure / np.pi) / P)[cells]

    # element q numbering q = qx + NQ*qy  ->  patch q-point (iy, ix)
    qx = np.arange(NQ)
    qy = np.arange(NQ)
    iy = lat[:, 1:2, None] * NQ + qy[None, :, None]   # (c, NQ, 1)
    ix = lat[:, 0:1, None] * NQ + qx[None, None, :]   # (c, 1, NQ)
    q_idx = qx[None, None, :] + NQ * qy[None, :, None]
    cidx = np.arange(n_c)[:, None, None]
    pb = patch[:, None, None]
    jinv_t = np.zeros((n_patches, 4, Lq, Lq))
    for r in range(2):
        for x in range(2):
            jinv_t[pb, r * 2 + x, iy, ix] = jinv[cidx, q_idx, r, x]
    jxw_t = np.zeros((n_patches, Lq, Lq))
    jxw_t[pb, iy, ix] = jxw[cidx, q_idx]
    h_t = np.zeros((n_patches, 2, m, m))
    h_t[patch, 0, lat[:, 1], lat[:, 0]] = h1
    h_t[patch, 1, lat[:, 1], lat[:, 0]] = hq

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    tables = Patch2DTables(
        P=P, NQ=NQ, m=m,
        n_nodes=space.n_nodes if n_nodes is None else n_nodes, plan=None,
        S1=f32(S1), D1=f32(D1), bS=f32(bS), bD=f32(bD), xS=None, xD=None,
        jinv=f32(jinv_t), jxw=f32(jxw_t), h=f32(h_t),
        patch_nodes=torch.as_tensor(pn, device=dev),
    )
    return _with_plan(tables, patch2d_plan(P, m, n_patches))


def build_patch2d_tables(op):
    """Host-side packing into :class:`Patch2DFamilies`; None when the
    operator/space is not a patch-2D f32 BDF/stationary configuration.
    Raises where a family's plan does not fit."""
    space = op.space
    if not getattr(space, "patch2d", False):
        return None
    if op.theta != 1.0 or op.dtype != torch.float32:
        return None
    return families([family_tables(space, fam, op.device)
                      for fam in space.patch2d_families], space.n_nodes)


# ---------------------------------------------------------------------------
# the sweep: plain version and kernel
# ---------------------------------------------------------------------------
def _lead_ul(flavor: str, C: int = 3) -> int:
    """Components of u_lin the flavor reads (gradients only in increment)."""
    return C if flavor == "increment" else C - 1


def patch2d_sweep_plain(tables: Patch2DTables, sc: dict, u, ul, vo,
                        flavor: str, consider_dt: bool, cell_wise: bool):
    """Plain PyTorch version of the patch-2D kernel (its reference).
    ``sc``: weight, stau, nu, c1, c2 (floats, used in f32).  u, ul, vo:
    node-major (n_nodes, 3) (ul: the first 3 components read in
    increment, 2 otherwise; vo: 2) -> cell-row tiles (n_p, m, nbx, P+1,
    XN, 3)."""
    d, C = 2, 3
    dev = u.device
    sc = {k: torch.tensor(v, dtype=torch.float32, device=dev)
          for k, v in sc.items()}
    bS, bD = tables.bS, tables.bD
    NQ, m = tables.NQ, tables.m
    pn = tables.patch_nodes.long()
    n_p = pn.shape[0]
    nbx = tables.plan.nbx
    need_lin_grads = flavor == "increment"
    need_dt_old = consider_dt and flavor in ("increment", "residual")

    def fwd(v, lead, grads):
        # the first ``lead`` components on the patch lattices (lead, n_p,
        # Yn, Xn) -> values / reference derivatives (lead, n_p, Lq, Lq)
        t = v[:, :lead].T[:, pn]
        tx = t @ bS.T                   # contract x: (lead, n_p, Yn, Lq)
        val = bS @ tx                   # contract y
        if not grads:
            return val, None, None
        return val, bS @ (t @ bD.T), bD @ tx

    uv, udx, udy = fwd(u, C, True)
    lv, ldx, ldy = fwd(ul, _lead_ul(flavor), need_lin_grads)
    dt_old = list(fwd(vo, d, False)[0]) if need_dt_old else None

    ustar = [lv[a] for a in range(d)]
    usq = ustar[0] * ustar[0] + ustar[1] * ustar[1]

    def per_q(cellwise_t):
        # (n_p, m, m) per-cell -> (n_p, Lq, Lq) per q-point
        return cellwise_t.repeat_interleave(NQ, 1).repeat_interleave(NQ, 2)

    h1 = per_q(tables.h[:, 0])
    hq = per_q(tables.h[:, 1])
    if cell_wise:
        msq = usq.reshape(n_p, m, NQ, m, NQ).amax(dim=(2, 4))
        d1_q, d2_q = _delta(sc, h1, hq, per_q(msq), None, True)
    else:
        d1_q, d2_q = _delta(sc, h1, hq, None, usq, False)

    ji = [tables.jinv[:, k] for k in range(4)]

    def to_phys(dx, dy):
        return [dx * ji[0] + dy * ji[2], dx * ji[1] + dy * ji[3]]

    u_grad = [to_phys(udx[a], udy[a]) for a in range(d)]
    p_grad = to_phys(udx[d], udy[d])
    gus = gps = None
    if need_lin_grads:
        gus = [to_phys(ldx[a], ldy[a]) for a in range(d)]
        gps = to_phys(ldx[d], ldy[d])

    val_res, grad_res = _physics(
        d, flavor, sc, [uv[a] for a in range(d)], u_grad, uv[d], p_grad,
        ustar, gus, gps, dt_old, d1_q, d2_q, consider_dt,
    )

    # the test-function weights of the C components: value, then the
    # reference x and y gradient weights, (C, n_p, Lq, Lq) each
    jxw = tables.jxw
    g0 = torch.stack([g[0] for g in grad_res])
    g1 = torch.stack([g[1] for g in grad_res])
    w_val = torch.stack(val_res) * jxw
    grx = (g0 * ji[0] + g1 * ji[1]) * jxw
    gry = (g0 * ji[2] + g1 * ji[3]) * jxw

    def bricks(w):
        # (C, n_p, Lq, Lq) -> (C, n_p, m, NQ, nbx, NQ*xb): cell row,
        # q-row, brick, the brick's q-columns
        return w.reshape(C, n_p, m, NQ, nbx, -1)

    # along x within each brick, then along y within each cell row
    xv = bricks(w_val) @ tables.xS + bricks(grx) @ tables.xD
    xy = bricks(gry) @ tables.xS
    out = (torch.einsum("qj,cpeqbx->pebjxc", tables.S1, xv)
           + torch.einsum("qj,cpeqbx->pebjxc", tables.D1, xy))
    return out.contiguous()


class Patch2DKernel:
    """ctypes binding of ``csrc/patch2d.cu``; the library is built at
    first use (``utils/cuda_build.py``)."""

    # launches of the CUDA kernel in this process: one per successful
    # ``launch``, nowhere else
    launches = 0
    _lib = None
    # the last tables held to the kernel's needs (checked once per tables)
    _checked = None

    @classmethod
    def _load(cls):
        if cls._lib is None:
            from ns_gls_tpu_torch.utils.cuda_build import load_library

            lib = load_library("patch2d")
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fn = lib.patch2d_sweep_launch
            fn.argtypes = [vp] * 10 + [ci] * 7 + [cf] * 5 + [ci] * 3 + [vp]
            fn.restype = ci
            at = lib.patch2d_attributes
            ip = ctypes.POINTER(ci)
            at.argtypes = [ci] * 6 + [ip, ip, ip,
                                      ctypes.POINTER(ctypes.c_longlong)]
            at.restype = ci
            cls._lib = lib
        return cls._lib

    @classmethod
    def _check_tables(cls, tables: Patch2DTables, device):
        if cls._checked is tables:
            return
        for t in (tables.jinv, tables.jxw, tables.h, tables.S1, tables.D1,
                  tables.patch_nodes):
            if t.device != device or not t.is_contiguous():
                raise ValueError("tables must be contiguous on u's device")
        if tables.patch_nodes.dtype != torch.int32:
            raise TypeError("patch_nodes: need int32 node ids")
        cls._checked = tables

    @classmethod
    def launch(cls, tables: Patch2DTables, sc: dict, u, ul, vo,
               flavor: str, consider_dt: bool, cell_wise: bool, out=None):
        """The kernel on node-major u, ul, vo (n_nodes, 3) under the
        tables' plan -> cell-row tiles, written into ``out`` where given
        (a contiguous float32 tensor of the tiles' shape on u's device,
        e.g. a family's range of one tile buffer)."""
        n_p = tables.jinv.shape[0]
        P, NQ, m = tables.P, tables.NQ, tables.m
        for name, t in (("u", u), ("u_lin", ul), ("vec_old", vo)):
            if not t.is_cuda or t.dtype != torch.float32:
                raise TypeError(f"{name}: need a float32 CUDA tensor")
            if tuple(t.shape) != (tables.n_nodes, 3) or not t.is_contiguous():
                raise ValueError(f"{name}: need a contiguous "
                                 f"({tables.n_nodes}, 3) tensor, got "
                                 f"{tuple(t.shape)}")
        cls._check_tables(tables, u.device)
        plan = tables.plan
        shape = tile_shape(tables)
        if out is None:
            out = torch.empty(shape, dtype=torch.float32, device=u.device)
        elif (tuple(out.shape) != shape or out.dtype != torch.float32
              or out.device != u.device or not out.is_contiguous()):
            raise ValueError(f"out: need a contiguous float32 {shape} "
                             f"tensor on u's device")
        err = cls._load().patch2d_sweep_launch(
            u.data_ptr(), ul.data_ptr(), vo.data_ptr(),
            tables.patch_nodes.data_ptr(), tables.jinv.data_ptr(),
            tables.jxw.data_ptr(), tables.h.data_ptr(),
            tables.S1.data_ptr(), tables.D1.data_ptr(), out.data_ptr(),
            n_p, P, NQ, m, FLAVORS.index(flavor), int(consider_dt),
            int(cell_wise),
            sc["weight"], sc["stau"], sc["nu"], sc["c1"], sc["c2"],
            plan.xb, plan.ys, plan.nyb,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
        if err != 0:
            hint = (" (a degree, plan or input the kernel does not take)"
                    if err == 1 else "")
            raise RuntimeError(
                f"patch-2D kernel launch failed: CUDA error {err}{hint}"
            )
        cls.launches += 1
        return out

    @classmethod
    def attributes(cls, P: int, plan: Patch2DPlan, flavor: str,
                   consider_dt: bool) -> dict:
        """Registers per thread, spills (local memory) and static shared
        memory per block of the built kernel for degree P, and its dynamic
        shared memory per block under ``plan``, in bytes."""
        regs, local, static = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        dyn = ctypes.c_longlong()
        err = cls._load().patch2d_attributes(
            P, plan.xb, plan.ys, plan.yc, FLAVORS.index(flavor),
            int(consider_dt), ctypes.byref(regs), ctypes.byref(local),
            ctypes.byref(static), ctypes.byref(dyn))
        if err != 0:
            raise RuntimeError(f"patch2d_attributes: CUDA error {err}")
        return dict(registers=regs.value, spill_bytes=local.value,
                    static_smem=static.value, dynamic_smem=dyn.value)


def patch2d_tiles(tables: Patch2DFamilies, sc: dict, u, ul, vo,
                  flavor: str, consider_dt: bool, cell_wise: bool):
    """Every family's cell-row tiles, concatenated in family order
    (n_rows, 3): for tensors on the card one kernel launch per family,
    each into its own range of one buffer; for tensors on the CPU the
    plain version per family."""
    fams = tables.fams
    if u.device.type == "cpu":
        return torch.cat([patch2d_sweep_plain(t, sc, u, ul, vo, flavor,
                                              consider_dt, cell_wise)
                          .reshape(-1, 3) for t in fams])
    if not u.is_cuda:
        raise TypeError(f"patch-2D sweep: unsupported device {u.device}")
    rows = [tile_rows(t) for t in fams]
    buf = torch.empty((sum(rows), 3), dtype=torch.float32, device=u.device)
    start = 0
    for t, n in zip(fams, rows):
        Patch2DKernel.launch(t, sc, u, ul, vo, flavor, consider_dt,
                             cell_wise,
                             out=buf[start:start + n].view(tile_shape(t)))
        start += n
    return buf


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------
class Patch2DSweep:
    """Applies the fused patch-2D sweep for one operator, with the
    interface every fused sweep of the operator has.  The kernel reads the
    node-major vectors through the patch lattices itself, so
    ``gather_nodes(v, lead)`` only makes v a contiguous (n_nodes, 3)
    array, and ``apply(...)`` runs the sweep of every patch family and
    the seam sums back to (n_nodes, 3): n_families + 1 launches on the
    card."""

    def __init__(self, op, tables: Patch2DFamilies):
        self.tables = tables
        self.d = 2
        # the largest patch size
        self.m = max(t.m for t in tables.fams)
        self.consider_dt = op.consider_time_derivative
        self.cell_wise = op.cell_wise_stabilization
        self.nu = op.nu
        self.c1 = op.c_1
        self.c2 = op.c_2

    def view_shape(self, lead: int):
        return (self.tables.n_nodes, 3)

    def gather_nodes(self, v, lead: int):
        """(n_nodes, 3) -> the same, contiguous (every component is kept:
        the kernel reads the ``lead`` it needs)."""
        return v.contiguous()

    def compress(self, tiles):
        """Cell-row tiles of every family (n_rows, ...) -> (n_nodes, 3)."""
        return seam_sum(self.tables.seams, tiles.reshape(-1, 3))

    def apply(self, weight: float, stau: float, u, ul, vo, flavor: str):
        """u, ul, vo: node-major (n_nodes, 3) (from ``gather_nodes``).
        Returns (n_nodes, 3)."""
        sc = dict(weight=weight, stau=stau, nu=self.nu, c1=self.c1,
                  c2=self.c2)
        tiles = patch2d_tiles(self.tables, sc, u.contiguous(),
                              ul.contiguous(), vo.contiguous(), flavor,
                              self.consider_dt, self.cell_wise)
        return self.compress(tiles)
