"""Patch-lattice fused GLS sweep for GENERAL 2D meshes.

Port of ``ns_gls_tpu/ops/patch2d.py``.  The mesh is tiled into
per-coarse-cell refinement PATCHES (``fem/space.py``
``_build_patch2d_numbering``): an m x m lattice of cells whose
(P*m+1)^2 nodes form a dense tile.  One fused sweep evaluates u, u_lin
and vec_old at every quadrature point of a patch (values and reference
gradients from the 1D Lagrange tables), maps gradients with the per-cell,
per-q ``jinv`` (curved cells cost nothing extra), computes delta_1/delta_2
and the GLS q-point physics, and integrates back onto the patch tile.

Layout (per patch, no TPU grouping or padding):

- node tiles ``(lead, n_patches, Yn, Xn)`` with Xn = Yn = P*m + 1,
- geometry ``jinv (n_patches, 4, Lq, Lq)`` (entry r*2+x = dxi_r/dx_x),
  ``jxw (n_patches, Lq, Lq)`` with Lq = NQ*m in natural order (q-point
  row iy = ey*NQ + qy, column ix = ex*NQ + qx), and the cell sizes
  ``h (n_patches, 2, m, m)`` (h_min_vertex, measure-based h),
- output tiles ``(C, n_patches, Yn, Xn)``.

The patch gather in and the multiplicity-class seam compression out
(nodes on patch seams sum the tiles of every patch that holds them) are
plain tensor gathers around the sweep.

The sweep itself is the CUDA kernel ``csrc/patch2d.cu`` for tensors on
the card and :func:`patch2d_sweep_plain` (its plain PyTorch version, the
same arithmetic with dense 1D band matrices) for tensors on the CPU.

Supported: dim 2, any degree, any m, curved cells, BDF/stationary
(theta = 1), cell- or q-wise stabilization, fixed/increment/residual
flavors, f32, meshes with ONE patch family (uniformly refined).  The
operator uses the general sweep for anything else; adaptive multi-family
meshes raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ns_gls_tpu_torch.fem.lagrange import (
    eval_lagrange,
    gauss_lobatto_points_1d,
    gauss_points_1d,
)
from ns_gls_tpu_torch.ops.structured import _delta, _physics

FLAVORS = ("fixed", "increment", "residual")


class Patch2DTables(NamedTuple):
    """Device tables for the patch-2D sweep (per-patch layout)."""

    P: int
    NQ: int
    m: int
    S1: torch.Tensor        # (NQ, P+1) 1D values at the Gauss points
    D1: torch.Tensor        # (NQ, P+1) 1D derivatives
    bS: torch.Tensor        # (Lq, Xn) patch band: bS[ex*NQ+qx, P*ex+l]
    bD: torch.Tensor        # (Lq, Xn)
    jinv: torch.Tensor      # (n_patches, 4, Lq, Lq)
    jxw: torch.Tensor       # (n_patches, Lq, Lq)
    h: torch.Tensor         # (n_patches, 2, m, m)  (h_min_vertex, hq)
    patch_nodes: torch.Tensor   # (n_patches, Yn, Xn) int64 node ids
    compress: tuple         # per multiplicity class: (n_k, K) flat positions


def _band_1d(P, NQ, m):
    """Single-patch 1D bands (NQ*m, P*m+1) in natural q order
    (row = ex*NQ + qx): basis values / reference derivatives of the
    patch nodes at the patch's Gauss points."""
    nodes = gauss_lobatto_points_1d(P + 1)
    qpts, _ = gauss_points_1d(NQ)
    S1, D1 = eval_lagrange(tuple(nodes), np.asarray(qpts))  # (NQ, P+1)
    Lq, Xn = NQ * m, P * m + 1
    bS = np.zeros((Lq, Xn))
    bD = np.zeros((Lq, Xn))
    for e in range(m):
        for q in range(NQ):
            for l in range(P + 1):
                bS[e * NQ + q, P * e + l] = S1[q, l]
                # reference-cell derivative: the chain rule to physical
                # coordinates is in jinv (per-cell geometry)
                bD[e * NQ + q, P * e + l] = D1[q, l]
    return S1, D1, bS, bD


def _build_compress(flat_nodes, n2d, device):
    """Dense multiplicity-class seam-compress gathers over the flattened
    tile position space (copied from the JAX package)."""
    order = np.argsort(flat_nodes, kind="stable")
    s_nodes = flat_nodes[order]
    # drop pad entries (node id n2d)
    n_real = int(np.searchsorted(s_nodes, n2d))
    s_nodes = s_nodes[:n_real]
    s_pos = order[:n_real].astype(np.int64)
    uniq, starts, counts = np.unique(
        s_nodes, return_index=True, return_counts=True
    )
    if len(uniq) != n2d or not (uniq == np.arange(n2d)).all():
        raise ValueError("patch tiles must cover every 2D node at least once")
    compress = []
    n0 = 0
    while n0 < n2d:
        K = int(counts[n0])
        n1 = int(np.searchsorted(counts, K, side="right"))
        idx = np.empty((n1 - n0, K), np.int64)
        for k in range(K):
            idx[:, k] = s_pos[starts[n0:n1] + k]
        compress.append(torch.as_tensor(idx, device=device))
        n0 = n1
    return tuple(compress)


def build_patch2d_tables(op):
    """Host-side packing; None when the operator/space is not a
    patch-2D f32 BDF/stationary configuration."""
    space = op.space
    if not getattr(space, "patch2d", False):
        return None
    if op.theta != 1.0 or op.dtype != torch.float32:
        return None
    fams = space.patch2d_families
    if len(fams) != 1:
        raise NotImplementedError(
            "adaptive multi-family patch-2D meshes are not ported yet"
        )
    fam = fams[0]
    dev = op.device
    P = space.degree
    NQ = space.n_q1d
    m = int(fam["m"])
    pn = np.asarray(fam["patch_nodes"], np.int64)     # (n_patches, Yn, Xn)
    n_patches = pn.shape[0]
    Lq = NQ * m

    S1, D1, bS, bD = _band_1d(P, NQ, m)

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

    return Patch2DTables(
        P=P, NQ=NQ, m=m,
        S1=f32(S1), D1=f32(D1), bS=f32(bS), bD=f32(bD),
        jinv=f32(jinv_t), jxw=f32(jxw_t), h=f32(h_t),
        patch_nodes=torch.as_tensor(pn, device=dev),
        compress=_build_compress(pn.reshape(-1), space.n2d, dev),
    )


# ---------------------------------------------------------------------------
# the sweep: plain version and kernel
# ---------------------------------------------------------------------------
def _lead_ul(flavor: str, C: int = 3) -> int:
    """Components of u_lin the flavor reads (gradients only in increment)."""
    return C if flavor == "increment" else C - 1


def patch2d_sweep_plain(tables: Patch2DTables, sc: dict, uP, ulP, voP,
                        flavor: str, consider_dt: bool, cell_wise: bool):
    """Plain PyTorch version of the patch-2D sweep (the CUDA kernel's
    reference).  ``sc``: weight, stau, nu, c1, c2 (floats, used in f32).
    uP (3, n_p, Yn, Xn), ulP (3 or 2, ...), voP (2, ...) -> (3, n_p, Yn, Xn).
    """
    d, C = 2, 3
    dev = uP.device
    sc = {k: torch.tensor(v, dtype=torch.float32, device=dev)
          for k, v in sc.items()}
    bS, bD = tables.bS, tables.bD
    NQ, m = tables.NQ, tables.m
    need_lin_grads = flavor == "increment"
    need_dt_old = consider_dt and flavor in ("increment", "residual")

    def fwd(t, grads):
        # t (n_p, Yn, Xn) -> values / reference derivatives (n_p, Lq, Lq)
        tx = t @ bS.T                   # contract x: (n_p, Yn, Lq)
        val = bS @ tx                   # contract y
        if not grads:
            return val, None, None
        dx = bS @ (t @ bD.T)
        dy = bD @ tx
        return val, dx, dy

    u = [fwd(uP[c], True) for c in range(C)]
    ul = [fwd(ulP[c], need_lin_grads) for c in range(_lead_ul(flavor))]
    dt_old = ([fwd(voP[c], False)[0] for c in range(d)]
              if need_dt_old else None)

    ustar = [ul[a][0] for a in range(d)]
    usq = ustar[0] * ustar[0] + ustar[1] * ustar[1]

    def per_q(cellwise_t):
        # (n_p, m, m) per-cell -> (n_p, Lq, Lq) per q-point
        return cellwise_t.repeat_interleave(NQ, 1).repeat_interleave(NQ, 2)

    h1 = per_q(tables.h[:, 0])
    hq = per_q(tables.h[:, 1])
    if cell_wise:
        n_p = usq.shape[0]
        msq = usq.reshape(n_p, m, NQ, m, NQ).amax(dim=(2, 4))
        d1_q, d2_q = _delta(sc, h1, hq, per_q(msq), None, True)
    else:
        d1_q, d2_q = _delta(sc, h1, hq, None, usq, False)

    ji = [tables.jinv[:, k] for k in range(4)]

    def to_phys(dx, dy):
        return [dx * ji[0] + dy * ji[2], dx * ji[1] + dy * ji[3]]

    u_grad = [to_phys(u[a][1], u[a][2]) for a in range(d)]
    p_grad = to_phys(u[d][1], u[d][2])
    gus = gps = None
    if need_lin_grads:
        gus = [to_phys(ul[a][1], ul[a][2]) for a in range(d)]
        gps = to_phys(ul[d][1], ul[d][2])

    val_res, grad_res = _physics(
        d, flavor, sc, [u[a][0] for a in range(d)], u_grad, u[d][0], p_grad,
        ustar, gus, gps, dt_old, d1_q, d2_q, consider_dt,
    )

    jxw = tables.jxw
    out = []
    for c in range(C):
        w_val = val_res[c] * jxw
        grx = (grad_res[c][0] * ji[0] + grad_res[c][1] * ji[1]) * jxw
        gry = (grad_res[c][0] * ji[2] + grad_res[c][1] * ji[3]) * jxw
        out.append(bS.T @ (w_val @ bS + grx @ bD) + bD.T @ (gry @ bS))
    return torch.stack(out)


class Patch2DKernel:
    """ctypes binding of ``csrc/patch2d.cu``; the library is built at
    first use (``utils/cuda_build.py``)."""

    # launches of the CUDA kernel in this process: one per successful
    # ``launch``, nowhere else
    launches = 0
    _fn = None

    @classmethod
    def _load(cls):
        if cls._fn is None:
            from ns_gls_tpu_torch.utils.cuda_build import load_library

            lib = load_library("patch2d")
            fn = lib.patch2d_sweep_launch
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fn.argtypes = [vp] * 9 + [ci] * 7 + [cf] * 5 + [vp]
            fn.restype = ci
            cls._fn = fn
        return cls._fn

    @classmethod
    def launch(cls, tables: Patch2DTables, sc: dict, uP, ulP, voP,
               flavor: str, consider_dt: bool, cell_wise: bool):
        n_p = tables.jinv.shape[0]
        P, NQ, m = tables.P, tables.NQ, tables.m
        Xn = P * m + 1
        C = 3
        lead_ul = _lead_ul(flavor)
        for name, t, lead in (("u", uP, C), ("u_lin", ulP, lead_ul),
                              ("vec_old", voP, 2)):
            if not t.is_cuda or t.dtype != torch.float32:
                raise TypeError(f"{name}: need a float32 CUDA tensor")
            if tuple(t.shape) != (lead, n_p, Xn, Xn):
                raise ValueError(
                    f"{name}: shape {tuple(t.shape)}, need "
                    f"({lead}, {n_p}, {Xn}, {Xn})"
                )
            if not t.is_contiguous():
                raise ValueError(f"{name}: need a contiguous tensor")
        for t in (tables.jinv, tables.jxw, tables.h, tables.S1, tables.D1):
            if t.device != uP.device or not t.is_contiguous():
                raise ValueError("tables must be contiguous on u's device")
        out = torch.empty((C, n_p, Xn, Xn), dtype=torch.float32,
                          device=uP.device)
        fn = cls._load()
        err = fn(
            uP.data_ptr(), ulP.data_ptr(), voP.data_ptr(),
            tables.jinv.data_ptr(), tables.jxw.data_ptr(),
            tables.h.data_ptr(), tables.S1.data_ptr(), tables.D1.data_ptr(),
            out.data_ptr(),
            n_p, P, NQ, m, FLAVORS.index(flavor), int(consider_dt),
            int(cell_wise),
            sc["weight"], sc["stau"], sc["nu"], sc["c1"], sc["c2"],
            torch.cuda.current_stream(uP.device).cuda_stream,
        )
        if err != 0:
            hint = (" (the patch's shared-memory tiles exceed the card's "
                    "per-block limit)" if err == 1 else "")
            raise RuntimeError(
                f"patch2d kernel launch failed: CUDA error {err}{hint}"
            )
        cls.launches += 1
        return out


def patch2d_sweep(tables: Patch2DTables, sc: dict, uP, ulP, voP,
                  flavor: str, consider_dt: bool, cell_wise: bool):
    """The patch-2D sweep: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if uP.is_cuda:
        return Patch2DKernel.launch(tables, sc, uP, ulP, voP, flavor,
                                     consider_dt, cell_wise)
    if uP.device.type != "cpu":
        raise TypeError(f"patch2d sweep: unsupported device {uP.device}")
    return patch2d_sweep_plain(tables, sc, uP, ulP, voP, flavor,
                               consider_dt, cell_wise)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------
class Patch2DSweep:
    """Applies the fused patch-2D sweep for one operator.

    ``gather(v)`` maps a (lead, n2d) component-major vector view to the
    patch tiles the sweep consumes; ``apply(...)`` runs the sweep and
    seam-compresses back to (C, n2d).
    """

    def __init__(self, op, tables: Patch2DTables):
        self.tables = tables
        self.C = op.space.dim + 1
        self.d = op.space.dim
        self.m = tables.m
        self.consider_dt = op.consider_time_derivative
        self.cell_wise = op.cell_wise_stabilization
        self.nu = op.nu
        self.c1 = op.c_1
        self.c2 = op.c_2

    def view_shape(self, lead: int):
        return (lead,) + tuple(self.tables.patch_nodes.shape)

    def gather(self, v):
        """(lead, n2d) -> (lead, n_patches, Yn, Xn)."""
        return v[:, self.tables.patch_nodes]

    def apply(self, weight: float, stau: float, uP, ulP, voP, flavor: str):
        """uP/ulP/voP: (lead, n_patches, Yn, Xn) patch tiles (from
        ``gather``).  Returns (C, n2d)."""
        sc = dict(weight=weight, stau=stau, nu=self.nu, c1=self.c1,
                  c2=self.c2)
        if flavor != "increment":
            ulP = ulP[: self.d]
        out = patch2d_sweep(self.tables, sc, uP.contiguous(),
                            ulP.contiguous(), voP.contiguous(), flavor,
                            self.consider_dt, self.cell_wise)
        flat = out.reshape(self.C, -1)
        outs = [flat[:, idx].sum(dim=2) for idx in self.tables.compress]
        return torch.cat(outs, dim=1)                  # (C, n2d)
