"""Matrix-free GLS-stabilized Navier-Stokes operator (PyTorch).

The computational core — the port of the reference's
``NavierStokesOperator`` (``operator_ns.h:17-189``, ``operator_ns.cc``):

- one quadrature sweep evaluates the GLS weak form (Galerkin + SUPG +
  PSPG + grad-div) in two algebraic flavors — *fixed-point/residual* form
  and *Newton increment* form (``operator_ns.cc:949-1182``
  ``do_vmult_cell``),
- the linearization point (u*, grad u*, grad p*) and the BDF history
  contribution are cached at quadrature points
  (``set_linearization_point``, ``operator_ns.cc:570-620``;
  ``set_previous_solution``, ``operator_ns.cc:234-320``), or, in fused
  mode, kept as vectors and re-evaluated inside the sweep,
- stabilization parameters delta_1/delta_2 per cell or per q-point
  (``compute_penalty_parameters``, ``operator_ns.cc:322-526``),
- weak outflow boundary terms (directional do-nothing "cut" and Nitsche,
  ``do_vmult_boundary``, ``operator_ns.cc:1195-1301``), added after the
  cell sweep, whichever sweep that is.

Layout: cells are the leading (batch) axis; basis contractions are
einsums over the cell batch.  In f32 with a BDF or stationary integrator
the whole sweep is a fused kernel (CUDA on the card), picked in the JAX
package's order: the structured kernels on affine lattice spaces
(``ops/structured.py``: subdivided rectangles and boxes, no gather at
all), else the prism kernel on extruded 3D spaces (``ops/prism.py``), the
patch-3D kernel on general 3D patch spaces (``ops/patch3d.py``) or the
patch kernel on patch-2D spaces (``ops/patch2d.py``); everything else
(f64, the theta method, iso-Q1 coarse spaces) runs the general gather
sweep below.  The face terms are plain PyTorch on every level, as the
JAX package computes them outside any Pallas kernel.

State updates replace the ``state`` tuple with new tensors (as the JAX
reference's immutable pytrees do); nothing here writes into a tensor that
a caller holds.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ns_gls_tpu_torch.fem import constraints as cstr
from ns_gls_tpu_torch.fem.constraints import ConstraintArrays
from ns_gls_tpu_torch.fem.space import FESpace
from ns_gls_tpu_torch.utils.device import resolve_device
from ns_gls_tpu_torch.utils.timer import count, host_sync


# --------------------------------------------------------------------------
# static per-batch data
# --------------------------------------------------------------------------
class CellBatch(NamedTuple):
    S: torch.Tensor           # (n_q, n_loc)
    D: torch.Tensor           # (n_q, n_loc, dim)
    jinv: torch.Tensor        # (n_c, n_q_or_1, dim, dim)
    jxw: torch.Tensor         # (n_c, n_q)
    cell_nodes: torch.Tensor  # (n_c, n_loc) int64
    h_min_vertex: torch.Tensor  # (n_c,)
    h_q: torch.Tensor         # (n_c,)  measure-based h / degree
    node_gather: tuple        # per contribution-count class: (n_class, K)
    #                           transpose maps; empty => scatter-add
    node_gather_perm: Optional[torch.Tensor]  # patch spaces: count-sorted
    #                           order -> node numbering


class FaceBlock(NamedTuple):
    """Boundary faces sharing a local face index (static data)."""

    S: torch.Tensor          # (n_fq, n_loc)
    D: torch.Tensor          # (n_fq, n_loc, dim)
    nodes: torch.Tensor      # (n_bf, n_loc) int64: the faces' cells' nodes
    jxw: torch.Tensor        # (n_bf, n_fq)
    normals: torch.Tensor    # (n_bf, n_fq, dim)
    jinv: torch.Tensor       # (n_bf, n_fq, dim, dim)
    beta_eff: torch.Tensor   # (n_bf,) Nitsche/cut penalty
    is_cut: torch.Tensor     # (n_bf,) bool — directional do-nothing faces
    is_nitsche: torch.Tensor  # (n_bf,) bool — Nitsche faces


class NSState(NamedTuple):
    """Linearization-point + history data.

    Two storage modes (``fuse_tables``):
    - cached: u*, grad u*, grad p*, dt_u_old precomputed per (cell, q)
      like the reference's tables (``operator_ns.cc:570-620``); the vector
      fields have extent 0,
    - fused: only the *vectors* (u_lin, vec_old, u_old) are stored and the
      q-point tables are recomputed inside the sweep; the table fields
      have q-extent 0.  The fused sweeps also keep the lattice views
      (structured), patch-gathered views (prism) or contiguous node-major
      vectors (patch-2D and patch-3D, whose kernels read them through the
      patch lattices) ``u_linT`` / ``vec_oldT``.
    """

    weight: torch.Tensor        # () primary BDF/theta weight
    stau: torch.Tensor          # () 1/dt for the stabilization parameters
    u_star: torch.Tensor        # (n_c, n_q, d)
    grad_u_star: torch.Tensor   # (n_c, n_q, d, d)
    grad_p_star: torch.Tensor   # (n_c, n_q, d)
    dt_u_old: torch.Tensor      # (n_c, n_q, d)   sum_i>=1 w_i u^(n-i) at q
    u_old_grad: torch.Tensor    # (n_c, n_q, d, d)  (theta method only)
    p_old_grad: torch.Tensor    # (n_c, n_q, d)
    delta1: torch.Tensor        # (n_c, n_q) or (n_c, 1)
    delta2: torch.Tensor        # (n_c, n_q) or (n_c, 1)
    face_velocity: tuple        # per FaceBlock: (n_bf, n_fq, d)
    face_target: tuple          # per FaceBlock: (n_bf, n_fq, d)
    u_lin: torch.Tensor         # (n_nodes, C) fused mode, else (0, C)
    vec_old: torch.Tensor       # (n_nodes, C) fused mode, else (0, C)
    u_old: torch.Tensor         # (n_nodes, C) fused theta mode, else (0, C)
    u_linT: torch.Tensor        # structured: (C,) + lattice_shape;
    #                             prism: (C, n_patches, Yn, Xn, Nzn);
    #                             patch-2D, patch-3D: (n_nodes, C); else (0,)
    vec_oldT: torch.Tensor      # the same with lead d (patch-2D, 3D: C)


# --------------------------------------------------------------------------
# FE evaluate / integrate (shape-agnostic over leading batch dims)
# --------------------------------------------------------------------------
def _apply_jinv(t, jinv):
    """Contract a (..., q, c, r) tensor with jinv (..., q_or_1, r, x).
    Broadcasts over the q axis, so affine-compressed geometry (jinv
    stored once per cell, q-extent 1) works transparently."""
    return (t.unsqueeze(-1) * jinv.unsqueeze(-3)).sum(dim=-2)


def fe_evaluate(S, D, jinv, u_loc):
    """u_loc (..., n_loc, C) -> (val (..., n_q, C), grad (..., n_q, C, d))."""
    val = torch.einsum("qi,...ic->...qc", S, u_loc)
    ref_grad = torch.einsum("qir,...ic->...qcr", D, u_loc)
    return val, _apply_jinv(ref_grad, jinv)


def fe_integrate(S, D, jinv, jxw, val_res, grad_res):
    """Adjoint of fe_evaluate with quadrature weights:
    r_loc[..., i, c] = sum_q S[q,i] val_res*jxw + D[q,i,r] (grad_res.Jinv) jxw."""
    vr = val_res * jxw.unsqueeze(-1)
    gw = grad_res * jxw[..., None, None]
    # gr[..., q, c, r] = sum_x gw[..., q, c, x] * jinv[..., q?, r, x]
    gr = (gw.unsqueeze(-2) * jinv.unsqueeze(-3)).sum(dim=-1)
    return (torch.einsum("qi,...qc->...ic", S, vr)
            + torch.einsum("qir,...qcr->...ic", D, gr))


# --------------------------------------------------------------------------
# the operator
# --------------------------------------------------------------------------
class NavierStokesOperator:
    """GLS NS operator on an FESpace.

    Mirrors the reference ``OperatorBase`` contract (``operator_base.h:13-73``):
    ``vmult``, ``evaluate_residual``, ``evaluate_rhs``,
    ``set_linearization_point``, ``set_previous_solution``,
    ``get_max_u``, ``invalidate_system``; diagonals and assembled matrices
    are in ``ops/assembly.py``.

    ``use_structured`` admits a fused sweep where the configuration
    allows it (f32, theta = 1): the structured sweep on an affine lattice
    space, else the prism sweep on an extruded 3D space, the patch-3D
    sweep on any other 3D patch space or the patch-2D sweep on a patch-2D
    space.  It is on by default and the tests switch
    it off to hold the sweeps against each other.
    """

    # the counter (``utils/timer.py``) that each apply adds one to, named
    # by the operator's owner ("fine_apply", "level_apply"); None counts
    # nothing
    apply_counter = None

    def __init__(
        self,
        space: FESpace,
        constraints_homogeneous: ConstraintArrays,
        constraints_full: ConstraintArrays,
        nu: float,
        c_1: float,
        c_2: float,
        time_integrator,
        consider_time_derivative: bool = True,
        increment_form: bool = False,
        cell_wise_stabilization: bool = True,
        outflow_bcs_cut: set = frozenset(),
        outflow_bcs_nitsche: dict = None,
        dtype=torch.float64,
        fuse_tables: bool = False,
        use_structured: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.device = dev = resolve_device(device)
        self.space = space
        self.dim = space.dim
        self.n_comp = space.dim + 1
        self.n_nodes = space.n_nodes
        self.dtype = dtype
        self.nu = float(nu)
        self.c_1 = float(c_1)
        self.c_2 = float(c_2)
        self.time_integrator = time_integrator
        self.theta = float(time_integrator.theta)
        self.consider_time_derivative = bool(
            consider_time_derivative and time_integrator.order > 0
        )
        self.increment_form = bool(increment_form)
        self.cell_wise_stabilization = bool(cell_wise_stabilization)
        self.outflow_bcs_cut = frozenset(outflow_bcs_cut)
        self.outflow_bcs_nitsche = dict(outflow_bcs_nitsche or {})
        self.needs_face_integrals = bool(
            self.outflow_bcs_cut or self.outflow_bcs_nitsche
        )
        self.fuse_tables = bool(fuse_tables)
        self.constraints_homogeneous = constraints_homogeneous
        self.constraints_full = constraints_full
        # filled per time step by the driver:
        self.constraints_inhomogeneous: Optional[ConstraintArrays] = None
        self._valid_system = False

        el = space.element
        S, D = el.tables
        degree = space.degree
        if space.dim == 2:
            h_q = np.sqrt(4.0 * space.cell_measure / np.pi) / degree
        else:
            h_q = np.cbrt(6.0 * space.cell_measure / np.pi) / degree

        # affine-cell geometry compression: when every cell's Jacobian is
        # constant over quadrature points, store it once per cell
        jinv_np = space.jinv
        scale = np.abs(jinv_np).max()
        self.affine_geometry = bool(
            np.abs(jinv_np - jinv_np[:, :1]).max() < 1e-12 * scale
        )
        if self.affine_geometry:
            jinv_np = jinv_np[:, :1]

        # fused sweep, in the JAX package's order: structured
        # (ops/structured.py) on affine lattices, else prism
        # (ops/prism.py) on extruded 3D meshes, the Turek/Hoffmann 3D
        # family, then patch-3D (ops/patch3d.py) on general 3D meshes,
        # the Gmsh sphere family, or patch-2D (ops/patch2d.py) on 2D
        # patch spaces; it consumes the linearization VECTORS, so it
        # forces fused tables
        self._fast = None
        if use_structured:
            from ns_gls_tpu_torch.ops.structured import (
                StructuredSweep,
                build_structured_tables,
            )

            candidates = [(build_structured_tables, StructuredSweep)]
            if space.dim == 2:
                from ns_gls_tpu_torch.ops.patch2d import (
                    Patch2DSweep,
                    build_patch2d_tables,
                )

                candidates.append((build_patch2d_tables, Patch2DSweep))
            else:
                from ns_gls_tpu_torch.ops.patch3d import (
                    Patch3DSweep,
                    build_patch3d_tables,
                )
                from ns_gls_tpu_torch.ops.prism import (
                    PrismSweep,
                    build_prism_tables,
                )

                candidates.append((build_prism_tables, PrismSweep))
                candidates.append((build_patch3d_tables, Patch3DSweep))
            for build, sweep in candidates:
                tables = build(self)
                if tables is not None:
                    self.fuse_tables = True
                    self._fast = sweep(self, tables)
                    break

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        perm = getattr(space, "node_gather_perm", None)
        self.batch = CellBatch(
            S=t(S),
            D=t(D),
            jinv=t(jinv_np),
            jxw=t(space.jxw),
            cell_nodes=t(space.cell_nodes, torch.int64),
            h_min_vertex=t(space.cell_h_min_vertex),
            h_q=t(h_q),
            node_gather=tuple(
                t(idx, torch.int64) for _, _, idx in space.node_gather_classes
            ),
            node_gather_perm=(
                t(perm, torch.int64) if perm is not None else None
            ),
        )
        # weak outflow faces: only the face batches of a cut or Nitsche
        # boundary id
        blocks = []
        host_batches = []
        if self.needs_face_integrals:
            for fb in space.face_batches:
                is_cut = np.isin(fb.boundary_id, list(self.outflow_bcs_cut))
                is_nit = np.isin(fb.boundary_id,
                                 list(self.outflow_bcs_nitsche.keys()))
                if not (is_cut.any() or is_nit.any()):
                    continue
                Sf, Df = el.face_tables[fb.local_face]
                cells = np.asarray(fb.cells, np.int64)
                # effective beta: 1 / h^(degree+1), lethe-style
                beta = 1.0 / h_q[cells] ** (degree + 1)
                blocks.append(FaceBlock(
                    S=t(Sf), D=t(Df),
                    nodes=t(np.asarray(space.cell_nodes)[cells], torch.int64),
                    jxw=t(fb.jxw), normals=t(fb.normals), jinv=t(fb.jinv),
                    beta_eff=t(beta),
                    is_cut=t(is_cut, torch.bool),
                    is_nitsche=t(is_nit, torch.bool),
                ))
                host_batches.append(fb)
        self.face_blocks: tuple[FaceBlock, ...] = tuple(blocks)
        self._face_host_batches = tuple(host_batches)   # per FaceBlock
        # the Nitsche targets and the functions' times they were taken at
        self._face_targets = ()
        self._face_targets_key = None
        # the vmult's face matrices at the current linearization
        self._face_K = None

        self._weight_host = 0.0
        self._stau_host = 0.0
        self.state = self._zero_state()

    # ------------------------------------------------------------------
    def _zero_state(self) -> NSState:
        n_c = self.space.mesh.n_cells
        n_q = self.space.element.n_q
        d = self.dim
        C = self.n_comp

        def z(*shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        tq = 0 if self.fuse_tables else n_q  # table q-extent
        nn = self.n_nodes if self.fuse_tables else 0
        dq = 1 if self.cell_wise_stabilization else (
            0 if self.fuse_tables else n_q
        )
        return NSState(
            weight=z(),
            stau=z(),
            u_star=z(n_c, tq, d),
            grad_u_star=z(n_c, tq, d, d),
            grad_p_star=z(n_c, tq, d),
            dt_u_old=z(n_c, tq, d),
            u_old_grad=z(n_c, tq, d, d),
            p_old_grad=z(n_c, tq, d),
            delta1=z(n_c, dq),
            delta2=z(n_c, dq),
            face_velocity=tuple(z(*fb.normals.shape[:2], d)
                                for fb in self.face_blocks),
            face_target=tuple(z(*fb.normals.shape[:2], d)
                              for fb in self.face_blocks),
            u_lin=z(nn, C),
            vec_old=z(nn, C),
            u_old=z(nn if self.theta != 1.0 else 0, C),
            u_linT=z(*self._fast_path_view_shape(C)),
            vec_oldT=z(*self._fast_path_view_shape(d)),
        )

    def _fast_path_view_shape(self, lead: int):
        """Shape of the lattice / patch-gathered linearization views."""
        return self._fast.view_shape(lead) if self._fast is not None else (0,)

    # ------------------------------------------------------------------
    # q-point physics (shape-agnostic over leading dims (..., n_q))
    # ------------------------------------------------------------------
    def qpoint_fixed_point(self, val, grad, cq, residual: bool):
        """Fixed-point / residual flavor (``operator_ns.cc:955-1066``).

        cq: dict with per-(cell,q) tables broadcastable against (..., n_q).
        Returns (val_res, grad_res) with shapes of (val, grad).
        """
        d = self.dim
        theta = self.theta
        nu = self.nu
        u_val = val[..., :d]
        p_val = val[..., d]
        p_grad = grad[..., d, :]
        u_grad = grad[..., :d, :]

        u_dt = cq["weight"] * u_val
        if residual:
            u_dt = u_dt + cq["dt_u_old"]
        u_bar_grad = theta * u_grad
        p_bar_grad = theta * p_grad
        if residual and theta != 1.0:
            u_bar_grad = u_bar_grad + (1.0 - theta) * cq["u_old_grad"]
            p_bar_grad = p_bar_grad + (1.0 - theta) * cq["p_old_grad"]

        div_bar = torch.diagonal(u_bar_grad, dim1=-2, dim2=-1).sum(-1)
        # S.grad(B):  (T*v)[a] = sum_b T[a,b] v[b]
        s_grad_b = torch.einsum("...ab,...b->...a", u_bar_grad, cq["u_star"])

        d1 = cq["delta1"][..., None]
        d2 = cq["delta2"]

        val_res_u = u_dt + s_grad_b
        eye = torch.eye(d, dtype=val.dtype, device=val.device)
        grad_res_u = (
            -p_val[..., None, None] * eye
            + nu * (u_bar_grad + u_bar_grad.transpose(-1, -2))
            + (d2 * div_bar)[..., None, None] * eye
        )
        pspg = u_dt if self.consider_time_derivative else torch.zeros_like(u_dt)
        residual_0 = d1 * (pspg + p_bar_grad + s_grad_b)
        grad_res_u = (grad_res_u
                      + residual_0[..., :, None] * cq["u_star"][..., None, :])

        val_res_p = div_bar
        grad_res_p = d1 * (pspg + p_grad + s_grad_b)

        val_res = torch.cat([val_res_u, val_res_p[..., None]], dim=-1)
        grad_res = torch.cat([grad_res_u, grad_res_p[..., None, :]], dim=-2)
        return val_res, grad_res

    def qpoint_increment(self, val, grad, cq):
        """Newton increment flavor (``operator_ns.cc:1067-1181``)."""
        d = self.dim
        nu = self.nu
        u_val = val[..., :d]
        p_val = val[..., d]
        p_grad = grad[..., d, :]
        u_grad = grad[..., :d, :]
        u_star = cq["u_star"]
        u_star_grad = cq["grad_u_star"]

        u_dt = cq["weight"] * u_val
        div_u = torch.diagonal(u_grad, dim1=-2, dim2=-1).sum(-1)
        s_grad_u = torch.einsum("...ab,...b->...a", u_grad, u_star)
        u_grad_s = torch.einsum("...ab,...b->...a", u_star_grad, u_val)
        s_grad_s = torch.einsum("...ab,...b->...a", u_star_grad, u_star)

        d1 = cq["delta1"][..., None]
        d2 = cq["delta2"]

        val_res_u = u_dt + s_grad_u + u_grad_s
        eye = torch.eye(d, dtype=val.dtype, device=val.device)
        grad_res_u = (
            -p_val[..., None, None] * eye
            + nu * (u_grad + u_grad.transpose(-1, -2))
            + (d2 * div_u)[..., None, None] * eye
        )
        if self.consider_time_derivative:
            pspg0 = u_dt
            pspg1 = cq["weight"] * u_star + cq["dt_u_old"]
        else:
            pspg0 = torch.zeros_like(u_dt)
            pspg1 = torch.zeros_like(u_dt)
        residual_0 = d1 * (pspg0 + p_grad + s_grad_u + u_grad_s)
        residual_1 = d1 * (pspg1 + cq["grad_p_star"] + s_grad_s)
        grad_res_u = (
            grad_res_u
            + residual_0[..., :, None] * u_star[..., None, :]
            + residual_1[..., :, None] * u_val[..., None, :]
        )

        val_res_p = div_u
        grad_res_p = residual_0

        val_res = torch.cat([val_res_u, val_res_p[..., None]], dim=-1)
        grad_res = torch.cat([grad_res_u, grad_res_p[..., None, :]], dim=-2)
        return val_res, grad_res

    # ------------------------------------------------------------------
    def _cq(self, state: NSState) -> dict:
        """Per-(cell, q) tables for the cell sweep."""
        return dict(
            weight=state.weight,
            u_star=state.u_star,
            grad_u_star=state.grad_u_star,
            grad_p_star=state.grad_p_star,
            dt_u_old=state.dt_u_old,
            u_old_grad=state.u_old_grad,
            p_old_grad=state.p_old_grad,
            delta1=state.delta1,
            delta2=state.delta2,
        )

    def _fused_cq(self, b: CellBatch, state: NSState) -> dict:
        """Recompute the linearization tables from the stored vectors
        (fused mode)."""
        d = self.dim
        ul_loc = state.u_lin[b.cell_nodes]
        lval, lgrad = fe_evaluate(b.S, b.D, b.jinv, ul_loc)
        u_star = lval[..., :d]
        vo_loc = state.vec_old[b.cell_nodes]
        dt_u_old = torch.einsum("qi,eic->eqc", b.S, vo_loc[..., :d])
        cq = dict(
            weight=state.weight,
            u_star=u_star,
            grad_u_star=lgrad[..., :d, :],
            grad_p_star=lgrad[..., d, :],
            dt_u_old=dt_u_old,
            delta1=state.delta1,
            delta2=state.delta2,
            u_old_grad=None,
            p_old_grad=None,
        )
        if self.theta != 1.0:
            uo_loc = state.u_old[b.cell_nodes]
            _, ograd = fe_evaluate(b.S, b.D, b.jinv, uo_loc)
            cq["u_old_grad"] = ograd[..., :d, :]
            cq["p_old_grad"] = ograd[..., d, :]
        if not self.cell_wise_stabilization:
            cq["delta1"], cq["delta2"] = self._penalty_impl(
                b, u_star, state.stau
            )
        return cq

    def cell_tables(self, b: CellBatch, state: NSState) -> dict:
        """The per-(cell, q) tables of the sweep: recomputed from the
        stored vectors in fused mode, the cached ones otherwise."""
        return self._fused_cq(b, state) if self.fuse_tables else self._cq(state)

    def cell_integrals(self, b: CellBatch, state: NSState, u,
                       residual_form: bool, cq: Optional[dict] = None):
        """The general sweep up to the cells' own integrals: gather ->
        evaluate -> physics -> integrate, (n_c, n_loc, C).  ``b`` and
        ``state`` may be a shard's (``parallel/``), which passes the
        :meth:`cell_tables` it keeps for its state as ``cq``."""
        u_loc = u[b.cell_nodes]  # (n_c, n_loc, C)
        val, grad = fe_evaluate(b.S, b.D, b.jinv, u_loc)
        if cq is None:
            cq = self.cell_tables(b, state)
        if residual_form or not self.increment_form:
            val_res, grad_res = self.qpoint_fixed_point(
                val, grad, cq, residual=residual_form
            )
        else:
            val_res, grad_res = self.qpoint_increment(val, grad, cq)
        return fe_integrate(b.S, b.D, b.jinv, b.jxw, val_res, grad_res)

    def _cell_sweep(self, b: CellBatch, state: NSState, u,
                    residual_form: bool):
        """The general sweep: :meth:`cell_integrals`, then the transpose
        gather-sum (``do_vmult_range``, ``operator_ns.cc:806-830``)."""
        r_loc = self.cell_integrals(b, state, u, residual_form)
        if b.node_gather:
            # transpose gather-sum: one dense table per contribution
            # class (the same summation order as the JAX reference)
            flat = r_loc.reshape(-1, self.n_comp)
            flat = torch.cat([flat, flat.new_zeros((1, self.n_comp))], dim=0)
            out = torch.cat([flat[idx].sum(dim=1) for idx in b.node_gather],
                            dim=0)
            if b.node_gather_perm is not None:
                out = out[b.node_gather_perm]
            return out
        r = r_loc.new_zeros((self.n_nodes, self.n_comp))
        r.index_put_((b.cell_nodes,), r_loc, accumulate=True)
        return r

    def _sweep(self, u, residual_form: bool):
        """One sweep over the cells: the fused sweep this operator holds
        (the JAX package's ``_fast_apply`` with its ``_structured_apply``
        / ``_prism_apply`` / ``_patch2d_apply`` / ``_patch3d_apply``,
        behind one interface here) or the general one."""
        sw = self._fast
        if sw is not None:
            # u is viewed as a lattice (structured: a reshape, no index),
            # patch-gathered (prism) or kept node-major (patch-2D, patch-
            # 3D) here; the linearization tensors are kept that way in
            # the state
            flavor = ("residual" if residual_form
                      else "increment" if self.increment_form else "fixed")
            return sw.apply(self._weight_host, self._stau_host,
                            sw.gather_nodes(u, self.n_comp),
                            self.state.u_linT, self.state.vec_oldT, flavor)
        return self._cell_sweep(self.batch, self.state, u, residual_form)

    def face_block_terms(self, fb: FaceBlock, u_loc, face_velocity,
                         face_target, residual_form: bool):
        """Weak outflow terms for ONE face block (``do_vmult_boundary``,
        ``operator_ns.cc:1195-1301``): u_loc (n_bf, n_loc, C) -> r_loc of
        the same shape."""
        d = self.dim
        nu = self.nu
        val, grad = fe_evaluate(fb.S, fb.D, fb.jinv, u_loc)
        u_val = val[..., :d]
        u_grad = grad[..., :d, :]
        beta = fb.beta_eff[:, None]

        # -- directional do-nothing ("cut") faces
        star = u_val if residual_form else face_velocity
        normal_outflux = torch.clamp(
            torch.einsum("fqa,fqa->fq", star, fb.normals), max=0.0)
        val_res_cut = (beta * normal_outflux)[..., None] * u_val

        # -- Nitsche faces
        u_eff = u_val
        if residual_form:
            u_eff = u_val - face_target
        val_res_nit = beta[..., None] * u_eff - nu * torch.einsum(
            "fqai,fqi->fqa", u_grad, fb.normals
        )
        grad_res_nit = -nu * u_eff[..., :, None] * fb.normals[..., None, :]

        mask_cut = fb.is_cut[:, None, None]
        mask_nit = fb.is_nitsche[:, None, None]
        zero = val.new_zeros(())
        val_res_u = (torch.where(mask_cut, val_res_cut, zero)
                     + torch.where(mask_nit, val_res_nit, zero))
        grad_res_u = torch.where(mask_nit[..., None], grad_res_nit, zero)

        # pressure rows get zero
        val_res = torch.cat([val_res_u, torch.zeros_like(val[..., d:])],
                            dim=-1)
        grad_res = torch.cat(
            [grad_res_u, torch.zeros_like(grad[..., d:, :])], dim=-2)
        return fe_integrate(fb.S, fb.D, fb.jinv, fb.jxw, val_res, grad_res)

    def _face_matrices(self):
        """Per face block, the face terms of the vmult as one dense matrix
        a face (n_bf, n_loc*C, n_loc*C), in the flattened local dof order
        (i * C + c): :meth:`face_block_terms` outside residual form is
        linear in u_loc for a given face velocity, so its responses to the
        local basis vectors are its matrix.  Taken at the first vmult after
        each linearization, so that a vmult applies the face terms in one
        batched product instead of re-evaluating them (the face sweep runs
        on every level in every smoothing step)."""
        if self._face_K is None:
            st = self.state
            mats = []
            for k, fb in enumerate(self.face_blocks):
                n_bf, n_loc = fb.nodes.shape
                nd = n_loc * self.n_comp
                eye = torch.eye(nd, dtype=self.dtype, device=self.device)
                cols = [self.face_block_terms(
                    fb, e.reshape(1, n_loc, self.n_comp).expand(
                        n_bf, n_loc, self.n_comp),
                    st.face_velocity[k], st.face_target[k], False,
                ).reshape(n_bf, nd) for e in eye]
                mats.append(torch.stack(cols, dim=-1))
            self._face_K = tuple(mats)
        return self._face_K

    def _boundary_sweep(self, u, r, residual_form: bool):
        """Weak outflow boundary terms (``do_vmult_boundary``,
        ``operator_ns.cc:1195-1301``) added onto the cell sweep's r: the
        residual evaluates :meth:`face_block_terms` (the cut term is
        nonlinear in u there), the vmult applies their matrices."""
        mats = None if residual_form else self._face_matrices()
        return self.face_sweep(self.face_blocks, mats, self.state, u, r,
                               residual_form)

    def face_sweep(self, faces, mats, state: NSState, u, r,
                   residual_form: bool):
        """The face terms of the blocks ``faces`` added onto r: the
        residual form evaluates them, the vmult applies their matrices
        ``mats``.  ``faces``, ``mats`` and ``state`` may be a shard's."""
        for k, fb in enumerate(faces):
            if fb.nodes.shape[0] == 0:     # a shard without such faces
                continue
            u_loc = u[fb.nodes]
            if residual_form:
                r_loc = self.face_block_terms(
                    fb, u_loc, state.face_velocity[k], state.face_target[k],
                    True)
            else:
                r_loc = torch.bmm(mats[k], u_loc.reshape(
                    u_loc.shape[0], -1, 1)).reshape(u_loc.shape)
            r = r.index_put((fb.nodes,), r_loc, accumulate=True)
        return r

    # ------------------------------------------------------------------
    # public API (reference OperatorBase contract)
    # ------------------------------------------------------------------
    def vmult(self, u):
        """Matrix-free sandwich: dst = Cᵀ A C u ; dst[constrained] = u."""
        if self.apply_counter is not None:
            count(self.apply_counter)
        ch = self.constraints_homogeneous
        u_eff = cstr.distribute(ch, u, homogeneous=True)
        r = self._sweep(u_eff, residual_form=False)
        if self.needs_face_integrals:
            r = self._boundary_sweep(u_eff, r, residual_form=False)
        r = cstr.condense_transpose(ch, r)
        return cstr.copy_constrained(ch, r, u)

    def residual(self, ca_inhom: ConstraintArrays, u):
        """-Cᵀ R(C u + b) (``evaluate_residual``, ``operator_ns.cc:648-682``).
        Cᵀ on the write side as well: master rows must receive the
        hanging-slave contributions or the residual is inconsistent with
        the vmult Jacobian."""
        tmp = cstr.distribute(ca_inhom, u, homogeneous=False)
        r = self._sweep(tmp, residual_form=True)
        if self.needs_face_integrals:
            r = self._boundary_sweep(tmp, r, residual_form=True)
        r = cstr.condense_transpose(self.constraints_homogeneous, r)
        return -r

    def evaluate_residual(self, u):
        return self.residual(self.constraints_inhomogeneous, u)

    def evaluate_rhs(self):
        return self.residual(self.constraints_inhomogeneous, self.new_vector())

    def invalidate_system(self):
        self._valid_system = False

    def new_vector(self):
        return torch.zeros((self.n_nodes, self.n_comp), dtype=self.dtype,
                           device=self.device)

    # -- state updates ---------------------------------------------------
    def _evaluate_tables(self, b: CellBatch, u):
        return fe_evaluate(b.S, b.D, b.jinv, u[b.cell_nodes])

    def _set_linearization_impl(self, batch, state: NSState, u):
        d = self.dim
        state = state._replace(face_velocity=tuple(
            torch.einsum("qi,fic->fqc", fb.S, u[fb.nodes])[..., :d]
            for fb in self.face_blocks))
        if self.fuse_tables:
            new = state._replace(u_lin=u)
            if self._fast is not None:
                new = new._replace(
                    u_linT=self._fast.gather_nodes(u, self.n_comp))
            if self.cell_wise_stabilization:
                u_loc = u[batch.cell_nodes][..., :d]
                u_star = torch.einsum("qi,eic->eqc", batch.S, u_loc)
                delta1, delta2 = self._penalty_impl(batch, u_star, state.stau)
                new = new._replace(delta1=delta1, delta2=delta2)
            return new
        val, grad = self._evaluate_tables(batch, u)
        u_star = val[..., :d]
        delta1, delta2 = self._penalty_impl(batch, u_star, state.stau)
        return state._replace(
            u_star=u_star,
            grad_u_star=grad[..., :d, :],
            grad_p_star=grad[..., d, :],
            delta1=delta1,
            delta2=delta2,
        )

    def _penalty_impl(self, batch, u_star, stau):
        """delta_1/delta_2 (``compute_penalty_parameters``,
        ``operator_ns.cc:357-420``); stau = 1/dt."""
        nu, c1, c2 = self.nu, self.c_1, self.c_2
        u_norm2 = (u_star**2).sum(-1)  # (n_c, n_q)
        if self.cell_wise_stabilization:
            u_max = torch.sqrt(u_norm2.amax(dim=1, keepdim=True))  # (n_c,1)
            h = batch.h_min_vertex[:, None]
            d1_adv = c1 / torch.sqrt(stau**2 + u_max**2 / h**2)
            d2_adv = c2 * h
            d1_visc = c1 * h * h
            d2_visc = c2 * h * h
            visc = nu >= h
            return (torch.where(visc, d1_visc, d1_adv),
                    torch.where(visc, d2_visc, d2_adv))
        h = batch.h_q[:, None]
        u2 = 1e-12 + u_norm2
        d1 = 1.0 / torch.sqrt(
            stau**2 + 4.0 * u2 / h**2 + 9.0 * (4.0 * nu / h**2) ** 2
        )
        d2 = torch.sqrt(u2) * h * 0.5
        return d1, d2

    def set_linearization_point(self, u):
        self._valid_system = False
        self._face_K = None
        self.update_weight()  # keep weight + stau in sync with current dt
        self.state = self._set_linearization_impl(self.batch, self.state, u)
        if self.outflow_bcs_nitsche:
            self._update_face_targets()

    def _update_face_targets(self):
        """Evaluate the Nitsche target-velocity functions at the face
        q-points at the functions' current time (host -> device;
        ``operator_ns.cc:478-521``).  The host evaluation runs once per
        time value and is cached: set_linearization_point is called every
        Newton iteration and must not pay a host-side face scan.

        The JAX package caches the targets of the first linearization
        for good, taking the functions to be time-independent; the
        cylinder's inflow ramps up from zero, so its outflow target stays
        zero, the mass balance fails and ``input/hoffmann_2d_reinf.json``
        stalls there at its second step (ROADMAP queue 3).  The port
        follows the functions' time, as the reference does."""
        key = tuple(getattr(fn, "time", None)
                    for fn in self.outflow_bcs_nitsche.values())
        if self._face_targets_key != key:
            targets = []
            for hb in self._face_host_batches:
                tgt = np.zeros(hb.q_points.shape[:2] + (self.dim,))
                for bid, fn in self.outflow_bcs_nitsche.items():
                    sel = hb.boundary_id == bid
                    if sel.any():
                        pts = hb.q_points[sel]  # (n_sel, n_fq, dim)
                        for d in range(self.dim):
                            tgt[sel, :, d] = fn(
                                pts.reshape(-1, self.dim), d
                            ).reshape(pts.shape[:2])
                targets.append(torch.as_tensor(tgt, dtype=self.dtype,
                                               device=self.device))
            self._face_targets_key = key
            self._face_targets = tuple(targets)
        self.state = self.state._replace(face_target=self._face_targets)

    def _set_previous_impl(self, batch, state: NSState, vec_old, u_old):
        """vec_old = sum_i>=1 w_i u^(n-i); u_old for theta-method tables."""
        d = self.dim
        if self.fuse_tables:
            new = state._replace(vec_old=vec_old)
            if self._fast is not None:
                new = new._replace(
                    vec_oldT=self._fast.gather_nodes(vec_old, d))
            if self.theta != 1.0:
                new = new._replace(u_old=u_old)
            return new
        val, _ = self._evaluate_tables(batch, vec_old)
        new = state._replace(dt_u_old=val[..., :d])
        if self.theta != 1.0:
            _, grad1 = self._evaluate_tables(batch, u_old)
            new = new._replace(
                u_old_grad=grad1[..., :d, :], p_old_grad=grad1[..., d, :]
            )
        return new

    def set_previous_vectors(self, vec_old, u_old):
        """History from its weighted sum ``vec_old`` = sum_i>=1 w_i u^(n-i)
        and the last solution ``u_old`` (theta tables)."""
        self._valid_system = False
        if self.time_integrator.order == 0:
            return
        self.state = self._set_previous_impl(self.batch, self.state,
                                             vec_old, u_old)
        self.update_weight()

    def set_previous_solution(self, history):
        """history: SolutionHistory (ops.time_integration)."""
        if self.time_integrator.order == 0:
            self._valid_system = False
            return
        w = self.time_integrator.weights
        vec_old = history.weighted_old_sum(tuple(
            host_sync(torch.tensor, x, dtype=self.dtype, device=self.device)
            for x in w
        ))
        self.set_previous_vectors(vec_old, history.vectors[1])

    def update_weight(self):
        tau = self.time_integrator.current_dt
        self._weight_host = float(self.time_integrator.primary_weight)
        self._stau_host = 0.0 if tau == 0.0 else 1.0 / tau
        # two copies of host numbers to the device, each a wait for the
        # stream
        self.state = self.state._replace(
            weight=host_sync(torch.tensor, self._weight_host,
                             dtype=self.dtype, device=self.device),
            stau=host_sync(torch.tensor, self._stau_host, dtype=self.dtype,
                           device=self.device),
        )

    # -- diagnostics -------------------------------------------------------
    def get_max_u(self, u) -> float:
        """Max |u| over quadrature points (``operator_ns.cc:530-568``)."""
        b = self.batch
        u_loc = u[b.cell_nodes][..., : self.dim]
        val = torch.einsum("qi,eic->eqc", b.S, u_loc)
        return host_sync(float, torch.sqrt((val**2).sum(-1).max()))
