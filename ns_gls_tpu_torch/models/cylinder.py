"""Turek/Hoffmann flow-past-cylinder case with drag/lift/pressure-drop
functionals (reference ``simulation.cc:198-785``).

The drag/lift surface integral is a face-batch reduction on the
solution's device (``simulation.cc:447-511``); the pressure probe uses
host point evaluation (the RemotePointEvaluation analogue,
``simulation.cc:513-541``).  In 3D, with a ``paraview prefix`` and an
``output granularity``, every output time also writes two slices
(``DataOutResample``, ``simulation.cc:555-639``): the solution resampled
on the z = 0 midplane copy of the 2D channel mesh and on the vertical
cross-section through the cylinder axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ns_gls_tpu_torch.fem.element import Element, tabulate_at
from ns_gls_tpu_torch.mesh.cylinder import cylinder_mesh_2d, cylinder_mesh_3d
from ns_gls_tpu_torch.models.base import (
    BoundaryDescriptor,
    ChannelInflow,
    SimulationBase,
)
from ns_gls_tpu_torch.utils.point_eval import PointEvaluator


class SimulationCylinder(SimulationBase):
    def __init__(self, dim: int):
        super().__init__(dim)
        # defaults mirror the reference ctor (``simulation.cc:199-224``)
        self.use_no_slip_cylinder_bc = True
        self.use_no_slip_wall_bc = True
        self.nu = 0.0
        self.rotate = False
        self.distortion = 0.0
        self.t_init = 0.0
        self.reset_manifold_level = -1
        self.u_max = 1.0
        self.paraview_prefix = ""
        self.output_granularity = 0.0
        self.geometry_channel_length = 2.2 if dim == 2 else 2.5
        self.geometry_channel_extra_length = 0.0
        self.geometry_channel_height = 0.41
        self.geometry_cylinder_position = 0.2 if dim == 2 else 0.5
        self.geometry_cylinder_diameter = 0.1
        self.geometry_cylinder_shift = 0.005
        self.use_wall_bc_periodic = False
        self.use_outflow_bc_weak_cut = False
        self.use_outflow_bc_weak_nitsche = False
        self.use_outflow_bc_strong = False
        self._history = []

    _KEYS = {
        "nu": "nu",
        "simulation no slip cylinder": "use_no_slip_cylinder_bc",
        "simulation no slip wall": "use_no_slip_wall_bc",
        "simulation rotate": "rotate",
        "simulation distortion": "distortion",
        "simulation t init": "t_init",
        "simulation reset manifold level": "reset_manifold_level",
        "simulation u max": "u_max",
        "paraview prefix": "paraview_prefix",
        "output granularity": "output_granularity",
        "simulation geometry length": "geometry_channel_length",
        "simulation geometry extra length": "geometry_channel_extra_length",
        "simulation geometry geometry_channel_height": "geometry_channel_height",
        "simulation geometry cylinder position": "geometry_cylinder_position",
        "simulation geometry cylinder diameter": "geometry_cylinder_diameter",
        "simulation geometry cylinder shift": "geometry_cylinder_shift",
        "simulation use wall bc periodic": "use_wall_bc_periodic",
        "simulation use outflow bc weak cut": "use_outflow_bc_weak_cut",
        "simulation use outflow bc weak nitsche": "use_outflow_bc_weak_nitsche",
        "simulation use outflow bc strong": "use_outflow_bc_strong",
    }

    def parse_parameters(self, raw: dict):
        for k, v in raw.items():
            if k in self._KEYS:
                cur = getattr(self, self._KEYS[k])
                # coerce by the default's type, but round through float
                # for ints so "level": 3.0 (JSON floats) stays valid
                if isinstance(cur, bool):
                    val = bool(v)
                elif isinstance(cur, int):
                    val = int(round(float(v)))
                elif isinstance(cur, float):
                    val = float(v)
                else:
                    val = type(cur)(v)
                setattr(self, self._KEYS[k], val)
        # also pick nu from the top-level parameter set
        assert (
            int(self.use_outflow_bc_weak_cut)
            + int(self.use_outflow_bc_weak_nitsche)
            + int(self.use_outflow_bc_strong)
            < 2
        )

    def get_u_max(self) -> float:
        return self.u_max

    def create_mesh(self, n_global_refinements: int):
        kwargs = dict(
            length=self.geometry_channel_length
            + self.geometry_channel_extra_length,
            height=self.geometry_channel_height,
            cylinder_position=self.geometry_cylinder_position,
            cylinder_diameter=self.geometry_cylinder_diameter,
            shift=self.geometry_cylinder_shift,
        )
        mesh = (
            cylinder_mesh_2d(**kwargs)
            if self.dim == 2
            else cylinder_mesh_3d(**kwargs)
        )
        # Roughness-study machinery (``simulation.cc:654-785``,
        # ``get_mapping_private``): with ``reset manifold level`` = r, the
        # cylinder surface follows the true circle only for the first r
        # refinement levels and is frozen (polygonal) afterwards — surface
        # roughness as a controlled parameter.  The reference realizes the
        # same geometry through a MappingQCache morph of a flat-refined
        # p4est mesh; here we simply drop the manifold attachments after r
        # levels (geometry is identical: Q1-cached mapping == vertex
        # placement).
        r = self.reset_manifold_level
        xcut = (
            self.geometry_channel_length - self.geometry_cylinder_position
        )
        for lvl in range(n_global_refinements):
            if r != -1 and lvl >= r:
                mesh.edge_manifold.clear()
                mesh.face_manifold.clear()
            # refine-in-wake loop (``simulation.cc:317-326``): cells with
            # center x < length - position; without extra length this is
            # all cells (global refinement)
            centers = mesh.vertices[mesh.cells].mean(axis=1)
            flags = centers[:, 0] < xcut
            if flags.all():
                mesh = mesh.refine()
            else:
                mesh = mesh.refine(flags)
        if r == 0 and n_global_refinements == 0:
            mesh.edge_manifold.clear()
            mesh.face_manifold.clear()
        if self.rotate:
            self._apply_chain(mesh, self._rotated_vertices(mesh.vertices))
        if self.distortion != 0.0:
            self._apply_chain(mesh, self._distorted_vertices(mesh))
        return mesh

    # ------------------------------------------------------------------
    # roughness-study vertex machinery (``simulation.cc:328-375``)
    # ------------------------------------------------------------------
    @staticmethod
    def _apply_chain(mesh, new_verts):
        """Apply a fine-mesh vertex displacement to the whole GMG
        refinement chain: parent-level vertices are an index prefix of
        the fine mesh's (``Mesh.refine`` vstacks new points), which is
        exactly the reference's global-coarsening behavior (coarse level
        geometry = subset of the deformed fine vertices)."""
        disp = new_verts - mesh.vertices
        m = mesh
        while m is not None:
            m.vertices = m.vertices + disp[: len(m.vertices)]
            m = m.prev

    def _rotated_vertices(self, verts):
        """``simulation rotate`` (``simulation.cc:328-372``): rotate the
        (possibly polygonal) cylinder surface by 0.2 rad, blending the
        rotation to zero on the |x|,|y| = D box around the cylinder —
        the cylinder-roughness phase parameter of the study."""
        D = self.geometry_cylinder_diameter
        angle = 0.2
        rl = self.reset_manifold_level
        # polygonal surfaces sit at the chord radius, not D/2
        factor_i = 1.0 if rl == -1 else np.cos(np.pi / 8.0 / (1 + rl))
        xy = verts[:, :2]
        inside = (np.abs(xy[:, 0]) <= D - 1e-6) & (
            np.abs(xy[:, 1]) <= D - 1e-6
        )
        sel = xy[inside]
        r = np.linalg.norm(sel, axis=1)
        box = D / np.maximum(
            np.maximum(np.abs(sel[:, 0]), np.abs(sel[:, 1])), 1e-300
        )
        c = factor_i * D / 2.0
        # t = 0 on the cylinder surface (full rotation), 1 on the box
        t = ((r - c) / (r * box - c))[:, None]
        ca, sa = np.cos(angle), np.sin(angle)
        rot = sel @ np.array([[ca, sa], [-sa, ca]])
        out = verts.copy()
        out[inside, :2] = rot * (1.0 - t) + sel * t
        return out

    def _distorted_vertices(self, mesh, seed: int = 0):
        """``simulation distortion`` (``simulation.cc:374-375``,
        ``GridTools::distort_random`` semantics): displace every interior
        vertex by a random vector bounded by factor x (shortest incident
        edge); boundary vertices stay put."""
        from ns_gls_tpu_torch.fem.element import cell_edge_vertices

        verts = mesh.vertices
        n_v = len(verts)
        dim = mesh.dim
        edges = np.asarray(cell_edge_vertices(dim))
        a = mesh.cells[:, edges[:, 0]].ravel()
        b = mesh.cells[:, edges[:, 1]].ravel()
        ln = np.linalg.norm(verts[a] - verts[b], axis=1)
        min_len = np.full(n_v, np.inf)
        np.minimum.at(min_len, a, ln)
        np.minimum.at(min_len, b, ln)

        from ns_gls_tpu_torch.fem.element import cell_face_vertices

        on_bdy = np.zeros(n_v, dtype=bool)
        fv = cell_face_vertices(dim)
        for f in range(2 * dim):
            cb = mesh.boundary_ids[:, f] >= 0
            if cb.any():
                on_bdy[mesh.cells[cb][:, fv[f]].ravel()] = True

        rng = np.random.default_rng(seed)
        direction = rng.standard_normal((n_v, dim))
        direction /= np.maximum(
            np.linalg.norm(direction, axis=1, keepdims=True), 1e-300
        )
        amp = self.distortion * min_len * rng.uniform(-1.0, 1.0, n_v)
        amp[on_bdy] = 0.0
        return verts + direction * amp[:, None]

    def mapping_degree(self, fe_degree: int, requested: int) -> int:
        # the reference's roughness mapping is a Q1 MappingQCache morph
        # (``simulation.cc:679,759``) — vertex-level geometry only
        if self.reset_manifold_level != -1:
            return 1
        return fe_degree if requested == 0 else requested

    def get_boundary_descriptor(self) -> BoundaryDescriptor:
        bcs = BoundaryDescriptor()
        inflow = ChannelInflow(
            self.t_init,
            self.u_max,
            self.use_no_slip_wall_bc,
            self.geometry_channel_height,
            -self.geometry_channel_height / 2.0 + self.geometry_cylinder_shift,
        )
        bcs.all_inhomogeneous_dbcs.append((0, inflow))

        # outflow (``simulation.cc:394-403``)
        if self.use_outflow_bc_weak_cut:
            bcs.all_outflow_bcs_cut.add(1)
        elif self.use_outflow_bc_weak_nitsche:
            bcs.all_outflow_bcs_nitsche[1] = inflow
        elif self.use_outflow_bc_strong:
            bcs.all_inhomogeneous_dbcs.append((1, inflow))
        else:
            bcs.all_homogeneous_nbcs.append(1)

        # walls
        if self.use_wall_bc_periodic:
            bcs.periodic_bcs.append((3, 4, 1))
            if self.dim == 3:
                bcs.periodic_bcs.append((5, 6, 2))
        else:
            for i in range(2 * self.dim):
                if self.use_no_slip_wall_bc:
                    bcs.all_homogeneous_dbcs.append(3 + i)
                else:
                    bcs.all_slip_bcs.append(3 + i)

        # cylinder
        if self.use_no_slip_cylinder_bc:
            bcs.all_homogeneous_dbcs.append(2)
        else:
            bcs.all_slip_bcs.append(2)
        return bcs

    # ------------------------------------------------------------------
    def setup_postprocess(self, space, nu: float,
                          device: str | torch.device = "cpu"):
        """Precompute the drag/lift face reduction and the pressure probes."""
        self.nu_pp = float(nu)
        dim = self.dim
        D = self.geometry_cylinder_diameter

        def t(a, dt=torch.float64):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        batches = space.build_face_batches(3, boundary_ids=[2])
        el3 = Element(dim, space.degree, 3)
        self._facedata = []
        for fb in batches:
            fqp = el3.face_q_points(fb.local_face)
            S, Dref = tabulate_at(space.degree, dim, fqp)
            self._facedata.append(
                dict(
                    S=t(S),
                    D=t(Dref),
                    nodes=t(space.cell_nodes[fb.cells], torch.int64),
                    jinv=t(fb.jinv),
                    jxw=t(fb.jxw),
                    normals=t(fb.normals),
                )
            )

        p1 = np.zeros(dim)
        p2 = np.zeros(dim)
        p1[0] = -D / 2.0
        p2[0] = +D / 2.0
        self._probes = PointEvaluator(space, np.stack([p1, p2]))

        u_bar = self.u_max
        if self.use_no_slip_wall_bc:
            u_bar *= 2.0 / 3.0 if dim == 2 else 4.0 / 9.0
        scaling = 2.0 / D / u_bar**2
        if dim == 3:
            scaling /= self.geometry_channel_height
        self._scaling = scaling
        self._history = []
        self._slices = []
        self._slice_counter = 0
        if dim == 3 and self.paraview_prefix and self.output_granularity > 0:
            self._setup_slices(space)

    def _setup_slices(self, space):
        """Host tables of the two 3D slices: each slice's own Q(degree)
        space, its nodes placed in 3D, and for each of them the 3D cell
        that holds it, the basis values there and that cell's nodes."""
        from ns_gls_tpu_torch.fem.space import FESpace
        from ns_gls_tpu_torch.mesh.cylinder import cylinder_crossection_mesh
        from ns_gls_tpu_torch.utils.point_eval import locate_points_kd

        kwargs = dict(
            length=self.geometry_channel_length
            + self.geometry_channel_extra_length,
            height=self.geometry_channel_height,
            cylinder_position=self.geometry_cylinder_position,
            cylinder_diameter=self.geometry_cylinder_diameter,
        )
        n_ref = int(space.mesh.level)
        m0 = cylinder_mesh_2d(shift=self.geometry_cylinder_shift,
                              for_3d=True, **kwargs)
        if self.reset_manifold_level != -1:
            m0.edge_manifold.clear()
        patches = [(m0.refine_global(n_ref), "xy"),     # z = 0 midplane
                   (cylinder_crossection_mesh(**kwargs).refine_global(n_ref),
                    "xz")]
        for mesh_p, plane in patches:
            sp_p = FESpace(mesh_p, space.degree, 1)
            pts3 = np.zeros((sp_p.n_nodes, 3))
            if plane == "xy":
                pts3[:, :2] = sp_p.node_pos
            else:
                pts3[:, 0] = sp_p.node_pos[:, 0]
                pts3[:, 2] = sp_p.node_pos[:, 1]
            cells, refs = locate_points_kd(space, pts3, k=24)
            found = cells >= 0
            S = tabulate_at(space.degree, 3, refs)[0]
            nodes = space.cell_nodes[np.where(found, cells, 0)]
            self._slices.append(dict(space=sp_p, points=pts3, S=S,
                                     nodes=nodes, found=found))

    def write_slices(self, t, solution):
        """Write ``<prefix>_slice_<c>_<n>.vtu`` for both slices when the
        output time ``t`` has been reached."""
        if not self._slices:
            return
        if (t + 1e-15) < self._slice_counter * self.output_granularity:
            return
        from ns_gls_tpu_torch.utils.vtu import write_vtu

        u = solution.detach().cpu().numpy()
        for c, sl in enumerate(self._slices):
            vals = np.einsum("pi,pic->pc", sl["S"], u[sl["nodes"]])
            vals[~sl["found"]] = 0.0
            fname = (f"{self.paraview_prefix}_slice_{c}_"
                     f"{self._slice_counter}.vtu")
            write_vtu(fname, sl["space"], vals, time=t,
                      points=sl["points"], n_comp=4)
        self._slice_counter += 1

    def _drag_lift(self, u):
        """Surface integral of the fluid stress on the cylinder."""
        dim = self.dim
        drag = 0.0
        lift = 0.0
        for fd in self._facedata:
            u_loc = u[fd["nodes"]]
            S, Dref = fd["S"].to(u.dtype), fd["D"].to(u.dtype)
            val = torch.einsum("qi,fic->fqc", S, u_loc)
            ref_grad = torch.einsum("qir,fic->fqcr", Dref, u_loc)
            grad = torch.einsum("fqcr,fqrx->fqcx", ref_grad,
                                fd["jinv"].to(u.dtype))
            p = val[..., dim]
            eps = 0.5 * (grad[..., :dim, :]
                         + grad[..., :dim, :].transpose(-1, -2))
            eye = torch.eye(dim, dtype=u.dtype, device=u.device)
            stress = -p[..., None, None] * eye + 2.0 * self.nu_pp * eps
            normal = -fd["normals"].to(u.dtype)  # into the fluid
            forces = torch.einsum("fqab,fqb->fqa", stress, normal)
            w = fd["jxw"].to(u.dtype)
            drag = drag + (forces[..., 0] * w).sum()
            lift = lift + (forces[..., 1] * w).sum()
        return drag, lift

    def postprocess(self, t: float, solution):
        drag, lift = self._drag_lift(solution)
        vals = self._probes(solution)
        p_diff = float(vals[0, self.dim] - vals[1, self.dim])
        rec = dict(
            t=t,
            drag=float(drag) * self._scaling,
            lift=float(lift) * self._scaling,
            p_diff=p_diff,
        )
        self._history.append(rec)
        if self.dim == 3:
            self.write_slices(t, solution)
        if self.paraview_prefix:
            fname = f"{self.paraview_prefix}_drag_lift_pressure.m"
            mode = "a" if len(self._history) > 1 else "w"
            with open(fname, mode) as f:
                f.write(
                    f"{rec['t']}\t{rec['drag']}\t{rec['lift']}\t{rec['p_diff']}\n"
                )
        return rec
