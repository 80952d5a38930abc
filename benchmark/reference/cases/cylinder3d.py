"""Judging stationary solves of the 3D Schäfer–Turek cylinder.

From the configuration alone the reference works out the mesh (the
frozen generator, the cylindrical manifold, the isoparametric mapping),
its own node numbering, the boundary values and the GLS residual.  It
reads the program's answer (the node positions and values of a solution,
the drag and lift it reported) only to judge it:

- ``residual_l2``: the 2-norm of the stationary GLS residual of the
  solution over the rows no boundary condition fixes, the quantity the
  configuration's Newton tolerance bounds;
- ``bc_gap``: the largest gap between the solution and the boundary
  values on the rows they fix (inflow profile, no-slip walls and
  cylinder, zero outflow pressure);
- ``functional_gap``: the largest gap, relative to the reference's value
  (at least 1e-3), between the drag and lift the program reported and
  the reference's from the same solution.  The pressure drop is not
  compared: the program evaluates it in float64 whatever the solution's
  precision, so no lower precision can show in it, and the solution it
  reads is judged by ``residual_l2``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gls
from benchmark.reference.frozen.cylinder import cylinder_mesh_3d
from benchmark.reference.frozen.element import Element, tabulate_at
from benchmark.reference.frozen.space import Space

INFLOW, OUTFLOW, CYLINDER = 0, 1, 2
WALLS = (3, 4, 5, 6)
LENGTH, HEIGHT, POSITION, DIAMETER = 2.5, 0.41, 0.5, 0.1


class Reference:
    def __init__(self, config, device, dtype=torch.float64):
        p = config["program"]
        self.p = p
        self.device, self.dtype = device, dtype
        shift = p["simulation_geometry_cylinder_shift"]
        degree = p["fe_degree"]
        mapping = p["mapping_degree"] or degree
        mesh = cylinder_mesh_3d(LENGTH, HEIGHT, POSITION, DIAMETER, shift)
        mesh = mesh.refine_global(p["n_global_refinements"])
        self.space = sp = Space(mesh, degree, mapping)
        self.t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                                     device=device)
        S, D = sp.element.tables
        self.S, self.D = self.t(S), self.t(D)
        self.cells = self.t(sp.cell_nodes, torch.int64)
        self.jinv, self.jxw = self.t(sp.jinv), self.t(sp.jxw)
        self.h = self.t(np.cbrt(6.0 * sp.cell_measure / np.pi) / degree)
        # the rows the boundary conditions fix, and their values
        C = 4
        fixed = np.zeros((sp.n_nodes, C), bool)
        walls = sp.boundary_nodes([CYLINDER, *WALLS])
        inflow = sp.boundary_nodes([INFLOW])
        fixed[walls, :3] = True
        fixed[inflow, :3] = True
        fixed[sp.boundary_nodes([OUTFLOW]), 3] = True
        g = np.zeros((sp.n_nodes, C))
        x = sp.node_pos[inflow]
        y = x[:, 1] - (-HEIGHT / 2.0 + shift)
        z = x[:, 2] + HEIGHT / 2.0
        g[inflow, 0] = (p["simulation_u_max"] * 16.0 * y * (HEIGHT - y)
                        * z * (HEIGHT - z) / HEIGHT ** 4)
        self.fixed = self.t(fixed, torch.bool)
        self.g = self.t(g)
        self.order = np.lexsort(np.round(sp.node_pos, 9).T)

    def to_reference(self, node_pos, u):
        """The program's solution in the reference's numbering, matched by
        node position; None where the positions differ."""
        mine = self.space.node_pos
        if node_pos.shape != mine.shape:
            return None
        theirs = np.lexsort(np.round(node_pos, 9).T)
        if np.abs(node_pos[theirs] - mine[self.order]).max() > 1e-9:
            return None
        out = np.empty_like(u)
        out[self.order] = u[theirs]
        return self.t(out)

    def residual(self, u):
        p = self.p
        params = dict(nu=p["nu"], c1=p["c1"], c2=p["c2"], weight=0.0,
                      stau=1.0, cell_wise=False, pspg=False)

        def geometry(lo, hi):
            return self.jinv[lo:hi], self.jxw[lo:hi], self.h[lo:hi]

        r = gls.sweep(u, u, None, self.cells, self.S, self.D, geometry, params)
        return torch.where(self.fixed, torch.zeros_like(r), r)

    def functionals(self, u):
        """(drag, lift) of the solution u (reference numbering): the
        stress on the cylinder with a 3-point Gauss face rule, scaled by
        2 / (D U^2 H) with U = 4/9 u_max."""
        sp, p, t = self.space, self.p, self.t
        el3 = Element(3, sp.degree, 3)
        drag = lift = 0.0
        for fb in sp.build_face_batches(3, boundary_ids=[CYLINDER]):
            S, Dr = tabulate_at(sp.degree, 3, el3.face_q_points(fb.local_face))
            u_loc = u[self.cells[t(fb.cells, torch.int64)]]
            val, grad = gls.evaluate(t(S), t(Dr), t(fb.jinv), u_loc)
            gu = grad[..., :3, :]
            stress = (p["nu"] * (gu + gu.transpose(-1, -2))
                      - val[..., 3, None, None] * torch.eye(
                          3, dtype=u.dtype, device=u.device))
            force = torch.einsum("fqab,fqb->fqa", stress, -t(fb.normals))
            w = t(fb.jxw)
            drag = drag + float((force[..., 0] * w).sum())
            lift = lift + float((force[..., 1] * w).sum())
        u_bar = p["simulation_u_max"] * 4.0 / 9.0
        scale = 2.0 / DIAMETER / u_bar ** 2 / HEIGHT
        return drag * scale, lift * scale

    def judge(self, node_pos, answers) -> dict:
        worst = dict(residual_l2=0.0, bc_gap=0.0, functional_gap=0.0)
        for a in answers:
            u = self.to_reference(node_pos, np.asarray(a["u"], np.float64))
            if u is None or not bool(torch.isfinite(u).all()):
                return {k: float("inf") for k in worst}
            r = self.residual(u)
            gap_bc = (u - self.g).abs()[self.fixed].max()
            ref = self.functionals(u)
            rec = a["record"]
            got = (rec.get("drag"), rec.get("lift"))
            if any(v is None for v in got):
                fgap = float("inf")
            else:
                fgap = max(abs(g - f) / max(abs(f), 1e-3)
                           for g, f in zip(got, ref))
            worst["residual_l2"] = max(worst["residual_l2"],
                                       float(torch.linalg.vector_norm(r)))
            worst["bc_gap"] = max(worst["bc_gap"], float(gap_bc))
            worst["functional_gap"] = max(worst["functional_gap"], fgap)
        return worst


def judge(config, run, device) -> dict:
    return Reference(config, device).judge(run.node_pos, run.answers)
