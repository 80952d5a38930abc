"""Judging stationary solves of the flow past a sphere (dealii-ns-gls
``input/sphere_amg.json``, ``simulation.cc:852-908``).

From the configuration alone the reference works out the mesh (the
frozen Gmsh reader on ``meshes/sphere.msh``, the spherical manifold on
the sphere, boundary id 0, the isoparametric mapping), its own node
numbering, the boundary values and the GLS residual.  It reads the
program's answer (the node positions and values of a solution) only to
judge it:

- ``residual_l2``: the 2-norm of the stationary GLS residual of the
  solution with the rows the Dirichlet conditions fix set to zero
  (velocity on the inflow, id 1, and on the sphere; pressure on the
  do-nothing outflow, id 3) and, on the slip walls (id 2), the component
  along each wall's normal removed: one normal on a wall, both where two
  walls meet (deal.II ``compute_no_normal_flux_constraints``);
- ``bc_gap``: the largest gap between the solution and the Dirichlet
  values on the rows they fix (velocity (1, 0, 0) on the inflow, 0 on the
  sphere, pressure 0 on the outflow);
- ``slip_flux``: the largest |u . n| over the slip-wall nodes that no
  Dirichlet condition holds, for the normal n of every wall a node lies
  on.

The slip walls are the planes |y| = 1.5 and |z| = 1.5; their normals come
from the mesh's id-2 boundary faces, each checked to be planar.  The
sphere has no functional in the reference, so none is compared.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.reference.cases.cylinder3d import Reference as _Cylinder
from benchmark.reference.frozen.element import cell_face_vertices
from benchmark.reference.frozen.gmsh import read_msh
from benchmark.reference.frozen.space import Space
from benchmark.reference.frozen.sphere import (
    SphericalManifold,
    attach_manifold_to_boundary_id,
)

SPHERE, INFLOW, SLIP, OUTFLOW = 0, 1, 2, 3
MESH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "meshes", "sphere.msh")


def sphere_mesh(n_refinements: int):
    mesh = read_msh(MESH)
    mesh.manifolds[0] = SphericalManifold(np.zeros(3))
    attach_manifold_to_boundary_id(mesh, 0, SPHERE)
    return mesh.refine_global(n_refinements)


def slip_normals(space: Space):
    """(nodes, normals): each slip-wall node once for every distinct wall
    it lies on, with that wall's unit normal (sign: largest entry
    positive), from the planar id-2 faces."""
    mesh = space.mesh
    fv = np.array(cell_face_vertices(3))
    rows = []
    for fb in space.face_batches:
        cells = fb.cells[fb.boundary_id == SLIP]
        if not len(cells):
            continue
        corners = mesh.vertices[mesh.cells[cells][:, fv[fb.local_face]]]
        n = np.cross(corners[:, 3] - corners[:, 0],
                     corners[:, 2] - corners[:, 1])
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        big = np.abs(n).argmax(axis=1)
        n *= np.sign(n[np.arange(len(n)), big])[:, None]
        nodes = space.cell_nodes[cells][:, space.face_node_lattice(
            fb.local_face)]
        off = np.einsum("fkx,fx->fk",
                        space.node_pos[nodes] - corners[:, :1], n)
        assert np.abs(off).max() < 1e-12, "a slip-wall face is not planar"
        rows.append(np.column_stack([
            nodes.reshape(-1),
            np.repeat(np.round(n, 12), nodes.shape[1], axis=0)]))
    pairs = np.unique(np.concatenate(rows), axis=0)
    return pairs[:, 0].astype(np.int64), pairs[:, 1:]


class Reference:
    to_reference = _Cylinder.to_reference

    def __init__(self, config, device, dtype=torch.float64):
        p = config["program"]
        self.p = p
        self.device, self.dtype = device, dtype
        degree = p["fe_degree"]
        mapping = p["mapping_degree"] or degree
        mesh = sphere_mesh(p["n_global_refinements"])
        self.space = sp = Space(mesh, degree, mapping)
        self.t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                                     device=device)
        S, D = sp.element.tables
        self.S, self.D = self.t(S), self.t(D)
        self.cells = self.t(sp.cell_nodes, torch.int64)
        self.jinv, self.jxw = self.t(sp.jinv), self.t(sp.jxw)
        self.h = self.t(np.cbrt(6.0 * sp.cell_measure / np.pi) / degree)
        # the rows the Dirichlet conditions fix, and their values
        held = sp.boundary_nodes([SPHERE, INFLOW])
        fixed = np.zeros((sp.n_nodes, 4), bool)
        fixed[held, :3] = True
        fixed[sp.boundary_nodes([OUTFLOW]), 3] = True
        g = np.zeros((sp.n_nodes, 4))
        g[sp.boundary_nodes([INFLOW]), 0] = 1.0
        self.fixed = self.t(fixed, torch.bool)
        self.g = self.t(g)
        # the slip walls off the held nodes: each (node, wall normal) once,
        # and in passes that hold each node once
        nodes, normals = slip_normals(sp)
        free = ~np.isin(nodes, held)
        nodes, normals = nodes[free], normals[free]
        self.slip_nodes = self.t(nodes, torch.int64)
        self.slip_n = self.t(normals)
        first = np.searchsorted(nodes, nodes)
        rank = np.arange(len(nodes)) - first
        two = rank > 0
        assert np.abs((normals[two] * normals[first[two]]).sum(1)).max(
            initial=0.0) < 1e-12, "slip walls that meet are not orthogonal"
        self.slip_passes = [(self.t(nodes[rank == k], torch.int64),
                             self.t(normals[rank == k]))
                            for k in range(rank.max(initial=-1) + 1)]
        self.order = np.lexsort(np.round(sp.node_pos, 9).T)

    def residual(self, u):
        """The stationary GLS residual with the fixed rows zeroed (the
        cylinder's), then each slip wall's normal component removed."""
        r = _Cylinder.residual(self, u)
        # remove each wall's normal component; the walls that meet are
        # orthogonal, so one after the other removes the span of both
        for nodes, n in self.slip_passes:
            v = r[nodes, :3]
            r[nodes, :3] = v - (v * n).sum(1, keepdim=True) * n
        return r

    def judge(self, node_pos, answers) -> dict:
        worst = dict(residual_l2=0.0, bc_gap=0.0, slip_flux=0.0)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for a in answers:
                u = self.to_reference(node_pos,
                                      np.asarray(a["u"], np.float64))
                if u is None or not bool(torch.isfinite(u).all()):
                    return {k: float("inf") for k in worst}
                r = self.residual(u)
                gap_bc = (u - self.g).abs()[self.fixed].max()
                flux = ((u[self.slip_nodes, :3] * self.slip_n).sum(1).abs()
                        .max())
                worst["residual_l2"] = max(worst["residual_l2"], float(
                    torch.linalg.vector_norm(r)))
                worst["bc_gap"] = max(worst["bc_gap"], float(gap_bc))
                worst["slip_flux"] = max(worst["slip_flux"], float(flux))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return worst


def judge(config, run, device) -> dict:
    return Reference(config, device).judge(run.node_pos, run.answers)
