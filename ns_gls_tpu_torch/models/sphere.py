"""Flow-past-sphere case from a Gmsh mesh (reference
``simulation.cc:852-908``): mesh read from ``meshes/sphere.msh``,
spherical manifold on the sphere surface, slip walls, inflow/outflow.

Port of ``ns_gls_tpu/models/sphere.py``.  The mesh file is the
repository's ``meshes/sphere.msh`` unless the configuration names another
with ``"simulation mesh file"``.  The refined mesh is a general (not
extruded) 3D hex mesh, so its f32 multigrid levels run the patch-3D sweep
(``ops/patch3d.py``).
"""

from __future__ import annotations

import os

import numpy as np

from ns_gls_tpu_torch.mesh.core import SphericalManifold
from ns_gls_tpu_torch.mesh.gmsh import read_msh
from ns_gls_tpu_torch.models.base import (
    BoundaryDescriptor,
    ChannelInflow,
    SimulationBase,
)

MESH_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "meshes", "sphere.msh")


class SimulationSphere(SimulationBase):
    def __init__(self, dim: int, mesh_file: str | None = None):
        super().__init__(dim)
        if dim != 3:
            raise NotImplementedError("sphere case is 3D")
        self.mesh_file = mesh_file or MESH_FILE

    def parse_parameters(self, raw: dict):
        if "simulation mesh file" in raw:
            self.mesh_file = str(raw["simulation mesh file"])

    def create_mesh(self, n_global_refinements: int):
        mesh = read_msh(self.mesh_file)
        # spherical manifold on physical-group/boundary id 0 (the sphere)
        mesh.manifolds[0] = SphericalManifold(np.zeros(3))
        mesh.attach_manifold_to_boundary_id(0, 0)
        return mesh.refine_global(n_global_refinements)

    def get_boundary_descriptor(self) -> BoundaryDescriptor:
        bcs = BoundaryDescriptor()
        bcs.all_inhomogeneous_dbcs.append((1, ChannelInflow(0.0, 1.0)))
        bcs.all_homogeneous_nbcs.append(3)
        bcs.all_slip_bcs.append(2)
        bcs.all_homogeneous_dbcs.append(0)
        return bcs
