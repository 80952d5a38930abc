"""Taylor-Couette rotation case (reference ``simulation.cc:789-848``):
a 2D annular shell, rigid rotation on the inner boundary, no-slip on the
outer one, the boundary layer refined once more.

Port of ``ns_gls_tpu/models/rotation.py``.  The boundary refinement
leaves hanging nodes on the polar-manifold interface
(``fem/hanging.py``); ``input/rotation.json`` runs it under the
local-smoothing multigrid (``precond/gmg_ls.py``).
"""

from __future__ import annotations

from ns_gls_tpu_torch.mesh.core import PolarManifold
from ns_gls_tpu_torch.mesh.generators import hyper_shell_2d
from ns_gls_tpu_torch.models.base import (
    BoundaryDescriptor,
    RotationBoundary,
    SimulationBase,
)


class SimulationRotation(SimulationBase):
    def create_mesh(self, n_global_refinements: int):
        if self.dim != 2:
            raise NotImplementedError("rotation case is 2D")
        mesh = hyper_shell_2d((0.0, 0.0), 0.25, 1.0, 4)
        mesh.manifolds[0] = PolarManifold((0.0, 0.0))
        mesh = mesh.refine_global(n_global_refinements)
        # every boundary-adjacent cell once more (``simulation.cc:803-809``)
        flags = (mesh.boundary_ids >= 0).any(axis=1)
        return mesh.refine(flags)

    def get_boundary_descriptor(self) -> BoundaryDescriptor:
        bcs = BoundaryDescriptor()
        bcs.all_inhomogeneous_dbcs.append((0, RotationBoundary()))
        bcs.all_homogeneous_dbcs.append(1)
        return bcs
