"""Stretched-rectangle channel case (reference ``simulation.cc:145-191``).

The mesh is a subdivided rectangle (or box) refined globally, so it keeps
its cell lattice and every level space is structured: the f32 multigrid
levels run the structured sweep (``ops/structured.py``).  The outflow is
a homogeneous Neumann boundary (pressure Dirichlet), so no face terms are
needed.
"""

from __future__ import annotations

from ns_gls_tpu_torch.mesh.generators import subdivided_hyper_rectangle
from ns_gls_tpu_torch.models.base import (
    BoundaryDescriptor,
    ChannelInflow,
    SimulationBase,
)


class SimulationChannel(SimulationBase):
    def __init__(self, dim: int):
        super().__init__(dim)
        self.n_stretching = 4

    def create_mesh(self, n_global_refinements: int):
        dim = self.dim
        n_sub = [1] * dim
        n_sub[0] *= self.n_stretching
        p1 = [1.0] * dim
        p1[0] *= self.n_stretching
        mesh = subdivided_hyper_rectangle(
            n_sub, [0.0] * dim, p1, colorize=True
        )
        return mesh.refine_global(2 + n_global_refinements)

    def get_boundary_descriptor(self) -> BoundaryDescriptor:
        bcs = BoundaryDescriptor()
        bcs.all_inhomogeneous_dbcs.append((0, ChannelInflow(0.0, 1.0)))
        bcs.all_homogeneous_nbcs.append(1)
        for d in range(1, self.dim):
            bcs.all_homogeneous_dbcs.append(2 * d)
            bcs.all_homogeneous_dbcs.append(2 * d + 1)
        return bcs
