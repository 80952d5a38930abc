"""Simulation case interface (reference ``simulation.h:18-63``):
geometry + boundary conditions + functionals per case."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class BoundaryFunction:
    """Time-dependent boundary value function: __call__(points, component)
    -> values; set_time(t) like deal.II Function."""

    def __init__(self):
        self.time = 0.0

    def set_time(self, t: float):
        self.time = t

    def __call__(self, points: np.ndarray, component: int) -> np.ndarray:
        raise NotImplementedError


class ChannelInflow(BoundaryFunction):
    """Ramp-up + optional parabolic profile inflow
    (reference ``simulation.cc:24-75`` InflowBoundaryValues::Channel)."""

    def __init__(self, t_init: float, u_max: float, no_slip_bc: bool = False,
                 H: float = 0.0, shift: float = 0.0):
        super().__init__()
        self.t_init = t_init
        self.u_max = u_max
        self.no_slip_bc = no_slip_bc
        self.H = H
        self.shift = shift

    def __call__(self, points, component):
        n = len(points)
        if component != 0:
            return np.zeros(n)
        factor = np.ones(n)
        if self.t_init != 0:
            factor *= min(self.time / self.t_init, 1.0)
        if self.no_slip_bc:
            H = self.H
            y = points[:, 1] - self.shift
            factor *= 4 * y * (H - y) / H / H
            if points.shape[1] == 3:
                z = points[:, 2] + H / 2.0
                factor *= 4 * z * (H - z) / H / H
        return self.u_max * factor


class RotationBoundary(BoundaryFunction):
    """Rigid rotation (-y, x, 0) (reference ``simulation.cc:77-96``)."""

    def __call__(self, points, component):
        if component == 0:
            return -points[:, 1]
        if component == 1:
            return points[:, 0].copy()
        return np.zeros(len(points))


@dataclasses.dataclass
class BoundaryDescriptor:
    """Reference ``simulation.h:22-37``."""

    all_homogeneous_dbcs: list = dataclasses.field(default_factory=list)
    all_homogeneous_nbcs: list = dataclasses.field(default_factory=list)
    all_inhomogeneous_dbcs: list = dataclasses.field(default_factory=list)
    all_slip_bcs: list = dataclasses.field(default_factory=list)
    periodic_bcs: list = dataclasses.field(default_factory=list)  # (b0,b1,dir)
    all_outflow_bcs_cut: set = dataclasses.field(default_factory=set)
    all_outflow_bcs_nitsche: dict = dataclasses.field(default_factory=dict)


class SimulationBase:
    """Reference ``simulation.h:18-63`` contract."""

    def __init__(self, dim: int):
        self.dim = dim

    def parse_parameters(self, extra: dict):
        pass

    def create_mesh(self, n_global_refinements: int):
        raise NotImplementedError

    def get_boundary_descriptor(self) -> BoundaryDescriptor:
        raise NotImplementedError

    def get_u_max(self) -> float:
        return 1.0

    def mapping_degree(self, fe_degree: int, requested: int) -> int:
        return fe_degree if requested == 0 else requested

    def setup_postprocess(self, space, nu: float, device="cuda"):
        pass

    def postprocess(self, t: float, solution) -> Optional[dict]:
        return None
