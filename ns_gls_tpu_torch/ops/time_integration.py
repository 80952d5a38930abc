"""Time integration: variable-step BDF-1/2/3, one-step-theta, stationary.

Equivalent of the reference ``include/time_integration.{h,cc}``: the
weight computation (closed forms for variable-step BDF,
``time_integration.cc:61-91``) runs on the host as plain floats; the
``SolutionHistory`` ring buffer is a list of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


class TimeIntegrator:
    """Base interface (reference ``time_integration.h:10-32``)."""

    order: int = 0
    theta: float = 1.0

    def update_dt(self, dt_new: float) -> None:
        raise NotImplementedError

    @property
    def primary_weight(self) -> float:
        return self.weights[0]

    @property
    def weights(self) -> Sequence[float]:
        raise NotImplementedError

    @property
    def current_dt(self) -> float:
        raise NotImplementedError


class BDFIntegrator(TimeIntegrator):
    """Variable-step BDF of order 1..3 (reference ``time_integration.cc:4-91``).

    During start-up the *effective* order grows with the number of committed
    steps (entries of the dt ring buffer that are > 0), exactly like the
    reference's ``effective_order()``.
    """

    theta = 1.0

    def __init__(self, order: int):
        if not 1 <= order <= 3:
            raise ValueError("BDF order must be in 1..3")
        self.order = order
        self._dt = [0.0] * order
        self._weights = [0.0] * (order + 1)

    def update_dt(self, dt_new: float) -> None:
        for i in range(self.order - 2, -1, -1):
            self._dt[i + 1] = self._dt[i]
        self._dt[0] = dt_new
        self._update_weights()

    def _effective_order(self) -> int:
        return sum(1 for v in self._dt if v > 0)

    def _update_weights(self) -> None:
        w = [0.0] * (self.order + 1)
        dt = self._dt
        eff = self._effective_order()
        if eff == 3:
            w[1] = -(dt[0] + dt[1]) * (dt[0] + dt[1] + dt[2]) / (
                dt[0] * dt[1] * (dt[1] + dt[2]))
            w[2] = dt[0] * (dt[0] + dt[1] + dt[2]) / (
                dt[1] * dt[2] * (dt[0] + dt[1]))
            w[3] = -dt[0] * (dt[0] + dt[1]) / (
                dt[2] * (dt[1] + dt[2]) * (dt[0] + dt[1] + dt[2]))
            w[0] = -(w[1] + w[2] + w[3])
        elif eff == 2:
            w[0] = (2 * dt[0] + dt[1]) / (dt[0] * (dt[0] + dt[1]))
            w[1] = -(dt[0] + dt[1]) / (dt[0] * dt[1])
            w[2] = dt[0] / (dt[1] * (dt[0] + dt[1]))
        elif eff == 1:
            w[0] = 1.0 / dt[0]
            w[1] = -1.0 / dt[0]
        else:
            raise ValueError("BDF effective order not in 1..3")
        self._weights = w

    @property
    def weights(self):
        return tuple(self._weights)

    @property
    def current_dt(self):
        return self._dt[0]


class ThetaIntegrator(TimeIntegrator):
    """One-step-theta method (reference ``time_integration.cc:95-137``)."""

    order = 1

    def __init__(self, theta: float):
        self.theta = theta
        self._dt = 0.0
        self._weights = (0.0, 0.0)

    def update_dt(self, dt_new: float) -> None:
        self._dt = dt_new
        self._weights = (1.0 / dt_new, -1.0 / dt_new)

    @property
    def weights(self):
        return self._weights

    @property
    def current_dt(self):
        return self._dt


class StationaryIntegrator(TimeIntegrator):
    """No time integration (reference ``time_integration.cc:141-178``)."""

    order = 0
    theta = 1.0

    def update_dt(self, dt_new: float) -> None:
        pass

    @property
    def primary_weight(self):
        return 0.0

    @property
    def weights(self):
        return ()

    @property
    def current_dt(self):
        return 1.0


def set_dt_history(integrator: TimeIntegrator, dts) -> None:
    """Restore an integrator's step-size history, newest first (the JAX
    package's ``BDFIntegrator._dt`` list or a ``ThetaIntegrator``'s
    ``_dt``), and recompute its weights."""
    if isinstance(integrator, BDFIntegrator):
        dts = [float(x) for x in dts]
        if len(dts) != integrator.order:
            raise ValueError(
                f"BDF-{integrator.order} history needs {integrator.order} "
                f"step sizes, got {len(dts)}"
            )
        integrator._dt = dts
        integrator._update_weights()
    elif isinstance(integrator, ThetaIntegrator):
        integrator.update_dt(float(np.atleast_1d(dts)[0]))


def make_time_integrator(kind: str, bdf_order: int, theta: float) -> TimeIntegrator:
    if kind == "bdf":
        return BDFIntegrator(bdf_order)
    if kind == "theta":
        return ThetaIntegrator(theta)
    if kind == "none":
        return StationaryIntegrator()
    raise ValueError(f"unknown time integration '{kind}'")


@dataclasses.dataclass
class SolutionHistory:
    """Ring buffer of solution arrays, newest first
    (reference ``time_integration.cc:182-217``).

    ``vectors[0]`` is the current solution; ``vectors[i]`` the solution
    ``i`` steps back.  Stored as a list of ``(n_nodes, n_comp)`` arrays.
    """

    vectors: list

    @classmethod
    def zeros(cls, size: int, shape, dtype,
              device: str | torch.device = "cpu") -> "SolutionHistory":
        return cls([torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(size)])

    @classmethod
    def from_numpy(cls, arrays, dtype,
                   device: str | torch.device = "cpu") -> "SolutionHistory":
        """History from host arrays, newest first: each an
        ``(n_nodes, n_comp)`` array in the node numbering of ``FESpace``.
        Passing the JAX package's ``SolutionHistory.vectors`` (through
        ``np.asarray``) restarts the port from that state."""
        return cls([
            torch.tensor(np.asarray(a), dtype=dtype, device=device)
            for a in arrays
        ])

    @property
    def current(self):
        return self.vectors[0]

    @current.setter
    def current(self, value):
        self.vectors[0] = value

    def commit(self) -> None:
        """Shift: vectors[i+1] <- vectors[i] (ref ``commit_solution``)."""
        for i in range(len(self.vectors) - 2, -1, -1):
            self.vectors[i + 1] = self.vectors[i]

    def weighted_old_sum(self, weights):
        """sum_i>=1 weights[i] * vectors[i] — the 'old' part of the BDF
        derivative (reference ``operator_ns.cc:256-258``)."""
        acc = torch.zeros_like(self.vectors[0])
        for i in range(1, len(weights)):
            acc = acc + weights[i] * self.vectors[i]
        return acc
