"""The system under test of ``"system": "driver"`` configurations: the
port's ``Driver`` on the configuration's parameters, set up, driven one
driver step at a time (a stationary configuration's step is its whole
solve).  What the ``solve`` loop asks of a system."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.spec import program_params


class System:
    def __init__(self, config, device):
        from ns_gls_tpu_torch.config import Parameters
        from ns_gls_tpu_torch.driver import Driver
        from ns_gls_tpu_torch.utils.logging import set_verbose

        set_verbose(False)
        self.device = torch.device(device)
        self.driver = drv = Driver(Parameters.from_dict(
            program_params(config)), device=self.device)
        drv.setup()
        drv._setup_done = True
        self.start = torch.clone(drv.solution.vectors[0])
        self.n_dofs = drv.space.n_nodes * (drv.params.dim + 1)
        self.node_pos = drv.space.node_pos
        space = drv.space
        bids = np.unique(space.mesh.boundary_ids)
        boundary = space.boundary_nodes(bids[bids >= 0])
        self.interior = torch.as_tensor(
            np.setdiff1d(np.arange(space.n_nodes), boundary),
            device=self.device)

    def perturbed_start(self, gen, amplitude):
        """The configuration's start plus ``amplitude`` times a normal
        draw from ``gen`` on the nodes off the boundary (host arrays,
        newest first)."""
        start = self.start.clone()
        noise = torch.randn((len(self.interior), start.shape[1]),
                            generator=gen, device=self.device,
                            dtype=start.dtype)
        start[self.interior] += amplitude * noise
        return [start.cpu().numpy()]

    def solve(self, start):
        """One driver step from the state ``start``; its record."""
        drv = self.driver
        drv.restart_from(start, [], 0.0, 1)
        records = drv.run(max_steps=1)
        return records[-1] if records else {}

    def solution(self):
        return self.driver.solution.current

    def step_stats(self) -> list:
        return self.driver.step_stats

    def instrument(self, spans):
        """Spans around the layers a driver step calls: the Newton
        callbacks, the GMRES solve, the preconditioner's rebuild and
        V-cycle, the fine operator's apply."""
        drv = self.driver
        nl = drv.nonlinear_solver
        spans.wrap(nl, "evaluate_residual", "bench.residual")
        spans.wrap(nl, "setup_jacobian", "bench.jacobian")
        spans.wrap(drv.linear_solver, "solve", "bench.gmres")
        spans.wrap(drv.preconditioner, "initialize", "bench.rebuild")
        spans.wrap(drv.preconditioner, "vmult", "bench.vcycle")
        spans.wrap(drv.op, "vmult", "bench.fine_apply")

    def timers(self) -> dict:
        """The driver's own scope timers: {label: total seconds}."""
        from ns_gls_tpu_torch.utils.timer import get_collection

        return {k: v[1] for k, v in get_collection()._data.items()}
