"""The system under test of ``"system": "lattice_operator"``
configurations: the program's ``NavierStokesOperator`` on the unit
hypercube refined ``n_global_refinements`` times, with no constraints and
the BDF weights of equal steps, as the reference's ``gls-vmult``
(``performance.cc``) builds it; the history is zero, as there.  What the
``apply`` loop asks of a system.

Copied from ``bench_gpu.py`` ``build``, changed: the settings come from
the configuration file, and each node's place on the node lattice is
kept so that the state can be drawn on the lattice.
"""

from __future__ import annotations

import numpy as np
import torch


class System:
    def __init__(self, config, device):
        from ns_gls_tpu_torch.fem.constraints import AffineConstraints
        from ns_gls_tpu_torch.fem.space import FESpace
        from ns_gls_tpu_torch.mesh.generators import (
            subdivided_hyper_rectangle,
        )
        from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
        from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator

        p = config["program"]
        self.device = torch.device(device)
        dim, ref, degree = p["dim"], p["n_global_refinements"], p["fe_degree"]
        dtype = {"f32": torch.float32, "f64": torch.float64}[p["precision"]]
        mesh = subdivided_hyper_rectangle(
            (1,) * dim, (0.0,) * dim, (1.0,) * dim, colorize=True
        ).refine_global(ref)
        space = FESpace(mesh, degree)
        C = dim + 1
        ca = AffineConstraints(space.n_nodes, C).close(dtype, self.device)
        ti = BDFIntegrator(p["bdf_order"])
        for _ in range(p["bdf_order"]):
            ti.update_dt(p["dt"])
        self.op = NavierStokesOperator(
            space, ca, ca, nu=p["nu"], c_1=p["c1"], c_2=p["c2"],
            time_integrator=ti,
            consider_time_derivative=p["consider_time_derivative"],
            increment_form=p["flavor"] == "increment",
            cell_wise_stabilization=p["cell_wise_stabilization"],
            dtype=dtype, device=self.device)
        self.dim, self.dtype = dim, dtype
        self.n_dofs = space.n_nodes * C
        self.node_pos = space.node_pos
        self.n_lattice = degree * 2 ** ref + 1
        # each program node's place in the x-fastest node lattice
        ijk = np.rint(space.node_pos * (self.n_lattice - 1)).astype(np.int64)
        lin = np.zeros(space.n_nodes, np.int64)
        for d in reversed(range(dim)):
            lin = lin * self.n_lattice + ijk[:, d]
        self.lattice_index = torch.as_tensor(lin, device=self.device)

    def draw_state(self, gen):
        """A normal draw from ``gen`` on the node lattice (float32, x
        fastest), set as the linearization point: (the draw, which the
        reference is handed too, and the program's vector of it)."""
        u_lattice = torch.randn((self.n_lattice ** self.dim, self.dim + 1),
                                generator=gen, device=self.device,
                                dtype=torch.float32)
        u = u_lattice[self.lattice_index].to(self.dtype)
        self.op.set_linearization_point(u)
        return u_lattice, u

    def apply(self, x):
        return self.op.vmult(x)

    def instrument(self, spans):
        spans.wrap(self, "apply", "bench.apply")


def reference_in_place(config, device):
    """``wrap_system`` of the control: the apply becomes the plain
    reference's, in float32 with TF32 matrix products, at the state the
    loop draws."""
    from benchmark.reference.cases.hypercube import (
        Reference,
        lower_precision,
    )

    def wrap(system):
        draw_state = system.draw_state

        def draw(gen):
            u_lattice, u = draw_state(gen)
            ref = Reference(config, u_lattice, device, dtype=torch.float32)
            idx = system.lattice_index

            def apply(x):
                xl = torch.zeros((ref.N ** ref.d, x.shape[1]),
                                 dtype=torch.float32, device=device)
                xl[idx] = x
                with lower_precision():
                    return ref.apply_lattice(xl)[idx]

            system.apply = apply
            return u_lattice, u

        system.draw_state = draw

    return wrap
