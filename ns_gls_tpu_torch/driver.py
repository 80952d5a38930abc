"""Simulation driver: config -> setup -> time loop.

Port of the JAX package's single-device ``Driver`` (the reference's
``Driver<dim>``, ``main.cc:199-1052``): builds the mesh/space/constraints,
the NS operator (matrix-free, or assembled for the non-Newton solvers),
the preconditioner (GMG with global coarsening or local smoothing, level
operators in f32; AMG, ILU, Jacobi or identity), the GMRES, Richardson or
direct linear solver and the Newton, Picard or linearized nonlinear
solver wired through callbacks, then runs the CFL-controlled time loop
with drag/lift/pressure-drop records, optional VTU output and rolling
checkpoints, resumable with ``run(resume=True)``.

Precision follows the reference layering: f64 outer solve, f32 multigrid
levels, TF32 off.  With ``n devices`` > 1 one process shards the fine
operator and the multigrid levels over a list of devices
(``parallel/``): the halo-exchange operator and the distributed V-cycle
by default, the cell-sharded "replicated" strategy on request or for the
matrix-based operator (``ns_gls_tpu/driver.py:271-296``).
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ns_gls_tpu_torch.config import Parameters
from ns_gls_tpu_torch.fem import constraints as cstr
from ns_gls_tpu_torch.fem.constraints import (
    AffineConstraints,
    ConstraintArrays,
    distribute,
)
from ns_gls_tpu_torch.fem.space import FESpace
from ns_gls_tpu_torch.fem.transfer import build_transfer, interpolate_to_coarse
from ns_gls_tpu_torch.models import make_simulation
from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
from ns_gls_tpu_torch.ops.time_integration import (
    SolutionHistory,
    make_time_integrator,
    set_dt_history,
)
from ns_gls_tpu_torch.precond.gmg import PreconditionerGMG
from ns_gls_tpu_torch.precond.jacobi import (
    PreconditionerIdentity,
    PreconditionerJacobi,
)
from ns_gls_tpu_torch.solvers.linear import (
    LinearSolverDirect,
    LinearSolverGMRES,
    LinearSolverRichardson,
)
from ns_gls_tpu_torch.solvers.nonlinear import make_nonlinear_solver
from ns_gls_tpu_torch.utils.device import resolve_device
from ns_gls_tpu_torch.utils.logging import get_logger
from ns_gls_tpu_torch.utils.timer import timer


def pressure_pin_candidates(space) -> np.ndarray:
    """Node indices at ROOT-mesh vertex positions, in lexicographic
    position order.

    The pressure pin must land on the SAME physical point on the fine
    level and on every multigrid level (``main.cc:453-477`` pins the
    coarse level; the fine level is pinned too, see ConstraintSetBuilder):
    a fine pin whose position no level pins leaves the constant-pressure
    mode inconsistently gauged between the system and the V-cycle.  Root
    vertices persist on every refinement level and are
    numbering-independent, so selecting by root-vertex position makes
    every level agree."""
    mesh = space.mesh
    root = mesh
    while root.prev is not None:
        root = root.prev
    rv = np.round(np.asarray(root.vertices, np.float64), 9)
    rv = rv[np.lexsort(rv.T[::-1])]          # lexicographic by (x, y[, z])
    pos = np.round(np.asarray(space.node_pos, np.float64), 9)
    lut = {tuple(p): i for i, p in reversed(list(enumerate(pos)))}
    return np.array(
        [lut[tuple(p)] for p in rv if tuple(p) in lut], dtype=np.int64
    )


class ConstraintSetBuilder:
    """Builds the reference's three constraint sets (``main.cc:258-310``):
    - 'full'          : hom. DBCs + pressure pins + slip + periodic
    - 'homogeneous'   : full + inhom.-DBC boundaries zeroed
    - 'inhomogeneous' : full + inhom. DBC values at time t (rebuilt cheaply
                        each step by swapping the inhom value vector)
    """

    def __init__(self, space: FESpace, bcs, dtype, device):
        self.space = space
        self.bcs = bcs
        self.dtype = dtype
        self.device = device
        dim = space.dim
        self.vel_comps = list(range(dim))

        from ns_gls_tpu_torch.fem.hanging import hanging_node_constraints

        hanging = hanging_node_constraints(space)

        # all-Dirichlet problems have a floating constant-pressure mode:
        # pin one pressure dof so every level's system is nonsingular
        pin_pressure = not (
            bcs.all_homogeneous_nbcs
            or bcs.all_outflow_bcs_cut
            or bcs.all_outflow_bcs_nitsche
        )

        def build(include_inhom_rows: bool):
            b = AffineConstraints(space.n_nodes, dim + 1)
            for bid in bcs.all_homogeneous_dbcs:
                b.add_dirichlet(space.boundary_nodes([bid]), self.vel_comps)
            for bid in bcs.all_homogeneous_nbcs:
                b.add_dirichlet(space.boundary_nodes([bid]), [dim])
            for bid in bcs.all_slip_bcs:
                nodes, normals = space.boundary_node_normals([bid])
                b.add_no_normal_flux(nodes, normals)
            for b0, b1, direction in bcs.periodic_bcs:
                na, nb = self._match_periodic(b0, b1, direction)
                b.add_periodic(na, nb, list(range(dim + 1)))
            if include_inhom_rows:
                for bid, _fn in bcs.all_inhomogeneous_dbcs:
                    b.add_dirichlet(space.boundary_nodes([bid]), self.vel_comps)
            # hanging nodes last (reference order, ``main.cc:273-293``)
            for node, masters, weights in hanging:
                b.add_hanging_node(node, None, masters, weights)
            if pin_pressure:
                # positional choice (root-vertex order, see
                # pressure_pin_candidates) so every MG level pins the
                # same physical point under any node numbering
                for n in pressure_pin_candidates(space):
                    if not b.is_constrained(b.dof(int(n), dim)):
                        b.add_line(b.dof(int(n), dim))
                        break
                else:
                    for n in range(space.n_nodes):
                        if not b.is_constrained(b.dof(n, dim)):
                            b.add_line(b.dof(n, dim))
                            break
            return b

        self.full = build(False).close(dtype, device)
        self.homogeneous = build(True).close(dtype, device)

        # inhomogeneous: same rows as homogeneous, but remember which rows
        # belong to which (boundary fn, node, comp) for per-step updates
        self._inhom_slots = []  # (fn, row_positions, nodes, comps)
        rows_sorted = self.homogeneous.rows.cpu().numpy()
        for bid, fn in bcs.all_inhomogeneous_dbcs:
            nodes = space.boundary_nodes([bid])
            for comp in self.vel_comps:
                dofs = nodes.astype(np.int64) * (dim + 1) + comp
                pos = np.searchsorted(rows_sorted, dofs)
                ok = (pos < len(rows_sorted)) & (rows_sorted[np.minimum(
                    pos, len(rows_sorted) - 1)] == dofs)
                self._inhom_slots.append((fn, pos[ok], nodes[ok], comp))

    def _match_periodic(self, b0, b1, direction):
        sp = self.space
        na = sp.boundary_nodes([b0])
        nb = sp.boundary_nodes([b1])
        key_dims = [d for d in range(sp.dim) if d != direction]
        tol = max(self.space.mesh.cell_min_vertex_distance().min() / 64, 1e-12)

        def keys(nodes):
            k = np.round(sp.node_pos[nodes][:, key_dims] / tol).astype(np.int64)
            return [tuple(row) for row in k]

        map_a = dict(zip(keys(na), na))
        pa, pb = [], []
        for k, nb_i in zip(keys(nb), nb):
            if k in map_a:
                pa.append(nb_i)   # constrain side b
                pb.append(map_a[k])
        return np.array(pa), np.array(pb)

    def inhomogeneous_at(self, t: float) -> ConstraintArrays:
        """Constraint set with boundary values evaluated at time t
        (``main.cc:925-942``)."""
        inhom = np.zeros(self.homogeneous.rows.shape[0])
        for fn, pos, nodes, comp in self._inhom_slots:
            fn.set_time(t)
            inhom[pos] = fn(self.space.node_pos[nodes], comp)
        return self.homogeneous._replace(
            inhom=torch.as_tensor(inhom, dtype=self.dtype, device=self.device)
        )


def shard_devices(n: int, device: torch.device) -> tuple:
    """The devices of ``n`` shards: cards 0..n-1, or n CPU shards."""
    if device.type != "cuda":
        return (device,) * n
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"requested {n} devices, have {have}")
    return tuple(torch.device("cuda", i) for i in range(n))


class Driver:
    def __init__(self, params: Parameters, device: str | torch.device = "cuda",
                 devices=None):
        """``devices``: the shards' devices under ``n devices`` > 1 (a
        device may repeat, e.g. four shards on one card); by default
        ``device``'s cards 0..n-1, or n CPU shards.  The global vectors
        live on the first."""
        if (params.n_devices > 1
                and params.parallel_strategy not in ("halo", "replicated")):
            raise ValueError(
                f"unknown parallel strategy {params.parallel_strategy}")
        if devices is not None:
            from ns_gls_tpu_torch.parallel.sharding import make_device_mesh

            devices = make_device_mesh(devices)
            if len(devices) != params.n_devices:
                raise ValueError(f"'n devices' = {params.n_devices} with "
                                 f"{len(devices)} devices given")
            device = devices[0]
        self.device = resolve_device(device)
        if devices is None and params.n_devices > 1:
            devices = shard_devices(params.n_devices, self.device)
        self.devices = devices
        # exact f32/f64 arithmetic: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.params = params
        self.log = get_logger()
        # per time step: Newton and GMRES iterations, seconds
        self.step_stats = []
        self._t0 = 0.0
        # simulated time after the last completed step
        self.time_reached = 0.0
        self._counter0 = 1
        self._restarted = False
        self._output_counter = 0
        self._checkpoint_counter = 1

    # ------------------------------------------------------------------
    def setup(self):
        p = self.params
        dev = self.device
        dtype = p.dtype
        mg_dtype = p.mg_dtype

        with timer("setup::simulation"):
            sim = make_simulation(p.simulation_name, p.dim)
            # each case re-parses shared keys, like the reference's
            # two-phase ParameterHandler parsing (``simulation.cc:233-289``)
            sim.parse_parameters(
                p.extra
                | {
                    "nu": p.nu,
                    "paraview prefix": p.paraview_prefix,
                    "output granularity": p.output_granularity,
                    "fe degree": p.fe_degree,
                    "mapping degree": p.mapping_degree,
                }
            )
            self.sim = sim
            self.mesh = sim.create_mesh(p.n_global_refinements)

        bcs = sim.get_boundary_descriptor()
        self.bcs = bcs
        mapping_degree = sim.mapping_degree(p.fe_degree, p.mapping_degree)

        with timer("setup::space"):
            space = FESpace(self.mesh, p.fe_degree, mapping_degree)
            self.space = space
        self.log(
            f"    [I] Number of active cells:    {self.mesh.n_cells}\n"
            f"    [I] Global degrees of freedom: {space.n_nodes * (p.dim + 1)}"
        )

        with timer("setup::constraints"):
            self.csets = ConstraintSetBuilder(space, bcs, dtype, dev)

        self.time_integrator = make_time_integrator(
            p.time_integration, p.bdf_order, p.theta
        )
        increment_form = p.nonlinear_solver == "Newton"

        with timer("setup::operator"):
            self.op = NavierStokesOperator(
                space,
                self.csets.homogeneous,
                self.csets.full,
                nu=p.nu,
                c_1=p.c_1,
                c_2=p.c_2,
                time_integrator=self.time_integrator,
                consider_time_derivative=p.consider_time_derivative,
                increment_form=increment_form,
                cell_wise_stabilization=p.cell_wise_stabilization,
                outflow_bcs_cut=bcs.all_outflow_bcs_cut,
                outflow_bcs_nitsche=bcs.all_outflow_bcs_nitsche,
                dtype=dtype,
                device=dev,
            )
            self.op.constraints_inhomogeneous = self.csets.inhomogeneous_at(0.0)

        # the preconditioners that take the fine operator assemble or
        # apply the matrix-free one, unsharded
        op_mf = self.op
        self.op_unsharded = op_mf
        # the halo strategy shards the matrix-free operator; the
        # replicated one serves the matrix-based operator too
        halo = (self.devices is not None and p.parallel_strategy == "halo"
                and p.use_matrix_free_ns_operator)
        if not p.use_matrix_free_ns_operator:
            # assembled SpMV (``main.cc:351-364``; the reference restricts
            # it to non-Newton solvers)
            if p.nonlinear_solver == "Newton":
                raise ValueError(
                    "matrix-based operator does not support Newton")
            from ns_gls_tpu_torch.ops.matrix_based import (
                NavierStokesOperatorMatrixBased,
            )

            self.op = NavierStokesOperatorMatrixBased(op_mf)
        if self.devices is not None and not halo:
            from ns_gls_tpu_torch.parallel.sharding import ShardedOperator

            sharded = ShardedOperator(op_mf, self.devices)
            if p.use_matrix_free_ns_operator:
                self.op = sharded
            else:
                self.op.residual_op = sharded

        # ---- preconditioner ------------------------------------------------
        self.mg_ops = []
        self.mg_transfers = []
        # the levels' sharded wrappers (``n devices`` > 1, GMG)
        self.mg_ops_apply = []
        # GMG-LS: per forest level, its (level node, final node) pairs
        self._ls_lvl2fin = None
        with timer("setup::preconditioner"):
            if p.preconditioner == "GMG-LS" and self.devices is None:
                self._setup_gmg_ls(bcs, mapping_degree, increment_form,
                                   mg_dtype)
            elif p.preconditioner in ("GMG", "GMG-LS"):
                if p.preconditioner == "GMG-LS":
                    # the multi-device cycle is the distributed global-
                    # coarsening one, on an explicit opt-in
                    # (``ns_gls_tpu/driver.py:315-345``)
                    if not p.gmg_ls_parallel_fallback:
                        raise ValueError(
                            "preconditioner 'GMG-LS' with 'n devices' > 1 "
                            "is served by the distributed global-"
                            "coarsening GMG cycle; set "
                            '"gmg ls parallel fallback": true to accept '
                            "it (or use preconditioner 'GMG')")
                    import warnings

                    warnings.warn(
                        "preconditioner 'GMG-LS' with 'n devices' > 1 "
                        "falls back to the global-coarsening GMG cycle",
                        stacklevel=2)
                self._setup_gmg(bcs, mapping_degree, increment_form, mg_dtype,
                                halo)
            elif p.preconditioner == "ILU":
                from ns_gls_tpu_torch.precond.ilu import PreconditionerILU

                self.preconditioner = PreconditionerILU(op_mf)
            elif p.preconditioner == "AMG":
                from ns_gls_tpu_torch.precond.amg import PreconditionerAMG

                # matrix-free level 0 (``ns_gls_tpu/driver.py:353-359``)
                self.preconditioner = PreconditionerAMG(
                    op_mf, smoother=p.amg_smoother)
            elif p.preconditioner == "Jacobi":
                self.preconditioner = PreconditionerJacobi(op_mf)
            elif p.preconditioner == "identity":
                self.preconditioner = PreconditionerIdentity()
            else:
                raise ValueError(
                    f"unknown preconditioner {p.preconditioner}")

        if halo:
            from ns_gls_tpu_torch.parallel.halo import HaloShardedOperator

            # the outer Krylov hands the distributed V-cycle its vectors:
            # the fine operator takes the finest level's partition, so
            # that both have one layout (``ns_gls_tpu/driver.py:520-525``)
            part = (self.mg_ops_apply[-1].partition
                    if self.mg_ops_apply else None)
            self.op = HaloShardedOperator(op_mf, self.devices, part)
            if self.mg_ops_apply:
                assert np.array_equal(self.mg_ops_apply[-1].own_global,
                                      self.op.own_global), \
                    "fine MG level layout differs from the operator's"

        # ---- linear solver -------------------------------------------------
        if p.linear_solver == "GMRES":
            self.linear_solver = LinearSolverGMRES(
                self.op, self.preconditioner,
                p.lin_n_max_iterations, p.lin_absolute_tolerance,
                p.lin_relative_tolerance, logger=self.log,
            )
        elif p.linear_solver == "Richardson":
            self.linear_solver = LinearSolverRichardson(
                self.op, self.preconditioner,
                p.lin_n_max_iterations, p.lin_absolute_tolerance,
                p.lin_relative_tolerance, logger=self.log,
            )
        elif p.linear_solver == "direct":
            # the dense LU assembles the unsharded operator
            self.linear_solver = LinearSolverDirect(
                self.op if self.devices is None else op_mf, logger=self.log)
        else:
            raise ValueError(f"unknown linear solver {p.linear_solver}")

        # ---- nonlinear solver ----------------------------------------------
        nl = make_nonlinear_solver(p.nonlinear_solver, p.newton_inexact,
                                   p.nonlinear_tolerance,
                                   p.nonlinear_tolerance_relative,
                                   p.nonlinear_max_iterations)
        nl.logger = self.log
        nl.setup_jacobian = self._setup_jacobian
        nl.setup_preconditioner = self._setup_preconditioner
        nl.evaluate_rhs = self.op.evaluate_rhs
        nl.evaluate_residual = self.op.evaluate_residual
        nl.solve_with_jacobian = self._solve_with_jacobian
        self.nonlinear_solver = nl

        # ---- state ----------------------------------------------------------
        self.solution = SolutionHistory.zeros(
            self.time_integrator.order + 1,
            (space.n_nodes, p.dim + 1),
            dtype,
            dev,
        )
        self.solution.current = distribute(
            self.op.constraints_inhomogeneous, self.solution.current
        )
        sim.setup_postprocess(space, p.nu, dev)

    # ------------------------------------------------------------------
    def _setup_gmg(self, bcs, mapping_degree, increment_form, mg_dtype,
                   halo=False):
        """Geometric coarsening sequence (``main.cc:396-568``): the level
        meshes are the refinement *generation chain* of the final mesh,
        so MG transfers come straight from the stored parent maps.  Under
        sharding every level's hot apply is sharded over the same devices
        as the fine operator; with ``halo`` the transfers are halo
        transfers and the cycle runs on distributed vectors
        (``ns_gls_tpu/driver.py:490-540``)."""
        p = self.params
        dev = self.device
        meshes = [self.mesh]
        while meshes[0].prev is not None:
            meshes.insert(0, meshes[0].prev)
        self.mg_spaces = []
        self.mg_ops = []
        for lvl, mesh_l in enumerate(meshes):
            # "gmg coarse grid use fe q iso q1" (``main.cc:396-568``):
            # coarsest-level operator on piecewise-Q1 shape functions over
            # the same node lattice
            iso = p.mg_use_fe_q_iso_q1 and lvl == 0 and mesh_l is not self.mesh
            space_l = (
                self.space if mesh_l is self.mesh
                else FESpace(mesh_l, p.fe_degree, mapping_degree, iso_q1=iso)
            )
            self.mg_spaces.append(space_l)
            cs = ConstraintSetBuilder(space_l, bcs, mg_dtype, dev)
            # level operators use all-homogeneous constraints
            # (``main.cc:509-529``: same set for all three slots)
            ca = cs.homogeneous
            if p.gmg_constraint_coarse_pressure_dof and lvl == 0:
                ca = self._pin_coarse_pressure(space_l, ca)
            op_l = NavierStokesOperator(
                space_l, ca, ca,
                nu=p.nu, c_1=p.c_1, c_2=p.c_2,
                time_integrator=self.time_integrator,
                consider_time_derivative=p.consider_time_derivative,
                increment_form=increment_form,
                cell_wise_stabilization=p.cell_wise_stabilization,
                outflow_bcs_cut=bcs.all_outflow_bcs_cut,
                outflow_bcs_nitsche=bcs.all_outflow_bcs_nitsche,
                dtype=mg_dtype,
                device=dev,
            )
            op_l.constraints_inhomogeneous = ca
            self.mg_ops.append(op_l)

        self.mg_transfers = [
            build_transfer(self.mg_spaces[l], self.mg_spaces[l + 1], mg_dtype,
                           dev)
            for l in range(len(meshes) - 1)
        ]
        transfer_ops = None
        if halo:
            from ns_gls_tpu_torch.parallel.halo import (
                HaloShardedOperator,
                HaloTransferOps,
            )

            self.mg_ops_apply = [HaloShardedOperator(op_l, self.devices)
                                 for op_l in self.mg_ops]
            transfer_ops = [
                HaloTransferOps(self.mg_transfers[l], self.mg_ops_apply[l],
                                self.mg_ops_apply[l + 1])
                for l in range(len(self.mg_ops) - 1)]
        elif self.devices is not None:
            from ns_gls_tpu_torch.parallel.sharding import ShardedOperator

            self.mg_ops_apply = [ShardedOperator(op_l, self.devices)
                                 for op_l in self.mg_ops]
        self.preconditioner = PreconditionerGMG(
            self.mg_ops,
            self.mg_transfers,
            level_ops_apply=self.mg_ops_apply or None,
            transfer_ops=transfer_ops,
            mg_dtype=mg_dtype,
            smoothing_n_iterations=p.gmg.smoothing_n_iterations,
            smoothing_range=p.gmg.smoothing_range,
            smoothing_eig_n_iterations=p.gmg.smoothing_eig_cg_n_iterations,
            coarse_grid_solver=p.gmg.coarse_grid_solver,
            coarse_grid_iterate=p.gmg.coarse_grid_iterate,
            coarse_grid_gmres_reltol=p.gmg.coarse_grid_gmres_reltol,
            coarse_amg_default_parameters=(
                p.gmg.coarse_grid_amg_default_parameters
            ),
            logger=self.log if p.gmg.output_details else None,
        )

    def _setup_gmg_ls(self, bcs, mapping_degree, increment_form, mg_dtype):
        """Local-smoothing multigrid (``main.cc:569-732``): the levels are
        the cells of each refinement level of the forest, smoothing is
        masked off the refinement edge, the coarse level is the whole
        initial mesh.  See ``precond/gmg_ls.py`` for the cycle."""
        from ns_gls_tpu_torch.mesh.forest import forest_levels
        from ns_gls_tpu_torch.precond.gmg_ls import PreconditionerGMGLS

        p = self.params
        dev = self.device
        levels = forest_levels(self.mesh)
        n_fin = self.space.n_nodes
        fin_cn = np.asarray(self.space.cell_nodes)
        self.mg_spaces = []
        self.mg_ops = []
        lvl2fin = []       # per level: (level nodes, final nodes)
        for lvl, L in enumerate(levels):
            space_l = FESpace(L.mesh, p.fe_degree, mapping_degree)
            self.mg_spaces.append(space_l)
            ca = ConstraintSetBuilder(space_l, bcs, mg_dtype, dev).homogeneous
            if p.gmg_constraint_coarse_pressure_dof and lvl == 0:
                ca = self._pin_coarse_pressure(space_l, ca)
            op_l = NavierStokesOperator(
                space_l, ca, ca,
                nu=p.nu, c_1=p.c_1, c_2=p.c_2,
                time_integrator=self.time_integrator,
                consider_time_derivative=p.consider_time_derivative,
                increment_form=increment_form,
                cell_wise_stabilization=p.cell_wise_stabilization,
                outflow_bcs_cut=bcs.all_outflow_bcs_cut,
                outflow_bcs_nitsche=bcs.all_outflow_bcs_nitsche,
                dtype=mg_dtype,
                device=dev,
            )
            op_l.constraints_inhomogeneous = ca
            self.mg_ops.append(op_l)

            act = np.nonzero(L.active >= 0)[0]
            ln = np.asarray(space_l.cell_nodes)[act].reshape(-1)
            fn = fin_cn[L.active[act]].reshape(-1)
            pairs = np.unique(np.stack([ln, fn], axis=1), axis=0)
            assert len(np.unique(pairs[:, 0])) == len(pairs), \
                "inconsistent level-to-global node identification"
            lvl2fin.append((pairs[:, 0], pairs[:, 1]))

        self.mg_transfers = [
            build_transfer(self.mg_spaces[l], self.mg_spaces[l + 1], mg_dtype,
                           dev)
            for l in range(len(levels) - 1)
        ]

        # coarsest active level of every final node (edge dofs belong to
        # the coarse side; the defect is injected there)
        node_min_level = np.full(n_fin, len(levels), np.int64)
        for lvl, (_, fn) in enumerate(lvl2fin):
            np.minimum.at(node_min_level, fn, lvl)

        # refinement-edge masks: faces of a level mesh with one cell that
        # are not on the domain boundary border coarser active cells (2:1
        # balance); their nodes are left out of the smoothing
        inj_maps, copy_maps, int_masks = [], [], []
        for lvl, L in enumerate(levels):
            space_l = self.mg_spaces[lvl]
            mask = np.ones((space_l.n_nodes, 1), np.float64)
            if lvl > 0:
                bf = L.mesh.compute_boundary_faces()
                iface = bf[L.mesh.boundary_ids[bf[:, 0], bf[:, 1]] < 0]
                cn = np.asarray(space_l.cell_nodes)
                for lf in np.unique(iface[:, 1]):
                    cells = iface[iface[:, 1] == lf, 0]
                    loc = space_l.face_node_lattice(int(lf))
                    mask[cn[cells][:, loc].reshape(-1)] = 0.0
            int_masks.append(mask)
            ln, fn = lvl2fin[lvl]
            res = node_min_level[fn] == lvl
            inj_maps.append((ln[res], fn[res]))
            copy_maps.append((ln, fn))

        self._ls_lvl2fin = [
            (torch.as_tensor(ln, device=dev), torch.as_tensor(fn, device=dev))
            for ln, fn in lvl2fin
        ]
        self.preconditioner = PreconditionerGMGLS(
            self.mg_ops,
            self.mg_transfers,
            inj_maps,
            copy_maps,
            int_masks,
            constrained_rows=self.csets.homogeneous.rows.cpu().numpy(),
            n_fine_nodes=n_fin,
            mg_dtype=mg_dtype,
            smoothing_n_iterations=p.gmg.smoothing_n_iterations,
            smoothing_range=p.gmg.smoothing_range,
            smoothing_eig_n_iterations=p.gmg.smoothing_eig_cg_n_iterations,
            coarse_grid_solver=p.gmg.coarse_grid_solver,
            logger=self.log if p.gmg.output_details else None,
        )

    def _pin_coarse_pressure(self, space_l, ca: ConstraintArrays):
        """Constrain one pressure dof on the level (``main.cc:453-477``),
        chosen positionally (see pressure_pin_candidates)."""
        dim = space_l.dim
        rows = set(ca.rows.tolist())
        cand = [int(n) * (dim + 1) + dim
                for n in pressure_pin_candidates(space_l)]
        if not cand:
            cand = [dim]             # node 0's pressure dof (fallback)
        if any(d in rows for d in cand):
            return ca                # already gauged at a canonical point
        b = AffineConstraints(space_l.n_nodes, dim + 1)
        b.add_line(cand[0])
        extra = b.close(ca.weights.dtype, ca.rows.device)
        pad = ca.cols.shape[1]
        return ConstraintArrays(
            rows=torch.cat([ca.rows, extra.rows]),
            cols=torch.cat([ca.cols, ca.cols.new_zeros((1, pad))]),
            weights=torch.cat([ca.weights, ca.weights.new_zeros((1, pad))]),
            inhom=torch.cat([ca.inhom, extra.inhom]),
        )

    # ------------------------------------------------------------------
    # nonlinear solver callbacks (``main.cc:805-869``)
    # ------------------------------------------------------------------
    def _level_chain(self, v):
        """Interpolation cascade fine -> all levels
        (``interpolate_to_mg``, ``main.cc:789-795``).  Under GMG-LS the
        level meshes cover only part of the final mesh: each level's
        active region takes the fine values and the rest the
        interpolation from the level above."""
        n_l = len(self.mg_ops)
        out = [None] * n_l
        v = v.to(self.params.mg_dtype)
        if self._ls_lvl2fin is None:
            out[-1] = v
            for l in range(n_l - 2, -1, -1):
                out[l] = interpolate_to_coarse(self.mg_transfers[l],
                                               out[l + 1])
            return out
        for l in range(n_l - 1, -1, -1):
            w = (interpolate_to_coarse(self.mg_transfers[l], out[l + 1])
                 if l < n_l - 1
                 else v.new_zeros((self.mg_spaces[l].n_nodes, v.shape[1])))
            ln, fn = self._ls_lvl2fin[l]
            w[ln] = v[fn]              # in place on the fresh tensor
            out[l] = w
        return out

    def _setup_jacobian(self, u):
        with timer("setup_jacobian"):
            self.op.set_linearization_point(u)

    def _setup_preconditioner(self, u):
        with timer("setup_preconditioner"):
            if self.mg_ops:
                for op_l, u_l in zip(self.mg_ops, self._level_chain(u)):
                    op_l.set_linearization_point(u_l)
            gran = self.params.preconditioner_update_granularity
            if gran == "newton":
                rebuild = True
            else:
                # "step" or "step:N": rebuild on the first Newton
                # iteration of every Nth time step
                every = int(gran.split(":")[1]) if ":" in gran else 1
                stale = getattr(self, "_precond_stale", True)
                count = getattr(self, "_precond_step_count", 0)
                if stale:
                    self._precond_step_count = count = count + 1
                    self._precond_stale = False
                rebuild = stale and (
                    count % every == 1 or every == 1 or count == 1
                )
            if rebuild:
                self.preconditioner.initialize()
            self.linear_solver.initialize()

    def _solve_with_jacobian(self, rhs):
        """Constraint zeroing, the linear solve (tolerance relative to the
        zeroed rhs) and the constraint distribution."""
        with timer("solve_with_jacobian"):
            ca = self.csets.homogeneous
            x = self.linear_solver.solve(cstr.set_zero(ca, rhs))
            self._step_linear_its += self.linear_solver.last_iterations
            return cstr.distribute(ca, x, homogeneous=True)

    def _set_previous_solution(self):
        """(``main.cc:772-803``)  The levels get the interpolation chain
        of the fine weighted history sum (interpolation is linear), plus a
        chain of the last solution for theta tables."""
        self.op.set_previous_solution(self.solution)
        if not self.mg_ops or self.time_integrator.order == 0:
            return
        w = self.time_integrator.weights
        vec_old = self.solution.weighted_old_sum(tuple(
            torch.tensor(x, dtype=self.op.dtype, device=self.device)
            for x in w
        ))
        vo = self._level_chain(vec_old)
        uo = (self._level_chain(self.solution.vectors[1])
              if self.mg_ops[0].theta != 1.0 else vo)
        for op_l, v_l, u_l in zip(self.mg_ops, vo, uo):
            op_l.set_previous_vectors(v_l, u_l)

    # ------------------------------------------------------------------
    def restart_from(self, vectors, dt_history, t: float, counter: int):
        """Continue from a saved state: the solution history (host arrays,
        newest first, in this space's node numbering), the integrator's
        step-size history (newest first), the time reached and the next
        cycle number.  Call after ``setup``."""
        self.solution = SolutionHistory.from_numpy(
            vectors, self.params.dtype, self.device
        )
        set_dt_history(self.time_integrator, dt_history)
        self._t0 = self.time_reached = float(t)
        self._counter0 = int(counter)
        self._restarted = True

    def run(self, max_steps: int = 10**9, resume: bool = False):
        """The time loop up to ``t final`` or cycle ``max_steps``; with
        ``resume``, first restore the last checkpoint of ``checkpoint
        prefix`` (its time and next cycle, and the output and checkpoint
        counters that follow from that time)."""
        p = self.params
        if not getattr(self, "_setup_done", False):
            self.setup()
            self._setup_done = True
        if resume:
            from ns_gls_tpu_torch.utils.checkpoint import load_checkpoint

            if not p.checkpoint_prefix:
                raise ValueError("resume requested but no 'checkpoint prefix'")
            t, counter = load_checkpoint(p.checkpoint_prefix, self)
            if p.output_granularity > 0:
                self._output_counter = int(t / p.output_granularity) + 1
            self._checkpoint_counter = (
                int(t / p.checkpoint_granularity) + 1
                if p.checkpoint_granularity > 0 else 0)
            self.log(f"    [C] resumed from t = {t:.6g} (cycle {counter})")
        t = self._t0
        counter = self._counter0
        min_dx = self.mesh.minimal_cell_diameter()
        records = []

        if not self._restarted:
            self._output(t)
            rec = self.sim.postprocess(t, self.solution.current)
            if rec:
                records.append(rec)

        while t < p.t_final and counter <= max_steps:
            t_step = _time.perf_counter()
            self._step_linear_its = 0
            with timer("loop"):
                u_max = self.op.get_max_u(self.solution.current)
                dt = (
                    p.dt
                    if p.dt != 0.0
                    else min_dx * p.cfl / max(u_max, self.sim.get_u_max())
                )
                self.log(
                    f"\ncycle\t{counter} at time t = {t:.6g} with delta_t ="
                    f" {dt:.6g} and u_max = {u_max:.6g}"
                )

                # time-dependent inhomogeneous DBCs at (old) time t
                self.op.constraints_inhomogeneous = (
                    self.csets.inhomogeneous_at(t)
                )
                self.time_integrator.update_dt(dt)
                self.op.invalidate_system()
                for op_l in self.mg_ops:
                    op_l.invalidate_system()
                    op_l.update_weight()
                self.op.update_weight()

                self.solution.commit()
                self._set_previous_solution()
                self._precond_stale = True  # per-step precond granularity

                new_u = self.nonlinear_solver.solve(self.solution.current)

                new_u = distribute(self.op.constraints_inhomogeneous, new_u)
                new_u = distribute(self.csets.full, new_u)
                self.solution.current = new_u

                norm = float(torch.linalg.vector_norm(new_u))
                self.log(f"    [S] l2-norm of solution: {norm:.8g}")

                t += dt
                self.time_reached = t
                self._output(t)
                rec = self.sim.postprocess(t, self.solution.current)
                if rec:
                    records.append(rec)
                counter += 1
                self._checkpoint(t, counter)
            self.step_stats.append(dict(
                newton=self.nonlinear_solver.last_iterations,
                newton_residual=self.nonlinear_solver.last_residual,
                gmres=self._step_linear_its,
                seconds=_time.perf_counter() - t_step,
            ))
            if self.time_integrator.order == 0:
                break

        return records

    # ------------------------------------------------------------------
    def _checkpoint(self, t, counter, force=False):
        """Honor 'checkpoint prefix' / 'checkpoint granularity': a rolling
        save of the solution history and the integrator's step sizes,
        restorable with ``run(resume=True)``."""
        p = self.params
        if not p.checkpoint_prefix:
            return
        if p.checkpoint_granularity > 0 and not force:
            if (t + 1e-15) < (self._checkpoint_counter
                              * p.checkpoint_granularity):
                return
        elif not force:
            return  # prefix set but granularity 0: checkpoint only on demand
        from ns_gls_tpu_torch.utils.checkpoint import save_checkpoint

        with timer("postprocess::checkpoint"):
            save_checkpoint(p.checkpoint_prefix, self, t=t, counter=counter)
        self.log(f"    [C] checkpoint saved (t = {t:.6g})")
        self._checkpoint_counter += 1

    # ------------------------------------------------------------------
    def _output(self, t, force=False):
        p = self.params
        if p.output_granularity <= 0 and not force:
            return
        if (not force) and (t + 1e-15) < self._output_counter * p.output_granularity:
            return
        from ns_gls_tpu_torch.utils.vtu import write_vtu

        fname = f"{p.paraview_prefix}.{self._output_counter}.vtu"
        with timer("postprocess::vtu"):
            write_vtu(fname, self.space, self.solution.current.cpu().numpy())
        self.log(f"    [O] output VTU ({fname})")
        self._output_counter += 1
