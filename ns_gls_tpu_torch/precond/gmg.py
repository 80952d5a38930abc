"""Geometric multigrid preconditioner (global-coarsening flavor).

Port of the reference ``PreconditionerGMG`` (``multigrid.{h,cc}``, driver
setup ``main.cc:396-568``):

- V-cycle over the uniform-refinement hierarchy, level operators in reduced
  precision (MGNumber=float, ``config.h:7``; f32 by default),
- point-Jacobi relaxation smoother, `n_iterations` sweeps, damping from a
  power-iteration eigenvalue estimate with `smoothing_range`
  (deal.II ``PreconditionRelaxation``; ``multigrid.cc:281-305,353-370``),
- coarse solver: dense LU in f64 ("direct" on coarse levels of at most
  8000 DoFs, replaces Trilinos SolverDirect), aggregation AMG
  (``precond/amg.py``; "AMG", or "direct" on larger coarse levels, the
  reference's coarse AMG ``multigrid.cc:372-433``), SuperLU's ILU on the
  host ("ILU", ``precond/ilu.py``; the reference's Trilinos ILU coarse
  solver ``multigrid.cc:435-460``) or "identity",
  optionally iterated by GMRES on the coarse level operator
  (``multigrid.cc:490-532``; the scope ``coarse_gmres``, its iterations
  counted as ``coarse_gmres_it``); the float<->double shim of
  ``multigrid.cc:113-136`` becomes dtype casts around the coarse solve.

The V-cycle runs on flat (n_l*C,) vectors between the operator and
transfer calls, as the JAX reference does.  Under sharding the hot
applies (smoother vmults, power iterations) go to per-level sharded
wrappers (``level_ops_apply``); with halo transfers (``transfer_ops``,
``parallel/halo.py`` ``HaloTransferOps``) the whole cycle runs on
distributed vectors (``parallel/dist.py``) and only the coarse solve
gathers to the global layout (``ns_gls_tpu/precond/gmg.py:58-125``).

On the card the unsharded cycle replays CUDA graphs: the shapes and,
between two rebuilds, the tensors it reads stay fixed, so its long chain
of small launches is captured once (at the first V-cycle after each
``initialize``, or after anything the capture baked in changed) and
every later V-cycle is one launch.  Where the coarse solve is one
application that never reads the device (dense LU, an AMG cycle,
identity) the whole cycle is one graph (span ``vcycle::graph``);
where it iterates or runs on the host (GMRES, SuperLU) a graph goes down
to the coarse level and one comes back up around it (``vcycle::down``,
``vcycle::up``).  A capture counts nothing; each replay adds the counters
its capture would have counted, so ``level_apply``, ``amg_cycle`` and
``launch.*`` read as in the eager cycle (``vcycle_graph_capture``,
``vcycle_graph_replay`` count the captures and the V-cycles replayed).
"""

from __future__ import annotations

import numpy as np
import torch

from ns_gls_tpu_torch.fem import transfer as tr
from ns_gls_tpu_torch.parallel.dist import DistVector
from ns_gls_tpu_torch.utils.timer import (
    count,
    counters,
    counters_since,
    host_sync,
    timer,
)


def capture_graph(fn, device, pool=None):
    """``fn()``'s work captured as a CUDA graph on a side stream of
    ``device``, its allocations in the graph memory pool ``pool`` (a new
    one if None): (the graph, ``fn()``'s result, whose tensors each replay
    writes anew).  Nothing runs until the first replay; a failed capture
    raises."""
    with torch.cuda.device(device):
        stream = _CAPTURE_STREAMS.get(torch.cuda.current_device())
        if stream is None:
            stream = _CAPTURE_STREAMS[torch.cuda.current_device()] = (
                torch.cuda.Stream())
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                out = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        # cuBLAS keeps a workspace for each stream it runs on (32 MiB on
        # the H100): the capture stream's was taken from this graph's
        # pool, which keeps it for the replays, so cuBLAS lets go of it
        # and it stays allocated nowhere else
        torch._C._cuda_clearCublasWorkspaces()
    return graph, out


# device index -> the one stream captures run on there
_CAPTURE_STREAMS: dict = {}


class _CycleGraphs:
    """A captured V-cycle: its graphs (the whole cycle, or the legs down
    and up), the tensors they read and write, what the capture baked in
    (``key``) and, per graph, the counters one replay stands for."""

    __slots__ = ("key", "pool", "graphs", "deltas", "src", "saved",
                 "coarse_rhs", "coarse_x", "out")

    def __init__(self, key, src, pool):
        self.key = key
        self.src = src
        self.pool = pool
        self.graphs, self.deltas = [], []
        self.saved = self.coarse_rhs = self.coarse_x = self.out = None

    def matches(self, key) -> bool:
        tensors, numbers = key
        return (len(tensors) == len(self.key[0])
                and all(a is b for a, b in zip(tensors, self.key[0]))
                and numbers == self.key[1])

    def capture(self, fn):
        """Capture ``fn()`` into the next graph, in the cycle's pool, and
        take back the counters the capture counted: each replay counts
        them again."""
        before = counters()
        g, out = capture_graph(fn, self.src.device, self.pool)
        delta = {k: v for k, v in counters_since(before).items() if v}
        if delta.get("host_sync"):
            raise RuntimeError("a host sync inside the captured V-cycle")
        for k, v in delta.items():
            count(k, -v)
        if self.pool is None:
            self.pool = g.pool()
        self.graphs.append(g)
        self.deltas.append(delta)
        return out

    def replay(self, i: int):
        self.graphs[i].replay()
        for k, v in self.deltas[i].items():
            count(k, v)


def power_start_vector(level: int, shape, dtype, device) -> torch.Tensor:
    """Start vector of the power iteration on ``level``: normal samples
    from ``numpy.random.default_rng(31 + level)``."""
    rng = np.random.default_rng(31 + level)
    return host_sync(torch.as_tensor, rng.standard_normal(shape),
                     dtype=dtype, device=device)


class PreconditionerGMG:
    def __init__(
        self,
        level_ops: list,          # NavierStokesOperator per level, coarse->fine
        transfers: list,          # TwoLevelTransfer per gap
        mg_dtype=torch.float32,
        smoothing_n_iterations: int = 5,
        smoothing_range: float = 20.0,
        smoothing_eig_n_iterations: int = 20,
        coarse_grid_solver: str = "direct",
        coarse_grid_iterate: bool = False,
        coarse_grid_gmres_reltol: float = 1e-4,
        coarse_amg_default_parameters: bool = True,
        logger=None,
        level_ops_apply: list | None = None,
        transfer_ops: list | None = None,
    ):
        if coarse_grid_solver not in ("direct", "AMG", "ILU", "identity"):
            raise ValueError(
                f"unknown GMG coarse grid solver '{coarse_grid_solver}'")
        self.level_ops = level_ops
        # the level applies of the cycle: the operators themselves, or
        # their sharded wrappers (assembly, diagonals and the coarse
        # solve keep the plain operators)
        self.level_ops_apply = (list(level_ops) if level_ops_apply is None
                                else list(level_ops_apply))
        self.transfers = tuple(transfers)
        self.transfer_ops = transfer_ops
        self.distributed = transfer_ops is not None
        self.mg_dtype = mg_dtype
        self.n_smooth = smoothing_n_iterations
        self.smoothing_range = smoothing_range
        self.eig_n_iterations = smoothing_eig_n_iterations
        self.coarse_grid_solver = coarse_grid_solver
        self.coarse_grid_iterate = coarse_grid_iterate
        self.coarse_grid_gmres_reltol = coarse_grid_gmres_reltol
        self.coarse_amg_default_parameters = coarse_amg_default_parameters
        self.logger = logger
        self.n_levels = len(level_ops)
        # level 0's smoother state is used only when the coarse solve
        # applies the level-0 operator (iterated) or there is one level
        self._needs_level0_args = bool(
            coarse_grid_iterate and coarse_grid_solver != "identity"
        ) or self.n_levels == 1
        # start vectors of the power iteration: (level, shape, dtype,
        # device) -> tensor; replaceable, so that a comparison can feed
        # the same start vectors to another implementation
        self.power_start = power_start_vector
        self.inv_diags = None
        self.omegas = None
        self.coarse_lu = None
        self.coarse_amg = None
        self.coarse_ilu = None
        # the cycle as CUDA graphs (unsharded, on the card): the captured
        # cycle, and the graph whose memory pool the next capture reuses
        self._sharded = level_ops_apply is not None
        self._captured = None
        self._pool_owner = None
        # the first cycle runs eager: it builds what the applies and
        # transfers cache (their class-sum tables read the device)
        self._warm = False
        # the coarse solve's GMRES iterations and AMG cycles, and the
        # cycle's captures and replays, at zero in every step record
        # whether or not the cycle runs them
        for name in ("coarse_gmres_it", "amg_cycle", "vcycle_graph_capture",
                     "vcycle_graph_replay"):
            count(name, 0)

    # ------------------------------------------------------------------
    def _estimate_omega(self, level: int, inv_diag):
        """Power iteration for lambda_max(D^{-1} A); relaxation =
        2 / (lambda_max * (1 + 1/smoothing_range)) — deal.II
        PreconditionRelaxation semantics (``multigrid.cc:281-305``).
        Returns the factor as a 0-dim tensor (no host sync).  On the
        distributed cycle the start vector is drawn in the JAX package's
        (n_dev, n_own_max, C) layout, pads included, and split by shard."""
        op = self.level_ops_apply[level]
        if self.distributed:
            v0 = self.power_start(level, (op.n_dev, op.n_own_max, op.n_comp),
                                  inv_diag.dtype, inv_diag.device)
            v = DistVector(x.to(p.device) for x, p in zip(v0,
                                                          inv_diag.parts))
            vmult, norm = op.vmult_dist, DistVector.norm
        else:
            v = self.power_start(level, tuple(inv_diag.shape),
                                 inv_diag.dtype, inv_diag.device)
            vmult, norm = op.vmult, torch.linalg.vector_norm
        v = v / norm(v)
        lam = torch.ones((), dtype=v.dtype, device=v.device)
        for _ in range(self.eig_n_iterations):
            w = inv_diag * vmult(v)
            lam = norm(w)
            v = w / lam
        lam_max = 1.2 * lam  # deal.II-style safety factor on the estimate
        lam_min = lam_max / self.smoothing_range
        return 2.0 / (lam_min + lam_max)

    def initialize(self):
        """Recompute the smoother state (inverse diagonals, relaxation
        factors) and the coarse factorization (per Newton step,
        ``setup_preconditioner``, ``main.cc:815-839``)."""
        from ns_gls_tpu_torch.ops.assembly import (
            assemble_dense,
            compute_inverse_diagonal,
        )

        count("rebuild")
        # a new smoother state and coarse solver: the next cycle captures
        self._captured = None
        inv_diags, omegas = [], []
        for lvl in range(self.n_levels):
            if lvl == 0 and not self._needs_level0_args:
                inv_diags.append(None)
                omegas.append(None)
                continue
            with timer("mg_init::diagonal"):
                dinv = compute_inverse_diagonal(self.level_ops[lvl])
                if self.distributed:
                    dinv = self.level_ops_apply[lvl].to_dist(dinv)
            inv_diags.append(dinv)
            with timer("mg_init::power_iteration"):
                omegas.append(self._estimate_omega(lvl, dinv))
        self.inv_diags = inv_diags
        self.omegas = omegas

        self.coarse_lu = None
        op0 = self.level_ops[0]
        n_coarse = op0.n_nodes * op0.n_comp
        if self.coarse_grid_solver == "ILU":
            # SuperLU's ILU of the assembled coarse matrix, on the host
            from ns_gls_tpu_torch.precond.ilu import PreconditionerILU

            if self.coarse_ilu is None:
                self.coarse_ilu = PreconditionerILU(op0)
            with timer("mg_init::coarse_ilu"):
                self.coarse_ilu.initialize()
        elif self.coarse_grid_solver == "direct" and n_coarse <= 8000:
            with timer("mg_init::coarse_lu"):
                A = assemble_dense(op0)
                # its check of the factorization reads the device
                self.coarse_lu = host_sync(torch.linalg.lu_factor,
                                           A.to(torch.float64))
        elif self.coarse_grid_solver in ("direct", "AMG"):
            # large coarse levels / AMG requests: aggregation AMG on the
            # assembled coarse matrix with a matrix-free level 0; "use
            # default parameters" false = the reference's tuned ML set
            # (``multigrid.cc:398-433``) -> stronger aggregation
            from ns_gls_tpu_torch.precond.amg import PreconditionerAMG

            if self.coarse_amg is None:
                kw = ({} if self.coarse_amg_default_parameters
                      else {"theta": 0.02, "n_smooth": 3,
                            "max_coarse": 1000})
                self.coarse_amg = PreconditionerAMG(op0, **kw)
            with timer("mg_init::coarse_amg"):
                self.coarse_amg.initialize()

        if self.logger:
            for lvl, om in enumerate(omegas):
                if om is not None:
                    self.logger(
                        f"    [M]  - level: {lvl}, omega: "
                        f"{host_sync(float, om):.4f}"
                    )

    # ------------------------------------------------------------------
    def _coarse_apply(self, r):
        """One application of the coarse preconditioner (dense LU, an AMG
        V-cycle or the host ILU solve)."""
        if self.coarse_grid_solver == "identity":
            return r
        if self.coarse_ilu is not None:
            return self.coarse_ilu.vmult(r)
        if self.coarse_lu is None:
            return self.coarse_amg.vmult(r)
        lu, piv = self.coarse_lu
        x = torch.linalg.lu_solve(lu, piv, r.reshape(-1, 1).to(lu.dtype))
        return x.reshape(r.shape).to(r.dtype)

    def _coarse_solve(self, r):
        op0 = self.level_ops_apply[0]
        if self.distributed:
            # only the coarse solve gathers to the global layout
            def capply(x):
                return op0.to_dist(self._coarse_apply(op0.to_global(x)))
        else:
            capply = self._coarse_apply
        if not self.coarse_grid_iterate or self.coarse_grid_solver == "identity":
            return capply(r)
        # iterative coarse solve: GMRES on the coarse level operator
        # preconditioned by the LU (``multigrid.cc:490-532``)
        from ns_gls_tpu_torch.solvers.linear import gmres

        if self.distributed:
            A0, zero, norm = op0.vmult_dist, r.zeros_like(), r.norm()
        else:
            A0, zero = op0.vmult, torch.zeros_like(r)
            norm = torch.linalg.vector_norm(r)
        with timer("coarse_gmres"):
            res = gmres(A0, r, zero, M=capply,
                        tol=self.coarse_grid_gmres_reltol * norm,
                        restart=30, max_restarts=10)
        count("coarse_gmres_it", res.iterations)
        return res.x

    def _smooth(self, level: int, x, b):
        """Damped Jacobi sweeps on flat level vectors (distributed ones on
        the distributed cycle)."""
        op = self.level_ops_apply[level]
        om = self.omegas[level]
        if self.distributed:
            inv_d = self.inv_diags[level]
            for _ in range(self.n_smooth):
                x = x + om * inv_d * (b - op.vmult_dist(x))
            return x
        shp = (op.n_nodes, op.n_comp)
        inv_df = self.inv_diags[level].reshape(-1)
        for _ in range(self.n_smooth):
            Av = op.vmult(x.reshape(shp)).reshape(-1)
            x = x + om * inv_df * (b - Av)
        return x

    # The stages of the cycle run in flat scopes (``vcycle::smooth``, ...;
    # none holds the recursive call), so their labels are the same on
    # every level.
    def _vcycle_dist(self, level: int, b):
        """The V-cycle on distributed vectors."""
        if level == 0:
            with timer("coarse"):
                return self._coarse_solve(b)
        op = self.level_ops_apply[level]
        t = self.transfer_ops[level - 1]
        with timer("smooth"):
            x = self._smooth(level, b.zeros_like(), b)
        with timer("residual"):
            d = b - op.vmult_dist(x)
        with timer("restrict"):
            d_c = t.restrict(d)
        x_c = self._vcycle_dist(level - 1, d_c)
        with timer("prolongate"):
            x = x + t.prolongate(x_c)
        with timer("smooth"):
            return self._smooth(level, x, b)

    def _down(self, level: int, b):
        """Pre-smoothing from zero, the residual and its restriction on
        ``level``: (x, the coarser level's right-hand side), flat."""
        op = self.level_ops_apply[level]
        shp = (op.n_nodes, op.n_comp)
        with timer("smooth"):
            x = self._smooth(level, torch.zeros_like(b), b)
        with timer("residual"):
            d = b - op.vmult(x.reshape(shp)).reshape(-1)
        with timer("restrict"):
            d_c = tr.restrict(self.transfers[level - 1], d.reshape(shp))
        return x, d_c.reshape(-1)

    def _up(self, level: int, x, b, x_c):
        """The coarser level's correction ``x_c`` prolongated onto x, then
        post-smoothing on ``level``."""
        op_c = self.level_ops[level - 1]
        with timer("prolongate"):
            x = x + tr.prolongate(
                self.transfers[level - 1],
                x_c.reshape(op_c.n_nodes, op_c.n_comp),
            ).reshape(-1)
        with timer("smooth"):
            return self._smooth(level, x, b)

    def _vcycle(self, level: int, b):
        if level == 0:
            op = self.level_ops_apply[0]
            with timer("coarse"):
                return self._coarse_solve(
                    b.reshape(op.n_nodes, op.n_comp)).reshape(-1)
        x, d_c = self._down(level, b)
        return self._up(level, x, b, self._vcycle(level - 1, d_c))

    def _cycle_on(self, src):
        """The eager cycle on a fine vector, back in its dtype and shape."""
        x = self._vcycle(self.n_levels - 1, src.to(self.mg_dtype).reshape(-1))
        return x.reshape(src.shape).to(src.dtype)

    def _leg_down(self, src):
        """The cycle from the finest level down to the coarse level's
        right-hand side: (that, each smoothed level's (x, b), finest
        first)."""
        b = src.to(self.mg_dtype).reshape(-1)
        saved = []
        for level in range(self.n_levels - 1, 0, -1):
            x, d_c = self._down(level, b)
            saved.append((x, b))
            b = d_c
        return b, saved

    def _leg_up(self, x_c, saved, like):
        """The cycle from the coarse solution ``x_c`` back up, in the
        dtype and shape of ``like``."""
        for level, (x, b) in zip(range(1, self.n_levels), reversed(saved)):
            x_c = self._up(level, x, b, x_c)
        return x_c.reshape(like.shape).to(like.dtype)

    # ------------------------------------------------------------------
    # the cycle as CUDA graphs
    # ------------------------------------------------------------------
    def _graph_form(self, src):
        """How the cycle on ``src`` is replayed: "whole" (one graph: the
        coarse solve is one application that never reads the device),
        "legs" (a graph down and one up around an eager coarse solve,
        which iterates or runs on the host) or None (eager: on the CPU,
        on sharded or distributed levels, or an iterated coarse solve
        with no level around it)."""
        if not src.is_cuda or self.distributed or self._sharded:
            return None
        if self.coarse_grid_solver == "ILU" or (
                self.coarse_grid_iterate
                and self.coarse_grid_solver != "identity"):
            return "legs" if self.n_levels > 1 else None
        return "whole"

    def _graph_key(self, src):
        """What a capture bakes in: the tensors it reads by address,
        compared by identity (each level operator's state, which a new
        linearization point, history or time-step weight replaces; the
        smoother's diagonals and factors), and what it passes the fused
        kernels by value or sizes its buffers by, compared by value (each
        operator's weight, 1/dt, nu, c1, c2; the source's shape and
        dtype)."""
        ops = self.level_ops
        tensors = (*(op.state for op in ops), *self.inv_diags, *self.omegas)
        numbers = (tuple(src.shape), src.dtype, *(
            (op._weight_host, op._stau_host, op.nu, op.c_1, op.c_2)
            for op in ops))
        return tensors, numbers

    def _capture(self, src, form):
        """Capture the cycle in ``form``.  The graph captured before keeps
        its memory pool alive for the new one, which then owns it: one
        pool across rebuilds."""
        pool = None if self._pool_owner is None else self._pool_owner.pool()
        cyc = _CycleGraphs(self._graph_key(src), torch.empty_like(src), pool)
        # the face matrices follow the linearization point: taken here,
        # eagerly, not inside the capture
        for op in self.level_ops:
            if op.needs_face_integrals:
                op._face_matrices()
        count("vcycle_graph_capture")
        if form == "whole":
            cyc.out = cyc.capture(lambda: self._cycle_on(cyc.src))
        else:
            cyc.coarse_rhs, cyc.saved = cyc.capture(
                lambda: self._leg_down(cyc.src))
            cyc.coarse_x = torch.empty_like(cyc.coarse_rhs)
            cyc.out = cyc.capture(lambda: self._leg_up(
                cyc.coarse_x, cyc.saved, cyc.src))
        self._captured = cyc
        self._pool_owner = cyc.graphs[0]
        return cyc

    def _replay(self, src, form):
        """The cycle on ``src`` from its graphs, captured first where the
        last capture baked in something that has changed since."""
        cyc = self._captured
        if cyc is None or not cyc.matches(self._graph_key(src)):
            self._captured = None
            cyc = self._capture(src, form)
        cyc.src.copy_(src)
        count("vcycle_graph_replay")
        if form == "whole":
            with timer("graph"):
                cyc.replay(0)
        else:
            with timer("down"):
                cyc.replay(0)
            cyc.coarse_x.copy_(self._vcycle(0, cyc.coarse_rhs))
            with timer("up"):
                cyc.replay(1)
        # the next replay writes over the graph's output
        return cyc.out.clone()

    def vmult(self, src):
        if self.inv_diags is None:
            self.initialize()
        count("vcycle")
        with timer("vcycle"):
            if self.distributed:
                x = self._vcycle_dist(self.n_levels - 1,
                                      src.to(self.mg_dtype))
                return x.to(src.dtype)
            form = self._graph_form(src)
            if form is None or not self._warm:
                self._warm = form is not None
                return self._cycle_on(src)
            return self._replay(src, form)
