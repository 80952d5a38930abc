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

The V-cycle is written once (``ns_gls_tpu/precond/gmg.py``
``vcycle_level``): a leg down (pre-smoothing, residual, restriction,
level by level), the coarse step and a leg up (prolongation,
post-smoothing).  Its vectors live in one of two layouts, chosen at
construction: node-major (n_l, C) tensors, the levels applied by their
operators or, under sharding, by per-level sharded wrappers
(``level_ops_apply``); or, with halo transfers (``transfer_ops``,
``parallel/halo.py`` ``HaloTransferOps``), distributed vectors
(``parallel/dist.py``), where only the coarse solve gathers to the
global layout (``ns_gls_tpu/precond/gmg.py:58-125``).

On the card the unsharded cycle replays CUDA graphs: the shapes and,
between two rebuilds, the tensors it reads stay fixed, so its long chain
of small launches is captured once (at the first V-cycle after each
``initialize``, or after anything the capture baked in changed: what
each level operator's ``capture_key`` names, the smoother's state) and
every later V-cycle is one launch.  Where the coarse solve is one
application that never reads the device (dense LU, an AMG cycle,
identity) the whole cycle is one graph (span ``vcycle::graph``);
where it iterates or runs on the host (GMRES, SuperLU) the leg down is
one graph and the leg up another around the eager coarse step
(``vcycle::down``, ``vcycle::up``).  A capture counts nothing; each
replay adds the counters its capture would have counted, so
``level_apply``, ``amg_cycle`` and ``launch.*`` read as in the eager
cycle (``vcycle_graph_capture``, ``vcycle_graph_replay`` count the
captures and the V-cycles replayed).
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


def power_start_vector(level: int, shape, dtype, device,
                       seed: int = 31) -> torch.Tensor:
    """Start vector of the power iteration on ``level``: normal samples
    from ``numpy.random.default_rng(seed + level)``."""
    rng = np.random.default_rng(seed + level)
    return host_sync(torch.as_tensor, rng.standard_normal(shape),
                     dtype=dtype, device=device)


def graph_form(device, sharded: bool, coarse_grid_solver: str,
               coarse_grid_iterate: bool, n_levels: int):
    """How the cycle replays: "whole" (one graph: the coarse solve is one
    application that never reads the device), "legs" (a graph down and
    one up around an eager coarse step, which iterates or runs on the
    host) or None (eager: off the card, on sharded or distributed
    levels, or an iterated coarse solve with no level around it)."""
    if device.type != "cuda" or sharded:
        return None
    if coarse_grid_solver == "ILU" or (
            coarse_grid_iterate and coarse_grid_solver != "identity"):
        return "legs" if n_levels > 1 else None
    return "whole"


class _NodeMajor:
    """The cycle's vectors as node-major (n_l, C) tensors: each level
    applied by ``vmult`` (its operator's, or a replicated wrapper's), the
    transfers of ``fem/transfer.py``."""

    zeros = staticmethod(torch.zeros_like)
    norm = staticmethod(torch.linalg.vector_norm)

    def __init__(self, ops, transfers):
        self.ops, self.transfers = ops, transfers
        self.n_comp = ops[0].n_comp

    def apply(self, level: int):
        return self.ops[level].vmult

    def into(self, src, dtype):
        return src.to(dtype).reshape(-1, self.n_comp)

    @staticmethod
    def back(x, like):
        return x.reshape(like.shape).to(like.dtype)

    def restrict(self, level: int, d):
        return tr.restrict(self.transfers[level - 1], d)

    def prolongate(self, level: int, x_c):
        return tr.prolongate(self.transfers[level - 1], x_c)

    @staticmethod
    def from_global(level: int, u):
        return u

    @staticmethod
    def on_coarse(fn):
        return fn

    @staticmethod
    def start_vector(start, level: int, like):
        return start(level, tuple(like.shape), like.dtype, like.device)


class _Distributed:
    """The cycle's vectors distributed over the shards of the levels'
    halo-sharded operators: each level applied by ``vmult_dist``, the
    transfers ``HaloTransferOps``; the coarse solve gathers to the global
    layout and scatters back."""

    zeros = staticmethod(DistVector.zeros_like)
    norm = staticmethod(DistVector.norm)

    def __init__(self, ops, transfers):
        self.ops, self.transfers = ops, transfers

    def apply(self, level: int):
        return self.ops[level].vmult_dist

    @staticmethod
    def into(src, dtype):
        return src.to(dtype)

    @staticmethod
    def back(x, like):
        return x.to(like.dtype)

    def restrict(self, level: int, d):
        return self.transfers[level - 1].restrict(d)

    def prolongate(self, level: int, x_c):
        return self.transfers[level - 1].prolongate(x_c)

    def from_global(self, level: int, u):
        return self.ops[level].to_dist(u)

    def on_coarse(self, fn):
        op0 = self.ops[0]
        return lambda x: op0.to_dist(fn(op0.to_global(x)))

    def start_vector(self, start, level: int, like):
        """Drawn in the JAX package's (n_dev, n_own_max, C) layout, pads
        included, and split by shard."""
        op = self.ops[level]
        v0 = start(level, (op.n_dev, op.n_own_max, op.n_comp), like.dtype,
                   like.device)
        return DistVector(x.to(p.device) for x, p in zip(v0, like.parts))


class PreconditionerGMG:
    # the scope of initialize's stages (``mg_init::diagonal``, ...)
    init_scope = "mg_init"
    # the power iteration's start vectors: ``power_start_vector``'s seed
    power_seed = 31

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
        self._layout = (
            _Distributed(self.level_ops_apply, transfer_ops)
            if self.distributed
            else _NodeMajor(self.level_ops_apply, self.transfers))
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
        self.inv_diags = None
        self.omegas = None
        self.coarse_lu = None
        self.coarse_amg = None
        self.coarse_ilu = None
        # the cycle as CUDA graphs: its form, the captured cycle, and the
        # graph whose memory pool the next capture reuses
        self._form = graph_form(level_ops[0].device,
                                level_ops_apply is not None,
                                coarse_grid_solver, coarse_grid_iterate,
                                self.n_levels)
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

    def power_start(self, level: int, shape, dtype, device) -> torch.Tensor:
        """Start vector of the power iteration on ``level``.  An instance
        attribute of the same name replaces it, so that a comparison can
        feed the same start vectors to another implementation."""
        return power_start_vector(level, shape, dtype, device,
                                  self.power_seed)

    # ------------------------------------------------------------------
    def _estimate_omega(self, level: int, inv_diag):
        """Power iteration for lambda_max(D^{-1} A); relaxation =
        2 / (lambda_max * (1 + 1/smoothing_range)) — deal.II
        PreconditionRelaxation semantics (``multigrid.cc:281-305``).
        Returns the factor as a 0-dim tensor (no host sync)."""
        lay = self._layout
        vmult = lay.apply(level)
        v = lay.start_vector(self.power_start, level, inv_diag)
        v = v / lay.norm(v)
        lam = torch.ones((), dtype=v.dtype, device=v.device)
        for _ in range(self.eig_n_iterations):
            w = inv_diag * vmult(v)
            lam = lay.norm(w)
            v = w / lam
        lam_max = 1.2 * lam  # deal.II-style safety factor on the estimate
        lam_min = lam_max / self.smoothing_range
        return 2.0 / (lam_min + lam_max)

    def initialize(self):
        """Recompute the smoother state (inverse diagonals, relaxation
        factors) and the coarse solver (per Newton step,
        ``setup_preconditioner``, ``main.cc:815-839``)."""
        from ns_gls_tpu_torch.ops.assembly import compute_inverse_diagonal

        count("rebuild")
        # a new smoother state and coarse solver: the next cycle captures
        self._captured = None
        scope = self.init_scope
        inv_diags, omegas = [], []
        for lvl in range(self.n_levels):
            if lvl == 0 and not self._needs_level0_args:
                inv_diags.append(None)
                omegas.append(None)
                continue
            with timer(scope + "::diagonal"):
                dinv = self._layout.from_global(
                    lvl, compute_inverse_diagonal(self.level_ops[lvl]))
            inv_diags.append(dinv)
            with timer(scope + "::power_iteration"):
                omegas.append(self._estimate_omega(lvl, dinv))
        self.inv_diags = inv_diags
        self.omegas = omegas
        self.coarse_lu = None
        self._coarse_setup()

        if self.logger:
            for lvl, om in enumerate(omegas):
                if om is not None:
                    self.logger(
                        f"    [M]  - level: {lvl}, omega: "
                        f"{host_sync(float, om):.4f}"
                    )

    def _coarse_setup(self):
        """The coarse solver: SuperLU's ILU on the host ("ILU"), a dense LU
        in f64 ("direct" on at most 8000 DoFs), else aggregation AMG on
        the assembled coarse matrix with a matrix-free level 0."""
        op0 = self.level_ops[0]
        if self.coarse_grid_solver == "ILU":
            from ns_gls_tpu_torch.precond.ilu import PreconditionerILU

            if self.coarse_ilu is None:
                self.coarse_ilu = PreconditionerILU(op0)
            with timer(self.init_scope + "::coarse_ilu"):
                self.coarse_ilu.initialize()
        elif (self.coarse_grid_solver == "direct"
              and op0.n_nodes * op0.n_comp <= 8000):
            self._factor_coarse()
        elif self.coarse_grid_solver in ("direct", "AMG"):
            # large coarse levels / AMG requests; "use default parameters"
            # false = the reference's tuned ML set
            # (``multigrid.cc:398-433``) -> stronger aggregation
            from ns_gls_tpu_torch.precond.amg import PreconditionerAMG

            if self.coarse_amg is None:
                kw = ({} if self.coarse_amg_default_parameters
                      else {"theta": 0.02, "n_smooth": 3,
                            "max_coarse": 1000})
                self.coarse_amg = PreconditionerAMG(op0, **kw)
            with timer(self.init_scope + "::coarse_amg"):
                self.coarse_amg.initialize()

    def _factor_coarse(self):
        """The dense LU of the assembled coarse matrix, in f64."""
        from ns_gls_tpu_torch.ops.assembly import assemble_dense

        with timer(self.init_scope + "::coarse_lu"):
            A = assemble_dense(self.level_ops[0])
            # its check of the factorization reads the device
            self.coarse_lu = host_sync(torch.linalg.lu_factor,
                                       A.to(torch.float64))

    # ------------------------------------------------------------------
    def _coarse_apply(self, r):
        """One application of the coarse preconditioner (dense LU, an AMG
        V-cycle or the host ILU solve) to a global (n_0, C) vector."""
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
        """The coarse level's correction for ``r``, in the cycle's
        layout."""
        lay = self._layout
        capply = lay.on_coarse(self._coarse_apply)
        if not self.coarse_grid_iterate or self.coarse_grid_solver == "identity":
            return capply(r)
        # iterative coarse solve: GMRES on the coarse level operator
        # preconditioned by the LU (``multigrid.cc:490-532``)
        from ns_gls_tpu_torch.solvers.linear import gmres

        with timer("coarse_gmres"):
            res = gmres(lay.apply(0), r, lay.zeros(r), M=capply,
                        tol=self.coarse_grid_gmres_reltol * lay.norm(r),
                        restart=30, max_restarts=10)
        count("coarse_gmres_it", res.iterations)
        return res.x

    def _smooth(self, level: int, x, b):
        """Damped Jacobi sweeps."""
        vmult = self._layout.apply(level)
        inv_d = self.inv_diags[level]
        om = self.omegas[level]
        for _ in range(self.n_smooth):
            x = x + om * inv_d * (b - vmult(x))
        return x

    # The stages of the cycle run in flat scopes (``vcycle::smooth``, ...),
    # so their labels are the same on every level.
    def _leg_down(self, src):
        """The cycle from a fine vector down to the coarse level's
        right-hand side: (that, each smoothed level's (x, b), finest
        first)."""
        lay = self._layout
        b = lay.into(src, self.mg_dtype)
        saved = []
        for level in range(self.n_levels - 1, 0, -1):
            with timer("smooth"):
                x = self._smooth(level, lay.zeros(b), b)
            with timer("residual"):
                d = b - lay.apply(level)(x)
            with timer("restrict"):
                d_c = lay.restrict(level, d)
            saved.append((x, b))
            b = d_c
        return b, saved

    def _coarse(self, b):
        with timer("coarse"):
            return self._coarse_solve(b)

    def _leg_up(self, x_c, saved, like):
        """The cycle from the coarse correction ``x_c`` back up, in the
        dtype and shape of ``like``."""
        lay = self._layout
        for level, (x, b) in zip(range(1, self.n_levels), reversed(saved)):
            with timer("prolongate"):
                x = x + lay.prolongate(level, x_c)
            with timer("smooth"):
                x_c = self._smooth(level, x, b)
        return lay.back(x_c, like)

    def _eager_cycle(self, src):
        """The eager cycle on a fine vector, back in its dtype and shape."""
        b, saved = self._leg_down(src)
        return self._leg_up(self._coarse(b), saved, src)

    # ------------------------------------------------------------------
    # the cycle as CUDA graphs
    # ------------------------------------------------------------------
    def _graph_key(self, src):
        """What a capture bakes in: each level operator's
        ``capture_key``, the smoother's diagonals and factors (tensors
        read by address, compared by identity) and the source's shape and
        dtype, which size the graph's buffers (compared by value)."""
        keys = [op.capture_key() for op in self.level_ops]
        tensors = (*(t for k in keys for t in k[0]), *self.inv_diags,
                   *self.omegas)
        numbers = (tuple(src.shape), src.dtype, *(k[1] for k in keys))
        return tensors, numbers

    def _capture(self, src):
        """Capture the cycle in its form.  The graph captured before keeps
        its memory pool alive for the new one, which then owns it: one
        pool across rebuilds."""
        pool = None if self._pool_owner is None else self._pool_owner.pool()
        cyc = _CycleGraphs(self._graph_key(src), torch.empty_like(src), pool)
        # the face matrices follow the linearization point: built here,
        # eagerly, not inside the capture
        for op in self.level_ops:
            op.face_matrices()
        count("vcycle_graph_capture")
        if self._form == "whole":
            cyc.out = cyc.capture(lambda: self._eager_cycle(cyc.src))
        else:
            cyc.coarse_rhs, cyc.saved = cyc.capture(
                lambda: self._leg_down(cyc.src))
            cyc.coarse_x = torch.empty_like(cyc.coarse_rhs)
            cyc.out = cyc.capture(lambda: self._leg_up(
                cyc.coarse_x, cyc.saved, cyc.src))
        self._captured = cyc
        self._pool_owner = cyc.graphs[0]
        return cyc

    def _replay(self, src):
        """The cycle on ``src`` from its graphs, captured first where the
        last capture baked in something that has changed since."""
        cyc = self._captured
        if cyc is None or not cyc.matches(self._graph_key(src)):
            self._captured = None
            cyc = self._capture(src)
        cyc.src.copy_(src)
        count("vcycle_graph_replay")
        if self._form == "whole":
            with timer("graph"):
                cyc.replay(0)
        else:
            with timer("down"):
                cyc.replay(0)
            cyc.coarse_x.copy_(self._coarse(cyc.coarse_rhs))
            with timer("up"):
                cyc.replay(1)
        # the next replay writes over the graph's output
        return cyc.out.clone()

    def vmult(self, src):
        if self.inv_diags is None:
            self.initialize()
        count("vcycle")
        with timer("vcycle"):
            if self._form is None or not self._warm:
                self._warm = True
                return self._eager_cycle(src)
            return self._replay(src)
