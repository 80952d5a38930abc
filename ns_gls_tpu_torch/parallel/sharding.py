"""Cell-sharded operator over a list of devices: the "replicated" strategy.

Port of ``ns_gls_tpu/parallel/sharding.py``.  The JAX package shards the
cell batch axis over a 1-D device mesh under ``shard_map`` and combines
the per-device contributions with a ``psum``; here one process drives the
devices itself:

- the cells are chunked contiguously along the batch axis (each shard a
  chunk of at most ceil(n_cells / n_shards) cells), and so is each weak-
  outflow face block along its face axis,
- the global node vector is replicated: each shard reads a copy on its
  device, sweeps its own cells and faces into a partial of full length,
- the partials are summed on the first device in shard order (the psum),
  and the constraint sandwich runs there on the global vector.

Every shard runs the general sweep (``ops/navier_stokes.py``
``cell_integrals``), as the JAX sharded sweep does, whatever fused sweep
the wrapped operator holds.  The helpers at the top build a shard's cell
batch, state and face blocks; ``parallel/halo.py`` uses them on its
windows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ns_gls_tpu_torch.fem import constraints as cstr
from ns_gls_tpu_torch.ops.navier_stokes import (
    CellBatch,
    FaceBlock,
    NavierStokesOperator,
    NSState,
)
from ns_gls_tpu_torch.parallel.dist import on_device
from ns_gls_tpu_torch.utils.device import resolve_device
from ns_gls_tpu_torch.utils.segment import TargetSums, class_sum, target_sums
from ns_gls_tpu_torch.utils.timer import count


def make_device_mesh(devices) -> tuple:
    """The mesh: a tuple of ``torch.device``.  A device may repeat (four
    shards on one card, or on the CPU); ``"cuda"`` without an index names
    the current card."""
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("a device mesh needs at least one device")
    return tuple(out)


# --------------------------------------------------------------------------
# a shard's part of an operator
# --------------------------------------------------------------------------
_CELL_FIELDS = ("u_star", "grad_u_star", "grad_p_star", "dt_u_old",
                "u_old_grad", "p_old_grad", "delta1", "delta2")


def shard_batch(op: NavierStokesOperator, cells: np.ndarray,
                cell_nodes: np.ndarray, dev) -> CellBatch:
    """The cell batch of ``cells`` on ``dev``, with ``cell_nodes`` (the
    cells' nodes in the numbering of the shard's vectors)."""
    b = op.batch
    idx = torch.as_tensor(np.asarray(cells, np.int64), device=op.device)
    return CellBatch(
        S=b.S.to(dev), D=b.D.to(dev), jinv=b.jinv[idx].to(dev),
        jxw=b.jxw[idx].to(dev),
        cell_nodes=torch.as_tensor(np.asarray(cell_nodes, np.int64),
                                   device=dev),
        h_min_vertex=b.h_min_vertex[idx].to(dev), h_q=b.h_q[idx].to(dev),
        node_gather=(), node_gather_perm=None)


def shard_faces(op: NavierStokesOperator, sels, node_map, dev) -> tuple:
    """The weak-outflow face blocks of a shard: of block k the faces
    ``sels[k]`` (positions in the block), their nodes mapped by
    ``node_map`` (global ids -> the shard's numbering)."""
    out = []
    for fb, sel in zip(op.face_blocks, sels):
        idx = torch.as_tensor(np.asarray(sel, np.int64), device=op.device)
        nodes = node_map(fb.nodes.cpu().numpy()[np.asarray(sel, np.int64)])
        out.append(FaceBlock(
            S=fb.S.to(dev), D=fb.D.to(dev),
            nodes=torch.as_tensor(np.asarray(nodes, np.int64), device=dev),
            jxw=fb.jxw[idx].to(dev), normals=fb.normals[idx].to(dev),
            jinv=fb.jinv[idx].to(dev), beta_eff=fb.beta_eff[idx].to(dev),
            is_cut=fb.is_cut[idx].to(dev),
            is_nitsche=fb.is_nitsche[idx].to(dev)))
    return tuple(out)


def shard_state(state: NSState, cells: torch.Tensor, face_sels,
                node_index: Optional[torch.Tensor], dev) -> NSState:
    """The part of ``state`` a shard's sweep reads, on ``dev``: the
    per-cell tables of ``cells``, the per-face tables of ``face_sels``
    (index tensors on the state's device) and the node vectors, gathered
    at ``node_index`` (a window) or whole (replicated).  The fused
    sweeps' views are left empty: a shard builds its own from its
    window."""
    def node(x):
        if node_index is None or x.shape[0] == 0:
            return x.to(dev)
        return x[node_index].to(dev)

    empty = state.u_linT.new_zeros((0,), device=dev)
    return state._replace(
        weight=state.weight.to(dev), stau=state.stau.to(dev),
        face_velocity=tuple(x[s].to(dev) for x, s in
                            zip(state.face_velocity, face_sels)),
        face_target=tuple(x[s].to(dev) for x, s in
                          zip(state.face_target, face_sels)),
        u_lin=node(state.u_lin), vec_old=node(state.vec_old),
        u_old=node(state.u_old), u_linT=empty, vec_oldT=empty,
        **{f: getattr(state, f)[cells].to(dev) for f in _CELL_FIELDS})


def scatter_sums(cell_nodes: np.ndarray, dev) -> Optional[TargetSums]:
    """Fixed-order sum tables of a shard's cell integrals onto its nodes
    (None for a shard without cells)."""
    if cell_nodes.size == 0:
        return None
    return target_sums(cell_nodes, dev)


def cell_partial(op: NavierStokesOperator, batch: CellBatch,
                 sums: Optional[TargetSums], state: NSState, cq, u,
                 residual_form: bool, n_out: int):
    """A shard's general sweep with its tables ``cq``: its cells'
    integrals summed onto its (n_out, C) vector in a fixed order, zero
    where no cell of it adds."""
    out = u.new_zeros((n_out, op.n_comp))
    if sums is None:
        return out
    r_loc = op.cell_integrals(batch, state, u, residual_form, cq)
    out[sums.targets] = class_sum(sums.gather,
                                  r_loc.reshape(-1, op.n_comp))
    return out


def sum_partials(partials, dev):
    """The per-shard partials summed on ``dev`` in shard order."""
    total = partials[0].to(dev)
    for p in partials[1:]:
        total = total + p.to(dev)
    return total


class _Shard(NamedTuple):
    dev: torch.device
    cells: torch.Tensor          # the shard's cells (op.device)
    batch: CellBatch
    sums: Optional[TargetSums]
    face_sels: tuple             # per face block: positions (op.device)
    faces: tuple                 # FaceBlock per block, on dev


class WrappedOperator:
    """The operator surface a sharded wrapper delegates to the operator
    it wraps (every delegate that can replace ``op.state`` is visible to
    the wrapper through the state's identity)."""

    # the counter (``utils/timer.py``) that each apply adds one to, named
    # by the operator's owner ("fine_apply", "level_apply"); None counts
    # nothing
    apply_counter = None

    def __init__(self, op: NavierStokesOperator, devices):
        self.op = op
        self.devices = make_device_mesh(devices)
        self.n_dev = len(self.devices)

    def set_linearization_point(self, u):
        self.op.set_linearization_point(u)

    def set_previous_solution(self, history):
        self.op.set_previous_solution(history)

    def invalidate_system(self):
        self.op.invalidate_system()

    def update_weight(self):
        self.op.update_weight()

    def get_max_u(self, u):
        return self.op.get_max_u(u)

    @property
    def constraints_inhomogeneous(self):
        return self.op.constraints_inhomogeneous

    @constraints_inhomogeneous.setter
    def constraints_inhomogeneous(self, value):
        self.op.constraints_inhomogeneous = value

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def n_comp(self):
        return self.op.n_comp

    @property
    def n_nodes(self):
        return self.op.n_nodes

    def evaluate_rhs(self):
        return self.evaluate_residual(self.op.new_vector())


class ShardedOperator(WrappedOperator):
    """A :class:`NavierStokesOperator` with a cell-sharded apply over
    ``devices``; vectors in and out are global, on the operator's
    device."""

    def __init__(self, op: NavierStokesOperator, devices):
        super().__init__(op, devices)
        n_dev = self.n_dev
        n_c = op.space.mesh.n_cells
        cn = np.asarray(op.space.cell_nodes, np.int64)
        chunk = -(-n_c // n_dev)
        self.cells_of = [np.arange(d * chunk, min((d + 1) * chunk, n_c))
                         for d in range(n_dev)]
        shards = []
        for d, dev in enumerate(self.devices):
            cells = self.cells_of[d]
            sels = []
            for fb in op.face_blocks:
                n_bf = fb.nodes.shape[0]
                fc = -(-n_bf // n_dev)
                sels.append(np.arange(d * fc, min((d + 1) * fc, n_bf)))
            shards.append(_Shard(
                dev=dev,
                cells=torch.as_tensor(cells, device=op.device),
                batch=shard_batch(op, cells, cn[cells], dev),
                sums=scatter_sums(cn[cells], dev),
                face_sels=tuple(torch.as_tensor(s, device=op.device)
                                for s in sels),
                faces=shard_faces(op, sels, lambda n: n, dev)))
        self.shards = tuple(shards)
        self._states = None
        self._state_src = None
        self._mats = None
        self._mats_src = None

    def _shard_states(self):
        """Each shard's state and sweep tables, rebuilt when the wrapped
        operator's state is replaced."""
        if self._state_src is not self.op.state:
            states = []
            for s in self.shards:
                with on_device(s.dev):
                    st = shard_state(self.op.state, s.cells, s.face_sels,
                                     None, s.dev)
                    states.append((st, self.op.cell_tables(s.batch, st)))
            self._states = tuple(states)
            self._state_src = self.op.state
        return self._states

    def _shard_face_matrices(self):
        mats = self.op._face_matrices()
        if self._mats_src is not mats:
            self._mats = tuple(
                tuple(K[sel].to(s.dev) for K, sel in zip(mats, s.face_sels))
                for s in self.shards)
            self._mats_src = mats
        return self._mats

    def _sweep(self, u, residual_form: bool):
        op = self.op
        states = self._shard_states()
        mats = (self._shard_face_matrices()
                if op.needs_face_integrals and not residual_form else None)
        partials = []
        for i, (s, (st, cq)) in enumerate(zip(self.shards, states)):
            with on_device(s.dev):
                ud = u.to(s.dev)
                r = cell_partial(op, s.batch, s.sums, st, cq, ud,
                                 residual_form, op.n_nodes)
                if op.needs_face_integrals:
                    r = op.face_sweep(s.faces, None if mats is None
                                      else mats[i], st, ud, r, residual_form)
            partials.append(r)
        return sum_partials(partials, op.device)

    def vmult(self, u):
        if self.apply_counter is not None:
            count(self.apply_counter)
        ch = self.op.constraints_homogeneous
        u_eff = cstr.distribute(ch, u, homogeneous=True)
        r = cstr.condense_transpose(ch, self._sweep(u_eff, False))
        return cstr.copy_constrained(ch, r, u)

    def evaluate_residual(self, u):
        tmp = cstr.distribute(self.op.constraints_inhomogeneous, u,
                              homogeneous=False)
        r = self._sweep(tmp, True)
        return -cstr.condense_transpose(self.op.constraints_homogeneous, r)
