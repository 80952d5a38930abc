"""Node-sharded operator with a halo exchange: the default strategy.

Port of ``ns_gls_tpu/parallel/halo.py`` (the counterpart of the
reference's partitioned vectors with ghost update and compress,
``operator_ns.cc:260,346,634-639``; the p4est partition
``main.cc:230-233``), driven by one process over a list of devices:

- partition: by patch where the operator holds a fused patch sweep
  (prism, then patch-2D, then patch-3D: whole patches per shard, so the
  kernel runs per shard), else contiguous chunks of the Morton order of
  the cells; a node belongs to the lowest shard whose cells touch it,
- windows: each shard works on ``[owned | ghosts]`` (n_loc rows): its
  owned nodes, then the other nodes its cells touch and the masters of
  every constraint on a node it sees, so that constraints resolve
  locally,
- apply: owned values into the windows -> ghost fill (one exchange
  round per SFC-neighbour distance, a copy between shards per pair) ->
  the constraints distributed per shard -> the local sweep (the shard's
  fused kernel, or the general sweep) and the face terms -> Cᵀ per shard
  -> the reverse exchange adds ghost partials at the owners -> the owned
  rows,
- distributed vectors (``parallel/dist.py``) carry the owned rows per
  shard; ``to_dist`` / ``to_global`` convert at the solver boundaries,
  and ``vmult`` / ``evaluate_residual`` take and return global vectors.

:class:`HaloTransferOps` is the distributed MG transfer between two such
layouts: the V-cycle (``precond/gmg.py``) runs on distributed vectors
down to the coarse solve.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ns_gls_tpu_torch.fem import constraints as cstr
from ns_gls_tpu_torch.fem.constraints import ConstraintArrays
from ns_gls_tpu_torch.fem.transfer import restrict_rows, row_gather_sum
from ns_gls_tpu_torch.ops.navier_stokes import CellBatch, NavierStokesOperator
from ns_gls_tpu_torch.parallel.dist import DistVector, on_device
from ns_gls_tpu_torch.parallel.sharding import (
    WrappedOperator,
    cell_partial,
    scatter_sums,
    shard_batch,
    shard_faces,
    shard_state,
)
from ns_gls_tpu_torch.utils.segment import TargetSums
from ns_gls_tpu_torch.utils.timer import count


class Partition(NamedTuple):
    """Cells (and, for a patch partition, patches) of every shard."""

    cells_of: list                  # per shard: global cell ids
    patches_of: Optional[list]      # per shard: patch ids, or None
    kind: str                       # "prism", "patch2d", "patch3d", "cells"


def halo_partition(op: NavierStokesOperator, n_dev: int) -> Partition:
    """By patch where ``op`` holds a fused patch sweep that the partition
    can serve (the JAX order: prism, patch-2D, patch-3D), else Morton
    chunks of the cells."""
    from ns_gls_tpu_torch.ops.patch2d import Patch2DSweep
    from ns_gls_tpu_torch.ops.patch3d import Patch3DSweep
    from ns_gls_tpu_torch.ops.prism import PrismSweep
    from ns_gls_tpu_torch.parallel.halo_patch2d import patch2d_partition
    from ns_gls_tpu_torch.parallel.halo_patch3d import patch3d_partition
    from ns_gls_tpu_torch.parallel.halo_prism import prism_patch_partition

    space = op.space
    for kind, sweep, part_fn in (
            ("prism", PrismSweep, prism_patch_partition),
            ("patch2d", Patch2DSweep, patch2d_partition),
            ("patch3d", Patch3DSweep, patch3d_partition)):
        if isinstance(op._fast, sweep):
            part = part_fn(space, n_dev)
            if part is not None:
                return Partition(part[0], part[1], kind)
    n_c = space.mesh.n_cells
    perm = space.mesh.sfc_order()
    chunk = -(-n_c // n_dev)
    return Partition([perm[d * chunk: min((d + 1) * chunk, n_c)]
                      for d in range(n_dev)], None, "cells")


def _pad_rows(a: np.ndarray, n: int, fill=0):
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def exchange_plan(need, owner: np.ndarray, send_slot, recv_slot, pad: int):
    """The exchange rounds, one per SFC-neighbour distance delta = receiver
    - owner, in ascending delta, as the JAX package plans them: for each
    round (pairs, send, recv, copies): the (owner, receiver) pairs, the
    padded (n_dev, L) send maps (owner slots, pads 0) and receive maps
    (receiver slots, pads ``pad``), and per pair the exact slot lists
    (owner, receiver, send slots, receive slots).  ``need[d]`` lists the
    nodes shard d needs from other shards; ``send_slot(o, nodes)`` and
    ``recv_slot(r, nodes)`` map nodes to slots."""
    n_dev = len(need)
    plans = {}
    for d in range(n_dev):
        if not len(need[d]):
            continue
        og = owner[need[d]]
        for o in np.unique(og):
            plans.setdefault(int(d - o), {})[int(o)] = need[d][og == o]
    rounds = []
    for delta in sorted(plans):
        by_src = plans[delta]
        L = max(len(v) for v in by_src.values())
        send = np.zeros((n_dev, L), np.int64)
        recv = np.full((n_dev, L), pad, np.int64)
        pairs, copies = [], []
        for o, nodes in sorted(by_src.items()):
            r = o + delta
            s, v = send_slot(o, nodes), recv_slot(r, nodes)
            send[o] = _pad_rows(s, L, 0)
            recv[r] = _pad_rows(v, L, pad)
            pairs.append((o, r))
            copies.append((o, r, s, v))
        rounds.append((tuple(pairs), send, recv, copies))
    return rounds


class _HaloShard(NamedTuple):
    dev: torch.device
    cells: torch.Tensor          # the shard's cells (op.device)
    own: torch.Tensor            # its owned nodes in slot order (op.device)
    loc_global: torch.Tensor     # (n_loc,) global node of each slot
    batch: Optional[CellBatch]   # general sweep only
    sums: Optional[TargetSums]
    fast: object                 # the shard's fused sweep, or None
    face_sels: tuple
    faces: tuple
    cstr_h: ConstraintArrays     # homogeneous, every row the window sees
    cstr_own: ConstraintArrays   # homogeneous, the owned rows
    cstr_i: ConstraintArrays     # inhomogeneous, every row the window sees
    ci_sel: torch.Tensor         # rows of the global inhomogeneous set


class HaloShardedOperator(WrappedOperator):
    """Node-sharded wrapper of a :class:`NavierStokesOperator` over
    ``devices``.  ``vmult_dist`` / ``residual_dist`` act on distributed
    vectors; ``vmult`` / ``evaluate_residual`` / ``evaluate_rhs`` on
    global ones.  ``partition`` (a :class:`Partition`) overrides
    :func:`halo_partition`: the driver gives the outer operator its
    finest multigrid level's, so that both share one layout."""

    def __init__(self, op: NavierStokesOperator, devices,
                 partition: Optional[Partition] = None):
        super().__init__(op, devices)
        n_dev = self.n_dev
        space = op.space
        C = op.n_comp
        n_nodes = op.n_nodes
        cell_nodes = np.asarray(space.cell_nodes, np.int64)
        part = partition if partition is not None \
            else halo_partition(op, n_dev)
        if len(part.cells_of) != n_dev:
            raise ValueError("the partition has another number of shards")
        self.partition = part
        cells_of = part.cells_of

        # ---- ownership: the lowest shard touching a node owns it ------
        touched = [np.unique(cell_nodes[cd]) for cd in cells_of]
        owner = np.full(n_nodes, n_dev, np.int64)
        for d in range(n_dev - 1, -1, -1):
            owner[touched[d]] = d
        assert owner.max() < n_dev, "orphan nodes"

        # ---- windows, extended by the masters of seen constraints -----
        ch = op.constraints_homogeneous
        ci = op.constraints_inhomogeneous
        assert ci is not None, "set constraints_inhomogeneous before sharding"
        deps = []          # (constrained node, master node) pairs
        for ca in (ch, ci):
            if ca.n == 0:
                continue
            w = ca.weights.cpu().numpy()
            i, k = np.nonzero(w != 0.0)
            deps.append(np.stack([ca.rows.cpu().numpy()[i] // C,
                                  ca.cols.cpu().numpy()[i, k] // C], 1))
        deps = (np.unique(np.concatenate(deps), axis=0) if deps
                else np.zeros((0, 2), np.int64))
        local = []
        for d in range(n_dev):
            seen = np.zeros(n_nodes, bool)
            seen[touched[d]] = True
            local.append(np.union1d(touched[d], deps[seen[deps[:, 0]], 1]))
        own = [ld[owner[ld] == d] for d, ld in enumerate(local)]
        ghost = [ld[owner[ld] != d] for d, ld in enumerate(local)]
        self.owner = owner
        self.own_lists = own
        self.n_own_max = n_own_max = max(len(o) for o in own)
        n_gh_max = max((len(g) for g in ghost), default=0)
        self.n_loc = n_loc = n_own_max + n_gh_max

        g2l = np.full((n_dev, n_nodes), n_loc, np.int64)
        own_global = np.zeros((n_dev, n_own_max), np.int64)
        loc_global = np.zeros((n_dev, n_loc), np.int64)
        for d in range(n_dev):
            g2l[d, own[d]] = np.arange(len(own[d]))
            g2l[d, ghost[d]] = n_own_max + np.arange(len(ghost[d]))
            own_global[d, : len(own[d])] = own[d]
            loc_global[d, : len(own[d])] = own[d]
            loc_global[d, n_own_max: n_own_max + len(ghost[d])] = ghost[d]
        self.g2l = g2l
        self.own_global = own_global
        self.n_ghosts = sum(len(g) for g in ghost)

        # ---- ghost exchange: one round per SFC-neighbour distance -----
        def slots(d, nodes):
            return g2l[d, nodes]

        rounds = exchange_plan(ghost, owner, slots, slots, n_loc)
        self.rounds = [(p, s, r) for p, s, r, _ in rounds]
        self._copies = [
            [(o, r, torch.as_tensor(s, device=self.devices[o]),
              torch.as_tensor(v, device=self.devices[r]))
             for o, r, s, v in cp] for _, _, _, cp in rounds]
        item = torch.tensor([], dtype=op.dtype).element_size()
        # the JAX package's measure (padded rounds, f32 payload) and the
        # exact payload of one apply (the fill and the reverse exchange)
        self.halo_bytes = int(sum(s.shape[1] * len(p)
                                  for p, s, _ in self.rounds)) * C * 4
        self.exchange_bytes = 2 * self.n_ghosts * C * item

        # ---- the shards' fused sweeps --------------------------------
        fast = None
        if part.kind != "cells":
            from ns_gls_tpu_torch.parallel.halo_patch2d import (
                build_halo_patch2d,
            )
            from ns_gls_tpu_torch.parallel.halo_patch3d import (
                build_halo_patch3d,
            )
            from ns_gls_tpu_torch.parallel.halo_prism import build_halo_prism

            build = dict(prism=build_halo_prism, patch2d=build_halo_patch2d,
                         patch3d=build_halo_patch3d)[part.kind]
            fast = build(op, part.patches_of, g2l, n_loc, self.devices)
        self.local_sweep = "general" if fast is None else part.kind

        # ---- the shards ----------------------------------------------
        cell_dev = np.empty(space.mesh.n_cells, np.int64)
        for d, cd in enumerate(cells_of):
            cell_dev[cd] = d
        face_dev = [cell_dev[np.asarray(hb.cells)]
                    for hb in op._face_host_batches]
        shards = []
        for d, dev in enumerate(self.devices):
            cells = np.asarray(cells_of[d])
            loc_cn = g2l[d, cell_nodes[cells]]
            sels = [np.nonzero(fd == d)[0] for fd in face_dev]
            h, _ = self._localize(ch, d, dev, owned_only=False)
            h_own, _ = self._localize(ch, d, dev, owned_only=True)
            i_loc, i_sel = self._localize(ci, d, dev, owned_only=False)
            shards.append(_HaloShard(
                dev=dev,
                cells=torch.as_tensor(cells, device=op.device),
                own=torch.as_tensor(own[d], device=op.device),
                loc_global=torch.as_tensor(loc_global[d], device=op.device),
                batch=(shard_batch(op, cells, loc_cn, dev) if fast is None
                       else None),
                sums=scatter_sums(loc_cn, dev) if fast is None else None,
                fast=None if fast is None else fast[d],
                face_sels=tuple(torch.as_tensor(s, device=op.device)
                                for s in sels),
                faces=shard_faces(op, sels, lambda n, d=d: g2l[d, n], dev),
                cstr_h=h, cstr_own=h_own, cstr_i=i_loc,
                ci_sel=torch.as_tensor(i_sel, device=op.device)))
        self.shards = tuple(shards)
        self._states = None
        self._state_src = None
        self._mats = None
        self._mats_src = None

    # ------------------------------------------------------------------
    def _localize(self, ca: ConstraintArrays, d: int, dev, owned_only: bool):
        """The rows of ``ca`` shard d's window sees (``owned_only``: the
        rows on nodes it owns) in window-slot numbering on ``dev``, and
        their positions in ``ca``.  Masters of zero weight may lie
        outside the window: they point at slot 0."""
        C = self.op.n_comp
        rows = ca.rows.cpu().numpy()
        cols = ca.cols.cpu().numpy()
        w = ca.weights.cpu().numpy()
        rnode = rows // C
        here = self.g2l[d, rnode] < self.n_loc
        if owned_only:
            here &= self.owner[rnode] == d
        sel = np.nonzero(here)[0]
        rl = self.g2l[d, rnode[sel]] * C + rows[sel] % C
        cl = self.g2l[d, cols[sel] // C] * C + cols[sel] % C
        cl = np.where(w[sel] != 0.0, cl, 0)
        assert (cl < self.n_loc * C).all(), "master outside the window"
        idx = torch.as_tensor(sel, device=ca.rows.device)
        return ConstraintArrays(
            rows=torch.as_tensor(rl, device=dev),
            cols=torch.as_tensor(cl, device=dev),
            weights=ca.weights[idx].to(dev), inhom=ca.inhom[idx].to(dev),
        ), sel

    @property
    def constraints_inhomogeneous(self):
        return self.op.constraints_inhomogeneous

    @constraints_inhomogeneous.setter
    def constraints_inhomogeneous(self, value):
        """The new values of the inhomogeneous set (its rows, columns and
        weights do not change from step to step) go to every shard."""
        self.op.constraints_inhomogeneous = value
        self.shards = tuple(
            s._replace(cstr_i=s.cstr_i._replace(
                inhom=value.inhom[s.ci_sel].to(s.dev)))
            for s in self.shards)

    # ------------------------------------------------------------------
    def _shard_states(self):
        """Each shard's part of the wrapped operator's state and, for the
        general sweep, its tables, rebuilt when that state is replaced
        (every linearization, history and weight update replaces it)."""
        if self._state_src is not self.op.state:
            op = self.op
            states = []
            for s in self.shards:
                with on_device(s.dev):
                    st = shard_state(op.state, s.cells, s.face_sels,
                                     s.loc_global, s.dev)
                    if s.fast is not None:
                        states.append((st._replace(
                            u_linT=s.fast.gather_nodes(st.u_lin, op.n_comp),
                            vec_oldT=s.fast.gather_nodes(st.vec_old,
                                                         op.dim)), None))
                    else:
                        states.append((st, op.cell_tables(s.batch, st)))
            self._states = tuple(states)
            self._state_src = op.state
        return self._states

    def _shard_face_matrices(self):
        mats = self.op._face_matrices()
        if self._mats_src is not mats:
            self._mats = tuple(
                tuple(K[sel].to(s.dev) for K, sel in zip(mats, s.face_sels))
                for s in self.shards)
            self._mats_src = mats
        return self._mats

    # -- the exchanges ----------------------------------------------------
    def exchange_fill(self, ws):
        """Owned values -> the ghost slots of the other shards' windows
        (``update_ghost_values``), in place on the windows ``ws``."""
        for copies in self._copies:
            for o, r, snd, rcv in copies:
                ws[r][rcv] = ws[o][snd].to(self.devices[r])

    def compress(self, rs):
        """Ghost partial sums -> their owners' rows (``compress(add)``),
        in place on the windows ``rs``; each owned row receives its
        partials one round after the other, in ascending distance."""
        for copies in self._copies:
            for o, r, snd, rcv in copies:
                rs[o][snd] += rs[r][rcv].to(self.devices[o])

    # -- the apply ----------------------------------------------------------
    def _apply(self, ud: DistVector, residual_form: bool) -> DistVector:
        op = self.op
        C, n_loc, n_own = op.n_comp, self.n_loc, self.n_own_max
        states = self._shard_states()
        mats = (self._shard_face_matrices()
                if op.needs_face_integrals and not residual_form else None)
        ws = []
        for u_own in ud.parts:
            w = u_own.new_zeros((n_loc, C))
            w[:n_own] = u_own
            ws.append(w)
        self.exchange_fill(ws)
        flavor = ("residual" if residual_form
                  else "increment" if op.increment_form else "fixed")
        rs = []
        for i, (s, (st, cq), w) in enumerate(zip(self.shards, states, ws)):
            with on_device(s.dev):
                w = cstr.distribute(s.cstr_i if residual_form else s.cstr_h,
                                    w, homogeneous=not residual_form)
                if s.fast is not None:
                    r = s.fast.apply(op._weight_host, op._stau_host,
                                     s.fast.gather_nodes(w, C), st.u_linT,
                                     st.vec_oldT, flavor)
                else:
                    r = cell_partial(op, s.batch, s.sums, st, cq, w,
                                     residual_form, n_loc)
                if op.needs_face_integrals:
                    r = op.face_sweep(s.faces, None if mats is None
                                      else mats[i], st, w, r, residual_form)
                # every sweep returns a fresh tensor: the reverse
                # exchange adds into it in place
                rs.append(cstr.condense_transpose(s.cstr_h, r))
        self.compress(rs)
        return DistVector(r[:n_own] for r in rs)

    def vmult_dist(self, ud: DistVector) -> DistVector:
        """dst = Cᵀ A C u on owned rows; dst[constrained] = u (``vmult``
        goes through here)."""
        if self.apply_counter is not None:
            count(self.apply_counter)
        r = self._apply(ud, False)
        return DistVector(cstr.copy_constrained(s.cstr_own, rp, up)
                          for s, rp, up in zip(self.shards, r.parts,
                                               ud.parts))

    def residual_dist(self, ud: DistVector) -> DistVector:
        """-Cᵀ R(C u + b) on owned rows."""
        return DistVector(-p for p in self._apply(ud, True).parts)

    # -- layouts ------------------------------------------------------------
    def to_dist(self, u: torch.Tensor) -> DistVector:
        """Global (n_nodes, C) -> distributed (zero pads)."""
        parts = []
        for s in self.shards:
            p = u.new_zeros((self.n_own_max, u.shape[1]))
            p[: s.own.shape[0]] = u[s.own]
            parts.append(p.to(s.dev))
        return DistVector(parts)

    def to_global(self, ud: DistVector) -> torch.Tensor:
        """Distributed -> global (n_nodes, C) on the operator's device."""
        dev = self.op.device
        out = torch.zeros((self.op.n_nodes, ud.parts[0].shape[1]),
                          dtype=ud.dtype, device=dev)
        for s, p in zip(self.shards, ud.parts):
            out[s.own] = p[: s.own.shape[0]].to(dev)
        return out

    # -- global vectors in and out -----------------------------------------
    def vmult(self, u):
        return self.to_global(self.vmult_dist(self.to_dist(u)))

    def evaluate_residual(self, u):
        return self.to_global(self.residual_dist(self.to_dist(u)))

    def stats(self) -> dict:
        """The layout's measures: the ghost copies as a share of the
        node vector, the exchange rounds and pairs, the bytes one apply
        exchanges, the local sweep and the rows of each window."""
        return dict(
            halo_share=self.n_ghosts / self.op.n_nodes,
            rounds=len(self.rounds),
            pairs=sum(len(p) for p, _, _ in self.rounds),
            exchange_bytes=self.exchange_bytes,
            local_sweep=self.local_sweep, n_loc=self.n_loc,
            n_own_max=self.n_own_max)


class HaloTransferOps:
    """Distributed two-level MG transfer between the layouts of a coarse
    and a fine :class:`HaloShardedOperator` (the distributed
    ``MGTwoLevelTransfer``, ``main.cc:540-567``): prolongation fills a
    per-shard window with the coarse values its owned fine nodes need
    (its own, then one exchange round per SFC-neighbour distance) and
    applies the embedding weights on its owned fine nodes; restriction is
    the exact transpose (scatter into the window, the local part added at
    the coarse owned rows, then the exchange back)."""

    def __init__(self, t, coarse: HaloShardedOperator,
                 fine: HaloShardedOperator):
        n_dev = fine.n_dev
        assert coarse.n_dev == n_dev
        self.devices = fine.devices
        self.n_own_c = coarse.n_own_max
        p_cols = t.p_cols.cpu().numpy()
        p_wts = t.p_wts.cpu().numpy()
        K = p_cols.shape[1]
        owner_c = coarse.owner
        g2l_c = coarse.g2l

        # per shard: the coarse nodes its owned fine nodes need, sorted
        need = []
        for d in range(n_dev):
            ofd = fine.own_lists[d]
            need.append(np.unique(p_cols[ofd][p_wts[ofd] != 0.0]))
        self.n_win = n_win = max(max((len(n) for n in need), default=0), 1)

        def win_slot(d, nodes):
            return np.searchsorted(need[d], nodes)

        remote = [nd[owner_c[nd] != d] for d, nd in enumerate(need)]
        rounds = exchange_plan(remote, owner_c,
                               lambda o, n: g2l_c[o, n], win_slot, n_win)
        self._copies = [
            [(o, r, torch.as_tensor(s, device=self.devices[o]),
              torch.as_tensor(v, device=self.devices[r]))
             for o, r, s, v in cp] for _, _, _, cp in rounds]

        shards = []
        for d, dev in enumerate(self.devices):
            mine = need[d][owner_c[need[d]] == d]
            ofd = fine.own_lists[d]
            cd, wd = p_cols[ofd], p_wts[ofd]
            cols = np.full((fine.n_own_max, K), n_win, np.int64)
            wts = np.zeros((fine.n_own_max, K), p_wts.dtype)
            cols[: len(ofd)] = np.where(wd != 0.0, win_slot(d, cd), n_win)
            wts[: len(ofd)] = wd
            shards.append(dict(
                fill_src=torch.as_tensor(g2l_c[d, mine], device=dev),
                fill_dst=torch.as_tensor(win_slot(d, mine), device=dev),
                cols=torch.as_tensor(cols, device=dev),
                wts=torch.as_tensor(wts, dtype=t.p_wts.dtype, device=dev)))
        self.shards = shards

    def prolongate(self, xc: DistVector) -> DistVector:
        """Coarse distributed -> fine distributed."""
        wins = []
        for s, p in zip(self.shards, xc.parts):
            win = p.new_zeros((self.n_win + 1, p.shape[1]))
            win[s["fill_dst"]] = p[s["fill_src"]]
            wins.append(win)
        for copies in self._copies:
            for o, r, snd, rcv in copies:
                wins[r][rcv] = xc.parts[o][snd].to(self.devices[r])
        out = []
        for s, win in zip(self.shards, wins):
            with on_device(win.device):
                out.append(row_gather_sum(s["cols"], s["wts"], win))
        return DistVector(out)

    def restrict(self, rf: DistVector) -> DistVector:
        """Fine distributed -> coarse distributed (the transpose)."""
        wins, out = [], []
        for s, p in zip(self.shards, rf.parts):
            with on_device(p.device):
                win = restrict_rows(s["cols"], s["wts"], p, self.n_win + 1)
            rc = p.new_zeros((self.n_own_c, p.shape[1]))
            rc[s["fill_src"]] += win[s["fill_dst"]]
            wins.append(win)
            out.append(rc)
        for copies in self._copies:
            for o, r, snd, rcv in copies:
                out[o][snd] += wins[r][rcv].to(self.devices[o])
        return DistVector(out)
