"""Device-resident serving admission: EDF admission as priority mesh
megarounds — the PyTorch twin of ``repro/serving/admission.py``, on one
card or one shard a process.

``ServingMeshEngine`` is a tick-driven configuration of the relaxed
``MeshHeapEngine`` (on one card the shard axis a leading tensor
dimension): pending
generation requests live on the card as ``(deadline-key | payload)``
entries of the per-shard heaps, and one serving tick is one chunk of the
engine's device loop (claim → pop-min → admission step → publish) that
pops requests in (locally exact, mesh k-relaxed) EDF order and admits
the maximal deadline-ordered prefix that fits the tick's slot and
KV-page budgets.  The admission decision *is* the engine's
``PriorityStepFn``:

* pops arrive per shard in ascending key order, so prefix-fit =
  stop-at-first-stall, exactly the host pool's ``_try_admit`` contract;
* a request that does not fit is republished as a *child* at its
  ORIGINAL deadline key, so it ages toward urgency while newer arrivals
  take later keys;
* any republication sets the ``stalled`` flag, the device loop's stop
  word (``csrc/loop.cu``'s optional fifth word, the reference's
  ``_extra_cond``): the chunk ends after that round, on the card, with
  no host round trip, and the tick with it.

A tick costs one launch to install its arrivals (``heap_apply_grid`` in
masked-insert mode over all S heaps, one destination shard a lane, in
the reference's spray order; the overflow pre-check reads the host copy
of the sizes kept from the last readback), one launch of the device
loop, and ONE readback of the occupancy, the rounds, the overflow flag,
the counters, the sizes and the admitted log.  The heap planes, the acc
and the observability planes stay in the engine's kept carry between
ticks: the trace, span and births planes persist across ticks as the
reference's ``_ext`` does, and telemetry drains at each tick's readback.

Across processes (``mesh`` bound to a process group, one shard a rank)
every rank calls ``tick`` with the same arguments: each installs the
arrivals sprayed to its own heap and runs its shard's rounds, whose one
collective a round is the relaxed mesh's exchange; the tick then gathers
every shard's admitted log in one more collective before its one
readback, and every rank returns the same admitted list.

Payload packing: ``val = retry · table + idx`` where ``idx`` names the
host-side request-table row and ``retry`` counts re-entries, so every
heap residence of a request is a unique ident (what ``pop_history()``
needs to feed ``check_p_linearizable``).  Budgets (slots and pages)
partition per shard, remainder to low shards: at one shard admission is
exact EDF; at S > 1 shards the admitted set may relax within the mesh
envelope.  Deadline keys are capped at ``DEADLINE_KEY_CAP`` (the packed
span stamp's 2^30 round-clock cap): a key at or past it raises
``ValueError`` at stamp time.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.distqueue import DistHeapState
from ..distributed.collectives import gather_rows
from ..kernels.heap_batch import KEY_INF as HEAP_KEY_INF
from ..kernels.ring_slots import SPAN_ROUND_CAP
from ..obs.trace import SyncPoint
from ..runtime.enginecore import new_carry, register_engine, tree_copy_
from ..runtime.meshrounds import MeshHeapEngine

__all__ = ["DEADLINE_KEY_CAP", "ServingMeshEngine"]

# deadline keys share the packed birth-stamp round clock's cap: one
# stamp-time contract for every monotone clock in the system
DEADLINE_KEY_CAP = SPAN_ROUND_CAP


def _check_deadline_keys(keys: np.ndarray) -> None:
    if keys.size == 0:
        return
    lo, hi = int(keys.min()), int(keys.max())
    if lo < 0 or hi >= DEADLINE_KEY_CAP:
        raise ValueError(
            f"deadline key {hi if hi >= DEADLINE_KEY_CAP else lo} outside "
            f"[0, {DEADLINE_KEY_CAP}): keys past the 2^30 round-clock cap "
            f"would wrap and silently invert EDF order — rebase the "
            f"deadline clock (PR 9 stamp-time cap contract)")


def _put_drop(dst: torch.Tensor, pos: torch.Tensor, src: torch.Tensor):
    """``dst`` with ``src`` scattered to ``pos``, positions at or past
    ``dst``'s length dropped (the reference's ``mode="drop"``): a copy
    with one trash slot at the end."""
    n = dst.shape[0]
    buf = torch.cat([dst, dst.new_zeros(1)])
    buf[torch.clamp(pos, max=n).long()] = src.to(dst.dtype)
    return buf[:n]


class ServingMeshEngine(MeshHeapEngine):
    """Tick-driven EDF admission on the relaxed priority mesh, on
    ``device`` ("cuda" by default; "cpu" runs the kernels' plain versions
    and the same loop in Python).

    Unlike the drain-to-quiescence engines, serving state is persistent:
    ``tick(new_keys, new_idxs, need=, slots=, pages=)`` installs the
    tick's arrivals into the heap planes, runs ONE chunk of rounds
    (ending at quiescence or at the first admission stall) and returns
    the admitted request indices in admission order.  Page-stalled
    requests stay heap-resident at their original deadline key and
    compete again next tick.

    ``acc`` (stacked, one row a shard): ``need`` (table,) pages a
    request; ``slots``/``pages`` the shard's budgets; ``adm_idx``/
    ``adm_n`` the admitted log; ``stalled`` the stop flag (equal on every
    shard: the loop reads shard 0's); ``round`` the round clock; with
    ``pop_log`` > 0 the pop-log planes ``plk``/``plv``/``plr``/``pln``
    recording every pop for the p-linearizability checker."""

    def __init__(self, *, mesh, axis: str = "data",
                 capacity_log2: int = 8, batch: int = 16,
                 arity_log2: int = 2, table_log2: int = 8,
                 pop_log: int = 0, sync_every: int = 0,
                 combine=None, telemetry=None, spans=None,
                 compact=None, device="cuda") -> None:
        self.table = 1 << table_log2
        self.pop_log = int(pop_log)
        super().__init__(self._admission_step, mesh=mesh, axis=axis,
                         capacity_log2=capacity_log2, batch=batch,
                         arity_log2=arity_log2, relaxed=True,
                         sync_every=sync_every, combine=combine,
                         telemetry=telemetry, spans=spans, compact=compact,
                         device=device)
        self._carry = None          # the kept carry: heaps, acc, obs planes
        self._loop = None           # its device loop (the card)
        self._sizes = None          # host copy of the heap sizes
        self._spray = 0             # round-robin insert pointer (persistent)
        self._rounds = 0
        self._host_syncs = 0
        self.admitted_log: List[int] = []

    # -- the admission decision as a PriorityStepFn --------------------------

    def _admission_step(self, acc, keys, vals, valid):
        """Admit the maximal deadline-ordered prefix of this pop wave that
        fits the remaining slot/page budget; republish the rest at their
        original keys with a bumped retry ident."""
        t = self.table
        i32 = torch.int32
        idx = torch.where(valid, vals % t, 0)
        need = acc["need"][idx.long()]
        lane = torch.arange(keys.shape[0], dtype=i32, device=keys.device)
        nvalid = torch.cumsum(valid.to(i32), 0, dtype=i32)
        pcum = torch.cumsum(torch.where(valid, need, 0), 0, dtype=i32)
        fits = valid & (pcum <= acc["pages"]) & (nvalid <= acc["slots"])
        # stop at first stall: admission is a deadline-ordered *prefix*,
        # so a request can only be jumped by an earlier deadline
        bad = valid & ~fits
        first_bad = torch.where(bad, lane, keys.shape[0]).min()
        admit = valid & (lane < first_bad)
        rep = valid & ~admit
        adm = admit.to(i32)
        acc = dict(acc)
        acc["pages"] = acc["pages"] - torch.where(admit, need, 0).sum(
            dtype=i32)
        acc["slots"] = acc["slots"] - adm.sum(dtype=i32)
        apos = acc["adm_n"] + torch.cumsum(adm, 0, dtype=i32) - 1
        apos = torch.where(admit, apos, t)
        acc["adm_idx"] = _put_drop(acc["adm_idx"], apos, idx)
        acc["adm_n"] = acc["adm_n"] + adm.sum(dtype=i32)
        if self.pop_log:
            ppos = acc["pln"] + nvalid - 1
            ppos = torch.where(valid, ppos, self.pop_log)
            acc["plk"] = _put_drop(acc["plk"], ppos, keys)
            acc["plv"] = _put_drop(acc["plv"], ppos, vals)
            acc["plr"] = _put_drop(acc["plr"], ppos,
                                   acc["round"].expand(keys.shape))
            acc["pln"] = acc["pln"] + valid.to(i32).sum(dtype=i32)
        acc["round"] = acc["round"] + 1
        # re-entry wave: original deadline key, next retry ident
        return (acc, keys[:, None], torch.where(rep, vals + t, 0)[:, None],
                rep[:, None])

    # -- stall exit: the stop word of the device loop ------------------------

    def _round(self, q, acc, live, sp=None, births=None, trace=False):
        r = super()._round(q, acc, live, sp, births, trace=trace)
        acc = dict(r[1])
        # total (the published-children count) is one number for the
        # mesh: every child is a stalled request's re-entry, so the flag
        # is equal on every shard and the loop reads shard 0's
        acc["stalled"] = acc["stalled"] | (r[3] > 0)
        return (r[0], acc) + r[2:]

    def _stop_of(self, carry):
        return carry.acc["stalled"]

    # -- persistent device state ---------------------------------------------

    def _acc_zero(self):
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32,  # noqa
                                       device=self.device)
        acc = {"need": z(self.table), "slots": z(), "pages": z(),
               "adm_idx": z(self.table), "adm_n": z(),
               "stalled": torch.zeros((), dtype=torch.bool,
                                      device=self.device),
               "round": z()}
        if self.pop_log:
            acc.update(plk=z(self.pop_log), plv=z(self.pop_log),
                       plr=z(self.pop_log), pln=z())
        return acc

    def begin(self) -> None:
        """(Re)initialize the persistent planes for a fresh run.  On the
        card the first call also builds the engine's device loop (a
        warm-up round on a copy, then the capture)."""
        self._reset()
        q = self._seed(np.zeros(0, np.int32), np.zeros(0, np.int32))
        acc = self._initial_acc(self._acc_zero())
        obs = self._obs_init()
        if self.device.type == "cuda" and not self._host_rounds:
            carry, self._loop = self._device_loop(q, acc, obs)
            tree_copy_(carry.q, q)
            tree_copy_(carry.acc, acc)
            tree_copy_((carry.tp, carry.sp, carry.births), obs)
        else:
            carry = new_carry(q, acc, self.device, obs)
        for word in (carry.processed, carry.spawned, carry.max_occ,
                     carry.occ):
            word.zero_()
        self._carry = carry
        self._sizes = np.zeros(self.shards, np.int64)
        self._spray = 0
        self._rounds = 0
        self._host_syncs = 0
        self.admitted_log = []
        self.stats = {"rounds": 0, "processed": 0, "spawned": 0,
                      "max_occupancy": 0, "drained": 1, "host_syncs": 0}

    def occupancy(self) -> int:
        """Heap-resident requests (the host copy of the sizes, exact: the
        sizes change only inside ``tick``, which reads them back)."""
        return 0 if self._carry is None else int(self._sizes.sum())

    def _planes(self):
        """The heap planes (S, cap): every rank's gathered on a
        group-bound mesh (a collective: every rank calls it)."""
        keys, vals = self._carry.q[:2]
        if self.rank is not None:
            keys, vals = (p.reshape(self.shards, -1)
                          for p in gather_rows((keys, vals), self.mesh))
        return keys, vals

    def heap_state(self) -> DistHeapState:
        """The resident heap planes ``(keys (S, cap), vals, sizes)`` on the
        engine's device."""
        return DistHeapState(*self._planes(), self._carry.q[2])

    def resident(self) -> List[Tuple[int, int, int]]:
        """Heap-resident ``(key, idx, retry)`` triples (host readback)."""
        if self._carry is None:
            return []
        keys, vals = (p.cpu().numpy() for p in self._planes())
        out = []
        for s in range(self.shards):
            live = keys[s] != HEAP_KEY_INF
            for k, v in zip(keys[s][live], vals[s][live]):
                out.append((int(k), int(v) % self.table,
                            int(v) // self.table))
        return sorted(out)

    # -- the arrivals' insert into the resident planes -----------------------

    def _insert(self, ik: np.ndarray, iv: np.ndarray) -> None:
        """One insert wave over all S heaps (``heap_apply_grid``, a
        destination shard a lane, spraying round-robin from the kept
        pointer), after an overflow pre-check on the host copy of the
        sizes; the hints become each heap's root key."""
        n = len(ik)
        if n == 0:
            return
        c = self._carry
        shard_of = ((self._spray + np.arange(n)) % self.shards).astype(
            np.int32)
        self._spray = (self._spray + n) % self.shards
        counts = np.bincount(shard_of, minlength=self.shards)
        for s in range(self.shards):
            if counts[s] and self._sizes[s] + counts[s] > self.capacity:
                raise RuntimeError(
                    f"serving heap overflow: {int(counts[s])} arrivals "
                    f"land on shard {s} holding {int(self._sizes[s])} of "
                    f"{self.capacity} (raise capacity_log2 or shed load)")
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        keys, vals, sizes, hints = c.q[:4]
        rider = c.births
        self._heap((keys, vals), sizes, rider, opkeys=t(ik), opvals=t(iv),
                   dest=t(shard_of), oprider=None if rider is None else t(
                       np.int32(min(self._rounds, self.span_round_cap - 1))))
        self._sizes += counts
        if self.rank is None:
            hints.copy_(keys[:, 0])      # empty slots hold KEY_INF
        else:       # every root: the least of its key and its arrivals'
            hints.scatter_reduce_(0, t(shard_of).long(), t(ik), "amin")
            sizes.copy_(t(self._sizes.astype(np.int32)))
        c.occ.copy_(sizes.sum(dtype=torch.int32))

    @staticmethod
    def _split(total: int, shards: int) -> np.ndarray:
        base = total // shards
        return base + (np.arange(shards) < total % shards)

    # -- one serving tick -----------------------------------------------------

    def tick(self, new_keys: Sequence[int], new_idxs: Sequence[int], *,
             slots: int, pages: int, need: Sequence[int] = (),
             max_rounds: int = 256) -> List[int]:
        """Install this tick's arrivals, refresh the budgets, and run one
        chunk of rounds (to quiescence or the first stall).  Returns the
        admitted request-table indices in admission order.  Unlike
        ``_drive``, occupancy > 0 at exit is NOT an error — stalled
        requests stay resident for the next tick."""
        if self._carry is None:
            self.begin()
        ik = np.asarray(new_keys, np.int64).reshape(-1)
        iv = np.asarray(new_idxs, np.int64).reshape(-1)
        assert ik.shape == iv.shape
        _check_deadline_keys(ik)
        if iv.size and (iv.min() < 0 or iv.max() >= self.table):
            raise ValueError(
                f"request index outside the {self.table}-row table")
        # arrivals enter as retry-0 idents at their deadline keys
        self._insert(ik.astype(np.int32), iv.astype(np.int32))
        c, dev = self._carry, self.device
        acc = c.acc
        if len(need):
            nd = np.asarray(need, np.int32).reshape(-1)
            assert nd.shape == iv.shape
            acc["need"][..., torch.as_tensor(iv, device=dev)] = (
                torch.as_tensor(nd, device=dev))
        budget = torch.as_tensor(np.stack(
            [self._split(int(slots), self.shards),
             self._split(int(pages), self.shards)]).astype(np.int32),
            device=dev)
        if self.rank is not None:        # this rank's shares
            budget = budget[:, self.rank]
        acc["slots"].copy_(budget[0])
        acc["pages"].copy_(budget[1])
        acc["stalled"].zero_()
        # the admitted log is per-tick (bounded by ``slots`` ≤ table);
        # letting it accumulate would run off the table on long runs
        acc["adm_n"].zero_()
        limit = max_rounds
        if self.spans is not None:
            # stamp-time cap: no round past the cap may write a birth
            # stamp into the heap's rider plane
            if self._rounds >= self.span_round_cap:
                raise RuntimeError(
                    f"serving span round clock reached the birth-stamp cap "
                    f"({self.span_round_cap} rounds): stamps would wrap "
                    f"(run without spans or restart the engine)")
            limit = min(limit, self.span_round_cap - self._rounds)
        self._run_chunk(c, self._loop, limit)
        # a shard admits at most its share of the slots
        width = min(self.table, -(-max(int(slots), 0) // self.shards))
        s = self.shards
        adm_n, adm_idx = acc["adm_n"], acc["adm_idx"][..., :width]
        if self.rank is not None:        # every shard's log, gathered
            adm_n, adm_idx = gather_rows((adm_n, adm_idx.contiguous()),
                                         self.mesh)
        words = torch.cat([
            torch.stack([c.occ, c.rounds, c.oflow.to(torch.int32),
                         c.processed, c.spawned, c.max_occ]),
            c.q[2], adm_n.reshape(-1),
            adm_idx.reshape(-1)]).tolist()               # THE host sync
        occ, r, oflow, processed, spawned, max_occ = words[:6]
        if self._loop is not None:
            self._loop.count(r)
        self._sizes = np.asarray(words[6:6 + s], np.int64)
        adm_n = words[6 + s:6 + 2 * s]
        adm_idx = np.asarray(words[6 + 2 * s:], np.int64).reshape(s, width)
        self._rounds += r
        self._host_syncs += 1
        now = time.time()
        point = SyncPoint(rounds=self._rounds, occupancy=occ, wall_time=now,
                          host_syncs=self._host_syncs)
        self.sync_log.append(point)
        self.stats = {
            "rounds": self._rounds, "processed": processed,
            "spawned": spawned, "max_occupancy": max_occ,
            "drained": int(occ == 0), "host_syncs": self._host_syncs,
        }
        if self.telemetry is not None:
            self.telemetry.drain(c.tp, sync=self._host_syncs - 1,
                                 wall_time=now)
            self.telemetry.heartbeat(point)
            self.telemetry.finish(self.stats)
        if self.spans is not None:
            self.spans.drain(c.sp, wall_time=now)
            self.spans.finish(self.stats)
        if oflow:
            raise RuntimeError(
                f"serving admission overflow: occupancy {occ} + re-entries "
                f"exceed per-shard heap capacity {self.capacity} at round "
                f"{self._rounds} (raise capacity_log2)")
        admitted: List[int] = []
        for sh in range(s):
            admitted.extend(int(i) for i in adm_idx[sh, :int(adm_n[sh])])
        self.admitted_log.extend(admitted)
        return admitted

    # -- history readback for the p-linearizability checker ------------------

    def pop_history(self) -> List[Tuple[int, int, int, int]]:
        """All recorded pops as ``(round, shard, key, val)`` sorted by
        round (requires ``pop_log`` > 0; raises otherwise)."""
        if not self.pop_log:
            raise ValueError("construct with pop_log=N to record pops")
        acc = self._carry.acc
        if self.rank is not None:        # every shard's log, gathered
            acc = gather_rows({k: acc[k] for k in ("plk", "plv", "plr",
                                                   "pln")}, self.mesh)
        pln = acc["pln"].cpu().numpy()
        if int(pln.max(initial=0)) > self.pop_log:
            raise RuntimeError(
                f"pop log overflowed ({int(pln.max())} > {self.pop_log}): "
                f"raise pop_log")
        plk, plv, plr = (acc[k].cpu().numpy() for k in ("plk", "plv", "plr"))
        rows = []
        for s in range(self.shards):
            n = int(pln[s])
            rows.extend((int(r), s, int(k), int(v))
                        for r, k, v in zip(plr[s][:n], plk[s][:n],
                                           plv[s][:n]))
        rows.sort(key=lambda t: (t[0], t[1]))
        return rows


register_engine("serving", ServingMeshEngine, priority=True, mesh=True,
                kwargs={}, spans_ok=True)
