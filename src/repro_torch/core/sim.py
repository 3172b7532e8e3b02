"""Adversarial interleaving simulator for the GPU queue algorithms.

A copy of ``repro/core/sim.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

Threads are Python generators that *yield* atomic-instruction requests; the
scheduler executes each request indivisibly against an `AtomicMemory` and
resumes the thread with the result.  This gives a faithful model of
concurrent execution at atomic granularity: any interleaving the scheduler
chooses is an execution the GPU memory system could produce.

Wave semantics
--------------
Threads are grouped into fixed *waves* of ``wave_size`` lanes (AMD wavefront
analogue).  The ``wavefaa`` instruction implements the paper's WAVEFAA
(Alg. 1): when a thread blocks on ``wavefaa(counter)``, the scheduler forms
the *active mask* from all lanes of the same wave that are currently blocked
on a ``wavefaa`` of the same counter, performs **one** fetch-and-add by the
mask's popcount, and resumes each lane with ``base + rank`` where rank is the
lane's prefix rank within the mask — exactly Lemma III.1.  The mask contains
only converged lanes, matching SIMT ballot semantics: in `gang` scheduling
mode lanes of a wave are co-scheduled so they usually arrive together (high
batching occupancy, the regime of Fig. 1); in `random` mode convergence is
emergent and batches are smaller, which only changes *how many* atomics are
issued, never the ticket order (Lemma III.1's observational equivalence — we
property-test this).

Histories & metrics
-------------------
Queue operations bracket themselves with ``op_begin``/``op_end`` events.  The
scheduler records a concurrent history (proc, op, arg, ret, call, end) in the
paper's § IV format for the linearizability checker, and derives the paper's
normalized § V-C metrics:

* ``steps/op``        — state-machine transitions per successful operation
                        (VALU/op analogue),
* ``stall-steps/op``  — transitions spent in attempts that did not commit
                        (failed fast-path rounds, spins, helping) per
                        successful operation (WAIT/op analogue).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generator, Iterable, List, Optional, Tuple

from .atomics import AtomicMemory
from .packed import EntryFormat

# Instruction opcodes yielded by thread generators.
LOAD, STORE, FAA, CAS, CONSUME, WAVEFAA, FETCH_OR, FETCH_AND, OP_BEGIN, OP_END, YIELD = (
    "load", "store", "faa", "cas", "consume", "wavefaa", "fetch_or", "fetch_and",
    "op_begin", "op_end", "yield",
)

ENQ, DEQ = 0, 1  # paper § IV history encoding: op=0 ENQ, op=1 DEQ


@dataclass
class HistoryEvent:
    proc: int
    op: int          # 0 = ENQ, 1 = DEQ
    arg: Optional[int]
    ret: Optional[Any]
    call: int        # scheduler step of invocation
    end: int         # scheduler step of response


@dataclass
class ThreadState:
    tid: int
    wave: int
    lane: int
    gen: Generator
    pending: Optional[Tuple] = None   # instruction awaiting execution
    done: bool = False
    steps: int = 0
    cur_op: Optional[Tuple] = None    # (op, arg, call_step, steps_at_begin)
    # Metrics:
    succ_enq: int = 0
    succ_deq: int = 0
    stall_steps: int = 0
    op_steps: int = 0                 # steps inside committed ops


class Ctx:
    """Per-thread instruction issue helper.  All methods are sub-generators —
    queue code uses ``yield from ctx.faa(...)`` etc."""

    def load(self, arr: str, i: int):
        return (yield (LOAD, arr, i))

    def store(self, arr: str, i: int, v: int):
        return (yield (STORE, arr, i, v))

    def faa(self, arr: str, i: int, d: int):
        return (yield (FAA, arr, i, d))

    def cas(self, arr: str, i: int, exp: int, new: int):
        return (yield (CAS, arr, i, exp, new))

    def consume(self, arr: str, i: int, fmt: EntryFormat):
        return (yield (CONSUME, arr, i, fmt))

    def wavefaa(self, arr: str, i: int, d: int = 1):
        """WAVEFAA — returns this lane's ticket (base + prefix rank)."""
        return (yield (WAVEFAA, arr, i, d))

    def fetch_or(self, arr: str, i: int, mask: int):
        return (yield (FETCH_OR, arr, i, mask))

    def fetch_and(self, arr: str, i: int, mask: int):
        return (yield (FETCH_AND, arr, i, mask))

    def op_begin(self, op: int, arg: Optional[int]):
        return (yield (OP_BEGIN, op, arg))

    def op_end(self, ret: Any, success: bool):
        return (yield (OP_END, ret, success))

    def step(self):
        """A pure-compute step (no memory traffic) — lets the scheduler
        preempt between local computations."""
        return (yield (YIELD,))


CTX = Ctx()


class Scheduler:
    """Executes a set of thread generators under a chosen interleaving policy.

    Policies:
      * ``random``  — uniformly random runnable thread each step (adversarial
                      coverage for linearizability checking),
      * ``gang``    — pick a wave, run its lanes round-robin for a burst
                      (SIMT-like; maximizes WAVEFAA batching occupancy),
      * ``rr``      — global round-robin.
    """

    def __init__(
        self,
        mem: AtomicMemory,
        *,
        wave_size: int = 8,
        policy: str = "gang",
        seed: int = 0,
        gang_burst: int = 24,
    ) -> None:
        self.mem = mem
        self.wave_size = wave_size
        self.policy = policy
        self.rng = random.Random(seed)
        self.gang_burst = gang_burst
        self.threads: List[ThreadState] = []
        self.history: List[HistoryEvent] = []
        self.step_count = 0
        self._gang_wave = 0
        self._gang_left = 0
        self._wf_defer = 0  # SIMT-reconvergence defer counter (gang policy)

    # -- thread management ---------------------------------------------------

    def spawn(self, fn: Callable[..., Generator], *args) -> ThreadState:
        tid = len(self.threads)
        wave, lane = divmod(tid, self.wave_size)
        th = ThreadState(tid=tid, wave=wave, lane=lane, gen=fn(CTX, tid, *args))
        self.threads.append(th)
        # Prime the generator to its first instruction.
        self._advance(th, None)
        return th

    def _advance(self, th: ThreadState, send_val) -> None:
        try:
            th.pending = th.gen.send(send_val)
        except StopIteration:
            th.pending = None
            th.done = True

    # -- instruction execution ------------------------------------------------

    def _exec(self, th: ThreadState) -> None:
        ins = th.pending
        th.steps += 1
        self.step_count += 1
        kind = ins[0]
        if kind == WAVEFAA:
            self._exec_wavefaa(th)
            return
        m = self.mem
        if kind == LOAD:
            res = m.load(ins[1], ins[2])
        elif kind == STORE:
            res = m.store(ins[1], ins[2], ins[3])
        elif kind == FAA:
            res = m.faa(ins[1], ins[2], ins[3])
        elif kind == CAS:
            res = m.cas(ins[1], ins[2], ins[3], ins[4])
        elif kind == CONSUME:
            res = m.consume(ins[1], ins[2], ins[3])
        elif kind == FETCH_OR:
            res = m.fetch_or(ins[1], ins[2], ins[3])
        elif kind == FETCH_AND:
            res = m.fetch_and(ins[1], ins[2], ins[3])
        elif kind == OP_BEGIN:
            th.cur_op = (ins[1], ins[2], self.step_count, th.steps)
            res = None
        elif kind == OP_END:
            op, arg, call, steps0 = th.cur_op
            ret, success = ins[1], ins[2]
            self.history.append(
                HistoryEvent(proc=th.tid, op=op, arg=arg, ret=ret,
                             call=call, end=self.step_count)
            )
            used = th.steps - steps0
            if success:
                th.op_steps += used
                if op == ENQ:
                    th.succ_enq += 1
                else:
                    th.succ_deq += 1
            else:
                th.stall_steps += used
            th.cur_op = None
            res = None
        elif kind == YIELD:
            res = None
        else:  # pragma: no cover
            raise ValueError(f"unknown instruction {kind!r}")
        self._advance(th, res)

    def _exec_wavefaa(self, th: ThreadState) -> None:
        """Form the active mask from converged lanes of th's wave and issue a
        single batched FAA (Alg. 1 WAVEFAA)."""
        _, arr, i, d = th.pending
        members = [
            t for t in self.threads
            if (not t.done and t.wave == th.wave and t.pending is not None
                and t.pending[0] == WAVEFAA and t.pending[1] == arr
                and t.pending[2] == i)
        ]
        members.sort(key=lambda t: t.lane)  # prefix rank by lane id
        deltas = [t.pending[3] for t in members]
        count = sum(deltas)
        base = self.mem.faa(arr, i, count)  # ONE atomic for the whole mask
        rank = 0
        for t, delta in zip(members, deltas):
            if t is not th:
                t.steps += 1  # each lane still executes the instruction
                self.step_count += 1
            self._advance(t, base + rank)  # ticket = base + prefix rank
            rank += delta

    # -- scheduling loop -------------------------------------------------------

    def runnable(self) -> List[ThreadState]:
        return [t for t in self.threads if not t.done]

    def _pick(self) -> Optional[ThreadState]:
        live = self.runnable()
        if not live:
            return None
        if self.policy == "random":
            return self.rng.choice(live)
        if self.policy == "rr":
            return live[self.step_count % len(live)]
        # gang: stay on one wave for a burst
        if self._gang_left <= 0:
            waves = sorted({t.wave for t in live})
            self._gang_wave = self.rng.choice(waves)
            self._gang_left = self.gang_burst
        wave_live = [t for t in live if t.wave == self._gang_wave]
        if not wave_live:
            self._gang_left = 0
            return self._pick()
        self._gang_left -= 1
        # SIMT reconvergence: lanes stopped at WAVEFAA wait for the rest of
        # the wave to arrive (a ballot takes whoever is converged); keep
        # advancing the non-arrived lanes first, with a defer budget so a
        # permanently-diverged lane cannot deadlock the wave.
        at_wf = [t for t in wave_live if t.pending and t.pending[0] == WAVEFAA]
        not_wf = [t for t in wave_live if t not in at_wf]
        if at_wf and not_wf and self._wf_defer < 4 * len(wave_live):
            self._wf_defer += 1
            return not_wf[self.step_count % len(not_wf)]
        self._wf_defer = 0
        pool = at_wf if at_wf else wave_live
        return pool[self.step_count % len(pool)]

    def run(self, max_steps: int = 1_000_000) -> bool:
        """Run until all threads finish or the step budget is exhausted.
        Returns True if all threads completed."""
        while self.step_count < max_steps:
            th = self._pick()
            if th is None:
                return True
            self._exec(th)
        return not self.runnable()

    # -- metrics ----------------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        succ = sum(t.succ_enq + t.succ_deq for t in self.threads)
        stall = sum(t.stall_steps for t in self.threads)
        steps = sum(t.steps for t in self.threads)
        return {
            "successful_ops": succ,
            "total_steps": steps,
            "steps_per_op": steps / max(succ, 1),
            "stall_steps_per_op": stall / max(succ, 1),
            "atomics": self.mem.total_atomics(),
            "atomics_per_op": self.mem.total_atomics() / max(succ, 1),
            "throughput_ops_per_kstep": 1000.0 * succ / max(self.step_count, 1),
        }
