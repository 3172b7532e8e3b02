"""The port's queue core (``repro_torch.core``: G-LFQ, G-WFQ, G-WFQ-YMC and
the SFQ baseline under the adversarial interleaving scheduler, the packed
word layouts and the § IV linearizability checker) on the CPU, held
against the JAX package's ``repro.core``.

Both packages are plain Python here: the same seeded runs go through
each, and everything they produce must be equal, not close.  Covered:

* every queue algorithm under the ``random``, ``gang`` and ``rr``
  schedules at three seeds, through ``run_producer_consumer`` and
  ``run_balanced``: the histories event by event, the consumption log,
  the FIFO report, ``Scheduler.metrics()``, every thread's counters, the
  atomic op and traffic counts and the final ``AtomicMemory`` words, and
  the verdicts of ``check_linearizable`` and ``fast_violation_screen``;
* both checkers (and the Wing–Gong search) on the hand-built fixtures of
  ``tests/test_linearizability.py``, legal and violating;
* the packed formats' encode and decode on seeded random words;
* the starvation scenarios of ``tests/test_progress.py`` and the
  wave-batching counts of ``tests/test_sim_waves.py``."""

import dataclasses
import importlib.util
import os
import random

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import linearizability as jlin  # noqa: E402
from repro.core import packed as jpacked  # noqa: E402
from repro_torch.core import linearizability as tlin  # noqa: E402
from repro_torch.core import packed as tpacked  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ALGOS = sorted(J.QUEUE_CLASSES)
POLICIES = ("random", "gang", "rr")
SEEDS = (0, 1, 2)
# tests/test_linearizability.py CASES: tiny patience forces the wait-free
# designs' slow paths
QUEUE_KW = {"glfq": {}, "gwfq": dict(patience=2, help_delay=4),
            "gwfq-ymc": dict(patience=2, help_delay=4), "sfq": {}}


def _memory(mem):
    return ({k: v.tolist() for k, v in mem._arrays.items()},
            dict(mem.op_counts), dict(mem.word_traffic),
            dict(mem.rmw_traffic))


def _threads(sched):
    return [(t.tid, t.wave, t.lane, t.done, t.steps, t.succ_enq,
             t.succ_deq, t.stall_steps, t.op_steps) for t in sched.threads]


def _run_state(pkg, sched):
    """Everything a finished run exposes, as plain values."""
    hist = sched.history
    return {"history": [dataclasses.astuple(e) for e in hist],
            "metrics": sched.metrics(), "steps": sched.step_count,
            "threads": _threads(sched), "memory": _memory(sched.mem),
            "linearizable": dataclasses.astuple(
                pkg.check_linearizable(hist)),
            "screen": dataclasses.astuple(pkg.fast_violation_screen(hist))}


def _producer_consumer(pkg, algo, policy, seed):
    q = pkg.QUEUE_CLASSES[algo](capacity=8, num_threads=8, **QUEUE_KW[algo])
    sched, sink, rep = pkg.run_producer_consumer(
        q, producers=4, consumers=4, ops_per_producer=10, policy=policy,
        seed=seed, max_steps=3_000_000)
    return dict(_run_state(pkg, sched), sink=sink,
                report=dataclasses.astuple(rep))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("algo", ALGOS)
def test_producer_consumer_equals_reference(algo, policy, seed):
    ref = _producer_consumer(J, algo, policy, seed)
    got = _producer_consumer(T, algo, policy, seed)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key] == ref[key], key
    assert got["report"][0], got["report"]
    assert got["linearizable"][0], got["linearizable"]


def _balanced(pkg, algo, policy, seed):
    q = pkg.QUEUE_CLASSES[algo](capacity=16, num_threads=8,
                                **QUEUE_KW[algo])
    sched = pkg.run_balanced(q, threads=8, ops=6, policy=policy, seed=seed,
                             max_steps=2_000_000)
    return _run_state(pkg, sched)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("algo", ALGOS)
def test_balanced_equals_reference(algo, policy, seed):
    ref = _balanced(J, algo, policy, seed)
    got = _balanced(T, algo, policy, seed)
    for key in ref:
        assert got[key] == ref[key], key
    assert all(t[3] for t in got["threads"]), "a worker did not finish"
    assert got["linearizable"][0], got["linearizable"]


def test_queue_classes_mirror_the_reference():
    assert set(J.__all__) <= set(T.__all__)
    assert sorted(T.QUEUE_CLASSES) == ALGOS
    for name, cls in T.QUEUE_CLASSES.items():
        assert cls.__name__ == J.QUEUE_CLASSES[name].__name__
        assert cls.__module__.startswith("repro_torch.core.")


# -- the checkers on hand-built histories -------------------------------------


def _fixtures():
    spec = importlib.util.spec_from_file_location(
        "_lin_fixtures", os.path.join(HERE, "test_linearizability.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.VIOLATIONS, mod.LEGAL


VIOLATIONS, LEGAL = _fixtures()
FIXTURES = [(k, False) for k in VIOLATIONS] + [(k, True) for k in LEGAL]


def _as(pkg, hist):
    return [pkg.HistoryEvent(*dataclasses.astuple(e)) for e in hist]


@pytest.mark.parametrize("case,legal", FIXTURES,
                         ids=[k for k, _ in FIXTURES])
def test_checkers_on_fixtures_equal_reference(case, legal):
    """Pattern checker, fast screen and Wing–Gong search: the same
    verdict, reason and node count as the reference's on each fixture."""
    hist = (LEGAL if legal else VIOLATIONS)[case]
    for name in ("check_linearizable", "check_linearizable_search",
                 "fast_violation_screen"):
        ref = getattr(jlin, name)(_as(J, hist))
        got = getattr(tlin, name)(_as(T, hist))
        assert dataclasses.astuple(got) == dataclasses.astuple(ref), name
    assert tlin.check_linearizable(_as(T, hist)).ok == legal
    assert tlin.check_linearizable_search(_as(T, hist)).ok == legal


@pytest.mark.parametrize("algo", ("glfq", "gwfq"))
def test_search_checker_on_real_histories(algo):
    """tests/test_linearizability.py's cross-check: pattern checker and
    search agree on small real histories, in both packages alike."""
    out = []
    for pkg, lin in ((J, jlin), (T, tlin)):
        q = pkg.QUEUE_CLASSES[algo](capacity=4, num_threads=4,
                                    **QUEUE_KW[algo])
        sched, _, rep = pkg.run_producer_consumer(
            q, producers=2, consumers=2, ops_per_producer=6,
            policy="random", seed=7, max_steps=2_000_000)
        out.append((dataclasses.astuple(rep),
                    dataclasses.astuple(lin.check_linearizable(
                        sched.history)),
                    dataclasses.astuple(lin.check_linearizable_search(
                        sched.history))))
    assert out[0] == out[1]
    assert out[1][1][0] and out[1][2][0]


# -- packed formats -----------------------------------------------------------

FORMATS = {
    "EntryFormat": ("pack", ("cycle", "safe", "enq", "idx"),
                    ("idx_mask", "cycle_mask", "cycle_range", "enq_shift",
                     "safe_shift", "cycle_shift", "idx_bot", "idx_botc")),
    "GlobalFormat": ("pack", ("cnt", "thridx"),
                     ("tid_mask", "null_tid", "cnt_mask")),
    "LocalFormat": ("pack", ("lcnt", "seq", "inc", "fin"),
                    ("seq_mask", "lcnt_mask")),
    "RequestFormat": ("pack", ("value", "seq", "pending", "isenq"),
                      ("seq_mask", "val_mask")),
    "ResultFormat": ("pack", ("value", "seq", "done", "empty"),
                     ("seq_mask", "val_mask")),
    "NoteFormat": ("pack", ("cycle", "seq", "valid"), ("seq_mask",)),
}


def _outcome(fn, args):
    """``fn(*args)``, or the type of what it raised (the formats assert
    their fields' ranges)."""
    try:
        return fn(*args)
    except AssertionError as e:
        return type(e).__name__


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_packed_formats_equal_reference(fmt):
    """Seeded random 64-bit words decode field by field, and seeded
    random fields pack, to the same values in both packages."""
    _, fields, consts = FORMATS[fmt]
    jf, tf = getattr(jpacked, fmt)(), getattr(tpacked, fmt)()
    assert dataclasses.astuple(tf) == dataclasses.astuple(jf)
    for c in consts:
        assert getattr(tf, c) == getattr(jf, c), c
    rng = random.Random(sum(map(ord, fmt)))
    for _ in range(500):
        w = rng.getrandbits(64)
        for f in fields:
            assert getattr(tf, f)(w) == getattr(jf, f)(w), (f, w)
        args = [rng.getrandbits(rng.choice((1, 4, 8, 16))) for _ in fields]
        assert _outcome(tf.pack, args) == _outcome(jf.pack, args), args
    if fmt == "EntryFormat":
        for _ in range(500):
            a, b, w = (rng.getrandbits(64) for _ in range(3))
            i = rng.getrandbits(31)
            assert tf.cycle_lt(a, b) == jf.cycle_lt(a, b)
            assert tf.cycle_eq(a, b) == jf.cycle_eq(a, b)
            assert tf.with_idx(w, i) == jf.with_idx(w, i)
            assert tf.is_empty_idx(w) == jf.is_empty_idx(w)
    assert tpacked.MASK64 == jpacked.MASK64 == (1 << 64) - 1


# -- progress: the starvation scenarios of tests/test_progress.py -------------


def _starving(base):
    class StarvingScheduler(base):
        """Runs the victim (tid 0) only once every ``starve`` steps;
        everyone else round-robins (tests/test_progress.py)."""

        def __init__(self, *args, starve: int = 64, **kw):
            super().__init__(*args, **kw)
            self.starve = starve
            self._last_victim = 0

        def _pick(self):
            live = self.runnable()
            if not live:
                return None
            victim = next((t for t in live if t.tid == 0), None)
            others = [t for t in live if t.tid != 0]
            due = self.step_count - self._last_victim >= self.starve
            if victim is not None and (due or not others):
                self._last_victim = self.step_count
                return victim
            if others:
                return others[self.step_count % len(others)]
            return victim
    return StarvingScheduler


def _run_starved(pkg, name, kw, ops=30, starve=64):
    from importlib import import_module
    base = import_module(pkg.__name__ + ".base")
    q = pkg.QUEUE_CLASSES[name](capacity=64, num_threads=8, **kw)
    mem = pkg.AtomicMemory()
    q.init(mem)
    sched = _starving(pkg.Scheduler)(mem, wave_size=8, policy="rr",
                                     starve=starve)
    done = {"victim": False}

    def victim(ctx, tid):
        for k in range(ops):
            v = (1 << 20) | k
            yield from ctx.op_begin(pkg.ENQ, v)
            ok = yield from q.enqueue(ctx, tid, v)
            yield from ctx.op_end(ok, ok)
            yield from ctx.op_begin(pkg.DEQ, None)
            ok, _ = yield from q.dequeue(ctx, tid)
            yield from ctx.op_end(None, ok)
        done["victim"] = True

    def antagonist(ctx, tid):
        k = 0
        while not done["victim"]:
            v = ((tid << 16) | (k & 0xFFFF)) & base.VAL_MASK
            yield from ctx.op_begin(pkg.ENQ, v)
            ok = yield from q.enqueue(ctx, tid, v)
            yield from ctx.op_end(ok, ok)
            yield from ctx.op_begin(pkg.DEQ, None)
            ok, _ = yield from q.dequeue(ctx, tid)
            yield from ctx.op_end(None, ok)
            k += 1

    sched.spawn(victim)
    for _ in range(7):
        sched.spawn(antagonist)
    sched.run(3_000_000)
    return (done["victim"], sched.threads[0].steps, sched.metrics(),
            _threads(sched), len(sched.history))


@pytest.mark.parametrize("name,kw,ops,finishes", [
    ("gwfq", dict(patience=4, help_delay=8), 30, True),
    ("gwfq-ymc", dict(patience=4, help_delay=8), 30, True),
    ("glfq", {}, 10, False),
], ids=("gwfq", "gwfq-ymc", "glfq"))
def test_starvation_equals_reference(name, kw, ops, finishes):
    """A 64x-starved victim: the wait-free designs finish it, G-LFQ does
    not (Theorems III.4 / III.10) — with the same step counts, metrics
    and history length in both packages."""
    ref = _run_starved(J, name, kw, ops)
    got = _run_starved(T, name, kw, ops)
    assert got == ref
    assert got[0] is finishes
    per_op = got[1] / (ops * 2)
    assert (per_op < 400) if finishes else (per_op > 400)


# -- wave batching: tests/test_sim_waves.py -----------------------------------


def _balanced_waves(pkg, policy, threads=64, steps=60_000):
    from importlib import import_module
    base = import_module(pkg.__name__ + ".base")
    q = pkg.QUEUE_CLASSES["glfq"](capacity=128, num_threads=threads)
    mem = pkg.AtomicMemory()
    q.init(mem)
    sched = pkg.Scheduler(mem, wave_size=8, policy=policy, seed=0)

    def worker(ctx, tid):
        k = 0
        while True:
            v = ((tid << 16) | (k & 0xFFFF)) & base.VAL_MASK
            yield from ctx.op_begin(pkg.ENQ, v)
            ok = yield from q.enqueue(ctx, tid, v)
            yield from ctx.op_end(ok, ok)
            yield from ctx.op_begin(pkg.DEQ, None)
            ok, o = yield from q.dequeue(ctx, tid)
            yield from ctx.op_end(o if ok else None, ok)
            k += 1

    for _ in range(threads):
        sched.spawn(worker)
    sched.run(steps)
    m = sched.metrics()
    hot = (mem.rmw_traffic.get("glfq_tail", 0)
           + mem.rmw_traffic.get("glfq_head", 0))
    return hot / max(m["successful_ops"], 1), m, _memory(mem)


def test_wave_batching_counts_equal_reference():
    """Gang scheduling gets within 2x of 1/wave_size hot-word RMWs per op
    and random does not — the same counts in both packages."""
    out = {}
    for policy in ("gang", "random"):
        ref = _balanced_waves(J, policy)
        got = _balanced_waves(T, policy)
        assert got == ref, policy
        out[policy] = got[0]
    assert out["gang"] < 0.25
    assert out["random"] > 2 * out["gang"]


def test_wavefaa_defer_equals_reference():
    """A permanently diverged lane does not stall its wave: the same
    tickets come out in both packages."""
    got = {}
    for pkg in (J, T):
        mem = pkg.AtomicMemory()
        mem.alloc("ctr", 1)
        sched = pkg.Scheduler(mem, wave_size=4, policy="gang", seed=0)
        tickets = []

        def spinner(ctx, tid):
            while True:
                yield from ctx.step()

        def claimer(ctx, tid, tickets=tickets):
            t = yield from ctx.wavefaa("ctr", 0)
            tickets.append(t)

        sched.spawn(spinner)
        for _ in range(3):
            sched.spawn(claimer)
        sched.run(5_000)
        got[pkg.__name__] = (tickets, sched.step_count, _memory(mem))
    assert got["repro_torch.core"] == got["repro.core"]
    assert sorted(got["repro_torch.core"][0]) == [0, 1, 2]


def test_atomics_wrap_and_sign_equal_reference():
    """AtomicMemory's 64-bit masking and signed helpers on seeded words."""
    rng = np.random.default_rng(3)
    mems = [J.AtomicMemory(), T.AtomicMemory()]
    for m in mems:
        m.alloc("w", 4, fill=-1)
    for _ in range(300):
        i = int(rng.integers(0, 4))
        d = int(rng.integers(-2 ** 63, 2 ** 63))
        kind = int(rng.integers(0, 4))
        res = []
        for m in mems:
            if kind == 0:
                res.append(m.faa("w", i, d))
            elif kind == 1:
                res.append(m.cas("w", i, m.load("w", i), d))
            elif kind == 2:
                res.append(m.fetch_or("w", i, d & ((1 << 64) - 1)))
            else:
                res.append(m.fetch_and("w", i, d & ((1 << 64) - 1)))
        assert res[0] == res[1]
        assert J.AtomicMemory.to_signed(res[0]) == \
            T.AtomicMemory.to_signed(res[1])
    assert _memory(mems[0]) == _memory(mems[1])
