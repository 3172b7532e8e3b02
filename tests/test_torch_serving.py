"""The port's serving engine (``repro_torch.serving``) held against the
JAX reference's ``ServingEngine`` on the same request traces, on the CPU.

Both engines run the same reduced model: the reference's ``init_params``
cast to float32, handed to the port through ``params_from_numpy``.  The
schedule does not depend on the tokens, so ``metrics``, the admission
log, every request's deadline and submit/admit/finish ticks, and (with a
registry) the whole metrics snapshot must be equal.  The engines feed
each slot the last token of its prompt at every decode step (the
reference does not feed generated tokens back), so the logits of every
step depend on the trace alone: they must agree within ``TOL``, and
each row's argmax must be equal wherever the reference's top-2 margin
exceeds ``TOL``.  ``TOL`` = 5e-3 is the bound of the bfloat16 decode
caches (``tests/test_torch_models.py``).  Each case checks that nearly
every row was compared.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.serving.engine import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serving import (EngineConfig, Request,  # noqa: E402
                                 ServingEngine)

TOL = 5e-3


@functools.lru_cache(maxsize=None)
def _model(name):
    jcfg, cfg = jget(name).reduced(), get_config(name).reduced()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jinit(jcfg))
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")


def _drive(port, name, ecfg_kw, trace, registry=False):
    """Run one engine over ``trace`` (rid, prompt, max_new, priority,
    tenant) with every request submitted before the first tick; returns
    (engine, requests, per-step logits)."""
    jcfg, cfg, jp, tp = _model(name)
    if port:
        eng = ServingEngine(cfg, tp, EngineConfig(**ecfg_kw),
                            MetricsRegistry() if registry else None,
                            device="cpu")
    else:
        eng = JEngine(jcfg, jp, JConfig(**ecfg_kw),
                      JRegistry() if registry else None)
    logits = []
    step = eng._step

    def recording(p, c, t, cur):
        lg, nc = step(p, c, t, cur)
        logits.append(np.asarray(lg[:, -1].float() if port else lg[:, -1]))
        return lg, nc

    eng._step = recording
    make = Request if port else JRequest
    reqs = [make(rid=rid, prompt=prompt, max_new_tokens=new,
                 priority=prio, tenant=tenant)
            for rid, prompt, new, prio, tenant in trace]
    for r in reqs:
        assert eng.submit(r)
    eng.run(max_ticks=2000)
    return eng, reqs, logits


def _serve_trace(cfg, requests=8, prompt_len=6, max_new=8):
    """``launch/serve.py``'s trace: prompts from default_rng(0)."""
    rng = np.random.default_rng(0)
    return [(rid, rng.integers(0, cfg.vocab, prompt_len).astype(np.int32),
             max_new, 1, 0) for rid in range(requests)]


def _compare(name, ecfg_kw, trace, registry=False):
    j, jreqs, jlog = _drive(False, name, ecfg_kw, trace, registry)
    t, treqs, tlog = _drive(True, name, ecfg_kw, trace, registry)
    assert t.metrics == j.metrics
    assert t.admission_log == j.admission_log
    assert t.tick == j.tick
    for a, b in zip(treqs, jreqs):
        assert (a.deadline, a.submit_tick, a.admit_tick, a.finish_tick,
                a.done, len(a.out)) == \
            (b.deadline, b.submit_tick, b.admit_tick, b.finish_tick,
             b.done, len(b.out))
    if registry:
        assert t.registry.snapshot() == j.registry.snapshot()
        assert t.wait_percentiles() == j.wait_percentiles()
    assert len(tlog) == len(jlog) == j.metrics["decode_steps"]
    rows = compared = 0
    for lt, lj in zip(tlog, jlog):
        np.testing.assert_allclose(lt, lj, atol=TOL, rtol=0)
        top2 = np.sort(lj, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > TOL
        np.testing.assert_array_equal(lt.argmax(-1)[clear],
                                      lj.argmax(-1)[clear])
        rows += len(clear)
        compared += int(clear.sum())
    assert compared >= 0.9 * rows, (compared, rows)
    if compared == rows:
        assert [r.out for r in treqs] == [r.out for r in jreqs]
    return t


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "h2o-danube-1.8b"])
def test_serve_defaults_match_reference(name):
    """``launch/serve.py``'s defaults: 8 requests, prompts of 6, 8 new
    tokens, 4 slots, 32 pages of 32 tokens, max_seq 64."""
    cfg = get_config(name).reduced()
    eng = _compare(name, dict(max_slots=4, num_pages=32, page_size=32,
                              max_seq=64), _serve_trace(cfg))
    assert eng.metrics["completed"] == 8 and eng.host_syncs == \
        eng.metrics["decode_steps"]


def test_page_stalls_match_reference():
    """One page for requests that each need one: admission serializes and
    the RETRY path re-enters the pool at the original deadline."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    trace = _serve_trace(cfg, requests=4, prompt_len=4, max_new=4)
    eng = _compare("h2o-danube-1.8b",
                   dict(max_slots=2, page_size=16, num_pages=1, max_seq=64),
                   trace)
    assert eng.metrics["page_stalls"] > 0 and eng.metrics["completed"] == 4
    free = 0
    while eng.free_pages.dequeue(timeout=0.0) is not None:
        free += 1
    assert free == 1


def test_two_tenant_policies_match_reference():
    """Two tenants under the strict and weighted policies, urgent and
    normal classes mixed, pages tight enough to stall; the registries'
    snapshots (counters, gauges, wait histograms) must be equal."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    rng = np.random.default_rng(5)
    trace = [(rid, rng.integers(0, cfg.vocab, int(rng.integers(2, 6)))
              .astype(np.int32), int(rng.integers(1, 4)),
              int(rng.integers(0, 2)), rid % 2) for rid in range(10)]
    eng = _compare("granite-moe-3b-a800m",
                   dict(max_slots=2, page_size=4, num_pages=3, max_seq=32,
                        request_ring_capacity=32, tenants=2,
                        tenant_policies=("strict", "weighted")),
                   trace, registry=True)
    assert eng.metrics["completed"] == 10
    assert eng.metrics["page_stalls"] > 0


def test_unported_admission_modes_raise():
    """``lanes`` (the host task pool) still raises and cites Queue A11;
    ``device`` is ported and builds its admission engine."""
    _, cfg, _, tp = _model("h2o-danube-1.8b")
    with pytest.raises(NotImplementedError, match="A11"):
        ServingEngine(cfg, tp, EngineConfig(admission="lanes"), device="cpu")
    eng = ServingEngine(cfg, tp, EngineConfig(admission="device"),
                        device="cpu")
    assert eng._device.shards == 1 and eng._queue_empty()


def test_device_admission_serves_like_the_reference_pool():
    """``admission="device"`` on the port against the reference's host
    pool on the same trace, pages tight enough to stall: the same
    admission log, metrics and per-request ticks."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    rng = np.random.default_rng(6)
    trace = [(rid, rng.integers(0, cfg.vocab, int(rng.integers(2, 6)))
              .astype(np.int32), int(rng.integers(1, 4)),
              int(rng.integers(0, 2)), 0) for rid in range(8)]
    kw = dict(max_slots=2, page_size=4, num_pages=3, max_seq=32,
              request_ring_capacity=32)
    port, preqs, _ = _drive(True, "granite-moe-3b-a800m",
                            dict(kw, admission="device",
                                 device_capacity_log2=6, device_batch=4,
                                 device_table_log2=6), trace)
    ref, rreqs, _ = _drive(False, "granite-moe-3b-a800m", kw, trace)
    assert port.admission_log == ref.admission_log
    assert port.metrics == ref.metrics and port.metrics["completed"] == 8
    assert port.metrics["page_stalls"] > 0
    for a, b in zip(preqs, rreqs):
        assert (a.deadline, a.admit_tick, a.finish_tick) == \
            (b.deadline, b.admit_tick, b.finish_tick)
