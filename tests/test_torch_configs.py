"""The port's copies of the reference's configs, host pools, policies,
metrics registry and free-page ring, held equal to the originals."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import HostRing as JHostRing  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.sched.hostpq import HostPriorityPool as JPool  # noqa: E402
from repro.sched.policy import make_policy as jmake_policy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import HostRing  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.sched import HostPriorityPool, make_policy  # noqa: E402

NAMES = sorted(jconfigs.ARCHS)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_same_architectures_and_shapes():
    assert sorted(configs.ARCHS) == NAMES == configs.list_archs()
    assert configs.SHAPES == jconfigs.SHAPES


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equal_field_by_field(name, reduced):
    want = jconfigs.get_config(name)
    got = configs.get_config(name)
    if reduced:
        want, got = want.reduced(), got.reduced()
        assert got == configs.get_config(name + "-smoke")
    assert _fields(got) == _fields(want)
    assert (got.hd, got.param_count(), got.active_param_count()) == \
        (want.hd, want.param_count(), want.active_param_count())
    assert [got.window_for_layer(i) for i in range(got.n_layers)] == \
        [want.window_for_layer(i) for i in range(want.n_layers)]


def test_granite_full_width_counts():
    cfg = configs.get_config("granite-moe-3b-a800m")
    assert cfg.param_count() == 3_374_295_552
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.vocab) == \
        (32, 1536, 24, 8, 64, 40, 8, 512, 49155)


@pytest.mark.parametrize("spec", ["strict", "weighted", "edf"])
def test_policies_give_the_same_keys(spec):
    rng = np.random.default_rng(len(spec))
    a, b = make_policy(spec), jmake_policy(spec)
    for now in range(1, 60):
        prio = int(rng.integers(0, 2))
        dl = None if rng.random() < 0.7 else int(rng.integers(0, 500))
        assert a.key(prio, dl, now) == b.key(prio, dl, now)
    with pytest.raises(ValueError):
        make_policy("nope")


def test_priority_pool_same_order_and_rejects():
    a, b = HostPriorityPool(8), JPool(8)
    rng = np.random.default_rng(1)
    for i in range(12):
        k = int(rng.integers(0, 5))
        assert a.enqueue(i, key=k, timeout=0.0) == \
            b.enqueue(i, key=k, timeout=0.0)
        if i % 3 == 2:
            assert a.peek_key() == b.peek_key()
            assert a.dequeue(timeout=0.0) == b.dequeue(timeout=0.0)
    out_a = [a.dequeue(timeout=0.0) for _ in range(10)]
    out_b = [b.dequeue(timeout=0.0) for _ in range(10)]
    assert out_a == out_b and a.metrics == b.metrics and a.empty()


def test_host_ring_fifo_and_backpressure():
    a, b = HostRing(4), JHostRing(4)
    for i in range(6):
        assert a.enqueue(i, timeout=0.0) == b.enqueue(i, timeout=0.0)
    assert [a.dequeue(timeout=0.0) for _ in range(5)] == \
        [b.dequeue(timeout=0.0) for _ in range(5)]
    assert a.empty() and b.empty()


def test_metrics_registry_same_snapshot():
    a, b = MetricsRegistry(), JRegistry()
    for reg in (a, b):
        reg.counter("serving.admitted", 3)
        reg.gauge("serving.free_pages", 7)
        for v in (1, 5, 2, 9):
            reg.observe("serving.wait[cls=1]", v)
    assert a.snapshot() == b.snapshot()
    assert a.filtered("serving") == b.filtered("serving")
    with pytest.raises(ValueError):
        a.gauge("serving.admitted", 1)
