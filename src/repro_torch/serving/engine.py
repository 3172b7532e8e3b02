"""Continuous-batching serving engine built on the paper's bounded rings —
the PyTorch twin of ``repro/serving/engine.py`` with EDF admission.

Two queue roles (DESIGN.md § 3):

* **request queue** — incoming generation requests land in a deadline-keyed
  ``HostPriorityPool`` (EDF admission, DESIGN.md § 5.5): a request's key is
  its admission sequence number plus a per-class slack (urgent = 0), so
  urgent requests pre-empt and waiting or page-stalled requests *age toward
  urgency* — a stalled normal request keeps its original deadline while new
  arrivals take later ones, so it drifts to the front instead of re-queuing
  at fixed rank.  Tenants map (class, deadline, now) to keys through their
  own policies (``EngineConfig.tenant_policies``).  ``admission="lanes"``
  keeps the legacy strict two-lane ``HostTaskPool`` (urgent lane drained
  first, stalled requests parked engine-side), which starves normal
  traffic under sustained urgent load.
* **KV page allocator** — the KV cache is paged; free page indices live in a
  bounded ring and are claimed by *ticket reservation* exactly like the
  paper's index indirection (enqueue of a released page, dequeue of a free
  one).  Near-empty = memory pressure, the split-benchmark regime where
  G-WFQ's graceful degradation matters.

The decode loop is ``models.decode_step`` over a fixed slot batch, run
eagerly on the engine's device (on the card, every MoE layer of every
step launches the B6 ticket kernel); this module owns admission, page
accounting, completion and metrics.  Each step reads the argmax tokens
back to the host once (``host_syncs``).  ``admission="device"`` keeps
the pending requests on the card instead, as ``(deadline | idx)``
entries of ``ServingMeshEngine``'s heaps (``device_shards`` heaps along a
tensor dimension of the engine's one card): one engine tick is one
admission tick of that engine.

Simplification (documented, as in the reference): all slots advance on one
shared timeline (a single ``cur`` index) — a late-admitted slot's earlier
cache positions hold zero K/V, which its queries may attend to.  Prefill
feeds the prompt token by token through the decode step.  The step
passes no image tokens (``img=None``), as the reference's engine calls
``decode_step``, so a vlm cross layer attends to the token itself; a
hybrid's shared block keeps its K/V in its layer's cache entry.
Scheduling/queueing semantics (what the tests assert) are exact; the
production path would carry per-slot position vectors.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..data.pipeline import HostRing
from ..distributed import make_mesh
from ..kernels._build import resolve_device
from ..models import decode_step, init_decode_cache
from ..obs.metrics import MetricsRegistry, metric_key
from ..runtime.taskpool import HostTaskPool
from ..sched.hostpq import HostPriorityPool
from ..sched.policy import make_policy
from .admission import DEADLINE_KEY_CAP, ServingMeshEngine


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (P,) int32
    max_new_tokens: int
    priority: int = 1            # 0 = urgent admission class
    deadline: Optional[int] = None   # EDF key; assigned at submit if unset
    tenant: int = 0              # policy lane (EngineConfig.tenant_policies)
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submit_tick: int = -1        # engine tick at submit; -1 = pre-engine
    admit_tick: int = -1         # engine tick at slot admission
    finish_tick: int = -1        # engine tick at completion


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 4           # concurrent decode slots
    page_size: int = 64          # tokens per KV page
    num_pages: int = 64          # total page budget
    max_seq: int = 256
    request_ring_capacity: int = 16
    request_shards: int = 2      # HostTaskPool shards per lane (lanes mode)
    admission: str = "edf"       # "edf" | "lanes" (legacy) | "device" (mesh)
    normal_slack: int = 64       # EDF slack for non-urgent admission classes
    # multi-tenant policy lanes: one sched.policy spec per tenant
    # ("strict" | "weighted" | "edf" | a PriorityPolicy); None keeps the
    # single-lane inline EDF stamping
    tenants: int = 1
    tenant_policies: Optional[tuple] = None
    # device admission (ServingMeshEngine) sizing
    device_capacity_log2: int = 8
    device_batch: int = 8
    device_table_log2: int = 8
    device_shards: int = 1


class ServingEngine:
    """Synchronous continuous batching on one device (``device="cuda"``
    by default; the parameters must live there)."""

    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig,
                 registry: Optional[MetricsRegistry] = None, *,
                 device="cuda") -> None:
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        self.registry = registry
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"the parameters are on "
                             f"{params['embed'].device}, not {self.device}")
        self._device = None
        if ecfg.admission == "edf":
            self.requests = HostPriorityPool(ecfg.request_ring_capacity)
        elif ecfg.admission == "lanes":
            self.requests = HostTaskPool(ecfg.request_ring_capacity,
                                         shards=ecfg.request_shards, lanes=2)
        elif ecfg.admission == "device":
            # device-resident EDF: pending requests live as (deadline |
            # idx) heap entries on the priority mesh, its shards a tensor
            # dimension on this device; one engine tick is one admission
            # tick of the mesh engine
            self.requests = None
            self._device = ServingMeshEngine(
                mesh=make_mesh((ecfg.device_shards,), ("data",)),
                capacity_log2=ecfg.device_capacity_log2,
                batch=ecfg.device_batch,
                table_log2=ecfg.device_table_log2, device=self.device)
            self._table: List[Optional[Request]] = \
                [None] * (1 << ecfg.device_table_log2)
            self._free_idx = list(range(1 << ecfg.device_table_log2))
            self._pending: List[tuple] = []    # (key, idx, need) per submit
            self._dev_spawned = 0              # stall-tick detection baseline
        else:
            raise ValueError(f"unknown admission mode {ecfg.admission!r}")
        self._policies = None
        if ecfg.tenant_policies is not None:
            if len(ecfg.tenant_policies) != ecfg.tenants:
                raise ValueError(
                    f"{len(ecfg.tenant_policies)} tenant_policies for "
                    f"{ecfg.tenants} tenants")
            self._policies = [make_policy(p) for p in ecfg.tenant_policies]
        self._seq = 0                      # admission sequence (EDF now-clock)
        self._seq_lock = threading.Lock()  # submit() is client-thread-callable
        self.stalled: List[Request] = []   # page-stalled, awaiting re-admission
        self.admission_log: List[int] = []
        # free-page ring (index indirection: pages move as indices); the
        # ring holds exactly num_pages, so every enqueue here succeeds
        self.free_pages = HostRing(ecfg.num_pages)
        for p in range(ecfg.num_pages):
            self.free_pages.enqueue(p, timeout=0.1)
        self.slots: List[Optional[Request]] = [None] * ecfg.max_slots
        self.cache = init_decode_cache(cfg, ecfg.max_slots, ecfg.max_seq,
                                       device=self.device)
        self.cur = np.zeros(ecfg.max_slots, np.int32)
        self.tokens = np.zeros((ecfg.max_slots, 1), np.int32)
        self.metrics = {"admitted": 0, "completed": 0, "decode_steps": 0,
                        "page_stalls": 0, "tokens_out": 0}
        self.host_syncs = 0                # argmax readbacks, one per step
        self.tick = 0                      # engine ticks; the wait clock
        self._step = lambda p, c, t, cur: decode_step(p, c, t, cur, cfg)

    def _count(self, name: str, delta: int = 1) -> None:
        """Bump a metric in the legacy dict and, when a registry is wired,
        mirror it as a ``serving.*`` counter — both surfaces always
        agree."""
        self.metrics[name] += delta
        if self.registry is not None:
            self.registry.counter(metric_key("serving", name), delta)

    # -- client API ------------------------------------------------------------

    def submit(self, req: Request, timeout: float = 1.0) -> bool:
        if req.submit_tick < 0:
            req.submit_tick = self.tick    # racy int read is fine: ±1 tick
        if self.ecfg.admission == "lanes":
            return self.requests.enqueue(req, timeout=timeout,
                                         priority=req.priority)
        if not 0 <= req.tenant < self.ecfg.tenants:
            raise ValueError(f"tenant {req.tenant} out of range "
                             f"[0, {self.ecfg.tenants})")
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
            if self._policies is not None:
                # tenant lane: the lane's policy maps (class, deadline,
                # now) to the EDF key; policy clocks are per tenant, so
                # lanes interleave by key, not by arrival
                req.deadline = self._policies[req.tenant].key(
                    req.priority, req.deadline, seq)
            elif req.deadline is None:
                slack = 0 if req.priority == 0 else self.ecfg.normal_slack
                req.deadline = seq + slack
        if not 0 <= req.deadline < DEADLINE_KEY_CAP:
            raise ValueError(
                f"deadline {req.deadline} outside [0, {DEADLINE_KEY_CAP}): "
                f"keys past the 2^30 round-clock cap would wrap — rebase "
                f"the deadline clock")
        if self._device is not None:
            with self._seq_lock:
                if not self._free_idx:
                    return False           # table full = pool full
                idx = self._free_idx.pop()
                self._table[idx] = req
                need = self._pages_needed(
                    len(req.prompt) + req.max_new_tokens)
                self._pending.append((req.deadline, idx, need))
            return True
        return self.requests.enqueue(req, key=req.deadline, timeout=timeout)

    # -- scheduler -------------------------------------------------------------

    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.ecfg.page_size)

    def _next_candidate(self) -> Optional[Request]:
        if self.ecfg.admission != "edf":
            # lanes mode: engine-side stalled requests retry first (fixed
            # rank — the inversion baseline)
            return (self.stalled.pop(0) if self.stalled
                    else self.requests.dequeue(timeout=0.0))
        # EDF: self.stalled only holds pool-full overflow; merge it back
        # by deadline so it cannot jump requests with earlier deadlines
        if self.stalled:
            self.stalled.sort(key=lambda r: r.deadline)
            pk = self.requests.peek_key()
            if pk is None or self.stalled[0].deadline <= pk:
                return self.stalled.pop(0)
        req = self.requests.dequeue(timeout=0.0)
        if req is None and self.stalled:
            return self.stalled.pop(0)
        return req

    def _install(self, req: Request, s: int, pages: List[int]) -> None:
        """Slot-install bookkeeping: metrics, wait histogram, tenant
        counter, prefill."""
        req.slot, req.pages = s, pages
        req.admit_tick = self.tick
        self.slots[s] = req
        self.admission_log.append(req.rid)
        self._count("admitted")
        if self.registry is not None and self.ecfg.tenants > 1:
            self.registry.counter(
                metric_key("serving", "admitted", tenant=req.tenant))
        if self.registry is not None and req.submit_tick >= 0:
            # request-level sojourn: ticks from submit to admission,
            # per admission class
            self.registry.observe(
                metric_key("serving", "wait", cls=req.priority),
                self.tick - req.submit_tick)
        # prefill (token-by-token through decode_step for simplicity;
        # slot-local so other slots keep decoding)
        self.cur[s] = 0
        for tok in req.prompt:
            self.tokens[s, 0] = tok
            self._decode_once(active_slot=s)

    def _try_admit_device(self) -> None:
        """One admission tick on the priority mesh: install the buffered
        arrivals as (deadline | idx·retry) heap entries, give the tick the
        free slot/page budgets, admit the EDF prefix the device returns.
        Page-stalled requests stay heap-resident at their original
        deadline."""
        free_slots = [s for s in range(self.ecfg.max_slots)
                      if self.slots[s] is None]
        if not free_slots:
            return
        if not self._pending and self._device.occupancy() == 0:
            return
        held = sum(len(r.pages) for r in self.slots if r is not None)
        with self._seq_lock:
            pending, self._pending = self._pending, []
        admitted = self._device.tick(
            [k for k, _, _ in pending], [i for _, i, _ in pending],
            slots=len(free_slots), pages=self.ecfg.num_pages - held,
            need=[n for _, _, n in pending])
        spawned = self._device.stats["spawned"]
        if spawned > self._dev_spawned:
            # a republished request = this tick hit its budget wall (one
            # stall event per stalled tick, as the host path counts one
            # per _try_admit call)
            self._count("page_stalls")
        self._dev_spawned = spawned
        for idx in admitted:
            req = self._table[idx]
            self._table[idx] = None
            self._free_idx.append(idx)
            need = self._pages_needed(len(req.prompt) + req.max_new_tokens)
            pages = []
            for _ in range(need):
                p = self.free_pages.dequeue(timeout=0.0)
                assert p is not None, "device admission fits the page budget"
                pages.append(p)
            self._install(req, free_slots.pop(0), pages)

    def _try_admit(self) -> None:
        if self._device is not None:
            self._try_admit_device()
            return
        for s in range(self.ecfg.max_slots):
            if self.slots[s] is not None:
                continue
            req = self._next_candidate()
            if req is None:
                return
            need = self._pages_needed(len(req.prompt) + req.max_new_tokens)
            pages = []
            for _ in range(need):
                p = self.free_pages.dequeue(timeout=0.0)
                if p is None:
                    break
                pages.append(p)
            if len(pages) < need:
                # not enough pages: release and requeue (RETRY path)
                for p in pages:
                    self.free_pages.enqueue(p, timeout=0.1)
                self._count("page_stalls")
                if self.ecfg.admission == "edf":
                    # re-enter the pool at the *original* deadline: newer
                    # arrivals take later keys, so the stalled request
                    # ages toward urgency.  Non-blocking: this thread is
                    # the pool's only consumer, so waiting on a full pool
                    # would deadlock the decode loop for the whole timeout
                    if not self.requests.enqueue(req, key=req.deadline,
                                                 timeout=0.0):
                        self.stalled.append(req)   # pool full: never drop
                else:
                    # lanes mode: park engine-side, retried ahead of the
                    # pool next tick (fixed priority — the starvation the
                    # EDF path removes)
                    self.stalled.append(req)
                return
            self._install(req, s, pages)

    def _decode_once(self, active_slot: Optional[int] = None) -> np.ndarray:
        tok = torch.from_numpy(self.tokens).to(self.device)
        # all slots share one step; cur is per-slot — use max and mask
        cur = int(self.cur.max())
        logits, new_cache = self._step(self.params, self.cache, tok, cur)
        self.cache = new_cache
        self._count("decode_steps")
        if active_slot is not None:
            self.cur[active_slot] += 1
        else:
            for s, r in enumerate(self.slots):
                if r is not None:
                    self.cur[s] += 1
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        self.host_syncs += 1
        return nxt

    def wait_percentiles(self) -> Dict[int, Dict[str, Optional[float]]]:
        """Per-class request wait percentiles ``{cls: {p50, p99, max,
        count}}`` read back from the registry's ``serving.wait[cls=...]``
        histograms (empty without a registry)."""
        out: Dict[int, Dict[str, Optional[float]]] = {}
        if self.registry is None:
            return out
        for key in self.registry.keys():
            if not key.startswith("serving.wait["):
                continue
            h = self.registry.get(key)
            cls = int(key[key.index("cls=") + 4:-1])
            out[cls] = {"p50": h.quantile(0.50), "p99": h.quantile(0.99),
                        "max": h.max, "count": h.count}
        return out

    def step(self) -> None:
        """One engine tick: admit, decode, complete."""
        self.tick += 1
        self._try_admit()
        if self.registry is not None:
            # pressure gauges: free-page ring occupancy (near-empty = the
            # split-benchmark memory-pressure regime) and busy decode slots
            self.registry.gauge(metric_key("serving", "free_pages"),
                                self.ecfg.num_pages
                                - sum(len(r.pages) for r in self.slots
                                      if r is not None))
            self.registry.gauge(metric_key("serving", "active_slots"),
                                sum(r is not None for r in self.slots))
        if not any(self.slots):
            return
        nxt = self._decode_once()
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            req.out.append(int(nxt[s]))
            self._count("tokens_out")
            if len(req.out) >= req.max_new_tokens:
                req.done = True
                req.finish_tick = self.tick
                for p in req.pages:          # release pages (enqueue indices)
                    self.free_pages.enqueue(p, timeout=0.1)
                self.slots[s] = None
                self._count("completed")

    def _queue_empty(self) -> bool:
        if self._device is not None:
            return not self._pending and self._device.occupancy() == 0
        return self.requests.empty()

    def run(self, max_ticks: int = 1000) -> Dict[str, int]:
        for _ in range(max_ticks):
            self.step()
            if (not any(self.slots) and not self.stalled
                    and self._queue_empty()):
                break
        return dict(self.metrics)
