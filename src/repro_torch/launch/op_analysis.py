"""Operation analysis of one step at the dispatcher — the counterpart of
``repro/launch/hlo_analysis.py: analyze_hlo_text``.

The reference reads a step's roofline inputs off its compiled XLA module.
The port runs eagerly, one ATen op after another, so ``analyze_step``
runs the step under a ``TorchDispatchMode`` and counts the ops as they
pass, usually on the ``meta`` tensors of ``launch/steps.py``, where
nothing is allocated or computed:

* FLOPs        — every matmul, batched matmul and convolution (``mm``,
                 ``addmm``, ``bmm``, ``baddbmm``, ``convolution``),
                 2·out_elems·K, the reference's count of a ``dot``;
* HBM bytes    — Σ output bytes × 2 (written, then read) of every op that
                 materialises a tensor; views and ``empty`` count nothing.
                 XLA fuses chains of elementwise ops into kernels whose
                 intermediates never leave the chip, while every eager op
                 writes its output, so the port counts more bytes than the
                 reference does for the same step;
* collective   — 0 on one card, in the reference's fields.

On ``meta`` the model's kernel wrappers take their plain versions
(``kernels/_build.py: PLAIN_DEVICES``), B7 as one block of every (query,
key) pair, so the FLOPs cover every tile of the mask, as the reference's
XLA ``_flash_core`` path does on the CPU.  The bytes of such a plain
span (``_build.plain_span``) are the kernel's: its inputs read once and
the outputs it leaves written once, and none of its temporaries (the
(B, H, S, S) scores of B7's one block), which the kernel keeps on chip.
``peak_bytes`` (no reference field) is the most bytes that tensors the
step made were holding at once: an eager run's peak beside its
arguments.  A plain span's temporaries do not enter it either; its
outputs do.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import _build

aten = torch.ops.aten

#: ops whose output is allocated but not written
_UNWRITTEN = {aten.empty, aten.empty_strided, aten.empty_like,
              aten.new_empty, aten.new_empty_strided}


@dataclass
class OpCosts:
    """The reference's ``HloCosts`` fields (per device: the one card),
    and ``peak_bytes``."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    by_collective: Dict[str, float] = field(default_factory=dict)
    dot_count: int = 0
    warnings: List[str] = field(default_factory=list)
    peak_bytes: int = 0


def _matmul_flops(func, args) -> float:
    """2·out·K of a (batched) matmul, else 0."""
    pkt = func.overloadpacket
    if pkt in (aten.mm, aten.bmm):
        a, b = args[0], args[1]
    elif pkt in (aten.addmm, aten.baddbmm):
        a, b = args[1], args[2]
    else:
        return 0.0
    return 2.0 * a.shape[:-1].numel() * b.shape[-1] * a.shape[-1]


def _conv_flops(out, weight) -> float:
    """The reference's count: 2·out·(weight elements per output
    channel)."""
    return 2.0 * out.numel() * max(weight.numel() // weight.shape[0], 1)


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


class _Counter(TorchDispatchMode):
    """Counts the ops, and the bytes of the storages the step made that
    are alive: a storage lives while any tensor on it does (every tensor
    the step makes passes through here, views too, each with a
    finalizer), so each op costs O(1)."""

    def __init__(self, costs: OpCosts, args) -> None:
        super().__init__()
        self.costs = costs
        self.known = {t.untyped_storage()._cdata for t in _tensors(args)}
        self.live: Dict[int, list] = {}     # key -> [tensors, bytes, counted]
        self.pending: List[int] = []
        self.span = None                    # the open plain span's entry
        self.now = 0

    def _release(self, key: int) -> None:
        rec = self.live[key]
        rec[0] -= 1
        if rec[0] == 0:
            if rec[2]:
                self.now -= rec[1]
            del self.live[key]

    def _track(self, out, fresh: bool) -> None:
        for t in _tensors(out):
            key = t.untyped_storage()._cdata
            if key in self.known:
                continue
            rec = self.live.get(key)
            if rec is None:
                if not fresh:
                    continue
                counted = self.span is None
                rec = self.live[key] = [0, t.untyped_storage().nbytes(),
                                        counted]
                if counted:
                    self.now += rec[1]
                else:
                    self.pending.append(key)
            rec[0] += 1
            weakref.finalize(t, self._release, key)
        self.settle()

    def settle(self) -> None:
        """Closes a finished plain span: charges its inputs and what it
        left alive (its outputs) once each to ``bytes``, and the outputs
        to the live bytes; updates the peak."""
        if self.span is not None and (not _build.PLAIN_SPANS or
                                      _build.PLAIN_SPANS[0] is not self.span):
            moved = sum(t.numel() * t.element_size() for t in self.span[1])
            for key in self.pending:
                rec = self.live.get(key)
                if rec is not None and not rec[2]:
                    rec[2] = True
                    self.now += rec[1]
                    moved += rec[1]
            self.costs.bytes += moved
            self.pending, self.span = [], None
        self.costs.peak_bytes = max(self.costs.peak_bytes, self.now)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.settle()           # a span that closed since the last op
        if _build.PLAIN_SPANS:
            self.span = _build.PLAIN_SPANS[0]
        out = func(*args, **kwargs)
        c = self.costs
        flops = _matmul_flops(func, args)
        if func.overloadpacket is aten.convolution:
            flops = _conv_flops(out, args[1])
        elif func.overloadpacket is aten.convolution_backward:
            # grad_input and grad_weight: a forward's products each
            flops = sum(_conv_flops(args[0], args[2])
                        for want in args[-1][:2] if want)
        if flops:
            c.flops += flops
            c.dot_count += 1
        views = any(r.alias_info is not None and not r.alias_info.is_write
                    for r in func._schema.returns)
        written = not views and func.overloadpacket not in _UNWRITTEN
        if written and self.span is None:
            c.bytes += 2.0 * sum(t.numel() * t.element_size()
                                 for t in _tensors(out))
        self._track(out, fresh=not views)
        return out


def analyze_step(fn, *args, **kwargs):
    """Runs ``fn(*args, **kwargs)`` under the counter; returns (its
    result, ``OpCosts``).  Tensors among the arguments are the step's
    inputs: they enter neither ``bytes`` nor ``peak_bytes`` unless an op
    writes them or a plain span reads them."""
    costs = OpCosts()
    counter = _Counter(costs, (args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    counter.settle()
    return out, costs
