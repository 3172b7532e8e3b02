"""Capacity-bounded MoE dispatch by per-expert ticket reservation — the
PyTorch twin of ``repro/kernels/moe_route.py``.

Each routed (token, choice) pair claims a slot in its expert's bounded
buffer.  A pair's slot is the number of earlier pairs, in pair order
(token-major, choice-minor), routed to the same expert; a slot at or past
``capacity`` becomes -1 (the bounded ring's RETRY path: the pair is
dropped), and so does an inactive pair (expert id -1), which takes no
slot.  A dropped pair still counts toward its expert, as in the Pallas
kernel's per-tile ``base`` update.

* ``expert_tickets`` — the wrapper.  A CPU tensor goes to
  ``expert_tickets_plain``; a CUDA tensor launches the kernels of
  ``csrc/moe_route.cu`` or raises.  Unlike the Pallas kernel it takes any
  N, not only multiples of 128.
* ``expert_tickets_plain`` — an exclusive cumsum of the (N, E) one-hot.
* ``moe_route`` — top-k gating, softmax combine weights and tickets, the
  reference's ``moe_route``.

Expert ids at or above ``num_experts`` follow the Pallas kernel: their
one-hot row is empty, so they count toward no expert and get slot 0 (or
-1 when the capacity is 0).

Ties in the top-k: ``jax.lax.top_k`` puts the lower index first.  The
port takes the first k of a stable descending sort, which does the same,
so equal gates pick the same experts in the same order on both sides.
"""

from __future__ import annotations

import torch

from . import _build

#: the kernel's per-block expert table holds this many experts
MAX_EXPERTS = 64


def _check(expert_ids: torch.Tensor, num_experts: int, capacity: int):
    if expert_ids.dim() != 1 or expert_ids.dtype != torch.int32:
        raise ValueError("expert_tickets: expert ids must be (N,) int32, "
                         f"got {tuple(expert_ids.shape)} {expert_ids.dtype}")
    if num_experts < 1:
        raise ValueError(f"expert_tickets: num_experts={num_experts}")
    if capacity < 0:
        raise ValueError(f"expert_tickets: capacity={capacity} < 0")


def expert_tickets_plain(expert_ids: torch.Tensor, *, num_experts: int,
                         capacity: int) -> torch.Tensor:
    """Plain PyTorch ``expert_tickets``: the exclusive per-expert cumsum
    of the one-hot, in int64."""
    _check(expert_ids, num_experts, capacity)
    e = expert_ids.long()
    in_range = (e >= 0) & (e < num_experts)
    onehot = (torch.nn.functional.one_hot(torch.where(in_range, e, 0),
                                          num_experts)
              * in_range[:, None])
    ranks = torch.cumsum(onehot, 0) - onehot
    slot = (ranks * onehot).sum(1)
    return torch.where((e >= 0) & (slot < capacity), slot, -1).int()


def expert_tickets(expert_ids: torch.Tensor, *, num_experts: int,
                   capacity: int) -> torch.Tensor:
    """``expert_ids``: (N,) int32, -1 for an inactive pair.  Returns the
    (N,) int32 slots: the pair's rank among the earlier pairs of its
    expert, or -1 when inactive or at or past ``capacity``."""
    _check(expert_ids, num_experts, capacity)
    if expert_ids.device.type == "cpu":
        return expert_tickets_plain(expert_ids, num_experts=num_experts,
                                    capacity=capacity)
    _build.require_cuda("expert_tickets", expert_ids)
    if num_experts > MAX_EXPERTS:
        raise ValueError(f"expert_tickets: the kernel takes at most "
                         f"{MAX_EXPERTS} experts, got {num_experts}")
    n = expert_ids.shape[0]
    dev = expert_ids.device
    slots = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return slots
    blocks = -(-n // _build.BLOCK)
    counts = torch.empty(blocks * num_experts, dtype=torch.int32, device=dev)
    lib = _build.library("moe_route")
    _build.check(lib.repro_expert_tickets(
        expert_ids.data_ptr(), slots.data_ptr(), counts.data_ptr(), n,
        num_experts, capacity, _build.stream_of(expert_ids)),
        "expert_tickets")
    _build.LAUNCHES["expert_tickets"] += 1
    return slots


def top_k_stable(gates: torch.Tensor, k: int):
    """The k largest gates of each row and their indices, largest first,
    equal gates in index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(gates: torch.Tensor, k: int, capacity: int):
    """Top-k gating, softmax over the top-k gates and ticket reservation.
    ``gates``: (T, E).  Returns (dispatch (T, k) int32 slot or -1,
    expert ids (T, k) int64, combine (T, k) float, 0 where dropped)."""
    t, e = gates.shape
    top_g, top_e = top_k_stable(gates, k)
    slots = expert_tickets(top_e.reshape(t * k).int(), num_experts=e,
                           capacity=capacity)
    dispatch = slots.reshape(t, k)
    probs = torch.softmax(top_g, dim=-1)
    combine = torch.where(dispatch >= 0, probs, 0.0)
    return dispatch, top_e, combine
