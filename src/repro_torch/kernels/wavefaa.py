"""WAVEFAA ticket reservation (paper Alg. 1 / Fig. 1) — the PyTorch twin
of ``repro/kernels/wavefaa.py``.

A wave ballots, a leader fetch-and-adds the popcount, and each active
lane adds its prefix rank: active lane i gets ``counter + (active lanes
before i)``, inactive lanes get -1, and the new counter is ``counter +
popcount``.  ``wavefaa`` launches the CUDA kernel in ``csrc/wavefaa.cu``
for a CUDA tensor (one launch: a wave of up to ``TILE_LANES`` lanes is one
block; a wider one ranks its tiles with a decoupled look-back over a
kept scratch, ``wavefaa_scratch``, which every call leaves zero) and the
plain ``wavefaa_plain`` for a CPU tensor.  The counter stays a device
tensor; nothing is read back.
"""

from __future__ import annotations

import torch

from . import _build

LANES = 8 * 128  # the reference's block: masks are padded to a multiple
#: lanes per tile of the CUDA kernel (``kFaaTileLanes`` in
#: ``csrc/wavefaa.cu``): a wave of up to this many lanes needs no scratch
TILE_LANES = 8192


def wavefaa_scratch_words(n: int) -> int:
    """int32 words of the kernel's look-back scratch for a wave of ``n``
    lanes: a ticket and a done counter (and two spare words), then one
    64-bit status word per tile."""
    return 4 + 2 * max(-(-int(n) // TILE_LANES), 1)


def wavefaa_scratch(n: int, device) -> torch.Tensor:
    """The kernel's zeroed scratch for waves of up to ``n`` lanes.  Every
    call leaves it zero; calls that may run at once need their own."""
    return torch.zeros(wavefaa_scratch_words(n), dtype=torch.int32,
                       device=device)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with 32-bit wraparound."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).int()


def _check_mask(name: str, active: torch.Tensor) -> None:
    if active.dim() != 1:
        raise ValueError(f"{name}: mask must be (N,), got "
                         f"{tuple(active.shape)}")
    if active.dtype not in (torch.bool, torch.int32):
        raise ValueError(f"{name}: mask must be bool or int32, got "
                         f"{active.dtype}")


def wavefaa_plain(active: torch.Tensor, counter: torch.Tensor):
    """Plain PyTorch ``wavefaa``: an exclusive cumsum over the ballot
    (``active > 0``), in int64 and wrapped to int32."""
    _check_mask("wavefaa", active)
    a = (active > 0).long()
    rank = torch.cumsum(a, 0) - a
    base = counter.long().reshape(-1)[0]
    tickets = torch.where(a > 0, _i32(base + rank), -1).int()
    return tickets, _i32(counter.long().reshape(1) + a.sum())


def wavefaa(active: torch.Tensor, counter: torch.Tensor, scratch=None):
    """``active``: (N,) bool, or int32 holding 0/1, with N % 1024 == 0;
    ``counter``: (1,) int32.  Returns (tickets (N,) int32, new_counter
    (1,) int32).  The kernel reads a bool mask: an int32 mask on the
    card is turned into ``active > 0`` first.  ``scratch``: from
    ``wavefaa_scratch`` for at least N lanes, used only by a wave of more
    than ``TILE_LANES`` lanes (allocated here, one memset, when None)."""
    _check_mask("wavefaa", active)
    n = active.shape[0]
    if n % LANES:
        raise ValueError(f"wavefaa: N={n} must be a multiple of {LANES}")
    if active.device.type == "cpu":
        return wavefaa_plain(active, counter)
    _build.require_cuda("wavefaa", counter)
    if active.device != counter.device or not active.is_contiguous():
        raise ValueError("wavefaa: mask must be contiguous, on the "
                         "counter's card")
    if active.dtype != torch.bool:
        active = active > 0          # the kernel takes a bool mask
    counter = counter.reshape(1)
    new_counter = torch.empty(1, dtype=torch.int32, device=active.device)
    if n == 0:
        new_counter.copy_(counter)
        return torch.empty(0, dtype=torch.int32,
                           device=active.device), new_counter
    ptr = 0
    if n > TILE_LANES:
        if scratch is None:
            scratch = wavefaa_scratch(n, active.device)
        _build.require_cuda("wavefaa", scratch)
        if (scratch.dim() != 1 or scratch.device != active.device
                or scratch.data_ptr() % 8
                or scratch.numel() < wavefaa_scratch_words(n)):
            raise ValueError(f"wavefaa: scratch must be wavefaa_scratch(n) "
                             f"for n >= {n}, on the mask's card")
        ptr = scratch.data_ptr()
    tickets = torch.empty(n, dtype=torch.int32, device=active.device)
    lib = _build.library("wavefaa")
    _build.check(lib.repro_wavefaa(
        active.data_ptr(), counter.data_ptr(), tickets.data_ptr(),
        new_counter.data_ptr(), ptr, n, _build.stream_of(active)),
        "wavefaa")
    _build.LAUNCHES["wavefaa"] += 1
    return tickets, new_counter
