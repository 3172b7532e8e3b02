"""Building, loading and counting the hand-written CUDA kernels — the role
``repro/kernels/pallas_env.py`` plays for the Pallas kernels.

Each ``csrc/<name>.cu`` is compiled on first use, with ``nvcc`` for
``sm_90a``, into its own shared library with a plain C interface under
``build/repro_torch/`` at the repository root.  The file name carries a
hash of the sources (the ``.cu`` file and every ``csrc/*.cuh``), so an
edited source is rebuilt and a stale library is never loaded.  All
sources are compiled by parallel ``nvcc`` processes on the first call.
Libraries are loaded with ``ctypes``: pointers and the stream pass as
``c_void_p``, and every entry point returns ``cudaGetLastError()``, which
``check`` turns into an exception.

``LAUNCHES`` holds a plain integer per kernel wrapper, incremented where
the wrapper launches its kernel and nowhere else, so a run can show it
went through the kernels.  A kernel inside a CUDA graph launches once per
replay: the round engines' device loop (``runtime/enginecore.py:
DeviceLoop``) counts its graph launches under ``device_loop`` and adds
its captured round's launches once per round it ran.

Where a wrapper runs is its tensors' device: a CPU tensor goes to its
plain version and a CUDA tensor launches its kernel or raises.  The
model's kernels (B6 ``expert_tickets``, B7 ``flash_attention`` and the
flash backward) also take their plain version on a ``meta`` tensor
(``PLAIN_DEVICES``), so that ``launch/op_analysis.py`` can walk a step
at full size without allocating; there ``plain_span`` marks the plain
version's span and its inputs: the kernel reads those and writes the
outputs, and keeps the plain version's temporaries on chip.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signature of every entry point, by source file
SIGNATURES = {
    "wavefaa": {"repro_wavefaa": (_P, _P, _P, _P, _P, _I, _P)},
    "ring_slots": {
        "repro_ring_dequeue": (_P,) * 8 + (_I, _I, _I, _P),
        "repro_ring_enqueue": (_P,) * 9 + (_I, _I, _I, _P),
        "repro_ring_dequeue_wave": (_P,) * 12 + (_I,) * 6 + (_P,),
        "repro_ring_enqueue_wave": (_P,) * 14 + (_I,) * 7 + (_P,),
    },
    "compact": {"repro_wave_compact": (_P, _P, _P, _P, _P, _I, _I, _I, _P)},
    "heap_batch": {"repro_heap_apply": (_P,) * 10 + (_I, _I, _I, _I, _P),
                   "repro_heap_apply_rider": (_P,) * 13 + (_I,) * 5
                   + (_P,),
                   "repro_heap_apply_grid": (_P,) * 12 + (_I,) * 7
                   + (_P,),
                   "repro_heap_resident_max": (_I, _I)},
    "frontier": {"repro_frontier_level": (_P,) * 10 + (_I, _I, _I, _P)},
    "moe_route": {"repro_expert_tickets": (_P, _P, _P, _I, _I, _I, _P)},
    "flash_attn": {"repro_flash_attention": (_P,) * 6 + (_F, _F, _P)},
    "flash_wgmma": {"repro_flash_attention_wgmma": (_P,) * 7 + (_F, _F,
                                                               _P)},
    "flash_bwd": {"repro_flash_attention_bwd": (_P,) * 12 + (_F, _F, _P)},
    "loop": {"repro_loop_create": (_P,) * 8, "repro_loop_launch": (_P, _P),
             "repro_loop_destroy": (_P, _P)},
    "obs_record": {"repro_obs_record": (_P,) * 16 + (_I,) * 6 + (_P,)},
}

#: kernel launches per wrapper (reset with ``reset_launches``)
LAUNCHES: Dict[str, int] = {"wavefaa": 0, "ring_dequeue": 0,
                            "ring_enqueue": 0, "ring_dequeue_masked": 0,
                            "ring_enqueue_masked": 0, "ring_dequeue_wave": 0,
                            "ring_enqueue_wave": 0,
                            "ring_dequeue_wave_packed": 0,
                            "ring_enqueue_wave_packed": 0,
                            "ring_dequeue_wave_sharded": 0,
                            "ring_enqueue_wave_sharded": 0, "wave_compact": 0,
                            "heap_apply": 0, "heap_apply_rider": 0,
                            "heap_apply_grid": 0,
                            "heap_apply_grid_rider": 0,
                            "frontier_expand": 0, "expert_tickets": 0,
                            "flash_attention": 0,
                            "flash_attention_bwd": 0, "obs_record": 0,
                            "obs_record_mesh": 0, "device_loop": 0}

#: devices whose tensors the model's kernels' wrappers give to their
#: plain versions (``meta``: shapes only, nothing computed)
PLAIN_DEVICES = ("cpu", "meta")
#: the wrappers whose plain version is running on ``meta`` tensors, as
#: (name, input tensors), innermost last
PLAIN_SPANS: List[Tuple[str, Tuple[torch.Tensor, ...]]] = []

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def plain_span(name: str, *inputs: torch.Tensor):
    """Around a wrapper's plain version: on ``meta`` tensors ``(name,
    inputs)`` stands on ``PLAIN_SPANS`` while it runs; elsewhere
    nothing."""
    if inputs[0].device.type != "meta":
        yield
        return
    PLAIN_SPANS.append((name, inputs))
    try:
        yield
    finally:
        PLAIN_SPANS.pop()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (every entry point's
    default) needs a card and raises without one: nothing falls back to
    the CPU on its own.  Pass ``device="cpu"`` to run the plain
    versions, ``device="meta"`` to build shapes only (nothing is
    allocated or computed)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch.cuda.is_available() is "
            "False: pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, object]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together.  Returns what it did: the nvcc version
    line, the seconds taken, the sources built and their ptxas reports."""
    with _lock:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in SIGNATURES:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        reports = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)      # atomic: never a half-written library
            reports[name] = log
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True).stdout.strip().splitlines()
        return {"nvcc": version[-1] if version else "",
                "seconds": time.perf_counter() - t0,
                "built": sorted(procs), "ptxas": reports}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(path))
            for fn, args in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(args)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Checks a wrapper makes before it hands pointers to a kernel: every
    tensor is an int32 tensor, contiguous, on the current card."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: takes CPU tensors (plain version) or "
                             f"CUDA tensors (kernel), got {t.device}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: every tensor must be on the current "
                             f"card, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
