"""Tile-based wavefront ray tracer with per-tile queues (paper § V-B-b) —
the PyTorch twin of ``repro/apps/raytrace.py``.

A W×H image is split into Tx×Ty tiles; each tile owns a bounded ray queue.
Primary rays are enqueued per tile; the persistent tracing loop dequeues a
wave of rays, intersects spheres/plane, shades, and re-enqueues reflective
bounces into the same tile queue until no work remains — the paper's
queue-as-work-distribution layer.

* ``render_rounds`` runs the bounce loop on the deterministic round
  engine (``RoundRunner``): the ring carries pixel ids, the ray state
  lives in the accumulator, and one step traces a claimed batch and
  re-enqueues the rays that bounced.  Fused, a drained render is one
  launch of the engine's device loop (the ring waves B2a/B2b under the
  WHILE node) and one readback; legacy, the standalone ring kernels one
  round at a time.
* ``render_queue`` keeps the tile queues on the host and traces a wave
  of at most ``wave`` rays at a time.
* ``render_runtime`` schedules the same ray batches as tasks of the host
  task runtime (``TaskFabric`` under ``TaskRuntime``): one task traces
  one batch of one tile on ``device`` and spawns a continuation for the
  rays that bounced.
* ``render_compaction`` is the stream-compaction baseline (Wald'11
  style): all rays advance in lockstep and dead rays are compacted out
  between bounces — the comparison target of Fig. 7.

Scenes (paper § V-B-b): ``complex_scene`` (100 spheres on a plane,
2-bounce) and ``cornell_scene`` (two spheres, 4 bounces).

The ray step (``trace_once``) is XLA code in the reference, not a Pallas
kernel, so here it is plain PyTorch elementwise code on the engine's
device.  It reads nothing back and runs the same operations every call,
so the device loop can capture it.  Its dot products are written out
component by component, so a ray's result does not depend on the batch
it is traced in.  Against the reference the colours agree to float32
rounding only: XLA's CPU backend contracts some products into fused
multiply-adds, which PyTorch's separate operations do not, so a grazing
ray can hit another sphere or checker cell after a bounce.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..kernels._build import resolve_device
from ..runtime import RoundRunner

__all__ = ["Scene", "complex_scene", "cornell_scene", "primary_rays",
           "render_compaction", "render_queue", "render_rounds",
           "render_runtime", "trace_once"]


@dataclass
class Scene:
    centers: np.ndarray   # (S, 3)
    radii: np.ndarray     # (S,)
    albedo: np.ndarray    # (S, 3)
    reflect: np.ndarray   # (S,) reflectivity in [0, 1]
    max_bounces: int
    name: str


def complex_scene(seed: int = 0) -> Scene:
    rng = np.random.default_rng(seed)
    s = 100
    centers = np.stack([rng.uniform(-8, 8, s), rng.uniform(0.3, 2.5, s),
                        rng.uniform(4, 20, s)], -1)
    return Scene(centers.astype(np.float32),
                 rng.uniform(0.2, 0.7, s).astype(np.float32),
                 rng.uniform(0.2, 1.0, (s, 3)).astype(np.float32),
                 rng.uniform(0.3, 0.9, s).astype(np.float32),
                 max_bounces=2, name="complex")


def cornell_scene() -> Scene:
    centers = np.array([[-1.0, 1.0, 6.0], [1.2, 0.7, 5.0]], np.float32)
    return Scene(centers, np.array([1.0, 0.7], np.float32),
                 np.array([[0.9, 0.9, 0.9], [0.8, 0.6, 0.2]], np.float32),
                 np.array([0.9, 0.7], np.float32),
                 max_bounces=4, name="cornell")


# the sun's direction, normalised in float32
_SUN = np.array([0.5, 0.8, -0.3], np.float32)
_SUN = [float(x) for x in _SUN / np.sqrt(np.float32(
    (_SUN[0] * _SUN[0] + _SUN[1] * _SUN[1]) + _SUN[2] * _SUN[2]))]
_SKY = (0.5, 0.7, 1.0)


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm over the last axis of 3, summed in order."""
    return torch.sqrt((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])
                      + x[..., 2] * x[..., 2])


def scene_tensors(scene: Scene, device="cuda") -> Tuple[torch.Tensor, ...]:
    """``(centers, radii, albedo, reflect)`` of ``scene`` as float32
    tensors on ``device``: ``trace_once``'s scene arguments."""
    dev = resolve_device(device)
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                 for a in (scene.centers, scene.radii, scene.albedo,
                           scene.reflect))


def primary_rays(w: int, h: int, device="cuda"):
    """Camera rays through the pixel centres, row-major: ``(o, d)`` of
    shape (h * w, 3) each, float32 on ``device``."""
    dev = resolve_device(device)
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2 - 1
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2 - 1
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    d = torch.stack([gx, -gy, torch.ones_like(gx)], -1)
    d = d / _norm3(d)[..., None]
    o = torch.zeros((h, w, 3), device=dev)
    o[..., 1] = 1.0
    return o.reshape(-1, 3), d.reshape(-1, 3)


def trace_once(o, d, centers, radii, albedo, reflect):
    """One intersection and shade step for a wave of rays ``o``, ``d``
    ((R, 3) float32) against the spheres and the ground plane y = 0.
    Returns ``(color, new_o, new_d, alive, refl)``: the ray's colour
    contribution, its reflected ray, whether it bounces on and the hit
    surface's reflectivity.  The reference's ``_trace_once`` operation by
    operation, with ``argmin``'s first-minimum tie rule; its constants
    enter as Python numbers, so a call copies nothing to the card."""
    inf = float("inf")
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]               # (R, 1)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ocx, ocy, ocz = (ox - centers[:, 0], oy - centers[:, 1],
                     oz - centers[:, 2])                      # (R, S)
    b = (ocx * dx + ocy * dy) + ocz * dz
    c = ((ocx * ocx + ocy * ocy) + ocz * ocz) - radii * radii
    disc = b * b - c
    t_sph = torch.where(disc > 0, -b - torch.sqrt(torch.clamp(disc, min=0)),
                        inf)
    t_sph = torch.where(t_sph > 1e-3, t_sph, inf)
    t_best = torch.amin(t_sph, -1)
    hit_idx = torch.argmin(t_sph, -1)
    # ground plane y=0
    dy1 = d[:, 1]
    t_pl = torch.where(dy1 < -1e-6, -o[:, 1] / dy1, inf)
    t_pl = torch.where(t_pl > 1e-3, t_pl, inf)
    use_pl = t_pl < t_best
    t = torch.where(use_pl, t_pl, t_best)
    hit = torch.isfinite(t)
    p = o + t[:, None] * d
    n_sph = ((p - centers[hit_idx])
             / torch.clamp(radii[hit_idx], min=1e-6)[:, None])
    n0, n1, n2 = (torch.where(use_pl, u, n_sph[:, i])
                  for i, u in enumerate((0.0, 1.0, 0.0)))
    checker = torch.remainder(torch.floor(p[:, 0]) + torch.floor(p[:, 2]), 2)
    alb_pl = (0.6 + 0.3 * checker)[:, None].expand(-1, 3)
    alb = torch.where(use_pl[:, None], alb_pl, albedo[hit_idx])
    refl = torch.where(use_pl, 0.15, reflect[hit_idx])
    # simple sun shading
    diff = torch.clamp((n0 * _SUN[0] + n1 * _SUN[1]) + n2 * _SUN[2],
                       min=0.1)
    lift = 0.6 + 0.4 * torch.clamp(dy1, min=0)
    sky = torch.stack([lift * _SKY[0], lift * _SKY[1], lift * _SKY[2]], -1)
    color = torch.where(hit[:, None],
                        alb * diff[:, None] * (1 - refl[:, None]), sky)
    dn2 = 2 * ((d[:, 0] * n0 + d[:, 1] * n1) + d[:, 2] * n2)
    new_d = torch.stack([d[:, 0] - dn2 * n0, d[:, 1] - dn2 * n1,
                         d[:, 2] - dn2 * n2], -1)
    new_o = p + 1e-3 * new_d
    alive = hit & (refl > 0.05)
    return color, new_o, new_d, alive, refl


def render_queue(scene: Scene, w: int = 64, h: int = 64, tx: int = 4,
                 ty: int = 4, wave: int = 256, *, device="cuda"
                 ) -> Tuple[np.ndarray, Dict]:
    """Queue-driven wavefront: per-tile ray queues on the host; the
    persistent loop dequeues at most ``wave`` rays of a tile, traces them
    on ``device`` and re-enqueues the live bounces."""
    dev = resolve_device(device)
    sc = scene_tensors(scene, dev)
    o, d = primary_rays(w, h, dev)
    img = np.zeros((h * w, 3), np.float32)
    weight = np.ones((h * w,), np.float32)
    bounces = np.zeros((h * w,), np.int32)
    # per-tile queues of ray ids
    tiles = [[] for _ in range(tx * ty)]
    ids = np.arange(h * w)
    tile_of = (ids // w // (h // ty)) * tx + (ids % w) // (w // tx)
    for i in ids:
        tiles[tile_of[i]].append(i)
    o_np, d_np = o.cpu().numpy(), d.cpu().numpy()
    rays_traced, waves = 0, 0
    while any(tiles):
        for t in range(tx * ty):
            if not tiles[t]:
                continue
            batch, tiles[t] = tiles[t][:wave], tiles[t][wave:]
            idx = np.asarray(batch)
            col, no, nd, alive, refl = (
                x.cpu().numpy() for x in trace_once(
                    torch.as_tensor(o_np[idx], device=dev),
                    torch.as_tensor(d_np[idx], device=dev), *sc))
            img[idx] += weight[idx, None] * col
            weight[idx] *= refl
            bounces[idx] += 1
            # primary trace + max_bounces reflections (matches the baseline)
            cont = alive & (bounces[idx] <= scene.max_bounces)
            o_np[idx], d_np[idx] = no, nd
            tiles[t].extend(idx[cont].tolist())  # re-enqueue bounces
            rays_traced += len(idx)
            waves += 1
    return img.reshape(h, w, 3), {"rays": rays_traced, "waves": waves}


def render_runtime(scene: Scene, w: int = 64, h: int = 64, tx: int = 4,
                   ty: int = 4, wave: int = 256, *, algo: str = "glfq",
                   shards: int = 4, workers: int = 8, steal: bool = True,
                   policy: str = "gang", seed: int = 0, device="cuda"
                   ) -> Tuple[np.ndarray, Dict]:
    """Tile scheduling through the host task fabric: one task = one
    <=``wave``-ray batch of one tile.  The handler traces the batch with
    ``trace_once`` on ``device`` (one upload of its rays, one readback of
    the results) and spawns a continuation task for the rays that
    bounced — wave-affinity keeps a tile's continuations on its home
    shard, and stealing rebalances when tiles finish at different bounce
    depths.  The fabric and its workers are the host simulation of
    ``repro_torch.runtime``; only the tracing touches the device.

    Pixels accumulate on the host in float32 as in ``render_queue``: a
    pixel takes the same sequence of adds under any fabric interleaving,
    so the image equals ``render_queue``'s and ``render_rounds``' bit for
    bit."""
    from ..runtime import ExecutorConfig, TaskFabric, TaskRuntime, TaskSpec

    dev = resolve_device(device)
    sc = scene_tensors(scene, dev)
    o, d = primary_rays(w, h, dev)
    img = np.zeros((h * w, 3), np.float32)
    weight = np.ones((h * w,), np.float32)
    bounces = np.zeros((h * w,), np.int32)
    o_np, d_np = o.cpu().numpy(), d.cpu().numpy()
    ids = np.arange(h * w)
    tile_of = (ids // w // (h // ty)) * tx + (ids % w) // (w // tx)
    stats = {"rays": 0, "waves": 0}

    def handler(rec):
        tile, idx = rec.payload
        idx = np.asarray(idx)
        col, no, nd, alive, refl = trace_once(
            torch.as_tensor(o_np[idx], device=dev),
            torch.as_tensor(d_np[idx], device=dev), *sc)
        out = torch.cat([col, no, nd, alive[:, None].to(col.dtype),
                         refl[:, None]], 1).cpu().numpy()
        col, no, nd = out[:, 0:3], out[:, 3:6], out[:, 6:9]
        alive, refl = out[:, 9] > 0, out[:, 10]
        img[idx] += weight[idx, None] * col
        weight[idx] *= refl
        bounces[idx] += 1
        cont = alive & (bounces[idx] <= scene.max_bounces)
        o_np[idx], d_np[idx] = no, nd
        stats["rays"] += len(idx)
        stats["waves"] += 1
        live = idx[cont]
        if len(live) == 0:
            return []
        return [TaskSpec((tile, live), cost=max(len(live) // 32, 1))]

    n_tiles = tx * ty
    fabric = TaskFabric(algo=algo, shards=shards,
                        capacity_per_shard=max(
                            4 * (h * w // wave + n_tiles) // max(shards, 1),
                            64),
                        num_threads=workers + 1, steal=steal)
    rt = TaskRuntime(fabric, handler,
                     ExecutorConfig(workers=workers, policy=policy, seed=seed,
                                    max_steps=50_000_000))
    for t in range(n_tiles):
        mine = ids[tile_of == t]
        for i in range(0, len(mine), wave):
            rt.add_task((t, mine[i:i + wave]),
                        cost=max(len(mine[i:i + wave]) // 32, 1))
    m = rt.run()
    info = dict(stats)
    info.update({"tasks": len(rt.executed),
                 "steal_rate": m["steal_rate"],
                 "idle_steps": m["idle_steps"],
                 "load_imbalance": m["load_imbalance"]})
    return img.reshape(h, w, 3), info


def render_rounds_runner(scene: Scene, w: int = 64, h: int = 64,
                         batch: int = 256, *, fused: bool = True,
                         sync_every: int = 0, device="cuda"):
    """The round engine of ``render_rounds`` and a function that makes its
    initial accumulator: ``(runner, init_fn)``, ``init_fn()`` returning
    ``(img, weight, o, d, bounces)`` of ``h * w + 1`` rows on the runner's
    device, the last row the trash row of invalid lanes.

    The step traces the claimed pixel ids with ``trace_once`` and updates
    the accumulator IN PLACE, in the reference's order (colour with the
    old weight, then weight, ray and bounce count, then the bounce test
    reads the new count).  Invalid lanes write to the trash row.  A pixel
    id is in flight at most once, so the valid lanes' scatters never
    collide: only the trash row takes duplicates."""
    dev = resolve_device(device)
    sc = scene_tensors(scene, dev)
    npix = h * w
    max_b = scene.max_bounces

    def step(acc, vals, valid):
        img, weight, o, d, bounces = acc
        ids = torch.where(valid, vals, 0).long()
        col, no, nd, alive, refl = trace_once(o[ids], d[ids], *sc)
        drop = torch.where(valid, ids, npix)   # invalid lanes go to trash
        img.index_add_(0, drop, weight[ids][:, None] * col)
        weight[drop] = weight[drop] * refl
        o.index_copy_(0, drop, no)
        d.index_copy_(0, drop, nd)
        bounces.index_add_(0, drop, torch.ones_like(vals))
        cont = valid & alive & (bounces[ids] <= max_b)
        return (img, weight, o, d, bounces), vals[:, None], cont[:, None]

    def init_fn():
        o0, d0 = primary_rays(w, h, dev)
        pad = torch.zeros((1, 3), device=dev)       # the trash row
        return (torch.zeros((npix + 1, 3), device=dev),
                torch.ones((npix + 1,), device=dev),
                torch.cat([o0, pad]), torch.cat([d0, pad]),
                torch.zeros((npix + 1,), dtype=torch.int32, device=dev))

    capacity_log2 = max(int(np.ceil(np.log2(max(npix, batch)))), 4)
    runner = RoundRunner(step, capacity_log2=capacity_log2, batch=batch,
                         fused=fused, sync_every=sync_every, device=dev)
    return runner, init_fn


def render_rounds(scene: Scene, w: int = 64, h: int = 64, batch: int = 256,
                  *, fused: bool = True, sync_every: int = 0,
                  max_rounds: int = 10_000, device="cuda"
                  ) -> Tuple[np.ndarray, Dict]:
    """Wavefront tracing on the deterministic round engine: the ring
    carries pixel ids (index indirection — the ray state lives in the
    accumulator), one step traces a batch with ``trace_once`` and
    re-enqueues the rays that bounced.  Per-pixel contribution order
    matches ``render_queue`` (each pixel id is in flight at most once).

    ``fused=True`` (default) keeps the whole bounce loop on the device
    (one readback for a drained render); ``fused=False`` is the legacy
    per-round path.  Both are bit-identical.  Returns (image (h, w, 3)
    numpy float32, stats with ``rays`` and ``waves``)."""
    runner, init_fn = render_rounds_runner(scene, w, h, batch, fused=fused,
                                           sync_every=sync_every,
                                           device=device)
    (img, _, _, _, _), _ = runner.run(np.arange(h * w, dtype=np.int32),
                                      acc=init_fn(), max_rounds=max_rounds)
    info = dict(runner.stats)
    info.update({"rays": info["processed"], "waves": info["rounds"]})
    return img[:h * w].cpu().numpy().reshape(h, w, 3), info


def render_compaction(scene: Scene, w: int = 64, h: int = 64, *,
                      chunk: int = 1 << 18, device="cuda"
                      ) -> Tuple[np.ndarray, Dict]:
    """Stream-compaction baseline: lockstep bounces over the full ray set
    on ``device``, compacting dead rays between bounces.  Rays are traced
    ``chunk`` at a time to bound the (rays, spheres) temporaries; a ray's
    result does not depend on its chunk."""
    dev = resolve_device(device)
    sc = scene_tensors(scene, dev)
    o, d = primary_rays(w, h, dev)
    img = torch.zeros((h * w, 3), device=dev)
    weight = torch.ones((h * w,), device=dev)
    idx = torch.arange(h * w, device=dev)
    rays_traced = 0
    for _ in range(scene.max_bounces + 1):
        n = idx.numel()
        if n == 0:
            break
        alive = torch.empty(n, dtype=torch.bool, device=dev)
        for i in range(0, n, chunk):
            ix = idx[i:i + chunk]
            col, no, nd, al, refl = trace_once(o[ix], d[ix], *sc)
            img[ix] += weight[ix, None] * col
            weight[ix] *= refl
            o[ix], d[ix] = no, nd
            alive[i:i + chunk] = al
        rays_traced += n
        idx = idx[alive]  # stream compaction
    return img.cpu().numpy().reshape(h, w, 3), {"rays": rays_traced}
