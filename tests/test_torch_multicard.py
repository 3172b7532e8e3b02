"""The port's mesh across processes on the CPU: one shard a rank of a
``torch.distributed`` gloo group (``make_mesh(..., group=)``), held
against the JAX package's ``shard_map`` runs.

Each world size starts once a pytest run: ``python tests/
test_torch_multicard.py --ranks W`` spawns W ranks
(``torch.multiprocessing.spawn``, a ``file://`` store under a temporary
directory), and every rank runs every case and writes its results; beside
it ``--worker S`` runs the reference's cases under ``shard_map`` on S
forced host devices (the forced-device subprocess of
``tests/test_torch_meshrounds.py``).  Both world sizes and both sides run
at once, on first use.  Covered, at 2 and 4 ranks:

* the mesh rows of ``GOLDEN`` of ``tests/test_enginecore.py`` on groups
  of one rank and every row of ``GOLDEN_2SHARD`` on two;
* live reference runs: the FIFO mesh replicated and sharded (telemetry,
  ``sync_every``, compaction, spans, legacy), the priority mesh relaxed
  and strict (plain, ``split``, compaction, ``sync_every``, legacy), mesh
  BFS replicated and sharded, SSSP relaxed and strict with and without
  ``split_payload``, ``mesh_task_round`` from tickets below and across
  2^31 and 2^32, and the admission engine at 2 shards: stats,
  ``sync_log``, accumulators, final state and trace digests;
* every rank returns the same values (``mesh_task_round``: this rank's
  rows, the reference's row of that shard), and every round makes
  exactly one collective (``distributed.COLLECTIVES``);
* the overflow and truncation errors word for word on every rank, and a
  group whose size is not the mesh's shard count;
* the four gradient collectives against the reference's under
  ``shard_map``: the int8 codes bit for bit, the reduced floats within
  ``GRAD_ULPS`` float32 spacings of S times the inputs' largest magnitude
  (the all-reduce may add the shards' terms in another order than XLA's
  psum, and XLA fuses the residual's multiply-subtract).

A launched process still running after SPAWN_TIMEOUT seconds is killed
and the test fails naming each process's last stage.

Integer state throughout the queue cases, so those comparisons are
exact."""

import atexit
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STATS = ("rounds", "processed", "spawned", "max_occupancy", "drained",
         "host_syncs")
# GOLDEN (mesh rows) / GOLDEN_2SHARD of tests/test_enginecore.py
GOLDEN = {
    "mesh_fanout": {
        "stats": [7, 63, 62, 32, 1, 1], "acc": "b8d77df0675e0603",
        "planes": "1a0afe86d6513a2a", "head_tail": [575, 575],
        "tel": "cb3aae309ae1f69f"},
    "mesh_bfs": {"stats": [23, 144, 143, 12, 1, 1],
                 "dist": "c8795c4f65942e14"},
    "pmesh_relaxed": {
        "stats": [19, 260, 258, 128, 1, 1], "acc": "cd729cf83f33eed5",
        "planes": "c5830eb454bd1761", "tel": "c24a2c5171ec130e"},
    "pmesh_strict": {
        "stats": [19, 260, 258, 128, 1, 1], "acc": "cd729cf83f33eed5",
        "planes": "c5830eb454bd1761", "tel": "c24a2c5171ec130e"},
    "serving": {
        "stats": [4, 20, 12, 6, 1, 4], "ticks": 4,
        "admitted": [1, 3, 7, 2, 6, 5, 4, 0],
        "planes": "d70650fb443f714a", "hist": "256ab85ea28951cc",
        "tel": "55a5a0cd9cee8fb0"},
}
GOLDEN_2SHARD = {
    "mesh_fanout_2": {
        "stats": [6, 63, 62, 32, 1, 1], "acc": "b8d77df0675e0603",
        "planes": "1a0afe86d6513a2a", "head_tail": [575, 575],
        "tel": "01bcb5be848e8028"},
    "mesh_bfs_2": {"stats": [23, 287, 286, 24, 1, 1],
                   "dist": "c8795c4f65942e14"},
    "pmesh_relaxed_2": {
        "stats": [12, 260, 258, 88, 1, 1], "acc": "cd729cf83f33eed5",
        "planes": "c822643452639513", "tel": "bd8f8645639ba8bc"},
    "pmesh_strict_2": {
        "stats": [12, 260, 258, 110, 1, 1], "acc": "cd729cf83f33eed5",
        "planes": "c5830eb454bd1761", "tel": "2455cb0b0971fae9"},
    "serving_2": {
        "stats": [4, 20, 12, 6, 1, 4], "ticks": 4,
        "admitted": [2, 1, 7, 3, 6, 4, 5, 0],
        "planes": "6ddad96eb514c320", "hist": "385db6ed17cface3",
        "tel": "12c1f9a6ce0747a2"},
}
WORLDS = (2, 4)
# mesh_task_round: tickets start below 2^31 and 2^32 and cross them
STARTS = (None, 2 ** 31 - 32, 2 ** 32 - 32)
MTR_CAP, MTR_B, MTR_ROUNDS = 16, 4, 12
# the reduced gradients: within GRAD_ULPS float32 spacings of S times the
# inputs' largest magnitude, a bound on every partial sum (gloo may add
# the shards' terms in another order than XLA's psum, and XLA fuses the
# compressed residual's multiply-subtract into one FMA)
GRAD_ULPS = 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(_np(a)).tobytes())
    return h.hexdigest()[:16]


def _tel_digest(tel):
    rows = [(r.round, r.imbalance, r.min_key, r.max_key, int(r.overflow),
             tuple(r.pops), tuple(r.pushes), tuple(r.occupancy))
            for r in tel.records]
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


def _stats(st):
    return [int(st[k]) for k in STATS]


def _log(r):
    return [(p.rounds, p.occupancy, p.host_syncs) for p in r.sync_log]


# -- the steps, one a package (torch or jax.numpy) ---------------------------


def _steps(port: bool):
    """(tree, pri, split, explode, immortal) steps of one package: the
    goldens' steps of tests/test_enginecore.py and the error cases'."""
    if port:
        def scatter(acc, idx, valid):
            return acc.index_add(0, torch.where(valid, idx, 0), valid.int())
        stack, i32 = torch.stack, (lambda a: a.int())
        bcast = torch.broadcast_to
    else:
        import jax.numpy as jnp

        def scatter(acc, idx, valid):
            return acc.at[jnp.where(valid, idx, 0)].add(
                valid.astype(jnp.int32))
        stack, i32 = jnp.stack, (lambda a: a.astype(jnp.int32))
        bcast = jnp.broadcast_to

    def tree(acc, vals, valid):
        acc = scatter(acc, vals, valid)
        cv = i32(stack([vals * 2, vals * 2 + 1], -1))
        return acc, cv, (valid & (vals < 32))[:, None]

    def pri(acc, keys, vals, valid):
        acc = scatter(acc, vals % 89, valid)
        ck = i32(stack([keys + 2, keys + 5], -1))
        cv = i32(stack([(vals * 7919) % 1000, (vals * 104729) % 1000], -1))
        return acc, ck, cv, (valid & (keys < 20))[:, None]

    def split(acc, keys, vals, aux, valid):
        acc = scatter(acc, (vals + aux) % 89, valid)
        ck = i32(stack([keys + 2, keys + 5], -1))
        cv = i32(stack([(vals * 7919) % 1000, (vals * 104729) % 1000], -1))
        ca = i32(stack([aux + 1, aux + 1], -1))
        return acc, ck, cv, ca, (valid & (aux < 6))[:, None]

    def explode(acc, vals, valid):
        cv = i32(bcast(vals[:, None], (vals.shape[0], 4)) + 1)
        return acc, cv, bcast(valid[:, None], cv.shape)

    def immortal(acc, vals, valid):
        return acc, vals[:, None], valid[:, None]

    return tree, pri, split, explode, immortal


def _mtr_inputs(s, seed):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(MTR_ROUNDS):
        d = {"vals": rng.integers(1, 10_000, (s, MTR_B)) + r * 10_000,
             "spawn": rng.random((s, MTR_B)) < 0.8,
             "claim": rng.random((s, MTR_B)) < 0.6}
        if r == 2:
            d["spawn"][:] = False
        if r == 3:
            d["claim"][-1] = False
        out.append({k: v.astype(np.int32) for k, v in d.items()})
    return out


def _grad_inputs(s):
    """Every shard's gradient leaves: (S, 700) and (S, 3, 5) float32."""
    rng = np.random.default_rng(7 + s)
    return [rng.standard_normal((s, 700)).astype(np.float32),
            rng.standard_normal((s, 3, 5)).astype(np.float32)]


# -- one scenario set, run by each package -----------------------------------


def _scenarios(s, port: bool, mesh, me=None):
    """The cases both packages run at ``s`` shards: {name: plain values}.
    ``mesh`` is the port's group-bound mesh (``me`` its rank) or the
    reference's ``jax`` mesh.  The port's entries carry the round
    exchanges they made (``exchanges``), popped before comparing."""
    tree, pri, split, explode, immortal = _steps(port)
    if port:
        from repro_torch import obs, runtime as rt, serving
        from repro_torch.apps import bfs as gbfs, sssp as gsssp
        from repro_torch.distributed import COLLECTIVES
        kw = dict(device="cpu")
        zeros = lambda n: torch.zeros(n, dtype=torch.int32)  # noqa: E731
        comb = lambda a: a.sum(0, dtype=torch.int32)  # noqa: E731
    else:
        import jax.numpy as jnp
        from repro import obs, runtime as rt, serving
        from repro.apps import bfs as gbfs, sssp as gsssp
        COLLECTIVES = None
        kw = {}
        zeros = lambda n: jnp.zeros(n, jnp.int32)  # noqa: E731
        comb = lambda a: a.sum(0)  # noqa: E731
    out = {}

    def counted(name, fn):
        before = None if COLLECTIVES is None else COLLECTIVES["exchange"]
        try:
            res = fn()
        except RuntimeError as e:
            res = {"error": str(e)}
        if before is not None:
            res["exchanges"] = COLLECTIVES["exchange"] - before
        out[name] = json.loads(json.dumps(res))

    def fifo(fused=True, **opts):
        tel = obs.Telemetry(capacity=256) if fused else None
        sp = (obs.Spans(classes=1, buckets=8) if opts.pop("spans", False)
              else None)
        r = rt.MeshRoundRunner(tree, mesh=mesh, capacity_log2=8, batch=16,
                               fused=fused, combine=comb, telemetry=tel,
                               spans=sp, **opts, **kw)
        acc, st = r.run([1], acc=zeros(80))
        res = {"stats": _stats(r.stats), "acc": _digest(acc),
               "planes": _digest(*st[:4]), "log": _log(r)}
        if opts.get("sharded"):
            res["tickets"] = [_np(st.tails).tolist(),
                              _np(st.heads).tolist()]
        else:
            res["head_tail"] = [int(_np(st.head)), int(_np(st.tail))]
        if tel is not None:
            res["tel"] = _tel_digest(tel)
        if sp is not None:
            res["spans"] = _digest(sp.hist, sp.max_wait)
            res["flows"] = sp.flows
        return res

    def pmesh(relaxed, fused=True, **opts):
        tel = obs.Telemetry(capacity=256) if fused else None
        is_split = opts.get("split", False)
        r = rt.PriorityMeshRoundRunner(
            split if is_split else pri, mesh=mesh, capacity_log2=8,
            batch=4, relaxed=relaxed, fused=fused, combine=comb,
            telemetry=tel, **opts, **kw)
        run_kw = {"initial_aux": [0, 1, 0, 2, 0]} if is_split else {}
        acc, st = r.run([3, 1, 9, 4, 4], [7, 11, 12, 5, 6], acc=zeros(89),
                        **run_kw)
        res = {"stats": _stats(r.stats), "acc": _digest(acc),
               "planes": _digest(st[0], st[1]),
               "size": _np(st[2]).tolist(), "log": _log(r)}
        if port and relaxed:
            res["hints"] = _np(r.hints).tolist()
        elif relaxed:   # the reference carries each heap's least key
            res["hints"] = np.asarray(st[0]).min(1).tolist()
        if tel is not None:
            res["tel"] = _tel_digest(tel)
        return res

    def serve():
        tel = obs.Telemetry(capacity=256)
        e = serving.ServingMeshEngine(mesh=mesh, capacity_log2=6, batch=8,
                                      table_log2=6, pop_log=128,
                                      telemetry=tel, **kw)
        e.begin()
        admitted = list(e.tick([60, 10, 30, 20, 50, 40, 35, 25],
                               [0, 1, 2, 3, 4, 5, 6, 7], slots=4, pages=5,
                               need=[2] * 8))
        ticks = 1
        while e.occupancy() > 0 and ticks < 12:
            admitted += e.tick([], [], slots=4, pages=4)
            ticks += 1
        # the reference keeps its planes in ``_state`` (no heap_state)
        st = e.heap_state() if port else e._state[0]
        return {"stats": _stats(e.stats), "ticks": ticks,
                "admitted": admitted, "planes": _digest(st[0], st[1]),
                "hist": _digest(np.asarray(e.pop_history(), np.int32)),
                "tel": _tel_digest(tel), "log": _log(e)}

    def graph_bfs():
        d, st = gbfs.bfs_mesh_rounds(gbfs.road_like(144), 0, mesh=mesh,
                                     batch=32, **kw)
        return {"stats": _stats(st), "dist": _digest(np.asarray(d))}

    def graph_sssp(relaxed, split_payload):
        g = gbfs.road_like(144)
        w = gsssp.with_weights(g, max_w=8, seed=1)
        d, st = gsssp.sssp_mesh_rounds(g, w, 0, mesh=mesh, batch=32,
                                       relaxed=relaxed,
                                       split_payload=split_payload, **kw)
        return {"stats": _stats(st), "dist": _digest(np.asarray(d))}

    def errors(case, fused):
        step, cap, seeds, rounds = {
            "overflow": (explode, 4, np.arange(8), 100),
            "seed_overflow": (tree, 4, np.arange(64), 100),
            "truncation": (immortal, 6, [1, 2, 3], 5)}[case]
        r = rt.MeshRoundRunner(step, mesh=mesh, capacity_log2=cap,
                               batch=8 // s, fused=fused, **kw)
        acc = np.zeros(80, np.int32) if case == "seed_overflow" else 0
        try:
            r.run(seeds, acc=acc if port else jnp.asarray(acc, jnp.int32),
                  max_rounds=rounds)
            return {"error": None}
        except RuntimeError as e:
            return {"error": str(e), "stats": _stats(r.stats)
                    if case == "truncation" else None}

    for name, opts in (("plain", {}), ("sharded", {"sharded": True}),
                       ("sync2_compact", {"sync_every": 2, "compact": True}),
                       ("sharded_compact", {"sharded": True,
                                            "compact": True}),
                       ("spans", {"spans": True}),
                       ("legacy", {"fused": False})):
        counted(f"fifo/{name}", lambda: fifo(**opts))
    for relaxed in (True, False):
        mode = "relaxed" if relaxed else "strict"
        for name, opts in (("sync3", {"sync_every": 3}),
                           ("split_compact", {"split": True,
                                              "compact": True}),
                           ("legacy", {"fused": False})):
            counted(f"pmesh/{mode}/{name}",
                    lambda: pmesh(relaxed, **opts))
        counted(f"sssp/{mode}/{'split' if relaxed else 'packed'}",
                lambda: graph_sssp(relaxed, relaxed))
    counted("bfs/replicated", graph_bfs)
    if s == 2:
        counted("serving", serve)
    for case, fused in (("overflow", True), ("overflow", False),
                        ("seed_overflow", True), ("truncation", True)):
        counted(f"error/{case}/{fused}", lambda: errors(case, fused))
    out.update(_mtr_cases(s, port, mesh, me))
    out.update(_grad_cases(s, port, mesh, me))
    return out


def _mtr_cases(s, port, mesh, me):
    """``mesh_task_round`` round after round from each start: the grants,
    claims and ok of every shard (the port's rank: its own row) and the
    replicated ring."""
    res = {}
    if port:
        from repro_torch import core, runtime as rt

        def put(key, g, v, ok, st):
            res[key] = {"rows": [_np(x).astype(np.int64).tolist()
                                 for x in (g, v, ok)],
                        "state": [_digest(*st[:4]),
                                  int(st.tail), int(st.head)]}
        for start in STARTS:
            st = core.dist_queue_init(MTR_CAP, start=start, device="cpu")
            for r, x in enumerate(_mtr_inputs(s, 11 + s)):
                st, g, v, ok = rt.mesh_task_round(
                    st, *(torch.as_tensor(x[k][me])
                          for k in ("vals", "spawn", "claim")), mesh=mesh)
                put(f"mtr/{start}/{r}", g, v, ok, st)
        return res
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro import runtime as rt
    from repro.core.distqueue import dist_queue_init
    d, r_ = P("data"), P()
    f = jax.jit(shard_map(
        lambda st, v, sm, cm: rt.mesh_task_round(st, v, sm, cm, "data"),
        mesh=mesh, in_specs=(r_, d, d, d), out_specs=(r_, d, d, d)))
    for start in STARTS:
        st = dist_queue_init(MTR_CAP, start=start)
        for r, x in enumerate(_mtr_inputs(s, 11 + s)):
            st, g, v, ok = f(st, x["vals"].reshape(-1),
                             x["spawn"].reshape(-1), x["claim"].reshape(-1))
            res[f"mtr/{start}/{r}"] = {
                "rows": [np.asarray(y).reshape(s, -1).astype(np.int64)
                         .tolist() for y in (g, v, ok)],
                "state": [_digest(*(np.asarray(p) for p in st[:4])),
                          int(np.asarray(st.tail)),
                          int(np.asarray(st.head))]}
    return res


def _grad_cases(s, port, mesh, me):
    """The four gradient collectives on ``_grad_inputs``: every shard's
    result rows (the port's rank: its own), float32 bits as lists."""
    xs = _grad_inputs(s)
    errs = [0.01 * x for x in xs]
    if port:
        from repro_torch import distributed as D
        t = [torch.as_tensor(x[me]) for x in xs]
        e = [torch.as_tensor(x[me]) for x in errs]
        red, new = D.tree_allreduce_compressed(t, e, mesh)
        outs = {"codes": [D.quantize(x.float() + y)[0]
                          for x, y in zip(t, e)],
                "mean": [D.allreduce_mean(x, mesh) for x in t],
                "compressed": list(D.allreduce_compressed(t[0], e[0], mesh)),
                "tree_red": red, "tree_err": new,
                "bucketed": D.bucketed_psum(t, mesh, bucket_bytes=1024)}
        return {f"grad/{k}": [_np(x).reshape(-1).tolist() for x in v]
                for k, v in outs.items()}
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.distributed import collectives as C

    def smap(fn):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=P("data"),
                                 out_specs=P("data")))
    from repro.distributed import compression as jcomp
    rows = lambda y: [np.asarray(a).reshape(s, -1) for a in y]  # noqa
    codes = [np.stack([np.asarray(jcomp.quantize(x[i] + y[i])[0])
                       .reshape(-1) for i in range(s)])
             for x, y in zip(xs, errs)]
    mean = rows(smap(lambda ys: [C.allreduce_mean(y, "data")
                                 for y in ys])(xs))
    comp = rows(smap(lambda a: C.allreduce_compressed(a[0], a[1], "data"))(
        (xs[0], errs[0])))
    red, new = smap(lambda a: C.tree_allreduce_compressed(a[0], a[1],
                                                          "data"))(
        (xs, errs))
    buck = rows(smap(lambda ys: C.bucketed_psum(ys, "data",
                                                bucket_bytes=1024))(xs))
    outs = {"codes": codes, "mean": mean, "compressed": comp,
            "tree_red": rows(red),
            "tree_err": rows(new), "bucketed": buck}
    return {f"grad/{k}": [[row.tolist() for row in x] for x in v]
            for k, v in outs.items()}


def _functional_cases(mesh, me, s):
    """Every ``core.distqueue`` round function on this rank's rows against
    the one-card form on every shard's rows (the stacked mesh computed in
    this rank, no collective): {name: the group form's outputs equal the
    stacked outputs' row ``me`` and its replicated state}."""
    from repro_torch.core import distqueue as dq
    rng = np.random.default_rng(31 + s)
    b, w, out = 8, 4, {}

    def rows(*shape, hi=1 << 20):
        return torch.as_tensor(rng.integers(0, hi, (s,) + shape)
                               .astype(np.int32))

    def same(a, b):
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if a is None or b is None:
            return a is None and b is None
        return torch.equal(torch.as_tensor(a), torch.as_tensor(b))

    st = dq.dist_queue_init(64, start=2 ** 31 - 128, device="cpu")
    st, _ = dq.dist_enqueue_round(st, rows(b), torch.ones(s, b, dtype=bool))
    vals, mask = rows(b), rows(b, hi=2) > 0
    for name, fn in (("publish", dq.dist_publish_round),
                     ("publish_compact", dq.dist_publish_compact_round)):
        kw = dict(capacity=64, with_counts=True)
        if name == "publish_compact":
            kw["width"] = w
        one = fn(st, vals, mask, **kw)
        grp = fn(st, vals[me], mask[me], mesh=mesh, **kw)
        out[name] = (same(grp[0], one[0]) and same(grp[2:], one[2:])
                     and same(grp[1], None if one[1] is None
                              else one[1][me]))
    one = dq.dist_claim_round(st, 11, b, s, with_grid=True)
    grp = dq.dist_claim_round(st, 11, b, s, with_grid=True, mesh=mesh)
    out["claim"] = (same(grp[0], one[0]) and same(grp[1], one[1][me])
                    and same(grp[2], one[2][me]) and same(grp[3], one[3]))
    ck, cv, ca = rows(6), rows(6), rows(6)
    cm = rows(6, hi=2) > 0
    hint, size = rows(), rows(hi=50)
    meta = (rows(), rows())
    for name, fn, kw in (
            ("priority_publish", dq.dist_priority_publish_round, {}),
            ("priority_publish_compact",
             dq.dist_priority_publish_compact_round, {"width": w})):
        one = fn(ck, cv, cm, hint, size, pop_meta=meta, aux=ca, **kw)
        grp = fn(ck[me], cv[me], cm[me], hint[me], size[me],
                 pop_meta=(meta[0][me], meta[1][me]), aux=ca[me],
                 mesh=mesh, **kw)
        out[name] = same(grp, one)
    sh = dq.dist_sharded_queue_init(16 * s, s, device="cpu")
    planes, heads, tails = tuple(sh[:4]), sh.heads, sh.tails
    lg = planes[0].shape[1].bit_length() - 1
    seeds = rows(b)
    planes, tails, *_ = dq.dist_sharded_publish_round(
        planes, heads, tails, seeds, seeds > 0, nslots_log2=lg,
        local_capacity=16)
    one = dq.dist_sharded_claim_round(planes, heads, tails, 3,
                                      nslots_log2=lg)
    grp = dq.dist_sharded_claim_round(tuple(p[me] for p in planes), heads,
                                      tails, 3, nslots_log2=lg, mesh=mesh)
    out["sharded_claim"] = (same(grp[0], tuple(p[me] for p in one[0]))
                            and same(grp[1], one[1])
                            and same(grp[2], one[2][me])
                            and same(grp[3], one[3][me])
                            and same(grp[4], one[4]))
    for width in (None, w):
        one = dq.dist_sharded_publish_round(
            planes, heads, tails, vals, mask, nslots_log2=lg,
            local_capacity=16, width=width, pop_meta=meta)
        grp = dq.dist_sharded_publish_round(
            tuple(p[me] for p in planes), heads, tails, vals[me], mask[me],
            nslots_log2=lg, local_capacity=16, width=width,
            pop_meta=(meta[0][me], meta[1][me]), mesh=mesh)
        out[f"sharded_publish/{width}"] = (
            same(grp[0], tuple(p[me] for p in one[0]))
            and same(grp[1:], one[1:]))
    return out


def _golden_cases(mesh, world):
    """The golden scenarios on ``mesh`` (a group of ``world`` ranks):
    {golden name: result}, the port only."""
    from repro_torch import obs, serving
    from repro_torch.apps import bfs as gbfs
    from repro_torch.runtime import MeshRoundRunner, PriorityMeshRoundRunner
    tree, pri = _steps(True)[:2]
    comb = lambda a: a.sum(0, dtype=torch.int32)  # noqa: E731
    sfx = "" if world == 1 else f"_{world}"
    out = {}
    tel = obs.Telemetry(capacity=256)
    r = MeshRoundRunner(tree, mesh=mesh, capacity_log2=8, batch=16,
                        combine=comb, telemetry=tel, device="cpu")
    acc, st = r.run([1], acc=torch.zeros(80, dtype=torch.int32))
    out["mesh_fanout" + sfx] = {
        "stats": _stats(r.stats), "acc": _digest(acc),
        "planes": _digest(*st[:4]), "head_tail": [st.head, st.tail],
        "tel": _tel_digest(tel)}
    d, stats = gbfs.bfs_mesh_rounds(gbfs.road_like(144), 0, mesh=mesh,
                                    batch=32, device="cpu")
    out["mesh_bfs" + sfx] = {"stats": _stats(stats), "dist": _digest(d)}
    for relaxed in (True, False):
        tel = obs.Telemetry(capacity=512)
        r = PriorityMeshRoundRunner(pri, mesh=mesh, capacity_log2=10,
                                    batch=16, relaxed=relaxed, combine=comb,
                                    telemetry=tel, device="cpu")
        acc, st = r.run([3, 1], [7, 11],
                        acc=torch.zeros(89, dtype=torch.int32))
        out[("pmesh_relaxed" if relaxed else "pmesh_strict") + sfx] = {
            "stats": _stats(r.stats), "acc": _digest(acc),
            "planes": _digest(st[0], st[1]), "tel": _tel_digest(tel)}
    tel = obs.Telemetry(capacity=256)
    e = serving.ServingMeshEngine(mesh=mesh, capacity_log2=6, batch=8,
                                  table_log2=6, pop_log=128, telemetry=tel,
                                  device="cpu")
    e.begin()
    admitted = list(e.tick([60, 10, 30, 20, 50, 40, 35, 25],
                           [0, 1, 2, 3, 4, 5, 6, 7], slots=4, pages=5,
                           need=[2] * 8))
    ticks = 1
    while e.occupancy() > 0 and ticks < 12:
        admitted += e.tick([], [], slots=4, pages=4)
        ticks += 1
    st = e.heap_state()
    out["serving" + sfx] = {
        "stats": _stats(e.stats), "ticks": ticks, "admitted": admitted,
        "planes": _digest(st.keys, st.vals),
        "hist": _digest(np.asarray(e.pop_history(), np.int32)),
        "tel": _tel_digest(tel)}
    return json.loads(json.dumps(out))


# -- the processes ------------------------------------------------------------


def _rank_main(rank, world, store, outdir, stagedir):
    """One rank: every case on the world group, the goldens on a group of
    one rank (and, at two ranks, on the world), the group-size error;
    writes {name: result} to ``outdir/rank<r>.json`` and rank 0 its stage
    to ``stagedir``."""
    import torch.distributed as dist

    from repro_torch.distributed import make_mesh

    def stage(text):
        if rank == 0:
            _stage(stagedir, f"ranks {text}")
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    solo = [dist.new_group([r]) for r in range(world)]
    mesh = make_mesh((world,), ("data",), group=dist.group.WORLD)
    stage("cases")
    res = {"cases": _scenarios(world, True, mesh, rank)}
    stage("functional")
    res["functional"] = _functional_cases(mesh, rank, world)
    stage("goldens")
    res["golden"] = _golden_cases(make_mesh((1,), ("data",),
                                            group=solo[rank]), 1)
    if world == 2:
        res["golden"].update(_golden_cases(mesh, 2))
    try:
        make_mesh((world * 2,), ("data",), group=dist.group.WORLD)
        res["size_error"] = None
    except ValueError as e:
        res["size_error"] = str(e)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _stage(stagedir, text):
    with open(os.path.join(stagedir, "stage"), "w") as f:
        f.write(text)


def _launch(args, env=None):
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                            + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=env)


# the launched processes' OpenMP and torch pools one thread each
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
SPAWN_TIMEOUT = 300


def _reference_env(n):
    env = {**os.environ, **THREADS}
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={n}"
                        ).strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(REPO, "src"), env.get("PYTHONPATH"), REPO)
        if p)
    return env


def _port_env():
    env = {**os.environ, **THREADS}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(REPO, "src"), env.get("PYTHONPATH")) if p)
    return env


_CACHE = {}


def _results(world):
    """(reference, {rank: port}) at ``world`` shards; on first use every
    world size's four processes start together."""
    if not _CACHE:
        pytest.importorskip("jax")
        tmp = tempfile.mkdtemp(prefix="multicard_")
        atexit.register(shutil.rmtree, tmp, True)
        procs = {}
        for w in WORLDS:
            for side, flag, env in (("ref", "--worker", _reference_env(w)),
                                    ("port", "--ranks", _port_env())):
                d = os.path.join(tmp, f"{side}{w}")
                os.makedirs(d)
                procs[(side, w)] = (_launch([flag, str(w), d], env), d)
        outs = _wait(procs, SPAWN_TIMEOUT)
        for w in WORLDS:
            _CACHE[w] = (outs[("ref", w)],
                         {int(r): v for r, v in outs[("port", w)].items()})
    return _CACHE[world]


def _wait(procs, timeout):
    """Each process's last stdout line as JSON; a process still running
    at ``timeout`` seconds is killed (with the others) and the call
    fails naming every process's last stage (``<dir>/stage``)."""
    deadline = time.monotonic() + timeout
    outs = {}
    try:
        for key, (p, d) in procs.items():
            stdout, stderr = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))
            assert p.returncode == 0, (key, stderr[-3000:])
            outs[key] = json.loads(stdout.strip().splitlines()[-1])
    except subprocess.TimeoutExpired:
        for p, _ in procs.values():
            p.kill()
        stages = {}
        for key, (p, d) in procs.items():
            p.communicate()
            path = os.path.join(d, "stage")
            stages[key] = (open(path).read() if os.path.exists(path)
                           else "not started")
        pytest.fail(f"ran past {timeout} s; last stages {stages}")
    return outs


# -- the tests ----------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_goldens_on_groups(world):
    """GOLDEN's mesh rows on a group of one rank, on every rank; at two
    ranks GOLDEN_2SHARD on the world group, the same on both ranks."""
    _, port = _results(world)
    for rank, res in port.items():
        want = dict(GOLDEN)
        if world == 2:
            want.update(GOLDEN_2SHARD)
        assert res["golden"] == json.loads(json.dumps(want)), rank


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", ("fifo", "pmesh", "sssp", "bfs",
                                    "serving", "error"))
def test_matches_shard_map(world, family):
    """Every case of the family gives the reference's results on every
    rank, with one exchange a round (a legacy round, an engine round)."""
    ref, port = _results(world)
    names = [k for k in ref if k.split("/")[0] == family]
    if family == "serving" and world != 2:
        assert not names
        return
    assert names
    for rank, res in port.items():
        for name in names:
            got = dict(res["cases"][name])
            exchanges = got.pop("exchanges")
            assert got == ref[name], (rank, name)
            if "error" not in got:
                # one collective a round
                assert exchanges == got["stats"][0], (rank, name)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_task_round_rows(world):
    """Each rank's grants, claims and ok are the reference's row of its
    shard; the replicated ring is the reference's on every rank; each
    round makes the reference's two collectives."""
    ref, port = _results(world)
    keys = [k for k in ref if k.startswith("mtr/")]
    assert len(keys) == len(STARTS) * MTR_ROUNDS
    for rank, res in port.items():
        for k in keys:
            got = res["cases"][k]
            assert got["state"] == ref[k]["state"], (rank, k)
            assert got["rows"] == [r[rank] for r in ref[k]["rows"]], (rank,
                                                                      k)


@pytest.mark.parametrize("world", WORLDS)
def test_gradient_collectives(world):
    """The int8 codes of every rank's compressed payload bit for bit; the
    reduced means, sums and residuals within GRAD_ULPS of the
    reference's, on every rank."""
    ref, port = _results(world)
    big = world * max(float(np.abs(x).max()) for x in _grad_inputs(world))
    tol = GRAD_ULPS * float(np.spacing(np.float32(big)))
    for rank, res in port.items():
        for name in ("codes", "mean", "compressed", "tree_red", "tree_err",
                     "bucketed"):
            got, want = res["cases"][f"grad/{name}"], ref[f"grad/{name}"]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                if name == "codes":
                    assert g == w[rank], rank
                    continue
                g, w = np.asarray(g, np.float32), np.asarray(w[rank],
                                                             np.float32)
                np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("world", WORLDS)
def test_gradient_collectives_on_one_card(world):
    """The one-card form (every shard's leaves stacked (S, ...)) gives
    each shard's row the reference's results, within the same bound."""
    from repro_torch import distributed as D
    ref, _ = _results(world)
    mesh = D.make_mesh((world,), ("data",))
    xs = [torch.as_tensor(x) for x in _grad_inputs(world)]
    errs = [0.01 * x for x in xs]
    red, new = D.tree_allreduce_compressed(xs, errs, mesh)
    got = {"mean": [D.allreduce_mean(x, mesh) for x in xs],
           "compressed": list(D.allreduce_compressed(xs[0], errs[0], mesh)),
           "tree_red": red, "tree_err": new,
           "bucketed": D.bucketed_psum(xs, mesh, bucket_bytes=1024)}
    big = world * max(float(x.abs().max()) for x in xs)
    tol = GRAD_ULPS * float(np.spacing(np.float32(big)))
    for name, outs in got.items():
        for g, w in zip(outs, ref[f"grad/{name}"]):
            np.testing.assert_allclose(
                g.reshape(world, -1).numpy(), np.asarray(w, np.float32),
                rtol=0, atol=tol)


@pytest.mark.parametrize("world", WORLDS)
def test_round_functions_take_this_ranks_rows(world):
    """Every ``dist_*`` round function given a group-bound mesh returns
    the one-card form's row of this rank and its replicated state."""
    _, port = _results(world)
    for rank, res in port.items():
        assert res["functional"] and all(res["functional"].values()), (
            rank, res["functional"])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_agrees_and_group_size_is_checked(world):
    _, port = _results(world)
    first = port[0]["cases"]
    for rank, res in port.items():
        for k, v in res["cases"].items():
            if not k.startswith(("mtr/", "grad/")):
                assert v == first[k], (rank, k)
        assert res["size_error"] == (
            f"make_mesh: the process group has {world} ranks but the mesh "
            f"{{'data': {2 * world}}} has {2 * world} shards")


def _spawn_ranks(world, stagedir):
    """Run ``_rank_main`` on ``world`` spawned ranks; print {rank:
    results} as one JSON line."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(world, os.path.join(tmp, "store"), tmp,
                                   stagedir),
                 nprocs=world, join=True)
        out = {}
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out[r] = json.load(f)
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1] == "--worker":        # the reference under shard_map
        from repro.jaxcompat import make_mesh as jmesh
        n = int(sys.argv[2])
        _stage(sys.argv[3], "reference cases")
        print(json.dumps(_scenarios(n, False, jmesh((n,), ("data",)))))
    elif sys.argv[1] == "--ranks":       # the port's ranks
        _spawn_ranks(int(sys.argv[2]), sys.argv[3])
