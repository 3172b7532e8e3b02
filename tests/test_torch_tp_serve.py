"""The port's serve steps over ("data", "model") meshes on gloo ranks, held
against the reference's sharded ``jit`` prefill and serve steps on forced
host devices.

Two world sizes start once a pytest run, all four processes at once:
``python tests/test_torch_tp_serve.py --ranks W`` spawns W ranks of a gloo
group, which run every case on every mesh of W ranks (W = 2: (1, 2); W =
4: (1, 4) and (2, 2)) with ``launch.steps.make_prefill_step(pspecs=,
mesh=)`` and ``make_serve_step(pspecs=, mesh=)`` on the rank's blocks of
the parameters (``models.init_params_block``) and its rows of the batch;
``--worker N`` runs the reference's ``make_prefill_step`` and
``make_serve_step`` under ``jax.jit`` on the same meshes of N forced host
devices, with the dry run's ``in_shardings`` (``param_specs``,
``batch_pspecs``, ``cache_pspecs`` and ``token_pspecs``, sanitized;
``seq_parallel=True`` for the prefill; meshes from
``repro.jaxcompat.make_mesh`` under ``jax.set_mesh``), from the same
parameters (the port's ``init_params`` in float32, carried over as
numpy) and tokens.  Each side prefills, fills its decode ring caches
from its own prefill's K and V, and decodes DECODE greedy steps.

Cases (reduced configs, float32 parameters and caches):

* ``dense``: gemma2-27b with FSDP (local and global layers, both
  soft-caps).  At M = 4 its 2 kv heads of hd 32 do not divide "model":
  wk's 64 columns split into blocks of half a kv head, so attention takes
  the general path (the cut projections all-gathered), and the cache
  takes ``cache_pspecs``' hd branch (a decode's logits all-reduced over
  hd).  At (2, 2) its leaves are cut over both axes.
* ``moe``: deepseek-moe-16b, its 8 experts over "model"; 512 tokens, so
  at (2, 2) each data rank's tokens are one dispatch group.
* ``moe_e6``: the same with 6 experts, which M = 4 does not divide: the
  experts are replicated and every rank runs all of them (at M = 2 they
  are cut); 128 tokens, the one-group fallback across the data ranks.
* ``vocab``: yi-34b with a 509-entry vocabulary, which no M divides:
  ``embed`` and ``lm_head`` are replicated.

Held: the prefill's last-token logits and every decode step's within
LOGITS_TOL, the greedy tokens equal, each rank's prefill K/V and final
decode cache blocks within CACHE_TOL of their slice of the reference's,
every rank's logits and tokens identical, every rank's collectives a
step equal to ``serve_collectives``, the blocks drawn by
``init_params_block`` equal to ``interop.params_block_from_numpy`` of the
whole parameters, MoE slots (layer 0 of the prefill) equal on every rank
of the model axis and to the reference's ticket rule under its
``_dp_groups``, integer for integer, and the refusals (an ssm config
served or trained over "model", ``cache_pspecs``' sequence-sharded
branch) raising by name, and training a dense config over "model"
taken (``tests/test_torch_tp_train.py`` holds it).  A launched process
still running after SPAWN_TIMEOUT seconds is killed and the test fails
naming each process's last stage."""

import atexit
import dataclasses
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
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
DECODE = 8
BATCH = 4
# float32 parameters and caches on both sides: the sums over "model" and
# GSPMD's partial sums run in other orders than one device's (measured
# at most 6.7e-6 on the logits, which reach about 4, and 7.7e-6 on the
# K/V blocks, which reach about 4.4)
LOGITS_TOL = dict(atol=5e-5, rtol=0)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
# name: (arch, config changes, prompt length)
CASES = {
    "dense": ("gemma2-27b", {"fsdp": True}, 32),
    "moe": ("deepseek-moe-16b", {}, 128),
    "moe_e6": ("deepseek-moe-16b", {"n_experts": 6}, 32),
    "vocab": ("yi-34b", {"vocab": 509}, 32),
}


def _cfg(pkg, case):
    arch, changes, _ = CASES[case]
    return dataclasses.replace(pkg.get_config(arch).reduced(), **changes)


def _tokens(cfg, case):
    s = CASES[case][2]
    rng = np.random.default_rng([len(case), s])
    return rng.integers(0, cfg.vocab, (BATCH, s)).astype(np.int32)


def _initial_params(cfg):
    """The port's ``init_params`` in float32 from a generator seeded 7."""
    from repro_torch.models import init_params
    gen = torch.Generator()
    gen.manual_seed(7)
    return init_params(cfg, gen, device="cpu", dtype=torch.float32)


def _fill_rings(caches, k, v, s):
    """Write a prefill's K and V ((L, B, s, kv, hd)) into per-layer ring
    caches: position p of the last min(Sc, s) at slot p % Sc."""
    for i, c in enumerate(caches):
        sc = c["k"].shape[1]
        n = min(sc, s)
        pos = np.arange(s - n, s)
        c["k"][:, pos % sc] = k[i][:, s - n:]
        c["v"][:, pos % sc] = v[i][:, s - n:]
    return caches


def _slots_oracle(gates, k, e, g, capacity_factor):
    """The reference's grouped ticket rule in numpy: top-k in index order
    on ties, an exclusive cumsum of the one-hot within each of g groups,
    -1 at or past the group's capacity."""
    t = gates.shape[0]
    top = np.argsort(-gates, axis=1, kind="stable")[:, :k]
    tl = t // g
    cap = int(tl * k / e * capacity_factor) + 1
    cap = -(-cap // 32) * 32
    onehot = np.eye(e, dtype=np.int64)[top].reshape(g, tl * k, e)
    ranks = np.cumsum(onehot, axis=1) - onehot
    slot = (ranks * onehot).sum(-1).reshape(t, k)
    return np.where(slot < cap, slot, -1)


# -- the reference ------------------------------------------------------------


def _reference(devices, outdir, stagedir):
    """Every case on every mesh of ``devices`` forced host devices; each
    (mesh, case)'s logits, tokens and caches to ``outdir``, its stage to
    ``stagedir``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro import configs as jconfigs
    from repro.jaxcompat import make_mesh
    from repro.launch import steps as jsteps
    from repro.models import init_decode_cache
    from repro.models import moe as jmoe
    from repro_torch import configs
    from repro_torch.interop import params_to_numpy

    isp = lambda x: isinstance(x, JP)  # noqa: E731
    out = {}
    for key, shape in MESHES.items():
        if shape[0] * shape[1] != devices:
            continue
        mesh = make_mesh(shape, ("data", "model"))
        ns = lambda t: jax.tree.map(  # noqa: E731
            lambda s: NamedSharding(mesh, s), t, is_leaf=isp)
        with jax.set_mesh(mesh):
            for case in CASES:
                _stage(stagedir, f"reference {key} {case}")
                cfg, jcfg = _cfg(configs, case), _cfg(jconfigs, case)
                s = CASES[case][2]
                params = jax.tree.map(jnp.asarray, params_to_numpy(
                    _initial_params(cfg)))
                pspecs = jsteps.sanitize_pspecs(
                    jsteps.param_specs(jcfg), params, mesh)
                params = jax.device_put(params, ns(pspecs))
                tokens = _tokens(cfg, case)
                rows = ("data",) if BATCH % shape[0] == 0 else ()
                bspec = {"tokens": JP(rows, None)}
                pre = jax.jit(jsteps.make_prefill_step(
                    dataclasses.replace(jcfg, seq_parallel=True)),
                    in_shardings=(pspecs, bspec))
                logits, kv = pre(params, jax.device_put(
                    {"tokens": jnp.asarray(tokens)}, ns(bspec)))
                k, v = np.asarray(kv["k"]), np.asarray(kv["v"])
                cache = jax.tree.map(np.array, init_decode_cache(
                    jcfg, BATCH, s + DECODE, dtype=jnp.float32))
                cache = _fill_rings(cache, k, v, s)
                cspecs = jsteps.sanitize_pspecs(
                    jsteps.cache_pspecs(jcfg, "decode_32k", mesh),
                    cache, mesh)
                tspec = jsteps.token_pspecs(jcfg, "decode_32k", mesh)
                serve = jax.jit(jsteps.make_serve_step(jcfg),
                                in_shardings=(pspecs, cspecs, tspec, JP()))
                cache = jax.device_put(jax.tree.map(jnp.asarray, cache),
                                       ns(cspecs))
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                dec, toks = [], []
                for j in range(DECODE):
                    lj, cache = serve(params, cache,
                                      jax.device_put(tok, ns(tspec)),
                                      jnp.int32(s + j))
                    tok = jnp.argmax(lj, -1).astype(jnp.int32)
                    dec.append(np.asarray(lj))
                    toks.append(np.asarray(tok))
                save = {"prefill": np.asarray(logits), "k": k, "v": v,
                        "decode": np.stack(dec), "tokens": np.stack(toks)}
                for i, c in enumerate(cache):
                    save[f"cache/{i}/k"] = np.asarray(c["k"])
                    save[f"cache/{i}/v"] = np.asarray(c["v"])
                np.savez(os.path.join(outdir, f"ref_{key}_{case}.npz"),
                         **save)
                out[f"{key}/{case}"] = {
                    "groups": jmoe._dp_groups(BATCH * s),
                    "cache_specs": [{n: list(sp[n]) for n in sp}
                                    for sp in cspecs]}
    return out


# -- the port's ranks ---------------------------------------------------------


def _spy_route(seen):
    """Record ``models.moe.route``'s first call of each step: the gates
    and the slots.  Returns the undo."""
    from repro_torch.models import moe
    real = moe.route

    def spy(gates, cfg, *a, **kw):
        out = real(gates, cfg, *a, **kw)
        if not seen:
            seen.append((gates.numpy().copy(), out[0].numpy().copy()))
        return out
    moe.route = spy

    def undo():
        moe.route = real
    return undo


def _run_case(key, case, mesh, rank, outdir):
    from repro_torch import configs
    from repro_torch.distributed import COLLECTIVES
    from repro_torch.distributed.sharding import coords, shard
    from repro_torch.interop import params_block_from_numpy, params_to_numpy
    from repro_torch.launch import steps
    from repro_torch.models import init_decode_cache, init_params_block
    from repro_torch.models.layers import kv_layout, layer_cut
    from repro_torch.tree import tree_leaves
    cfg = _cfg(configs, case)
    s = CASES[case][2]
    pre_cfg = dataclasses.replace(cfg, seq_parallel=True)
    specs = steps.sanitize_pspecs(steps.param_specs(cfg),
                                  steps.params_struct(cfg), mesh)
    gen = torch.Generator()
    gen.manual_seed(7)
    params = init_params_block(cfg, specs, mesh, gen, device="cpu",
                               dtype=torch.float32)
    want = params_block_from_numpy(params_to_numpy(_initial_params(cfg)),
                                   specs, mesh, device="cpu")
    same_init = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(want)))
    tokens = torch.from_numpy(_tokens(cfg, case))
    bspec = steps.sanitize_pspecs(
        steps.batch_pspecs(cfg, "prefill_32k", mesh, batch=BATCH),
        steps.batch_struct(cfg, "prefill_32k", batch=BATCH, seq=s),
        mesh)["tokens"]
    pre = steps.make_prefill_step(pre_cfg, specs, mesh=mesh,
                                  batch_specs=bspec)
    seen = []
    undo = _spy_route(seen)
    before = dict(COLLECTIVES)
    try:
        logits, kv = pre(params, {"tokens": shard(tokens, bspec, mesh)})
    finally:
        undo()
    coll = [{k: COLLECTIVES[k] - before[k] for k in COLLECTIVES}]
    plans = [steps.serve_collectives(pre_cfg, specs, mesh, BATCH * s,
                                     seq=s)]
    struct = init_decode_cache(cfg, BATCH, s + DECODE, torch.float32,
                               device="meta")
    cspecs = steps.sanitize_pspecs(
        steps.cache_pspecs(cfg, "decode_32k", mesh), struct, mesh)
    cache = init_decode_cache(cfg, BATCH, s + DECODE, torch.float32,
                              device="cpu", specs=cspecs, mesh=mesh)
    cache = _fill_rings(cache, kv["k"], kv["v"], s)
    # the prefill written straight into the ring caches
    into = init_decode_cache(cfg, BATCH, s + DECODE, torch.float32,
                             device="cpu", specs=cspecs, mesh=mesh)
    _, into = pre(params, {"tokens": shard(tokens, bspec, mesh)}, into=into)
    same_into = all(torch.equal(a[n], b[n]) for a, b in zip(into, cache)
                    for n in ("k", "v"))
    serve = steps.make_serve_step(cfg, specs, mesh=mesh)
    tok = logits.argmax(-1).int()          # this rank's rows
    dec, toks = [], []
    for j in range(DECODE):
        before = dict(COLLECTIVES)
        lj, cache = serve(params, cache, tok, s + j)
        coll.append({k: COLLECTIVES[k] - before[k] for k in COLLECTIVES})
        plans.append(steps.serve_collectives(cfg, specs, mesh, BATCH,
                                             decode=True))
        tok = lj.argmax(-1).int()
        dec.append(lj.numpy())
        toks.append(tok.numpy())
    save = {"prefill": logits.numpy(), "k": kv["k"].numpy(),
            "v": kv["v"].numpy(), "decode": np.stack(dec),
            "tokens": np.stack(toks)}
    for i, c in enumerate(cache):
        save[f"cache/{i}/k"] = c["k"].numpy()
        save[f"cache/{i}/v"] = c["v"].numpy()
    if seen:
        save["gates"], save["slots"] = seen[0]
    np.savez(os.path.join(outdir, f"port_{key}_{case}_rank{rank}.npz"),
             **save)
    tp = pre.tp
    return {"same_init": same_init, "same_into": same_into,
            "coords": list(coords(mesh, rank)),
            "collectives": [{k: v for k, v in c.items() if v or k in p}
                            for c, p in zip(coll, plans)],
            "plans": plans, "layout": kv_layout(cspecs[0]["k"], mesh),
            "split": {n: layer_cut(tp, n) for n in specs["layers"]},
            "embed_split": tp.split(specs["embed"]),
            "cache_specs": [{n: list(sp[n]) for n in sp} for sp in cspecs]}


def _refusals(mesh):
    """The error text of each path not ported, or None where it ran."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import init_decode_cache
    out = {}
    cfg = configs.get_config("h2o-danube-1.8b").reduced()
    seq = init_decode_cache(cfg, 1, 64, device="meta")
    ssm = configs.get_config("mamba2-130m").reduced()
    attempts = {
        "train": lambda: steps.make_train_step(
            cfg, pspecs=steps.state_pspecs(cfg).master, mesh=mesh),
        "train_ssm": lambda: steps.make_train_step(
            ssm, pspecs=steps.state_pspecs(ssm).master, mesh=mesh),
        "ssm": lambda: steps.make_prefill_step(
            configs.get_config("mamba2-130m").reduced(),
            steps.param_specs(configs.get_config("mamba2-130m").reduced()),
            mesh=mesh),
        "seq_cache": lambda: init_decode_cache(
            cfg, 1, 64, device="meta", mesh=mesh, specs=steps.sanitize_pspecs(
                steps.cache_pspecs(cfg, "long_500k", mesh), seq, mesh)),
    }
    for name, fn in attempts.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _rank_main(rank, world, store, outdir):
    import torch.distributed as dist

    from repro_torch.distributed import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    res = {}
    for key, shape in MESHES.items():
        if shape[0] * shape[1] != world:
            continue
        mesh = make_mesh(shape, ("data", "model"), group=dist.group.WORLD)
        for case in CASES:
            if rank == 0:
                _stage(outdir, f"ranks {key} {case}")
            res[f"{key}/{case}"] = _run_case(key, case, mesh, rank, outdir)
        res[f"{key}/refused"] = _refusals(mesh)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _spawn_ranks(world, outdir):
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(world, os.path.join(outdir, "store"), outdir),
             nprocs=world, join=True)
    out = {}
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            out[r] = json.load(f)
    print(json.dumps(out))


def _stage(outdir, text):
    with open(os.path.join(outdir, "stage"), "w") as f:
        f.write(text)


def _launch(args, env):
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                            + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=env)


def _wait(procs, timeout):
    """Each process's last stdout line as JSON; a process still running
    at ``timeout`` seconds is killed (with the others) and the call
    fails naming every process's last stage (``outdir/stage``)."""
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


# the launched processes' OpenMP and torch pools one thread each (the
# ranks also call ``torch.set_num_threads(1)``)
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
SPAWN_TIMEOUT = 300


def _env(n=None):
    env = {**os.environ, **THREADS}
    if n is not None:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + f" --xla_force_host_platform_device_count={n}"
                            ).strip()
        env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(REPO, "src"), env.get("PYTHONPATH"), REPO)
        if p)
    return env


_CACHE = {}


def _results():
    """(reference info, {rank: port info} per world size, the npz
    directory); on first use all four processes start together."""
    if not _CACHE:
        pytest.importorskip("jax")
        tmp = tempfile.mkdtemp(prefix="tp_serve_")
        atexit.register(shutil.rmtree, tmp, True)
        procs = {}
        for w in (2, 4):
            d = os.path.join(tmp, f"stage{w}")
            os.makedirs(d)
            procs[("ref", w)] = (_launch(["--worker", str(w), tmp, d],
                                         _env(w)), d)
            d = os.path.join(tmp, f"ranks{w}")
            os.makedirs(d)
            procs[("port", w)] = (_launch(["--ranks", str(w), d], _env()), d)
        outs = _wait(procs, SPAWN_TIMEOUT)
        _CACHE.update(ref={**outs[("ref", 2)], **outs[("ref", 4)]},
                      port={w: {int(r): v for r, v in outs[("port", w)]
                                .items()} for w in (2, 4)},
                      dir=tmp)
    return _CACHE


def _case(mesh, case):
    res = _results()
    world = MESHES[mesh][0] * MESHES[mesh][1]
    ranks = {r: v[f"{mesh}/{case}"] for r, v in res["port"][world].items()}
    want = np.load(os.path.join(res["dir"], f"ref_{mesh}_{case}.npz"))
    got = {r: np.load(os.path.join(res["dir"], f"ranks{world}",
                                   f"port_{mesh}_{case}_rank{r}.npz"))
           for r in ranks}
    return res["ref"][f"{mesh}/{case}"], want, ranks, got


def _rows(coords):
    d = coords[0]
    return slice(d * BATCH // 2, (d + 1) * BATCH // 2)


# -- the tests ----------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_logits_and_tokens_match_reference(mesh, case):
    """The prefill's last-token logits and DECODE greedy decode steps'
    logits, each rank's rows against the reference's within LOGITS_TOL;
    the greedy tokens equal; the ranks of one data index identical."""
    _, want, ranks, got = _case(mesh, case)
    d_sz = MESHES[mesh][0]
    for r, info in ranks.items():
        rows = _rows(info["coords"]) if d_sz > 1 else slice(None)
        g = got[r]
        np.testing.assert_allclose(g["prefill"], want["prefill"][rows],
                                   **LOGITS_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(g["decode"], want["decode"][:, rows],
                                   **LOGITS_TOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(g["tokens"], want["tokens"][:, rows])
        first = next(q for q, i in ranks.items()
                     if i["coords"][0] == info["coords"][0])
        for k in ("prefill", "decode", "tokens"):
            np.testing.assert_array_equal(g[k], got[first][k])


def _rank(info, mesh):
    d, j = info["coords"]
    return d * MESHES[mesh][1] + j


def _spec(spec):
    from repro_torch.distributed.sharding import P
    return P(*[tuple(e) if isinstance(e, list) else e for e in spec])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_blocks_match_reference(mesh, case):
    """Each rank's prefill K and V (its cache layout: kv heads, hd slices
    or whole, its batch rows) and its ring caches after the decode,
    against its slice of the reference's (``cache_pspecs``, sanitized:
    the same specs on both sides; the caches cut by
    ``interop.cache_block_from_numpy``); ``prefill(into=)`` writes the
    same rings as the stacked K and V put into them."""
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import P, shard
    from repro_torch.interop import cache_block_from_numpy
    ref, want, ranks, got = _case(mesh, case)
    m = make_mesh(MESHES[mesh], ("data", "model"))
    for r, info in ranks.items():
        assert info["same_into"], r       # prefill(into=) fills the rings
        assert info["cache_specs"] == ref["cache_specs"]
        specs = [{n: _spec(sp[n]) for n in sp} for sp in info["cache_specs"]]
        for n in ("k", "v"):          # the stacked layers lead the spec
            whole = torch.from_numpy(want[n])
            np.testing.assert_allclose(
                got[r][n], shard(whole, P(None, *specs[0][n]), m,
                                 _rank(info, mesh)).numpy(),
                **CACHE_TOL, err_msg=f"rank {r} prefill {n}")
        cache = [{n: want[f"cache/{i}/{n}"] for n in ("k", "v")}
                 for i in range(len(specs))]
        blocks = cache_block_from_numpy(cache, specs, m,
                                        rank=_rank(info, mesh), device="cpu")
        for i, blk in enumerate(blocks):
            for n in ("k", "v"):
                np.testing.assert_allclose(
                    got[r][f"cache/{i}/{n}"], blk[n].numpy(), **CACHE_TOL,
                    err_msg=f"rank {r} layer {i} {n}")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_collectives_follow_the_plan(mesh, case):
    """Every rank's collectives of the prefill and of each decode step
    are ``serve_collectives``'; its blocks are
    ``params_block_from_numpy``'s of the whole parameters."""
    _, _, ranks, _ = _case(mesh, case)
    for r, info in ranks.items():
        assert info["same_init"], r
        for i, (got, plan) in enumerate(zip(info["collectives"],
                                            info["plans"])):
            assert got == plan, (r, i, got, plan)
        assert info["plans"][0]["tp_scatter"] > 0     # sequence parallel
        if MESHES[mesh][0] > 1 and case == "dense":
            assert info["plans"][0]["all_gather"] == 1 + 2   # FSDP


def test_each_path_is_reached():
    """The cases reach the paths the specs choose: the fast path (kv
    heads over "model"), the split-head path with the hd-sharded cache
    (gemma2 at M = 4), experts over "model" and replicated (6 experts at
    M = 4), a replicated vocabulary."""
    def info(mesh, case):
        return _case(mesh, case)[2][0]
    assert info("1x2", "dense")["layout"] == "heads"
    dense4 = info("1x4", "dense")
    assert dense4["layout"] == "hd" and dense4["split"]["wk"]
    assert info("1x4", "dense")["cache_specs"][0]["k"][3] == "model"
    assert info("1x4", "moe")["split"]["e_gate"]
    assert info("1x2", "moe_e6")["split"]["e_gate"]
    assert not info("1x4", "moe_e6")["split"]["e_gate"]
    assert info("1x4", "moe_e6")["split"]["s_down"]
    for mesh in MESHES:
        assert not info(mesh, "vocab")["embed_split"]
        assert info(mesh, "dense")["embed_split"]
        assert info(mesh, "moe")["plans"][1]["exchange"] == (
            4 if MESHES[mesh][0] > 1 else 0)
    assert info("2x2", "moe")["plans"][0]["exchange"] == 0   # grouped
    assert info("2x2", "moe_e6")["plans"][0]["exchange"] == 4


@pytest.mark.parametrize("case", ["moe", "moe_e6"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_slots_are_the_reference_rule(mesh, case):
    """Layer 0's slots in the prefill: equal on every rank of a data
    index, and the data ranks' together equal to the reference's ticket
    rule on their gates under its ``_dp_groups`` (the mesh's), integer
    for integer."""
    from repro_torch import configs
    ref, _, ranks, got = _case(mesh, case)
    cfg = _cfg(configs, case)
    by_d = {}
    for r, info in ranks.items():
        d = info["coords"][0]
        if d in by_d:
            np.testing.assert_array_equal(got[r]["slots"],
                                          got[by_d[d]]["slots"])
            np.testing.assert_array_equal(got[r]["gates"],
                                          got[by_d[d]]["gates"])
        else:
            by_d[d] = r
    gates = np.concatenate([got[by_d[d]]["gates"] for d in sorted(by_d)])
    slots = np.concatenate([got[by_d[d]]["slots"] for d in sorted(by_d)])
    want = _slots_oracle(gates, cfg.top_k, cfg.n_experts, ref["groups"],
                         cfg.capacity_factor)
    if ref["groups"] == 1 and len(by_d) > 1:
        # the one-group fallback: each rank's slots continue the earlier
        # ranks' tickets
        np.testing.assert_array_equal(slots, want)
    else:
        np.testing.assert_array_equal(slots, want)
    assert ref["groups"] == (len(by_d) if case == "moe" else 1)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_what_is_not_ported_is_refused_by_name(mesh):
    res = _results()
    world = MESHES[mesh][0] * MESHES[mesh][1]
    for r, v in res["port"][world].items():
        got = v[f"{mesh}/refused"]
        assert got["train"] is None, r    # training over "model" is ported
        assert 'ssm family' in got["train_ssm"] and \
            "not ported" in got["train_ssm"], r
        assert 'ssm family' in got["ssm"] and "not ported" in got["ssm"]
        if MESHES[mesh][0] > 1:
            assert "sequence-sharded branch" in got["seq_cache"], r
        else:
            assert got["seq_cache"] is None   # batch 1 splits over no rank


if __name__ == "__main__":
    if sys.argv[1] == "--worker":        # the reference on forced devices
        print(json.dumps(_reference(int(sys.argv[2]), sys.argv[3],
                                    sys.argv[4])))
    elif sys.argv[1] == "--ranks":       # the port's ranks
        _spawn_ranks(int(sys.argv[2]), sys.argv[3])
