"""The port's train step over ("data", "model") meshes on gloo ranks, held
against the reference's sharded ``jit`` train step on forced host
devices.

Two world sizes start once a pytest run, all four processes at once:
``python tests/test_torch_tp_train.py --ranks W`` spawns W ranks of a gloo
group, which train their cases (W = 2: mesh (1, 2); W = 4: (1, 4) and
(2, 2)) for STEPS steps with ``launch.steps.make_train_step(pspecs=,
mesh=)`` on the rank's blocks of the state (``init_state``) and its rows
of the batch; ``--worker N`` runs the reference's
``make_train_step(cfg, pspecs=)`` under ``jax.jit`` on the same meshes of
N forced host devices with the dry run's ``in_shardings`` (the sanitized
state and batch specs; meshes from ``repro.jaxcompat.make_mesh`` under
``jax.set_mesh``), from the same initial state (the port's
``init_params``, carried over as numpy) and the same batches.  Both
sides train in float32: each process replaces its package's
``adamw.cast_params`` (the bfloat16 working copy) by the identity, so
that the comparison sees the sums' order and not bfloat16 roundings or
the routing flips they cause (``tests/test_torch_moe_drift.py``).

Cases (reduced configs at 2 layers, FSDP on, a 4 x 16 batch whose rows'
``-1`` label tails differ), each reaching its path at the smallest size:

* ``yi`` (yi-34b) at (1, 2): kv heads over "model", the fast path;
  sequence parallelism; the vocabulary-parallel loss;
* ``gemma`` (gemma2-27b, a local and a global layer, both soft-caps) at
  (1, 4): its 2 kv heads do not divide "model", so a column block splits a
  GQA group: the general path (the cut projections all-gathered, their
  gradients reduce-scattered);
* ``moe`` (deepseek-moe-16b) at (1, 2) and (2, 2): its 8 experts over
  "model"; at (2, 2) the one-group dispatch fallback across the data
  ranks (64 tokens), and leaves cut over both axes;
* ``moe_e6`` (6 experts) at (1, 4), without sequence parallelism: M does
  not divide E, so every rank runs every expert and their sum crosses no
  rank (a whole term whose gradient one rank takes); the layers' inputs
  are the same on every rank and their gradients all-reduced;
* ``yi_vocab`` (a 509-entry vocabulary, which no M divides) at (2, 2):
  ``embed`` and ``lm_head`` whole over "model", each rank's positions'
  loss terms summed over it.

Held: each step's loss within LOSS_RTOL and grad norm within GRAD_RTOL
of the reference's, lr within ADAM_RTOL; the gathered master after the
steps within MASTER_RTOL (a family's) of the reference's in the
Frobenius norm of each leaf's change; every rank's loss and grad norm
identical, and every block that two ranks both hold equal on them after
the steps (the replicated leaves on every rank); each rank's collectives
a step equal to ``train_collectives``; the initial blocks equal to
``interop.opt_state_block_from_numpy`` of the whole state; and the
refusals by name (the ssm, hybrid, vlm and audio families over "model",
``cache_pspecs``' sequence-sharded branch).  A launched process that runs
past SPAWN_TIMEOUT seconds is killed and the test fails naming its last
stage."""

import atexit
import dataclasses
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
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
STEPS = 2
BATCH, SEQ, LAYERS = 4, 16, 2
# float32 on both sides, so the sums over "model" and GSPMD's partial sums
# differ only in their order.  Measured, worst over the cells and steps:
# loss 1.5e-7, grad norm 4.1e-7, lr 7.5e-8 relative
LOSS_RTOL = 1e-6
GRAD_RTOL = 2e-6
ADAM_RTOL = 1e-6
# the gathered master against the reference's, ||got - want|| / ||want -
# initial|| leaf by leaf; measured worst leaves: dense 1.9e-4 (yi_vocab's
# wq at (2, 2)), moe 5.2e-4 (wk at (2, 2))
MASTER_RTOL = {"dense": 1e-3, "moe": 2e-3}
OPT = dict(lr=1e-4, warmup_steps=1, total_steps=10)
SPAWN_TIMEOUT = 300
# name: (arch, config changes)
CASES = {
    "yi": ("yi-34b", {}),
    "gemma": ("gemma2-27b", {}),
    "moe": ("deepseek-moe-16b", {}),
    "moe_e6": ("deepseek-moe-16b", {"n_experts": 6, "seq_parallel": False}),
    "yi_vocab": ("yi-34b", {"vocab": 509}),
}
# the (mesh, case) cells: one reference compile each
CELLS = (("1x2", "yi"), ("1x2", "moe"), ("1x4", "gemma"), ("1x4", "moe_e6"),
         ("2x2", "yi_vocab"), ("2x2", "moe"))


def _cfg(pkg, case):
    arch, changes = CASES[case]
    changes = {"seq_parallel": True, **changes}
    return dataclasses.replace(pkg.get_config(arch).reduced(), fsdp=True,
                               n_layers=LAYERS, **changes)


def _batch(cfg, case, step):
    """The global batch of ``step`` as numpy: tokens, and labels with -1
    tails that differ by row."""
    rng = np.random.default_rng([len(case), step, cfg.vocab])
    labels = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    for r in range(BATCH):
        labels[r, SEQ - 1 - 2 * r:] = -1
    return {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(
        np.int32), "labels": labels}


def _initial_params(cfg):
    """The port's ``init_params`` from a generator seeded 9 (bfloat16
    weights, as ``init_state`` draws them; the master is their float32
    copy)."""
    from repro_torch.models import init_params
    gen = torch.Generator()
    gen.manual_seed(9)
    return init_params(cfg, gen, device="cpu")


def _stage(outdir, text):
    with open(os.path.join(outdir, "stage"), "w") as f:
        f.write(text)


# -- the reference ------------------------------------------------------------


def _reference(devices, outdir):
    """Every cell on a mesh of ``devices`` forced host devices; each
    cell's metrics and final master (``outdir/ref_<mesh>_<case>.npz``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro import configs as jconfigs
    from repro.jaxcompat import make_mesh
    from repro.launch import steps as jsteps
    from repro.optim import adamw as jadamw
    from repro_torch import configs
    from repro_torch.interop import params_to_numpy
    jadamw.cast_params = lambda master: master          # float32 throughout
    isp = lambda x: isinstance(x, JP)  # noqa: E731
    out = {}
    for key, case in CELLS:
        shape = MESHES[key]
        if shape[0] * shape[1] != devices:
            continue
        _stage(outdir, f"reference {key} {case}")
        mesh = make_mesh(shape, ("data", "model"))
        ns = lambda t: jax.tree.map(  # noqa: E731
            lambda s: NamedSharding(mesh, s), t, is_leaf=isp)
        with jax.set_mesh(mesh):
            cfg, jcfg = _cfg(configs, case), _cfg(jconfigs, case)
            st = jadamw.init(jax.tree.map(
                jnp.asarray, params_to_numpy(_initial_params(cfg))))
            specs = jsteps.sanitize_pspecs(jsteps.state_pspecs(jcfg),
                                           jsteps.state_struct(jcfg), mesh)
            rows = ("data",) if BATCH % shape[0] == 0 else ()
            bspecs = {"tokens": JP(rows, None), "labels": JP(rows, None)}
            fn = jax.jit(jsteps.make_train_step(
                jcfg, jadamw.AdamWConfig(**OPT), pspecs=specs.master),
                in_shardings=(specs, bspecs), out_shardings=(specs, None))
            st = jax.device_put(st, ns(specs))
            metrics = []
            for i in range(STEPS):
                bat = jax.device_put({k: jnp.asarray(v) for k, v in
                                      _batch(cfg, case, i).items()},
                                     ns(bspecs))
                st, m = fn(st, bat)
                metrics.append({k: float(v) for k, v in m.items()})
            out[f"{key}/{case}"] = metrics
            np.savez(os.path.join(outdir, f"ref_{key}_{case}.npz"),
                     **{k: np.asarray(v) for k, v in _paths(st.master)})
    _stage(outdir, "reference done")
    return out


def _paths(tree):
    import jax
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), v) for path, v in leaves]


# -- the port's ranks ---------------------------------------------------------


def _run_cell(key, case, mesh, rank, outdir):
    from repro_torch import configs
    from repro_torch.distributed import COLLECTIVES
    from repro_torch.distributed.sharding import block_cuts, shard, \
        unshard_tree
    from repro_torch.interop import opt_state_block_from_numpy, \
        params_to_numpy
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models.layers import kv_layout, layer_cut
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten_with_paths, tree_leaves
    cfg = _cfg(configs, case)
    specs = steps.sanitize_pspecs(steps.state_pspecs(cfg),
                                  steps.state_struct(cfg), mesh)
    bspecs = steps.sanitize_pspecs(
        steps.batch_pspecs(cfg, "train_4k", mesh, batch=BATCH),
        steps.batch_struct(cfg, "train_4k", batch=BATCH, seq=SEQ), mesh)
    gen = torch.Generator()
    gen.manual_seed(9)
    state = steps.init_state(cfg, specs.master, mesh, gen, device="cpu")
    whole = adamw.init(_initial_params(cfg))
    want = opt_state_block_from_numpy(
        (params_to_numpy(whole.master), params_to_numpy(whole.m),
         params_to_numpy(whole.v), whole.step.numpy()), specs, mesh,
        device="cpu")
    same_init = all(torch.equal(a, w) for a, w in zip(
        tree_leaves(state), tree_leaves(want)))
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT), specs.master,
                                 mesh=mesh, batch_specs=bspecs)
    plan = steps.train_collectives(
        cfg, specs.master, mesh, BATCH * SEQ,
        batch_sharded=bspecs["labels"][0] is not None, seq=SEQ)
    rows = []
    for i in range(STEPS):
        batch = {k: shard(v, bspecs[k], mesh) for k, v in batch_to_device(
            _batch(cfg, case, i), "cpu").items()}
        before = dict(COLLECTIVES)
        state, m = step(state, batch)
        rows.append({**{k: float(v) for k, v in m.items()},
                     "collectives": {k: COLLECTIVES[k] - before[k]
                                     for k in COLLECTIVES
                                     if COLLECTIVES[k] != before[k]
                                     or plan.get(k)}})
    blocks = {k: [[list(c[::2]) for c in block_cuts(s, mesh, rank)],
                  hashlib.sha1(v.numpy().tobytes()).hexdigest()]
              for (k, v), (_, s) in zip(flatten_with_paths(state.master),
                                        flatten_with_paths(specs.master))}
    master = unshard_tree(state.master, specs.master, mesh)
    if rank == 0:
        np.savez(os.path.join(outdir, f"port_{key}_{case}.npz"),
                 **{k: v.numpy() for k, v in flatten_with_paths(master)})
    tp = step.tp
    return {"steps": rows, "plan": {k: v for k, v in plan.items() if v},
            "same_init": same_init, "blocks": blocks,
            "layout": kv_layout(tp.kv_spec, mesh),
            "split": {n: layer_cut(tp, n) for n in specs.master["layers"]},
            "vocab_split": tp.split(specs.master["lm_head"]),
            "sp": bool(cfg.seq_parallel and SEQ % tp.model == 0)}


def _rank_main(rank, world, store, outdir):
    import torch.distributed as dist

    from repro_torch.distributed import make_mesh
    from repro_torch.optim import adamw
    adamw.cast_params = lambda master: master           # float32 throughout
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    res = {}
    for key, case in CELLS:
        shape = MESHES[key]
        if shape[0] * shape[1] != world:
            continue
        if rank == 0:
            _stage(outdir, f"ranks {key} {case}")
        mesh = make_mesh(shape, ("data", "model"), group=dist.group.WORLD)
        res[f"{key}/{case}"] = _run_cell(key, case, mesh, rank, outdir)
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
    _stage(outdir, "ranks done")
    print(json.dumps(out))


# the gloo ranks' and the reference's torch and OpenMP pools one thread a
# process (the ranks also call ``torch.set_num_threads(1)``)
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


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


def _wait(procs, timeout):
    """Each process's last stdout line as JSON; a process still running
    at ``timeout`` seconds is killed (with the others) and the call
    fails naming every process's last stage."""
    deadline = time.monotonic() + timeout
    outs = {}
    try:
        for key, (p, d) in procs.items():
            left = max(deadline - time.monotonic(), 0.1)
            stdout, stderr = p.communicate(timeout=left)
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


_CACHE = {}


def _results():
    """{"ref": per-cell metrics, "port": {world: {rank: cells}}, "dir"};
    on first use all four processes start together."""
    if not _CACHE:
        pytest.importorskip("jax")
        tmp = tempfile.mkdtemp(prefix="tp_train_")
        atexit.register(shutil.rmtree, tmp, True)
        procs = {}
        for w in (2, 4):
            for side, args, env in (("ref", "--worker", _env(w)),
                                    ("port", "--ranks", _env())):
                d = os.path.join(tmp, f"{side}{w}")
                os.makedirs(d)
                procs[(side, w)] = (subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), args, str(w),
                     d], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, cwd=REPO, env=env), d)
        outs = _wait(procs, SPAWN_TIMEOUT)
        _CACHE.update(ref={**outs[("ref", 2)], **outs[("ref", 4)]},
                      port={w: {int(r): v for r, v in outs[("port", w)]
                                .items()} for w in (2, 4)},
                      dir=tmp)
    return _CACHE


def _cell(mesh, case):
    res = _results()
    world = MESHES[mesh][0] * MESHES[mesh][1]
    ranks = {r: v[f"{mesh}/{case}"] for r, v in res["port"][world].items()}
    want = np.load(os.path.join(res["dir"], f"ref{world}",
                                f"ref_{mesh}_{case}.npz"))
    got = np.load(os.path.join(res["dir"], f"port{world}",
                               f"port_{mesh}_{case}.npz"))
    return res["ref"][f"{mesh}/{case}"], want, ranks, got


# -- the tests ----------------------------------------------------------------


@pytest.mark.parametrize("mesh,case", CELLS)
def test_step_matches_reference(mesh, case):
    """Loss, grad norm and lr of each step; the gathered master's change
    after the steps, leaf by leaf."""
    from repro_torch import configs
    ref, want, ranks, got = _cell(mesh, case)
    cfg = _cfg(configs, case)
    for g, w in zip(ranks[0]["steps"], ref):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=GRAD_RTOL)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=ADAM_RTOL)
    init = {k: v.float().numpy() for k, v in _flat_params(cfg).items()}
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape, k
        moved = np.linalg.norm(want[k] - init[k])
        err = np.linalg.norm(got[k] - want[k]) / max(moved, 1e-30)
        assert err <= MASTER_RTOL[cfg.family], (k, err)


def _flat_params(cfg):
    from repro_torch.tree import flatten_with_paths
    return dict(flatten_with_paths(_initial_params(cfg)))


@pytest.mark.parametrize("mesh,case", CELLS)
def test_ranks_agree(mesh, case):
    """Every rank's loss and grad norm identical; after the steps every
    block two ranks both hold (the same indices along the leaf's cut
    dimensions: a replicated leaf on every rank) has the same bytes on
    both; the initial blocks those of
    ``interop.opt_state_block_from_numpy``."""
    _, _, ranks, _ = _cell(mesh, case)
    first = ranks[0]
    for r, info in ranks.items():
        assert info["same_init"], r
        for a, b in zip(info["steps"], first["steps"]):
            assert (a["loss"], a["grad_norm"]) == (b["loss"],
                                                   b["grad_norm"]), r
    for leaf in first["blocks"]:
        held = {}
        for r, info in ranks.items():
            where, digest = info["blocks"][leaf]
            held.setdefault(json.dumps(where), set()).add(digest)
        assert all(len(d) == 1 for d in held.values()), (leaf, held)
    world = MESHES[mesh][0] * MESHES[mesh][1]
    whole = [k for k, (where, _) in first["blocks"].items() if not where]
    assert whole and all(len({ranks[r]["blocks"][k][1] for r in ranks}) == 1
                         for k in whole) and len(ranks) == world


@pytest.mark.parametrize("mesh,case", CELLS)
def test_collectives_follow_the_plan(mesh, case):
    """Each rank's collectives of each step are ``train_collectives``'."""
    _, _, ranks, _ = _cell(mesh, case)
    for r, info in ranks.items():
        for i, row in enumerate(info["steps"]):
            assert row["collectives"] == info["plan"], (r, i, row, info)
        assert info["plan"]["tp_reduce"] > 0


def test_each_path_is_reached():
    """The cells reach the paths the specs choose: kv heads over "model"
    (the fast path), a split GQA group (the general path), experts over
    "model" and whole on every rank, the vocabulary cut and whole, FSDP
    over both axes, the MoE's one-group fallback over the data ranks,
    sequence parallelism on and off."""
    def info(mesh, case):
        return _cell(mesh, case)[2][0]
    assert info("1x2", "yi")["layout"] == "heads"
    gemma = info("1x4", "gemma")
    assert gemma["layout"] != "heads" and gemma["split"]["wk"]
    assert gemma["plan"]["tp_scatter"] > 0
    assert info("1x2", "moe")["split"]["e_gate"]
    assert info("2x2", "moe")["split"]["e_gate"]
    assert info("2x2", "moe")["plan"]["exchange"] == 2 * LAYERS
    e6 = info("1x4", "moe_e6")
    assert not e6["split"]["e_gate"] and e6["split"]["s_down"]
    assert not e6["sp"] and info("1x4", "gemma")["sp"]
    assert info("1x2", "yi")["vocab_split"]
    assert not info("2x2", "yi_vocab")["vocab_split"]
    assert info("2x2", "yi_vocab")["plan"]["all_gather"] > 0       # FSDP
    assert any(len(where) == 2 for where, _ in
               info("2x2", "moe")["blocks"].values())   # both axes


REFUSED = {"ssm": "mamba2-130m", "hybrid": "zamba2-7b",
           "vlm": "llama-3.2-vision-11b", "audio": "hubert-xlarge"}


@pytest.mark.parametrize("family", sorted(REFUSED))
def test_family_over_model_refused_by_name(family):
    """The train step refuses the families not ported over "model"
    (A7e(b)) before it touches a process group."""
    from repro_torch import configs
    from repro_torch.distributed import make_mesh
    from repro_torch.launch import steps
    cfg = configs.get_config(REFUSED[family]).reduced()
    mesh = make_mesh((1, 2), ("data", "model"))
    specs = steps.sanitize_pspecs(steps.state_pspecs(cfg),
                                  steps.state_struct(cfg), mesh)
    with pytest.raises(ValueError, match=f'the {family} family over '
                                         f'"model" is not ported'):
        steps.make_train_step(cfg, pspecs=specs.master, mesh=mesh)


def test_sequence_sharded_cache_refused_by_name():
    """``cache_pspecs``' sequence-sharded branch (a batch the data axes
    do not divide, A7e(c)) is refused by name."""
    from repro_torch import configs
    from repro_torch.distributed import make_mesh
    from repro_torch.launch import steps
    from repro_torch.models import init_decode_cache
    cfg = configs.get_config("yi-34b").reduced()
    mesh = make_mesh((2, 2), ("data", "model"))
    seq = init_decode_cache(cfg, 1, 64, device="meta")
    specs = steps.sanitize_pspecs(steps.cache_pspecs(cfg, "long_500k", mesh),
                                  seq, mesh)
    with pytest.raises(ValueError, match="sequence-sharded branch"):
        init_decode_cache(cfg, 1, 64, device="meta", mesh=mesh, specs=specs)


if __name__ == "__main__":
    if sys.argv[1] == "--worker":        # the reference on forced devices
        print(json.dumps(_reference(int(sys.argv[2]), sys.argv[3])))
    elif sys.argv[1] == "--ranks":       # the port's ranks
        _spawn_ranks(int(sys.argv[2]), sys.argv[3])
