"""The port's sharded train step on gloo ranks, held against the
reference's sharded ``jit`` step on forced host devices.

Each world size starts once a pytest run, all four processes at once:
``python tests/test_torch_dp_train.py --ranks W`` spawns W ranks of a gloo
group (``torch.multiprocessing.spawn``, a ``file://`` store), each of
which trains every case for two steps with
``launch.steps.make_train_step(pspecs=, mesh=)`` on its blocks of the
state (``init_state``) and its rows of the batch; ``--worker S`` runs the
reference's ``make_train_step(cfg, pspecs=)`` under ``jax.jit`` with the
sanitized state and batch specs as ``in_shardings`` on an (S, 1) mesh of S
forced host devices (``repro.jaxcompat.make_mesh``, under
``jax.set_mesh``: ``jax.make_mesh`` makes Explicit axes on this jax, and
the reference's ``with_sharding_constraint`` then fails), from the same
initial state (the port's ``init_params``, carried over as numpy) and the
same batches.  Cases (the reduced configs with FSDP on unless named):

* dense (h2o-danube-1.8b) with FSDP on and off; the rows' ``-1`` labels
  differ, so a rank's share of the mean differs (the global mean);
* moe (deepseek-moe-16b) grouped (256 tokens a rank: one dispatch group
  a rank) and in the one-group fallback (64 a rank: the ticket base
  across ranks), the fallback with ``d_ff`` 255, which no rank count
  divides, so ``sanitize_pspecs`` replicates ``e_down`` and the norm
  must count it once;
* hybrid (zamba2-7b: the shared block's gradient summed over its uses),
  vlm (llama-3.2-vision-11b) and audio (hubert-xlarge, bfloat16 frames);
* a batch of 3 rows, which no rank count divides: replicated, so each
  rank's gradient is the whole one and nothing is summed.

Held, at 2 and 4 ranks: loss within ``LOSS_RTOL``, grad norm within
``GRAD_RTOL`` (both ``tests/test_torch_train_grads.py``'s; the
reference's XLA keeps other bfloat16 roundings), lr within
``ADAM_RTOL``, the gathered
master within ``MASTER_RTOL`` (a family's) of the reference's in the
Frobenius norm of each leaf's change from the initial master; against the port's own one-card
step on the global batch within ``ONE_CARD_RTOL``; every rank's loss and
grad norm identical; every rank's collectives a step equal to
``train_collectives``; the initial blocks equal to
``interop.opt_state_block_from_numpy`` of the whole state.  MoE slots
are integers: each rank's equal to the reference's grouping
(``_dp_groups`` under the mesh) and ticket rule, grouped and in the
fallback, and the one-card ``route(groups=S)`` equal to them too.  A
launched process still running after SPAWN_TIMEOUT seconds is killed and
the test fails naming each process's last stage."""

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
WORLDS = (2, 4)
STEPS = 2
LOSS_RTOL = 1e-2
GRAD_RTOL = {"dense": 5e-2, "ssm": 1e-1, "moe": 1e-1, "hybrid": 1e-1,
             "vlm": 5e-2, "audio": 5e-2}
ADAM_RTOL = 1e-6
# the gathered master against the reference's, ||got - want|| / ||want -
# initial||, leaf by leaf: Adam's first update is each gradient element's
# sign times lr, so an element whose gradient is near zero steps either
# way on the two sides; two unrelated updates of one size give sqrt(2).
# Measured at 2 and 4 ranks (worst leaf): dense 0.167, vlm 0.165, audio
# 0.117, hybrid 0.324, moe 0.500 (bfloat16 routing flips: 1-2.4 % of the
# tokens take another expert along the forward,
# tests/test_torch_moe_drift.py)
MASTER_RTOL = {"dense": 0.3, "vlm": 0.3, "audio": 0.3, "ssm": 0.5,
               "hybrid": 0.5, "moe": 0.75}
# against the port's own one-card step on the global batch (``groups`` =
# S), whose gradients differ only by each rank's bfloat16 rounding before
# the sum: the first step's loss and grad norm, the master's change after
# the steps (Adam's signs again; measured up to 0.11, the MoE), and a
# replicated batch's master (its gradients are the one-card step's; the
# norm's float32 sum runs in another order)
ONE_CARD_RTOL = {"loss": 1e-5, "grad_norm": 1e-4, "master": 0.25,
                 "replicated": 1e-5}
OPT = dict(lr=1e-4, warmup_steps=1, total_steps=10)
# name: (arch, config changes, batch rows, sequence, fsdp)
CASES = {
    "dense_fsdp": ("h2o-danube-1.8b", {}, 4, 64, True),
    "dense_dp": ("h2o-danube-1.8b", {}, 4, 64, False),
    "moe_grouped": ("deepseek-moe-16b", {}, 4, 256, True),
    "moe_fallback": ("deepseek-moe-16b", {"d_ff": 255}, 4, 64, True),
    "hybrid": ("zamba2-7b", {}, 4, 64, True),
    "vlm": ("llama-3.2-vision-11b", {}, 4, 32, True),
    "audio": ("hubert-xlarge", {}, 4, 64, True),
    "replicated_batch": ("h2o-danube-1.8b", {}, 3, 64, True),
}
# MoE slots: tokens a rank, grouped (256) and in the fallback (64)
SLOT_TOKENS = (256, 64)


def _cfg(pkg, case):
    arch, changes, _, _, fsdp = CASES[case]
    return dataclasses.replace(pkg.get_config(arch).reduced(), fsdp=fsdp,
                               **changes)


def _batch(cfg, case, step):
    """The global batch of ``step`` as numpy (tokens or bfloat16-valued
    float32 frames, labels with -1 tails that differ by row, img)."""
    _, _, b, s, _ = CASES[case]
    rng = np.random.default_rng([len(case), step, b, s])
    out = {}
    if cfg.audio_frontend:
        out["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    for r in range(b):
        labels[r, s - 3 - 7 * r:] = -1
    out["labels"] = labels
    if cfg.family == "vlm":
        out["img"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _initial_params(cfg):
    """The port's ``init_params`` from a generator seeded 5, on the CPU."""
    from repro_torch.models import init_params
    gen = torch.Generator()
    gen.manual_seed(5)
    return init_params(cfg, gen, device="cpu")


def _gates(world, t, seed):
    return np.random.default_rng(seed).standard_normal(
        (world * t, 8)).astype(np.float32)


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
    return np.where(slot < cap, slot, -1).tolist()


# -- the reference ------------------------------------------------------------


def _reference(world, outdir):
    """Every case on an (S, 1) mesh of forced host devices; each case's
    metrics and final master (``outdir/ref_<case>.npz``)."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro import configs as jconfigs
    from repro.jaxcompat import make_mesh
    from repro.launch import steps as jsteps
    from repro.models import moe as jmoe
    from repro.optim import adamw as jadamw
    from repro_torch import configs
    from repro_torch.interop import params_to_numpy

    mesh = make_mesh((world, 1), ("data", "model"))
    isp = lambda x: isinstance(x, JP)  # noqa: E731
    out = {}
    with jax.set_mesh(mesh):
        for case in CASES:
            _stage(outdir, f"reference {case}")
            cfg, jcfg = _cfg(configs, case), _cfg(jconfigs, case)
            st = jadamw.init(jax.tree.map(
                jnp.asarray, params_to_numpy(_initial_params(cfg))))
            specs = jsteps.sanitize_pspecs(jsteps.state_pspecs(jcfg),
                                           jsteps.state_struct(jcfg), mesh)
            b = CASES[case][2]
            rows = ("data",) if b % world == 0 else ()
            bspecs = {k: JP(rows, *([None] * (v.ndim - 1)))
                      for k, v in _batch(cfg, case, 0).items()}
            ns = lambda t: jax.tree.map(  # noqa: E731
                lambda s: NamedSharding(mesh, s), t, is_leaf=isp)
            fn = jax.jit(jsteps.make_train_step(
                jcfg, jadamw.AdamWConfig(**OPT), pspecs=specs.master),
                in_shardings=(specs, bspecs), out_shardings=(specs, None))
            st = jax.device_put(st, ns(specs))
            rows_ = []
            for i in range(STEPS):
                bat = {k: jnp.asarray(v.astype(ml_dtypes.bfloat16)
                                      if v.dtype == np.float32 else v)
                       for k, v in _batch(cfg, case, i).items()}
                st, m = fn(st, jax.device_put(bat, ns(bspecs)))
                rows_.append({k: float(v) for k, v in m.items()})
            out[case] = rows_
            np.savez(os.path.join(outdir, f"ref_{case}.npz"),
                     **{f"master/{k}": np.asarray(v) for k, v in
                        _paths(st.master)})
        jcfg = jconfigs.get_config("deepseek-moe-16b").reduced()
        for t in SLOT_TOKENS:
            gates = _gates(world, t, t)
            g = jmoe._dp_groups(world * t)
            out[f"slots/{t}"] = {"groups": g, "slots": _slots_oracle(
                gates, jcfg.top_k, jcfg.n_experts, g, jcfg.capacity_factor)}
    return out


def _paths(tree):
    import jax
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), v) for path, v in leaves]


# -- the port's ranks ---------------------------------------------------------


def _rank_main(rank, world, store, outdir):
    """One rank: every case's steps; writes {case: per-step metrics,
    collectives, ...} to ``outdir/rank<r>.json`` and rank 0 the gathered
    master to ``outdir/port_<case>.npz``."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed import COLLECTIVES, make_mesh
    from repro_torch.distributed.sharding import P, shard, unshard_tree
    from repro_torch.interop import (opt_state_block_from_numpy,
                                     params_to_numpy)
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten_with_paths, tree_leaves
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    mesh = make_mesh((world, 1), ("data", "model"), group=dist.group.WORLD)
    res = {}
    for case in CASES:
        if rank == 0:
            _stage(outdir, f"ranks {case}")
        cfg = _cfg(configs, case)
        b, s = CASES[case][2:4]
        specs = steps.sanitize_pspecs(steps.state_pspecs(cfg),
                                      steps.state_struct(cfg), mesh)
        bspecs = steps.sanitize_pspecs(
            steps.batch_pspecs(cfg, "train_4k", mesh, batch=b),
            steps.batch_struct(cfg, "train_4k", batch=b, seq=s), mesh)
        gen = torch.Generator()
        gen.manual_seed(5)
        state = steps.init_state(cfg, specs.master, mesh, gen, device="cpu")
        whole = adamw.init(_initial_params(cfg))
        want = opt_state_block_from_numpy(
            (params_to_numpy(whole.master), params_to_numpy(whole.m),
             params_to_numpy(whole.v), whole.step.numpy()), specs, mesh,
            device="cpu")
        same_init = all(torch.equal(a, w) for a, w in zip(
            tree_leaves(state), tree_leaves(want)))
        step = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT),
                                     specs.master, mesh=mesh,
                                     batch_specs=bspecs)
        plan = steps.train_collectives(
            cfg, specs.master, mesh, b * s,
            batch_sharded=bspecs["labels"][0] is not None)
        one = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT),
                                    groups=world)
        rows = []
        for i in range(STEPS):
            batch = batch_to_device(_batch(cfg, case, i), "cpu")
            whole, m1 = one(whole, batch)
            batch = {k: shard(v, bspecs[k], mesh) for k, v in batch.items()}
            before = dict(COLLECTIVES)
            state, m = step(state, batch)
            rows.append({**{k: float(v) for k, v in m.items()},
                         "one_card": {k: float(v) for k, v in m1.items()},
                         "collectives": {k: COLLECTIVES[k] - before[k]
                                         for k in plan}})
        master = unshard_tree(state.master, specs.master, mesh)
        init = _flat_params(case)
        errs = {k: float((a - b).norm() / (b - init[k].float())
                                     .norm().clamp(min=1e-30))
                for (k, a), (_, b) in zip(flatten_with_paths(master),
                                          flatten_with_paths(whole.master))}
        res[case] = {"steps": rows, "plan": plan, "same_init": same_init,
                     "one_card_master": errs}
        if rank == 0:
            np.savez(os.path.join(outdir, f"port_{case}.npz"),
                     **{f"master/{k}": v.float().numpy()
                        for k, v in flatten_with_paths(master)})
    cfg = configs.get_config("deepseek-moe-16b").reduced()
    for t in SLOT_TOKENS:
        gates = torch.from_numpy(_gates(world, t, t)[rank * t:(rank + 1) * t])
        res[f"slots/{t}"] = moe.route(gates, cfg, mesh=mesh)[0].tolist()
    try:               # the ssm family over "model" is not ported
        steps.make_train_step(configs.get_config("mamba2-130m").reduced(),
                              pspecs=P(),
                              mesh=make_mesh((1, world), ("data", "model"),
                                             group=dist.group.WORLD))
        res["model_error"] = None
    except ValueError as e:
        res["model_error"] = str(e)
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


def _results(world):
    """(reference, {rank: port}, the npz directory) at ``world``; on first
    use both world sizes' four processes start together."""
    if not _CACHE:
        pytest.importorskip("jax")
        tmp = tempfile.mkdtemp(prefix="dp_train_")
        atexit.register(shutil.rmtree, tmp, True)
        procs = {}
        for w in WORLDS:
            d = os.path.join(tmp, str(w))
            for side, flag, env in (("ref", "--worker", _env(w)),
                                    ("port", "--ranks", _env())):
                os.makedirs(os.path.join(d, side))
                procs[(side, w)] = (_launch([flag, str(w),
                                             os.path.join(d, side)], env),
                                    os.path.join(d, side))
        outs = _wait(procs, SPAWN_TIMEOUT)
        for w in WORLDS:
            _CACHE[w] = (outs[("ref", w)],
                         {int(r): v for r, v in outs[("port", w)].items()},
                         os.path.join(tmp, str(w)))
    return _CACHE[world]


# -- the tests ----------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_reference(world, case):
    """Loss, grad norm and lr of each step; the gathered master's change
    after the steps, leaf by leaf."""
    from repro_torch import configs
    ref, port, d = _results(world)
    family = _cfg(configs, case).family
    got = port[0][case]["steps"]
    for g, w in zip(got, ref[case]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=GRAD_RTOL[family])
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=ADAM_RTOL)
    mine = np.load(os.path.join(d, "port", f"port_{case}.npz"))
    want = np.load(os.path.join(d, "ref", f"ref_{case}.npz"))
    init = {k: v.float().numpy() for k, v in _flat_params(case).items()}
    assert sorted(mine.files) == sorted(want.files)
    for k in want.files:
        w = np.asarray(want[k], np.float32)
        assert mine[k].shape == w.shape, k
        if k.startswith("master/"):
            moved = w - init[k[len("master/"):]]
            err = np.linalg.norm(mine[k] - w) / max(np.linalg.norm(moved),
                                                    1e-30)
            assert err <= MASTER_RTOL[family], (k, err)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_one_card(world, case):
    """Each rank's steps against the port's one-card step on the global
    batch from the whole state: the first step within ONE_CARD_RTOL, the
    next within the reference's bounds, the gathered master's change
    within ONE_CARD_RTOL (bit for bit when every rank holds the whole
    batch: its step is the one-card step's)."""
    from repro_torch import configs
    _, port, _ = _results(world)
    family = _cfg(configs, case).family
    for rank, res in port.items():
        for i, row in enumerate(res[case]["steps"]):
            one = row["one_card"]
            tol = (ONE_CARD_RTOL if i == 0 else
                   {"loss": LOSS_RTOL, "grad_norm": GRAD_RTOL[family]})
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(row[k], one[k], rtol=tol[k],
                                           err_msg=f"{rank} {i} {k}")
            assert row["lr"] == one["lr"]
        for k, err in res[case]["one_card_master"].items():
            bound = ONE_CARD_RTOL["master"]
            if case == "replicated_batch":
                bound = ONE_CARD_RTOL["replicated"]
            assert err <= bound, (rank, k, err)


def _flat_params(case):
    from repro_torch import configs
    from repro_torch.tree import flatten_with_paths
    return dict(flatten_with_paths(_initial_params(_cfg(configs, case))))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_agree_and_collectives_follow_the_plan(world, case):
    """Every rank's loss and grad norm identical; each step's collectives
    those of ``train_collectives``; the ranks' initial blocks those of
    ``interop.opt_state_block_from_numpy``."""
    _, port, _ = _results(world)
    first = port[0][case]
    for rank, res in port.items():
        got = res[case]
        assert got["same_init"], rank
        for a, b in zip(got["steps"], first["steps"]):
            assert (a["loss"], a["grad_norm"]) == (b["loss"],
                                                   b["grad_norm"]), rank
            assert a["collectives"] == got["plan"], (rank, a)
    plan = first["plan"]
    if case == "replicated_batch":
        assert plan["reduce_scatter"] == 0 and plan["all_gather"] > 0
    if case == "dense_dp":
        assert plan["all_gather"] == 0 and plan["reduce"] == 2
    if case == "moe_fallback":
        assert plan["exchange"] > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tokens", SLOT_TOKENS)
def test_moe_slots_are_the_reference_groups(world, tokens):
    """Each rank's slots are its rows of the reference's grouped (or
    one-group) slots, as integers; the one-card ``route(groups=S)`` gives
    all rows."""
    from repro_torch import configs
    from repro_torch.models import moe
    ref, port, _ = _results(world)
    want = ref[f"slots/{tokens}"]
    assert want["groups"] == (world if tokens >= 256 else 1)
    for rank, res in port.items():
        assert res[f"slots/{tokens}"] == want["slots"][
            rank * tokens:(rank + 1) * tokens], rank
    cfg = configs.get_config("deepseek-moe-16b").reduced()
    one = moe.route(torch.from_numpy(_gates(world, tokens, tokens)), cfg,
                    groups=world)
    assert one[0].tolist() == want["slots"] and one[4] == want["groups"]


@pytest.mark.parametrize("world", WORLDS)
def test_model_axis_refused_on_ranks(world):
    """Training over "model" runs the dense and moe families
    (``tests/test_torch_tp_train.py``); the ssm family over it is refused
    by name on the ranks."""
    _, port, _ = _results(world)
    for res in port.values():
        assert res["model_error"] and 'the ssm family over "model" is not ' \
            'ported' in res["model_error"]


if __name__ == "__main__":
    if sys.argv[1] == "--worker":        # the reference on forced devices
        print(json.dumps(_reference(int(sys.argv[2]), sys.argv[3])))
    elif sys.argv[1] == "--ranks":       # the port's ranks
        _spawn_ranks(int(sys.argv[2]), sys.argv[3])
