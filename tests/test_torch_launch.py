"""The port's launch layer for one card (``repro_torch.launch``: steps,
op_analysis, roofline, dryrun) against the reference's
(``repro.launch``), and the model repairs the registry's cells needed:
stacked leaves drawn a layer at a time, row-wise ops and Mamba2's SSD in
slabs, B7 at a GQA rep of 7, MoE at 64 experts (top-6, 2 shared)."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.jaxcompat import make_mesh  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo_text  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, roofline  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CELLS = [(a, s) for a in list_archs() for s in SHAPES]


def _sig(t):
    """(shape, dtype name) of a torch tensor or a jax struct."""
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _flat(tree, path=()):
    """{path: leaf} of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, path + (i,)).items()}
    if hasattr(tree, "_fields"):
        return {k: v for f in tree._fields
                for k, v in _flat(getattr(tree, f), path + (f,)).items()}
    return {path: tree}


# -- roofline ----------------------------------------------------------------


def test_registry_is_the_reference_grid():
    assert list_archs() == sorted(jroof.list_archs())
    assert SHAPES == JSHAPES


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    assert roofline.model_flops(arch, shape) == \
        jroof.model_flops(arch, shape)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_report_agrees_with_the_reference(arch, shape, monkeypatch):
    """The same record through both reports, the reference's constants
    swapped for the H100's: every field equal.  The port keeps the op
    quantities under ``ops``, the reference under ``hlo``."""
    rng = np.random.default_rng(len(arch) * 7 + len(shape))
    ops = {"flops_per_dev": float(rng.uniform(1e12, 1e17)),
           "bytes_per_dev": float(rng.uniform(1e9, 1e14)),
           "collective_bytes_per_dev": 0.0, "by_collective": {},
           "warnings": []}
    rec = {"status": "ok", "ndev": 1, "ops": ops,
           "memory": {"temp_bytes": int(rng.integers(1, 2 ** 36)),
                      "argument_bytes": int(rng.integers(1, 2 ** 36))}}
    monkeypatch.setattr(jroof, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", roofline.NVLINK_BW)
    key = f"{arch}|{shape}|h100"
    jrec = dict(rec, hlo=rec["ops"])
    assert roofline.cell_report(key, rec) == jroof.cell_report(key, jrec)
    assert roofline.build_report({key: rec}) == \
        jroof.build_report({key: jrec})


def test_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)


# -- steps: the structs ------------------------------------------------------


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_cache_structs_match_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    got = {k: _sig(v) for k, v in S.batch_struct(cfg, shape).items()}
    want = {k: _sig(v) for k, v in JS.batch_struct(jcfg, shape).items()}
    assert got == want
    if jcfg.is_encoder:
        return
    got = {k: _sig(v) for k, v in _flat(S.cache_struct(cfg, shape)).items()}
    want = {k: _sig(v) for k, v in
            _flat(JS.cache_struct(jcfg, shape)).items()}
    assert got == want
    assert all(t.device.type == "meta" for t in
               tree_leaves(S.cache_struct(cfg, shape)))


@pytest.mark.parametrize("arch", list_archs())
def test_params_and_state_structs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    got = {k: _sig(v) for k, v in _flat(S.params_struct(cfg)).items()}
    want = {k: _sig(v) for k, v in _flat(JS.params_struct(jcfg)).items()}
    assert got == want
    st = S.state_struct(cfg)
    jst = jax.eval_shape(lambda: jadamw.init(JT.init_params(jcfg)))
    for f in ("master", "m", "v"):
        assert {k: _sig(v) for k, v in _flat(getattr(st, f)).items()} == \
            {k: _sig(v) for k, v in _flat(getattr(jst, f)).items()}
    assert _sig(st.step) == _sig(jst.step)
    assert sum(t.numel() for t in tree_leaves(st.master)) == \
        sum(int(np.prod(v.shape)) for v in _flat(jst.master).values())


# -- op_analysis against the HLO analyzer ------------------------------------


def _ref_costs(arch, kind, b, s):
    """The reference's step for a reduced cell, lowered and compiled on a
    one-device mesh, through ``analyze_hlo_text``."""
    jcfg = jget(arch)
    bs = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
          "labels": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    with jax.set_mesh(make_mesh((1, 1), ("data", "model"))):
        if kind == "train":
            lowered = jax.jit(JS.make_train_step(jcfg)).lower(
                JS.state_struct(jcfg), bs)
        elif kind == "prefill":
            bs.pop("labels")
            lowered = jax.jit(JS.make_prefill_step(jcfg)).lower(
                JS.params_struct(jcfg), bs)
        else:
            cache = jax.eval_shape(lambda: JT.init_decode_cache(jcfg, b, s))
            lowered = jax.jit(JS.make_serve_step(jcfg)).lower(
                JS.params_struct(jcfg), cache,
                jax.ShapeDtypeStruct((b, 1), jnp.int32),
                jax.ShapeDtypeStruct((), jnp.int32))
        return analyze_hlo_text(lowered.compile().as_text())


@pytest.mark.parametrize("arch,kind", [
    ("gemma2-27b-smoke", "prefill"), ("gemma2-27b-smoke", "decode"),
    ("deepseek-moe-16b-smoke", "prefill"),
    ("deepseek-moe-16b-smoke", "decode"),
    ("gemma2-27b-smoke", "train")])
def test_op_flops_match_the_hlo_analysis(arch, kind):
    """The FLOPs are equal: both count every matmul of the step, 2·out·K,
    the recomputed forward of remat included.  The bytes are not held:
    XLA fuses elementwise chains (the port writes every op's output:
    1.7x the reference's bytes in training) and copies the whole decode
    cache where the port updates it in place (0.08-0.12x in decode)."""
    b, s = 2, 64
    want = _ref_costs(arch, kind, b, s)
    fn, args = dryrun.build(get_config(arch), kind, b, s)
    with dryrun._grad_mode(kind):
        _, got = op_analysis.analyze_step(fn, *args)
    assert got.collective_bytes == 0 and got.by_collective == {}
    assert got.flops == want.flops, (got.flops, want.flops)
    assert got.bytes > 0 and got.peak_bytes > 0


def test_op_analysis_counts_a_known_step():
    """Two products and their bytes: views cost nothing, the temporaries'
    peak is the largest set alive at once."""
    a = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 32, device="meta")

    def step(a, w):
        h = (a @ w).relu()
        return h.t() @ a                     # a view, then (32, 16)
    out, c = op_analysis.analyze_step(step, a, w)
    assert c.flops == 2 * 8 * 32 * 16 + 2 * 32 * 16 * 8
    assert c.dot_count == 2
    assert c.bytes == 2 * 4 * (8 * 32 + 8 * 32 + 32 * 16)
    assert c.peak_bytes == 4 * (8 * 32 + 32 * 16)   # h and the result
    assert out.shape == (32, 16)


def test_op_analysis_counts_every_flash_tile_once():
    """B7 on meta: its plain version as one block of every (q, k) pair,
    the products of every tile (what the reference's XLA path scans),
    and its temporaries kept out of the peak."""
    b, h, kv, s, hd = 1, 4, 2, 4096, 64
    q = torch.empty(b, h, s, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, kv, s, hd, dtype=torch.bfloat16, device="meta")
    out, c = op_analysis.analyze_step(
        lambda q, k, v: flash_attention(q, k, v, causal=True), q, k, k)
    assert out.shape == q.shape and out.device.type == "meta"
    assert c.flops == 2 * (2 * b * h * s * s * hd)
    assert c.peak_bytes == out.numel() * 2


def test_op_analysis_charges_a_kernel_what_it_moves():
    """A plain span's bytes are its kernel's: B7 reads q, k and v once
    and writes out (and lse) once, whatever its plain version's (B, H,
    S, S) block held; the ops around it keep the output x 2 rule."""
    b, h, kv, s, hd = 1, 4, 2, 1024, 64
    q = torch.empty(b, h, s, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, kv, s, hd, dtype=torch.bfloat16, device="meta")
    v = torch.empty(b, kv, s, hd, dtype=torch.bfloat16, device="meta")
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    out, c = op_analysis.analyze_step(
        lambda q, k, v: flash_attention(q, k, v, causal=True), q, k, v)
    assert c.bytes == size(q, k, v, out)
    (out, lse), c = op_analysis.analyze_step(
        lambda q, k, v: flash_attention(q, k, v, causal=True,
                                        return_lse=True), q, k, v)
    assert c.bytes == size(q, k, v, out, lse)
    # two spans back to back, then an op of the step's own
    out, c = op_analysis.analyze_step(
        lambda q, k, v: flash_attention(flash_attention(q, k, v), k, v)
        * 2, q, k, v)
    assert c.bytes == 2 * size(q, k, v, out) + 2 * size(out)


# -- dryrun ------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", [
    ("hubert-xlarge-smoke", "decode_32k"), ("hubert-xlarge-smoke",
                                            "long_500k"),
    ("deepseek-moe-16b-smoke", "long_500k"),
    ("mamba2-130m-smoke", "long_500k"), ("gemma2-27b-smoke", "decode_32k"),
    ("h2o-danube-1.8b-smoke", "long_500k")])
def test_dryrun_on_the_cpu(arch, shape, tmp_path):
    """Decode cells, which run in a fraction of a second on the CPU, and
    the shapes the configs skip."""
    out = tmp_path / "dryrun.json"
    dryrun.main(["--device", "cpu", "--arch", arch, "--shape", shape,
                 "--out", str(out)])
    rec = json.loads(out.read_text())[f"{arch}|{shape}|h100"]
    cfg = get_config(arch)
    if shape in cfg.skip_shapes:
        assert rec == {"status": "skipped", "reason": cfg.skip_reason}
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["model_flops_note"] == {
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count()}
    assert rec["ops"]["flops_per_dev"] > 0
    assert rec["cut"]["fits"] and rec["run"]["finite"]
    assert rec["cut"]["need_bytes"] <= rec["cut"]["budget_bytes"]
    for cut in rec["cut"]["cuts"]:
        assert cut["forced_by_bytes"] > rec["cut"]["budget_bytes"]
    assert 0 < rec["roofline"]["roofline_fraction"]


def test_dryrun_walks_in_worker_processes(tmp_path):
    """``--jobs 2``: the walks on meta in worker processes give the
    records this process gives, the skipped shape recorded the same."""
    recs = []
    for jobs in ("1", "2"):
        out = tmp_path / f"dryrun{jobs}.json"
        dryrun.main(["--device", "cpu", "--arch", "gemma2-27b-smoke",
                     "--shape", "decode_32k", "--jobs", jobs,
                     "--out", str(out)])
        dryrun.main(["--device", "cpu", "--arch", "hubert-xlarge-smoke",
                     "--shape", "long_500k", "--jobs", jobs,
                     "--out", str(out)])
        recs.append(json.loads(out.read_text()))
    assert recs[0].keys() == recs[1].keys()
    for key, rec in recs[1].items():
        want = recs[0][key]
        assert rec["status"] == want["status"], rec.get("traceback")
        for field in ("ops", "memory", "cut", "model_flops_note", "reason"):
            assert rec.get(field) == want.get(field), field


def test_plan_cuts_the_batch_then_whole_periods():
    """gemma2-27b's decode at 32k (at 8 of its layers): the batch first; a
    budget below one sequence at that depth cuts the depth in periods of
    (local, global)."""
    cfg = dataclasses.replace(get_config("gemma2-27b"), n_layers=8)
    full = dryrun.plan_cut(cfg, "decode", 128, 32768, budget=20e9)
    assert full["layers"] == 8 and 1 <= full["batch"] < 128
    assert [c["cut"] for c in full["cuts"]] == ["batch"]
    one = dryrun.footprint(cfg, "decode", 1, 32768)
    small = dryrun.plan_cut(cfg, "decode", 128, 32768,
                            budget=0.5 * (one[0] + one[1].peak_bytes))
    assert [c["cut"] for c in small["cuts"]] == ["batch", "layers"]
    assert small["batch"] == 1 and small["layers"] % 2 == 0
    assert 2 <= small["layers"] < 8 and small["fits"]


def test_dryrun_lists_the_registry(capsys):
    dryrun.main(["--list"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == list_archs()


# -- the model repairs -------------------------------------------------------


def test_stacked_leaf_is_drawn_one_layer_at_a_time(monkeypatch):
    """No float32 draw holds more than one layer of a stacked leaf, and
    the draws give the numbers of one whole-leaf draw (the CPU's
    generator fills them in the same order)."""
    gen = torch.Generator()
    gen.manual_seed(3)
    want = (torch.randn((5, 48, 32), generator=gen) / 48 ** 0.5).to(
        torch.bfloat16)
    draws = []
    real = torch.randn

    def spy(*shape, **kw):
        draws.append((tuple(shape[0]) if len(shape) == 1 else shape,
                      kw.get("dtype")))
        return real(*shape, **kw)
    monkeypatch.setattr(torch, "randn", spy)
    gen.manual_seed(3)
    got = TL._dense(gen, (48, 32), lead=(5,))
    assert torch.equal(got, want)
    assert draws == [((48, 32), torch.float32)] * 5
    draws.clear()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b-smoke"),
                              n_layers=6)
    params = init_params(cfg, gen, device="cpu")
    stacked = {tuple(t.shape[1:]) for t in params["layers"].values()}
    for shape, dtype in draws:
        assert dtype == torch.float32
        assert shape in stacked or shape in (
            (cfg.vocab, cfg.d_model), (cfg.d_model, cfg.vocab)), shape


def test_row_slabs_give_each_rows_numbers(monkeypatch):
    """``mlp``, ``rms_norm``, ``rope``, the causal conv and an SSM layer
    over more rows than a slab: the same rows as in one call."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 50, 64)).astype(np.float32))
    p = {k: torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
         for k, s in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                      ("w_down", (96, 64)))}
    w = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    q = x.reshape(3, 50, 4, 16)
    pos = torch.arange(50, dtype=torch.int32)
    conv_w = p["w_gate"][:4, :64]
    cfg = get_config("mamba2-130m-smoke")
    gen = torch.Generator()
    gen.manual_seed(6)
    sp = {k: v[0].float() for k, v in
          init_params(cfg, gen, device="cpu")["layers"].items()}
    xs = torch.from_numpy(rng.normal(size=(2, 300, cfg.d_model))
                          .astype(np.float32))

    def run():
        return (TL.mlp(p, x), TL.rms_norm(x, w), TL.rope(q, pos, 1e4),
                *TS._causal_conv(x, conv_w), *TS.ssm_forward(sp, xs, cfg)[:1])
    whole = run()
    monkeypatch.setattr(TL, "ROW_SLAB", 96 * 7)
    slabs = run()
    for a, b in zip(whole, slabs):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_ssd_groups_give_the_ungrouped_numbers(monkeypatch):
    rng = np.random.default_rng(1)
    b, s, nh, hd, st = 2, 1024, 3, 8, 4
    f = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.normal(size=sh).astype(np.float32))
    x, dt = f(b, s, nh, hd), f(b, s, nh).abs() * 0.1
    A, B, C, h0 = f(nh), f(b, s, st), f(b, s, st), f(b, nh, hd, st)
    y1, h1 = TS.ssd_chunked(x, dt, A, B, C, h0)
    monkeypatch.setattr(TS, "SSD_SLAB", b * TS.CHUNK * TS.CHUNK * nh)
    y2, h2 = TS.ssd_chunked(x, dt, A, B, C, h0)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(h1, h2, rtol=0, atol=0)


# -- the registry's new shapes on the CPU ------------------------------------


@pytest.mark.parametrize("h,kv,win,cap", [(7, 1, 0, 0.0), (14, 2, 96, 50.0)])
def test_flash_at_a_rep_of_seven(h, kv, win, cap):
    """yi-34b's GQA: 56 query heads on 8 kv heads, a rep of 7, in float32
    against the reference's oracle."""
    rng = np.random.default_rng(h)
    s, hd = 256, 128
    q, k, v = ((rng.normal(size=sh) * 0.3).astype(np.float32) for sh in
               ((1, h, s, hd), (1, kv, s, hd), (1, kv, s, hd)))
    want = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(t) for t in (q, k, v)), causal=True, window=win,
        softcap_val=cap))
    got = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                          causal=True, window=win, softcap_val=cap,
                          bq=128, bk=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_moe_at_64_experts_top_6_with_shared_experts():
    """deepseek-moe-16b's routing: 64 experts, top-6 and 2 shared
    experts, at reduced width, against the reference's layer."""
    changes = dict(n_experts=64, top_k=6, n_shared_experts=2)
    jcfg = dataclasses.replace(jget("deepseek-moe-16b").reduced(), **changes)
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              **changes)
    jl = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JM.moe_params(jax.random.PRNGKey(0), jcfg))
    tl = params_from_numpy(jax.tree.map(np.asarray, jl), device="cpu")
    x = (np.random.default_rng(9).normal(size=(2, 96, cfg.d_model))
         .astype(np.float32))
    got = TM.moe_forward(tl, torch.from_numpy(x), cfg).numpy()
    want = np.asarray(JM.moe_forward(jl, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_ssd_takes_a_ragged_last_chunk(monkeypatch):
    """A sequence that is not a multiple of the chunk (16 here): the
    output and the final state of the decode recurrence run token by
    token (the layer's O(1) step), in float32."""
    monkeypatch.setattr(TS, "CHUNK", 16)
    cfg = get_config("mamba2-130m-smoke")
    gen = torch.Generator()
    gen.manual_seed(4)
    p = {k: v[0].float() for k, v in
         init_params(cfg, gen, device="cpu")["layers"].items()}
    s = 3 * TS.CHUNK + 7
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, s, cfg.d_model)).astype(np.float32)) * 0.5
    out, (conv, ssm) = TS.ssm_forward(p, x, cfg)
    state, steps = None, []
    for t in range(s):
        o, state = TS.ssm_forward(p, x[:, t:t + 1], cfg, state=state)
        steps.append(o)
    torch.testing.assert_close(out, torch.cat(steps, 1), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(ssm, state[1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(conv, state[0], rtol=1e-4, atol=1e-4)


def test_adamw_updates_a_leaf_a_slab_at_a_time(monkeypatch):
    """A leaf larger than a slab gets the bits a whole-leaf update gives
    (every op of the update is elementwise)."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(8)
    params = {"w": torch.from_numpy(rng.normal(size=(37, 29))
                                    .astype(np.float32)),
              "b": torch.from_numpy(rng.normal(size=(29,))
                                    .astype(np.float32))}
    grads = {k: torch.from_numpy(rng.normal(size=v.shape)
                                 .astype(np.float32)).to(torch.bfloat16)
             for k, v in params.items()}
    cfg = adamw.AdamWConfig(warmup_steps=2)
    out = []
    for slab in (adamw.SLAB, 100):
        monkeypatch.setattr(adamw, "SLAB", slab)
        st = adamw.init(params)
        for _ in range(3):
            st, m = adamw.step(cfg, st, grads)
        out.append((st, m))
    (a, ma), (b, mb) = out
    for f in ("master", "m", "v"):
        for k in params:
            assert torch.equal(getattr(a, f)[k], getattr(b, f)[k]), (f, k)
    assert torch.equal(ma["grad_norm"], mb["grad_norm"])
