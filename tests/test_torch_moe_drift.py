"""How far the port's MoE routing drifts from the reference's in a forward
pass, and why: top-k choices and ticket slots compared as integers.

deepseek-moe-16b reduced (8 experts, top-2, 4 layers), the port's
``init_params`` seeded 5 carried over to the reference, 4 x 256 tokens
(1,024, one dispatch group) on one device, in bfloat16 (the training
dtype) and in float32.  Each MoE layer's input ``x`` is captured on both
sides (the reference's through ``jax.debug.callback`` inside its scan).
Per layer, for each side's gates ``x.float() @ router``:

* "same input": the port's gates and routing (``moe.route``) and the
  reference's (XLA's product, ``jax.lax.top_k`` and its ticket rule) on
  the reference's ``x``: must agree exactly, so the two routings are one
  function;
* "own input": each side on its own ``x``: the layers' inputs differ by
  the roundings of the layers before, and a token whose k-th and
  (k+1)-th gates lie closer than that difference takes another expert.
  In float32 no choice flips; in bfloat16 some do, and every pair behind
  a flipped pair in the same expert's ticket order takes another slot.

``python -m pytest -s tests/test_torch_moe_drift.py`` prints each case's
counts as one JSON line (``DRIFT``); the bounds below are held."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

BATCH, SEQ = 4, 256
# own-input drift bounds, shares of the tokens (top-k set differs) and of
# the pairs (another expert at its rank; another slot; kept on one side
# and dropped on the other) in the worst layer.  Measured in bfloat16:
# 0.0244 (layer 3), 0.0327 (layer 3), 0.753 (layer 2) and 0 (no expert
# reaches its capacity of 352); in float32 none
DRIFT_MAX = {"bfloat16": (0.05, 0.06, 0.9, 0.05),
             "float32": (0.0, 0.0, 0.0, 0.0)}


def _cfg(pkg):
    return pkg.get_config("deepseek-moe-16b").reduced()


def _port(dtype):
    """(params, the MoE layers' inputs, logits) of the port's forward."""
    from repro_torch import configs
    from repro_torch.models import init_params, transformer
    cfg = _cfg(configs)
    gen = torch.Generator()
    gen.manual_seed(5)
    params = init_params(cfg, gen, device="cpu", dtype=dtype)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    seen, real = [], transformer.moe_forward

    def spy(p, x, c, **kw):
        seen.append(x.detach().float().numpy())
        return real(p, x, c, **kw)
    transformer.moe_forward = spy
    try:
        with torch.no_grad():
            logits = transformer.forward(params, torch.from_numpy(tokens),
                                         cfg)
    finally:
        transformer.moe_forward = real
    return params, tokens, seen, logits.numpy()


def _reference(params, tokens):
    """The MoE layers' inputs and the logits of the reference's forward on
    the same parameters and tokens."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import transformer as jt
    from repro_torch.interop import params_to_numpy
    cfg = _cfg(jconfigs)
    seen, real = [], jt.moe_forward

    def spy(p, x, c):
        jax.debug.callback(lambda v: seen.append(np.asarray(v, np.float32)),
                           x, ordered=True)
        return real(p, x, c)
    jt.moe_forward = spy
    try:
        jp = jax.tree.map(jnp.asarray, params_to_numpy(params))
        logits = jt.forward(jp, jnp.asarray(tokens), cfg)
        logits = np.asarray(logits)
        jax.effects_barrier()
    finally:
        jt.moe_forward = real
    return seen, logits


def _port_gates(x, router):
    """The port's gates: ``xt.float() @ router.float()``."""
    return (torch.from_numpy(x) @ torch.from_numpy(router)).numpy()


def _ref_gates(x, router):
    """The reference's gates: ``xt.astype(f32) @ router`` under XLA."""
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(x) @ jnp.asarray(router))


def _ref_route(gates, cfg):
    """The reference's top-k (``jax.lax.top_k``) and one-group ticket
    rule: (expert ids (T, k), slot (T, k) or -1 past the capacity)."""
    import jax
    import jax.numpy as jnp
    _, top_e = jax.lax.top_k(jnp.asarray(gates), cfg.top_k)
    top_e = np.asarray(top_e)
    t, k, e = gates.shape[0], cfg.top_k, cfg.n_experts
    cap = -(-(int(t * k / e * cfg.capacity_factor) + 1) // 32) * 32
    onehot = np.eye(e, dtype=np.int64)[top_e].reshape(t * k, e)
    slot = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(-1).reshape(t, k)
    return top_e, np.where(slot < cap, slot, -1)


def _port_route(gates, cfg):
    from repro_torch.models import moe
    dispatch, top_e = moe.route(torch.from_numpy(gates), cfg)[:2]
    return top_e.numpy(), dispatch.numpy()


def _counts(a, b):
    """Between routings ``a`` and ``b`` (each (ids, slots)): tokens whose
    top-k set differs, pairs with another expert at their rank, pairs
    given another slot, pairs kept by one and dropped by the other."""
    sets = (np.sort(a[0], 1) != np.sort(b[0], 1)).any(1)
    return (int(sets.sum()), int((a[0] != b[0]).sum()),
            int((a[1] != b[1]).sum()), int(((a[1] < 0) != (b[1] < 0)).sum()))


_CACHE = {}


def _measure(dtype_name):
    if dtype_name not in _CACHE:
        pytest.importorskip("jax")
        from repro_torch import configs
        cfg = _cfg(configs)
        params, tokens, xs_p, logits_p = _port(getattr(torch, dtype_name))
        xs_r, logits_r = _reference(params, tokens)
        router = [params["layers"]["router"][i].float().numpy()
                  for i in range(cfg.n_layers)]
        rows = []
        for i, (xp, xr) in enumerate(zip(xs_p, xs_r)):
            d = xp.shape[-1]
            gp, gs = (_port_gates(x.reshape(-1, d), router[i])
                      for x in (xp, xr))
            gr = _ref_gates(xr.reshape(-1, d), router[i])
            ref = _ref_route(gr, cfg)
            same = _counts(_port_route(gs, cfg), ref)
            own = _counts(_port_route(gp, cfg), ref)
            top = np.sort(gr, 1)[:, ::-1]
            gap = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
            rows.append({
                "layer": i, "same_input": same, "own_input": own,
                "x_rel_diff": float(np.linalg.norm(xp - xr)
                                    / np.linalg.norm(xr)),
                "gate_abs_diff_max": float(np.abs(gp - gr).max()),
                "tokens_with_kth_gap_below_it": int(
                    (gap < np.abs(gp - gr).max(1)).sum())})
        t = BATCH * SEQ
        _CACHE[dtype_name] = {
            "dtype": dtype_name, "tokens": t, "pairs": t * cfg.top_k,
            "layers": rows,
            "logits_rel_diff": float(np.linalg.norm(logits_p - logits_r)
                                     / np.linalg.norm(logits_r))}
        print("DRIFT " + json.dumps(_CACHE[dtype_name]))
    return _CACHE[dtype_name]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_same_input_routes_the_same(dtype):
    """On the reference's own layer inputs the port routes every token to
    the same experts and every pair to the same slot."""
    got = _measure(dtype)
    assert len(got["layers"]) == 4
    for row in got["layers"]:
        assert row["same_input"] == (0, 0, 0, 0), row


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_own_input_drift_is_bounded(dtype):
    """Along the forward, the flipped top-k choices, the pairs sent
    elsewhere, the shifted slots and the changed drops stay within
    ``DRIFT_MAX``; a flip needs a token whose k-th gate gap is below the
    gates' difference."""
    got = _measure(dtype)
    whole = (got["tokens"], got["pairs"], got["pairs"], got["pairs"])
    for row in got["layers"]:
        for n, share, of in zip(row["own_input"], DRIFT_MAX[dtype], whole):
            assert n <= share * of, row
        assert row["own_input"][0] <= row["tokens_with_kth_gap_below_it"], row
