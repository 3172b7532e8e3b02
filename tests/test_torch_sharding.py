"""The port's PartitionSpecs held equal to the reference's.

For every registry config and its ``-smoke``: ``param_specs`` with FSDP
on and off, ``state_pspecs``, and for every input shape ``batch_pspecs``,
``cache_pspecs`` and ``token_pspecs`` — before and after
``sanitize_pspecs`` — over the production meshes (16 x 16 and 2 x 16 x
16) and the (S, 1) data meshes of S = 2 and 4 ranks.  Each reference
``PartitionSpec`` is compared as a tuple; the reference's meshes are
device-less ``jax.sharding.AbstractMesh``es, the port's ``make_mesh``
sizes with no process group, so no device is forced.  Each leaf's block
under the sanitized specs (``distributed.sharding.shard``) has the shape
of the reference's ``NamedSharding.shard_shape``."""

import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import param_specs as jparam_specs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.distributed.sharding import (DataParallel, P,  # noqa: E402
                                              _assemble,
                                              block_cuts, check_mesh,
                                              coords, data_dim, model_dim,
                                              shard)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import param_specs  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

NAMES = sorted(jconfigs.ARCHS)
CONFIGS = NAMES + [n + "-smoke" for n in NAMES]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}


def _cfgs(name):
    return configs.get_config(name), jconfigs.get_config(name)


def _meshes(key):
    shape, names = MESHES[key]
    return make_mesh(shape, names), AbstractMesh(shape, names)


def _flat(tree):
    """{path: tuple(spec)} of a port tree (``P`` leaves)."""
    out = {}
    for k, v in flatten_with_paths(tree):
        assert isinstance(v, P), (k, v)
        out[k] = tuple(v)
    return out


def _jflat(tree):
    """{path: tuple(spec)} of a reference tree, keyed as the port's."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    out = {}
    for path, v in leaves:
        assert isinstance(v, JP), (path, v)
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(
            p, "name", p)))) for p in path)
        out[key] = tuple(v)
    return out


def _same(got, want):
    """Equal spec trees (the reference's NamedTuple fields are keyed by
    name, the port's with a leading '.')."""
    g = {k.replace(".", ""): v for k, v in _flat(got).items()}
    assert g == _jflat(want)


@functools.lru_cache(maxsize=None)
def _structs(name):
    cfg, jcfg = _cfgs(name)
    return steps.state_struct(cfg), jsteps.state_struct(jcfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_param_and_state_specs(name):
    cfg, jcfg = _cfgs(name)
    for fsdp in (None, True, False):
        _same(param_specs(cfg, fsdp=fsdp), jparam_specs(jcfg, fsdp=fsdp))
    _same(steps.state_pspecs(cfg), jsteps.state_pspecs(jcfg))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_sanitized_state_specs_and_shards(name, mesh):
    cfg, jcfg = _cfgs(name)
    m, jm = _meshes(mesh)
    st, jst = _structs(name)
    got = steps.sanitize_pspecs(steps.state_pspecs(cfg), st, m)
    want = jsteps.sanitize_pspecs(jsteps.state_pspecs(jcfg), jst, jm)
    _same(got, want)
    if not mesh.endswith("x1"):
        return          # the port shards over the data axis alone
    # a rank's block of every leaf: the reference's shard shape
    jleaves = dict(zip(_jflat(want), jax.tree.leaves(jst)))
    for (k, spec), (_, x) in zip(flatten_with_paths(got),
                                 flatten_with_paths(st)):
        jk = k.replace(".", "")
        want_shape = NamedSharding(jm, JP(*tuple(spec))).shard_shape(
            jleaves[jk].shape)
        for r in range(m.shape["data"]):
            assert tuple(shard(x, spec, m, r).shape) == want_shape, (k, r)
        d = data_dim(spec, m)
        assert (d is None) == (tuple(want_shape) == tuple(x.shape)), k


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_input_specs_every_shape(name, mesh):
    """batch, cache and token specs of every shape, raw and sanitized."""
    cfg, jcfg = _cfgs(name)
    m, jm = _meshes(mesh)
    for shape in configs.SHAPES:
        got, want = (steps.batch_pspecs(cfg, shape, m),
                     jsteps.batch_pspecs(jcfg, shape, jm))
        _same(got, want)
        _same(steps.sanitize_pspecs(got, steps.batch_struct(cfg, shape), m),
              jsteps.sanitize_pspecs(want, jsteps.batch_struct(jcfg, shape),
                                     jm))
        assert tuple(steps.token_pspecs(cfg, shape, m)) == tuple(
            jsteps.token_pspecs(jcfg, shape, jm))
        got, want = (steps.cache_pspecs(cfg, shape, m),
                     jsteps.cache_pspecs(jcfg, shape, jm))
        _same(got, want)
        _same(steps.sanitize_pspecs(got, steps.cache_struct(cfg, shape), m),
              jsteps.sanitize_pspecs(want, jsteps.cache_struct(jcfg, shape),
                                     jm))


def test_spec_normalises_as_the_reference():
    for parts in [(("data",), None), ((), None), (("pod", "data"), "model"),
                  (None,), ()]:
        assert tuple(P(*parts)) == tuple(JP(*parts))
        assert P(*parts) == P(*parts) and P(*parts) == tuple(JP(*parts))
    assert P("data") != P(None)


def test_model_axis_is_refused_by_name():
    """Training over "model" runs the dense and moe families (a leaf cut
    over both axes has its data dimension); the other families are
    refused by name."""
    m = make_mesh((2, 2), ("data", "model"))
    assert data_dim(P("data", "model"), m) == 0
    with pytest.raises(ValueError, match='the ssm family over "model" is '
                                         'not ported'):
        steps.make_train_step(configs.get_config("mamba2-130m-smoke"),
                              pspecs={}, mesh=m)


TP_MESHES = {"1x4": ((1, 4), ("data", "model")),
             "2x2": ((2, 2), ("data", "model"))}


@pytest.mark.parametrize("mesh", sorted(TP_MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_two_dimensional_blocks(name, mesh):
    """Every parameter leaf's block under the sanitized specs on every
    rank of a ("data", "model") mesh (cut over both axes where FSDP is
    on) has the reference's ``NamedSharding.shard_shape``, and the ranks'
    blocks in rank order put together (``unshard_tree``'s assembly) are
    the whole leaf."""
    cfg, jcfg = _cfgs(name)
    shape, names = TP_MESHES[mesh]
    m, jm = make_mesh(shape, names), AbstractMesh(shape, names)
    st = steps.params_struct(cfg)
    got = steps.sanitize_pspecs(param_specs(cfg), st, m)
    want = jsteps.sanitize_pspecs(jparam_specs(jcfg),
                                  jsteps.params_struct(jcfg), jm)
    _same(got, want)
    n = shape[0] * shape[1]
    for (k, spec), (_, x) in zip(flatten_with_paths(got),
                                 flatten_with_paths(st)):
        want_shape = NamedSharding(jm, JP(*tuple(spec))).shard_shape(
            tuple(x.shape))
        for r in range(n):
            assert tuple(shard(x, spec, m, r).shape) == want_shape, (k, r)
    small = torch.arange(4 * 8 * 8).reshape(4, 8, 8).float()
    for spec in (P("data", "model", None), P("model", None, "data"),
                 P(None, None, "model"), P("data", None, None), P()):
        rows = torch.stack([shard(small, spec, m, r) for r in range(n)])
        dd = data_dim(spec, m)
        assert torch.equal(_assemble(rows, dd, model_dim(spec, m), m),
                           small), spec


def test_model_dim_coords_and_cuts():
    m = make_mesh((2, 4), ("data", "model"))
    assert model_dim(P("data", "model"), m) == 1
    assert model_dim(P("model", None), m) == 0
    assert model_dim(P("data", None), m) is None
    assert model_dim(P(None, "model"), make_mesh((2, 1), ("data", "model"))
                     ) is None
    assert data_dim(P("data", "model"), m) == 0
    assert [coords(m, r) for r in range(8)] == [
        (d, j) for d in range(2) for j in range(4)]
    assert block_cuts(P("model", "data"), m, 6) == [(1, 2, 1), (0, 4, 2)]
    with pytest.raises(ValueError, match="sequence-sharded branch"):
        data_dim(P(None, ("data", "model")), m)
    assert data_dim(P(None, "model"), m) is None


def test_serve_mesh_refusals_by_name():
    m = make_mesh((1, 2), ("data", "model"))
    check_mesh(m, configs.get_config("yi-34b-smoke"))
    check_mesh(m, configs.get_config("deepseek-moe-16b-smoke"))
    for arch, family in (("mamba2-130m-smoke", "ssm"),
                         ("zamba2-7b-smoke", "hybrid"),
                         ("llama-3.2-vision-11b-smoke", "vlm"),
                         ("hubert-xlarge-smoke", "audio")):
        with pytest.raises(ValueError, match=f"the {family} family over "
                                             f'"model" is not ported'):
            check_mesh(m, configs.get_config(arch))
    with pytest.raises(ValueError, match="takes TensorParallel"):
        DataParallel(m, {})
    with pytest.raises(ValueError, match="must be the last axis"):
        check_mesh(make_mesh((2, 1), ("model", "data")))
