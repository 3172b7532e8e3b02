"""The port's ray tracer (``repro_torch.apps.raytrace``) on the CPU, held
against itself and against the JAX package's ``repro.apps.raytrace``.

Inside the port the renders are bit-identical: ``render_rounds`` fused
equals legacy, and ``render_queue`` and ``render_compaction`` give the
same image (each pixel's contributions come in one order, and a ray's
trace does not depend on its batch).

Against the reference the images agree to float32 rounding only.  XLA's
CPU backend contracts some products of ``_trace_once`` into fused
multiply-adds (``disc = b*b - c`` differs in 247,193 of 409,600 entries
at 64 x 64 on the complex scene), which PyTorch's separate operations do
not.  The primary step's colours then differ by at most about 5e-5, and
after a bounce a grazing ray can hit another sphere or checker cell: on
the complex scene at 64 x 64, 19 pixels differ by more than 1e-4 (the
largest by 0.113) with the ray counts equal.  So:

* ``trace_once`` against ``_trace_once`` on the same rays (the primary
  rays and their first bounces): ``alive``, ``refl`` (which names the
  surface hit) and the hit equal on every ray whose decisions have a
  margin above 1e-5 (each compare the trace makes, relative to the size
  of what it compares);
  the continuous outputs within 1e-4 on those of them whose hit is well
  conditioned (a plane hit, a miss, or a sphere hit whose discriminant is
  above 1e-2 of b^2: nearer the tangent the contracted rounding of
  ``disc`` is amplified by 1 / sqrt(disc), past 1e-4 in the reflected
  direction);
* whole renders: on the cornell scene the stats exact and the image
  within 1e-4; on the complex scene ``rays`` exact, at least 99 % of the
  pixels within 1e-4 and every pixel finite."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.apps import raytrace as R  # noqa: E402
from repro_torch.apps import raytrace as T  # noqa: E402

SCENES = ("cornell", "complex")
SIZES = (16, 64)
INFO = ("rays", "waves", "rounds", "host_syncs")


def _scenes(name):
    return getattr(R, f"{name}_scene")(), getattr(T, f"{name}_scene")()


def test_scenes_equal_the_reference():
    for name in SCENES:
        js, ts = _scenes(name)
        for f in ("centers", "radii", "albedo", "reflect"):
            assert np.array_equal(getattr(js, f), getattr(ts, f))
        assert (js.max_bounces, js.name) == (ts.max_bounces, ts.name)


def test_primary_rays_match_reference():
    o, d = T.primary_rays(48, 32, device="cpu")
    jo, jd = R.primary_rays(48, 32)
    assert np.array_equal(o.numpy(), np.asarray(jo))
    # the norm's float32 sum may round one ulp (1.2e-7 here) apart
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0,
                               atol=2.5e-7)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", SCENES)
def test_render_rounds_fused_equals_legacy_and_queue(name, n):
    """tests/test_fusedrounds.py's raytrace case on the port: fused and
    legacy bit for bit, the fused render one readback, both within 1e-5
    of ``render_queue`` (here equal) and of ``render_compaction``."""
    _, sc = _scenes(name)
    img_f, info_f = T.render_rounds(sc, n, n, 256, device="cpu")
    img_l, info_l = T.render_rounds(sc, n, n, 256, fused=False, device="cpu")
    assert np.array_equal(img_f, img_l)
    assert info_f["rays"] == info_l["rays"]
    assert info_f["rounds"] == info_l["rounds"]
    assert info_f["host_syncs"] == 1 and info_l["fused"] == 0
    img_q, info_q = T.render_queue(sc, n, n, device="cpu")
    img_c, info_c = T.render_compaction(sc, n, n, device="cpu")
    np.testing.assert_allclose(img_f, img_q, rtol=0, atol=1e-5)
    np.testing.assert_allclose(img_f, img_c, rtol=0, atol=1e-5)
    assert info_f["rays"] == info_q["rays"] == info_c["rays"]
    assert img_f.shape == (n, n, 3) and np.isfinite(img_f).all()


def _margins(o, d, scene):
    """Per ray, in float64: the smallest margin of the trace's decisions
    relative to what they compare (discriminant sign, the 1e-3 cut-offs,
    the plane test, the nearest against the second-nearest hit, the
    checker's floor), the hit sphere (-1 for the plane or no hit) and the
    hit sphere's discriminant over b^2."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    ce, ra = scene.centers.astype(np.float64), scene.radii.astype(np.float64)
    oc = o[:, None, :] - ce[None]
    b = (oc * d[:, None, :]).sum(-1)
    c = (oc * oc).sum(-1) - ra ** 2
    disc = b * b - c
    m = (np.abs(disc) / np.maximum(1, b * b)).min(1)
    t = np.where(disc > 0, -b - np.sqrt(np.maximum(disc, 0)), np.inf)
    near = lambda x, at: np.where(np.isfinite(x),  # noqa: E731
                                  np.abs(x - at) / np.maximum(1, np.abs(x)),
                                  np.inf)
    m = np.minimum(m, near(t, 1e-3).min(1))
    t = np.where(t > 1e-3, t, np.inf)
    tpl = np.where(d[:, 1] < -1e-6, -o[:, 1] / d[:, 1], np.inf)
    m = np.minimum(m, np.abs(d[:, 1] + 1e-6))
    m = np.minimum(m, near(tpl, 1e-3))
    tpl = np.where(tpl > 1e-3, tpl, np.inf)
    cand = np.sort(np.concatenate([t, tpl[:, None]], 1), 1)
    gap = np.where(np.isfinite(cand[:, 1]),
                   (cand[:, 1] - cand[:, 0]) / np.maximum(1, cand[:, 0]),
                   np.inf)
    m = np.minimum(m, gap)
    best = cand[:, 0]
    j = np.argmin(t, 1)
    sphere = np.isfinite(t.min(1)) & (t.min(1) < tpl)
    p = o + np.where(np.isfinite(best), best, 0)[:, None] * d
    frac = lambda x: np.abs(x - np.round(x))  # noqa: E731
    on_plane = np.isfinite(tpl) & ~sphere
    m = np.minimum(m, np.where(on_plane, np.minimum(frac(p[:, 0]),
                                                    frac(p[:, 2])), np.inf))
    rows = np.arange(len(j))
    rel = disc[rows, j] / np.maximum(1, b[rows, j] ** 2)
    return m, np.where(sphere, j, -1), rel


@pytest.mark.parametrize("name", SCENES)
def test_trace_once_matches_reference(name):
    js, ts = _scenes(name)
    sc = [jnp.asarray(x) for x in (js.centers, js.radii, js.albedo,
                                   js.reflect)]
    o, d = (np.asarray(x) for x in R.primary_rays(64, 64))
    _, no, nd, alive, _ = (np.asarray(x) for x in R._trace_once(o, d, *sc))
    o = np.concatenate([o, no[alive]])        # the primary rays and their
    d = np.concatenate([d, nd[alive]])        # first bounces
    ref = [np.asarray(x) for x in R._trace_once(jnp.asarray(o),
                                                jnp.asarray(d), *sc)]
    got = [x.numpy() for x in T.trace_once(
        torch.as_tensor(o), torch.as_tensor(d),
        *T.scene_tensors(ts, "cpu"))]
    with np.errstate(divide="ignore", invalid="ignore"):   # inf - inf
        margin, sphere, rel = _margins(o, d, js)
    sure = margin > 1e-5
    assert sure.mean() > 0.95
    # the decisions: alive, refl (the surface hit) and the hit
    assert np.array_equal(got[3][sure], ref[3][sure])
    assert np.array_equal(got[4][sure], ref[4][sure])
    hit = [np.isfinite(x[:, 0]) for x in (got[1], ref[1])]
    assert np.array_equal(hit[0][sure], hit[1][sure])
    well = sure & ((sphere < 0) | (rel > 1e-2))
    assert well.sum() > 0.8 * sure.sum()
    for g, r in zip(got[:3], ref[:3]):
        g, r = g[well], r[well]
        assert np.array_equal(np.isfinite(g), np.isfinite(r))
        fin = np.isfinite(r)
        assert np.abs(g[fin] - r[fin]).max() <= 1e-4
    assert all(g.shape == r.shape for g, r in zip(got, ref))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", SCENES)
def test_whole_renders_match_reference(name, n):
    js, ts = _scenes(name)
    img, info = T.render_rounds(ts, n, n, 256, device="cpu")
    jimg, jinfo = R.render_rounds(js, n, n, 256)
    qimg, qinfo = T.render_queue(ts, n, n, device="cpu")
    jqimg, jqinfo = R.render_queue(js, n, n)
    cimg, cinfo = T.render_compaction(ts, n, n, device="cpu")
    jcimg, jcinfo = R.render_compaction(js, n, n)
    assert np.isfinite(img).all()
    assert info["rays"] == jinfo["rays"]
    assert (qinfo["rays"], cinfo["rays"]) == (jqinfo["rays"], jcinfo["rays"])
    pairs = ((img, jimg), (qimg, jqimg), (cimg, jcimg))
    if name == "cornell":
        assert [info[k] for k in INFO] == [jinfo[k] for k in INFO]
        assert qinfo == jqinfo
        for a, b in pairs:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    else:
        for a, b in pairs:
            close = (np.abs(a - b) <= 1e-4).all(-1)
            assert close.mean() >= 0.99, close.mean()


def test_sync_every_matches_reference():
    js, ts = _scenes("cornell")
    img, info = T.render_rounds(ts, 16, 16, 64, sync_every=2, device="cpu")
    jimg, jinfo = R.render_rounds(js, 16, 16, 64, sync_every=2)
    assert [info[k] for k in INFO] == [jinfo[k] for k in INFO]
    assert info["host_syncs"] > 1
    np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-4)


def test_render_rounds_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError):
        T.render_rounds(T.cornell_scene(), 16, 16)
