"""Hero-wavelength spectral transport and the homogeneous medium in the
port's plain version against the JAX package on the CPU.

Function by function (`ops/spectral.py`, `sampling.sample_hg` and
`hg_phase`, the WAVELENGTH, VOL_FREEPATH, VOL_PHASE and VOL_NEE draws),
the reference's preset 8 (`spectral_caustics`) as the JAX package builds
it, the plain `integrator.trace` against the JAX `integrator.trace` on
that preset in three modes (spectral transport alone, the medium alone,
both) and on an SDF scene and a cubemap with both, the plain autograd
against `jax.grad` (the leaves of the JAX adjoint kernel's own test,
tests/test_megakernel.py:133-160, and every table leaf and ray on
`mis_demo` with both flags), and the gates: K1 and K2 admit both over
their class (each in its medium copy), every ReSTIR route refuses them,
naming ROADMAP item 10.  K1's medium copy is held against the plain
version in the host build (tests/test_torch_kernel_host.py) and on the
card (tests/test_torch_cuda.py); K2's against the plain autograd in the
host build (tests/test_torch_kernel_host_medium.py) and on the card.

Tolerances: the spectral functions within 1e-6 (torch's and XLA's CPU exp
differ by an ULP); the forward under the parity contract of
tests/test_torch_integrator.py (at least 99 % of pixels within 1e-5, the
median below 1e-4), with the share of pixels that an ULP of log, exp, sin
or cos sent down another path printed; gradients within 1e-4 relative per
leaf (tests/test_megakernel.py:128-129).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu import rng as jrng
from raytracer0_tpu.models import camera as jcam
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.ops import sampling as jsmp
from raytracer0_tpu.ops import sdf as jsdf
from raytracer0_tpu.ops import spectral as jspec
from raytracer0_tpu.render import integrator as jint
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models.camera import generate_rays
from raytracer0_tpu_torch.models.scene import Scene
from raytracer0_tpu_torch.ops import megakernel as tmk
from raytracer0_tpu_torch.ops import restir_kernel as tk6
from raytracer0_tpu_torch.ops import restir_split as tsplit
from raytracer0_tpu_torch.ops import sampling as tsmp
from raytracer0_tpu_torch.ops import spectral as tspec
from raytracer0_tpu_torch.render import integrator as tint
from raytracer0_tpu_torch.render.renderer import Renderer, render_pass
from raytracer0_tpu_torch.render.state import RenderState

from test_torch_models import _scene_arrays, _scene_static, assert_scene_equal

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PARITY_TOL, PARITY_FRAC, MEDIAN_TOL = 1e-5, 0.99, 1e-4
GRAD_TOL = 1e-4
#: the three modes of preset 8
MODES = {"spectral": dict(use_volumetrics=False), "media": dict(use_spectral=False),
         "both": {}}
T = torch.from_numpy
#: the NaN entries of jax.grad on `mis_demo` with both flags (8x16, 2
#: bounces), left out of test_plain_grad_matches_jax_media_scene
MEDIA_SCENE_NANS = {"pos": 21, "joker": 9, "ro": 42, "rd": 42}


def assert_parity(name, out, ref):
    err = np.abs(out - ref).max(axis=-1)
    flipped = float((err > 1e-3).mean())
    print(f"{name}: share within {PARITY_TOL} {(err < PARITY_TOL).mean():.4f}, flipped "
          f"(> 1e-3) {flipped:.4f}, max {err.max():.3e}, median {np.median(err):.3e}")
    assert (err < PARITY_TOL).mean() >= PARITY_FRAC, err.max()
    assert np.median(err) < MEDIAN_TOL


def test_spectral_functions_match_jax():
    """sample_wavelength, the three CMFs, XYZ -> linear sRGB,
    wavelength_to_rgb and cauchy_ior at 341 wavelengths."""
    u = np.arange(341, dtype=np.float32) / np.float32(341.0)
    lam = np.asarray(jspec.sample_wavelength(u))
    np.testing.assert_array_equal(tspec.sample_wavelength(T(u)).numpy(), lam)
    close = lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    for name in ("cmf_x", "cmf_y", "cmf_z"):
        close(getattr(tspec, name)(T(lam)).numpy(), getattr(jspec, name)(lam))
    xyz = np.stack([np.asarray(f(lam)) for f in (jspec.cmf_x, jspec.cmf_y, jspec.cmf_z)], -1)
    close(tspec.xyz_to_linear_srgb(T(xyz)).numpy(), jspec.xyz_to_linear_srgb(xyz))
    rgb = tspec.wavelength_to_rgb(T(lam)).numpy()
    close(rgb, jspec.wavelength_to_rgb(lam))
    assert rgb.shape == (341, 3) and (rgb >= 0.0).all() and rgb.max() > 1.0
    a = np.abs(np.float32(-1.7167)) + np.zeros_like(lam)
    close(tspec.cauchy_ior(T(lam), T(a)).numpy(), jspec.cauchy_ior(lam, a))


@pytest.mark.parametrize("g", [0.5, -0.3, 0.0, 0.9])
def test_hg_matches_jax(g):
    """Henyey-Greenstein sampling and the phase value, the isotropic g = 0
    too, on seeded directions and draws."""
    rs = np.random.default_rng(17)
    w = rs.normal(size=(512, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    u1, u2 = rs.random((2, 512), dtype=np.float32)
    got = tsmp.sample_hg(T(w), g, T(u1), T(u2)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsmp.sample_hg(w, g, u1, u2)), atol=2e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    cos = np.linspace(-1.0, 1.0, 257, dtype=np.float32)
    np.testing.assert_allclose(tsmp.hg_phase(T(cos), g).numpy(),
                               np.asarray(jsmp.hg_phase(cos, g)), rtol=1e-6, atol=1e-7)


def test_medium_draws_bitwise():
    """The four draws of the medium and of the hero wavelength at the
    coordinates the integrator keys them on (the WAVELENGTH draw on no
    depth, VOL_NEE on depth and slot), and the hero wavelength's RGB weight
    that K1's wrapper applies."""
    h, w = 8, 16
    jpix, tpix = jrng.pixel_ids(h, w), trng.pixel_ids(h, w)
    for name in ("WAVELENGTH", "VOL_FREEPATH", "VOL_PHASE", "VOL_NEE"):
        assert int(getattr(trng.Stream, name)) == int(getattr(jrng.Stream, name))
    bits = lambda x: np.asarray(x, np.float32).view(np.uint32)
    cases = [("uniform", (3, 1, "WAVELENGTH")), ("uniform", (3, 1, 5, "VOL_FREEPATH")),
             ("uniform2", (3, 1, 5, "VOL_PHASE")), ("uniform2", (3, 1, 5, 2, "VOL_NEE"))]
    for fn, coords in cases:
        want = getattr(jrng, fn)(jpix, *coords[:-1], getattr(jrng.Stream, coords[-1]))
        got = getattr(trng, fn)(tpix, *coords[:-1], getattr(trng.Stream, coords[-1]))
        want, got = (want, got) if fn == "uniform2" else ((want,), (got,))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(bits(a.numpy()), bits(b))
    wl = jspec.sample_wavelength(jrng.uniform(jpix, 3, 1, jrng.Stream.WAVELENGTH))
    np.testing.assert_allclose(tmk.spectral_rgb(tpix, 3, 1).numpy(),
                               np.asarray(jspec.wavelength_to_rgb(wl)), rtol=1e-6, atol=1e-6)


def test_spectral_caustics_matches_jax_preset():
    """The port's preset 8 builds the JAX package's scene (the flint
    sphere's negative IOR among its arrays), camera and config, and
    `Scene.from_arrays` carries the JAX scene across unchanged."""
    js, jc, jcfg = jpresets.spectral_caustics()
    ts, tc, tcfg = tpresets.spectral_caustics(device="cpu")
    assert_scene_equal(ts, js)
    assert_scene_equal(Scene.from_arrays(_scene_arrays(js), _scene_static(js), "cpu"), js)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.use_spectral and tcfg.use_volumetrics and not tcfg.use_procedural_sky
    for k in ("origin", "lookat", "fov", "aperture", "focal_length"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)))
    assert float(ts.ior.min()) < 0.0


def _pair(where, h, w, max_bounces, **kw):
    """The JAX and the port's (scene, config) of the preset `where` with
    the config changes `kw`, and the JAX camera's rays of pass 1."""
    js, jc, jcfg = getattr(jpresets, where)()
    ts, _, _ = getattr(tpresets, where)(device="cpu")
    cfg = jcfg.replace(max_bounces=max_bounces, **kw)
    ro, rd = (np.asarray(a) for a in jcam.generate_rays(jc, h, w, 1))
    return js, ts, cfg, ro, rd


def _plain(ts, cfg, ro, rd, h, w):
    return tint.trace(ts, cfg, T(ro.copy()), T(rd.copy()), trng.pixel_ids(h, w), 1, 0).numpy()


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_matches_jax_integrator(mode):
    """Preset 8 at 8x16 with 3 bounces in each mode: the plain version
    against the JAX `integrator.trace`; the mode changes the image."""
    h, w = 8, 16
    js, ts, cfg, ro, rd = _pair("spectral_caustics", h, w, 3, **MODES[mode])
    ref = np.asarray(jint.trace(js, cfg, ro, rd, jrng.pixel_ids(h, w), 1, 0))
    out = _plain(ts, cfg, ro, rd, h, w)
    assert out.shape == (h, w, 3) and np.isfinite(out).all() and ref.max() > 0.1
    assert_parity(f"spectral_caustics, {mode}", out, ref)
    plain = _plain(ts, cfg.replace(use_spectral=False, use_volumetrics=False), ro, rd, h, w)
    assert (np.abs(out - plain).max(-1) > 1e-3).mean() > 0.25


@pytest.mark.parametrize("where,kw", [
    ("mis_demo", dict(use_mis=True)),
    ("cubemap_demo", {}),
], ids=["mis_demo", "cubemap_demo"])
def test_media_scenes_match_jax_integrator(where, kw):
    """Spectral transport and the medium over an SDF box under MIS (its
    tiny light's cone, the stale prev_nl of a scattered path's MIS weight)
    and under a photographic cubemap (rays that miss the scene can
    scatter), at 8x16 with 3 bounces; the JAX reference runs op by op, as
    tests/test_torch_sdf.py runs its SDF scenes (compiled XLA contracts
    FMAs, and a tiny light's cone sampler is ill-conditioned)."""
    h, w = 8, 16
    js, ts, cfg, ro, rd = _pair(where, h, w, 3, use_spectral=True, use_volumetrics=True,
                                remat_bounces=False, **kw)
    with jax.disable_jit():
        ref = np.asarray(jint.trace(js, cfg, ro, rd, jrng.pixel_ids(h, w), 1, 0,
                                    sdf_march=jsdf.march))
    out = _plain(ts, cfg, ro, rd, h, w)
    assert np.isfinite(out).all() and ref.max() > 0.02
    assert_parity(where, out, ref)


@pytest.mark.parametrize("bounces", [2, 3])
def test_plain_grad_matches_jax(bounces):
    """d sum(trace) / d(color, emission, ior) of preset 8 at 8x16 with 2
    bounces, as the JAX package holds its adjoint kernel, and with 3, where
    the flint's IOR first reaches the image (its refracted ray's in-scatter
    NEE and its next hit): the plain autograd (the reference of K2's medium
    copy, the adjoint of the medium and of Cauchy's IOR) against jax.grad."""
    h, w = 8, 16
    js, ts, cfg, ro, rd = _pair("spectral_caustics", h, w, bounces)
    leaves = ("color", "emission", "ior")
    jpix, tpix = jrng.pixel_ids(h, w), trng.pixel_ids(h, w)

    def jloss(*vals):
        return jnp.sum(jint.trace(js.replace(**dict(zip(leaves, vals))), cfg, ro, rd, jpix, 1, 0))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(getattr(js, k) for k in leaves))
    vals = {k: getattr(ts, k).detach().clone().requires_grad_(True) for k in leaves}
    tint.trace(ts.replace(**vals), cfg, T(ro.copy()), T(rd.copy()), tpix, 1, 0).sum().backward()
    for k, b in zip(leaves, want):
        a, b = vals[k].grad.numpy(), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-12)
        print(f"d/d {k}: max |a - b| / max |b| = {np.abs(a - b).max() / scale:.3e}")
        assert np.isfinite(a).all() and np.abs(a - b).max() / scale < GRAD_TOL, k
    if bounces == 3:   # Cauchy's IOR carries a gradient
        assert np.abs(np.asarray(want[2])).max() > 0.0


def test_plain_grad_matches_jax_media_scene():
    """Spectral transport and the medium beyond preset 8: d sum(trace * w)
    / d(pos, joker, color, emission, ro, rd) on `mis_demo` (an SDF box, a
    tiny sphere light under MIS) with both flags at 8x16 and 2 bounces
    (seeded weights w), the plain autograd against jax.grad op by op, per
    leaf within 1e-4 relative.  As in tests/test_torch_grad_wide.py, an
    entry where jax.grad gives NaN (`vecmath.length` at 0 in the SDF
    distance; the port's length has a zero gradient there) is left out and
    the NaNs are counted, so a new one fails the test."""
    h, w = 8, 16
    js, ts, cfg, ro, rd = _pair("mis_demo", h, w, 2, use_mis=True, use_spectral=True,
                                use_volumetrics=True, remat_bounces=False, marching_steps=16)
    leaves = ("pos", "joker", "color", "emission")
    wt = np.random.default_rng(3).uniform(0.5, 1.5, (h, w, 3)).astype(np.float32)
    jpix, tpix = jrng.pixel_ids(h, w), trng.pixel_ids(h, w)

    def jtrace(*args):
        return jint.trace(js.replace(**dict(zip(leaves, args[:-2]))), cfg, args[-2], args[-1],
                          jpix, 1, 0, sdf_march=jsdf.march)

    with jax.disable_jit():
        _, jvjp = jax.vjp(jtrace, *(getattr(js, k) for k in leaves), jnp.asarray(ro),
                          jnp.asarray(rd))
        want = dict(zip(leaves + ("ro", "rd"), (np.asarray(g) for g in jvjp(jnp.asarray(wt)))))
    vals = {k: getattr(ts, k).detach().clone().requires_grad_(True) for k in leaves}
    o, d = T(ro.copy()).requires_grad_(True), T(rd.copy()).requires_grad_(True)
    out = tint.trace(ts.replace(**vals), cfg, o, d, tpix, 1, 0)
    got = torch.autograd.grad((out * T(wt)).sum(), [*vals.values(), o, d])
    for k, a in zip(leaves + ("ro", "rd"), got):
        a, b = a.numpy(), want[k]
        ok = np.isfinite(b)
        scale = max(np.abs(b[ok]).max(), 1e-12)
        print(f"d/d {k}: max |a - b| / max |b| = {np.abs(a[ok] - b[ok]).max() / scale:.3e}, "
              f"{int((~ok).sum())} NaN entries of jax.grad left out")
        assert np.isfinite(a).all() and np.abs(a[ok] - b[ok]).max() / scale < GRAD_TOL, k
        assert scale > 1e-12, k
    counted = {k: int((~np.isfinite(v)).sum()) for k, v in want.items() if not np.isfinite(v).all()}
    assert counted == MEDIA_SCENE_NANS, counted


def test_gates_after_the_widening():
    """K1 admits spectral transport and the medium over its class (the
    plain version renders them, `trace_forward` on CPU tensors is the plain
    version, scaled once); K2 admits them too, in its medium copy (a stash
    of 12 slots under the preset's OFFLINE_CONFIG budgets, the wide copy's
    columns, the IOR's among them), while a gradient w.r.t. a texel array
    is still refused (item 14); every ReSTIR route (K4, K6 and K6v, the
    split path, K7 and the plain ReSTIR pass) still refuses them, each
    naming ROADMAP item 10."""
    ts, cam, cfg = tpresets.spectral_caustics(device="cpu")
    for kw in MODES.values():
        c = cfg.replace(**kw)
        assert tint.unsupported(ts, c) is None and tmk.unsupported(ts, c) is None
        assert tmk.unsupported_bwd(ts, c) is None and tmk.bwd_copy(ts, c) == "medium"
        assert not tmk.cornell_copy(ts, c) and tmk.bwd_slots(ts, c) == 12 <= tmk.MAX_SLOTS
        assert tmk.bwd_columns(ts, c) == tmk.wide_columns(ts) and 13 in tmk.bwd_columns(ts, c)
        assert "item 14" in tmk.unsupported_bwd(
            ts.replace(noise=ts.noise.clone().requires_grad_(True)), c)
    h, w = 4, 8
    ro, rd = generate_rays(cam, h, w, 0)
    pix = trng.pixel_ids(h, w)
    np.testing.assert_array_equal(tmk.trace_forward(ts, cfg, ro, rd, pix, 0, 0).numpy(),
                                  tint.trace(ts, cfg, ro, rd, pix, 0, 0).numpy())
    img = Renderer(ts, cam, cfg.replace(max_bounces=3), h, w).render(2)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0.0

    demo, dcam, dcfg = tpresets.restir_demo(device="cpu")
    for kw in ({"use_spectral": True}, {"use_volumetrics": True}):
        c = dcfg.replace(**kw)
        for gate in (tint.unsupported, tk6.unsupported_restir, tsplit.unsupported_gbuffer,
                     tk6.unsupported_restir_bwd):
            assert "item 10" in gate(demo, c), gate.__name__
        with pytest.raises(NotImplementedError, match="item 10"):
            tsplit.check_split(demo, c.replace(restir_adhoc_motion=True), dcam,
                               RenderState.create(h, w, "cpu"))
        with pytest.raises(NotImplementedError, match="item 10"):
            render_pass(demo, dcam, c, RenderState.create(h, w, "cpu"), h, w)
