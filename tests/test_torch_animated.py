"""The port's ANIMATED (real-time) mode against the JAX package, on the same
inputs: `animate_positions` (the orbit of rows 6-14 and the rotation and bob
of SDF rows), the moving-average accumulator and the display of
`render_pass`/`display_image`, an ANIMATED `sample_radiance` pass with ReSTIR
off, and the plain `restir.render_sample` under ANIMATED accumulation (the
history's light data refreshed, alpha x 0.85, spatial taps younger than 2
passes) over 4 passes at a moving frame time.

The scene is `animated_restir` with its rounded box MAT_WHITE, the
real-time scene the port measured before it rendered the preset as shipped
(tests/test_torch_restir_sdf.py holds that one, with its METAL texture on
an SDF mesh; `test_animated_restir_refused` checks its gates).  It crosses from
JAX through `Scene.from_arrays`, the rings through `Reservoirs.from_arrays`.
The JAX references run op by op (`jax.disable_jit`), since compiled XLA
contracts a*b + c into FMAs (tests/test_torch_restir.py).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.models import scene as jscene
from raytracer0_tpu.models.dsl import parse_scene as jparse
from raytracer0_tpu.models.materials import SdfShape as JSdfShape
from raytracer0_tpu.ops import restir as jrestir
from raytracer0_tpu.render import renderer as jren
from raytracer0_tpu.render.state import RenderState as JState
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.config import RenderMode
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models import scene as tscene
from raytracer0_tpu_torch.models.camera import Camera, generate_rays
from raytracer0_tpu_torch.ops import restir as trestir
from raytracer0_tpu_torch.ops import restir_kernel as tk6
from raytracer0_tpu_torch.ops import restir_split as tsplit
from raytracer0_tpu_torch.render import integrator as tint
from raytracer0_tpu_torch.render import renderer as tren
from raytracer0_tpu_torch.render.state import RESERVOIR_FIELDS, RenderState, Reservoirs

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

H, W = 8, 32
FIELDS = tuple(RESERVOIR_FIELDS)
TIMES = [0.0, 0.37, 2.75, 9.1]


def jax_realtime_scene():
    """The JAX real-time scene and camera (animated_restir, MAT_WHITE box)."""
    _, cam, _ = jpresets.animated_restir()
    text = tpresets._ANIMATED_RESTIR.replace("MAT_METAL, SDF", "MAT_WHITE, SDF")
    return jparse(text, sdf_shapes=[JSdfShape.ROUND_BOX]), cam


def port_scene(js):
    return tscene.Scene.from_arrays({k: np.asarray(getattr(js, k)) for k in tscene.TENSOR_FIELDS},
                                    {k: getattr(js, k) for k in tscene.STATIC_FIELDS}, "cpu")


def port_camera(jc):
    return Camera.from_arrays({k: np.asarray(getattr(jc, k)) for k in
                               ("origin", "lookat", "fov", "aperture", "focal_length")}, "cpu")


def port_ring(jstate, h, w):
    conv = lambda r: Reservoirs.from_arrays({k: np.asarray(getattr(r, k)) for k in FIELDS}, "cpu")
    return RenderState.create(h, w, "cpu").replace(
        restir_back=conv(jstate.restir_back), restir_hist1=conv(jstate.restir_hist1),
        restir_hist2=conv(jstate.restir_hist2))


def restir_cfg(**kw):
    """ANIMATED_CONFIG at a test's size (remat_bounces only steers JAX's
    autodiff memory; off, its op-by-op run compiles each op once)."""
    kw = dict(dict(max_bounces=2, restir_samples=4, marching_steps=16, remat_bounces=False),
              **kw)
    return jpresets.animated_restir()[2].replace(**kw)


def jax_restir_passes(cfg, h=H, w=W, passes=4):
    """JAX render_sample on the real-time scene, passes 0-3 at the frame
    times k/30, op by op: [(ring before the pass, radiance, new back)]."""
    js, jc = jax_realtime_scene()
    state, out = JState.create(h, w), []
    with jax.disable_jit():
        for p in range(passes):
            rad, nb = jrestir.render_sample(js, cfg, jc, state, h, w, p, jnp.float32(p / 30))
            out.append((state, np.asarray(rad), {k: np.asarray(getattr(nb, k)) for k in FIELDS}))
            state = state.rotate_reservoirs(nb)
    return out


def pass_contract(rad, new, ref_rad, ref_new):
    """tests/test_torch_restir.py's pass contract: JAX's fused-versus-
    wavefront contract (max |Δ| < 5e-3, median < 1e-6, light indices
    agreeing at >= 99.5 %, the other fields within 1e-4 plus 1e-4 of their
    size where they agree)."""
    err = np.abs(rad - ref_rad)
    agree = new["light_index"] == ref_new["light_index"]
    print(f"max |Δ| {err.max():.3e}, median {np.median(err):.3e}, "
          f"{int((err.max(axis=-1) > 0).sum())} pixels differ, light index agrees at "
          f"{agree.mean():.4f}")
    assert err.max() < 5e-3 and np.median(err) < 1e-6
    assert agree.mean() >= 0.995
    for k in FIELDS:
        if k != "light_index":
            np.testing.assert_allclose(new[k][agree], ref_new[k][agree], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("t", TIMES)
def test_animate_positions_matches_jax(t):
    """Both branches (the orbit of rows 6-14, then the SDF row's rotation
    about Y and bob) against JAX at a float32 frame time; XLA's and ATen's
    sin/cos may differ by an ULP, so within 1e-6 (the largest difference is
    printed), and the identity under STATIC."""
    js, _ = jax_realtime_scene()
    ts = port_scene(js)
    with jax.disable_jit():
        want = np.asarray(jscene.animate_positions(js, jnp.float32(t), 1).pos)
    got = tscene.animate_positions(ts, t, int(RenderMode.ANIMATED)).pos.numpy()
    print(f"t={t}: largest difference {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    moved = np.abs(want - np.asarray(js.pos)).max(axis=-1) > 0
    assert moved[6:15].all() and not moved[:6].any() and not moved[15:17].any()
    assert moved[-1] == (t != 0.0)   # at t = 0 the SDF row's rotation and bob are 0
    assert tscene.animate_positions(ts, t, int(RenderMode.STATIC)) is ts


def test_animate_positions_differentiable():
    """Autograd carries `pos` through the animation: d sum(pos') / d pos is
    1 on the orbiting rows and the SDF row's rotation's column sums."""
    ts = port_scene(jax_realtime_scene()[0])
    pos = ts.pos.clone().requires_grad_(True)
    out = tscene.animate_positions(ts.replace(pos=pos), 1.3, 1).pos
    g = torch.autograd.grad(out.sum(), pos)[0]
    assert torch.equal(g[:17], torch.ones_like(g[:17]))
    ca, sa = np.cos(np.float32(0.65)), np.sin(np.float32(0.65))
    np.testing.assert_allclose(g[17].numpy(), [ca + sa, 1.0, ca - sa], rtol=1e-6)


def test_ema_and_display_match_jax(monkeypatch):
    """Two ANIMATED passes of `render_pass` with the same seeded radiance in
    both packages: the moving average accum + (radiance - accum) / 5 equals
    JAX's bit for bit, and `display_image` (scale 1 under ANIMATED) within
    1e-5 (pow rounds by an ULP differently, tests/test_torch_renderer.py)."""
    cfg = jpresets.animated_restir()[2].replace(use_restir=False)
    r = np.random.default_rng(11)
    rads = [r.uniform(0.0, 3.0, (4, 8, 3)).astype(np.float32) for _ in range(2)]
    monkeypatch.setattr(jren, "sample_radiance",
                        lambda *a, **k: jnp.asarray(rads[int(a[5])]))
    monkeypatch.setattr(tren, "sample_radiance",
                        lambda *a, **k: torch.from_numpy(rads[int(a[5])].copy()))
    js, jc = jax_realtime_scene()
    jst, tst = JState.create(4, 8), RenderState.create(4, 8, "cpu")
    with jax.disable_jit():
        for _ in range(2):
            jst = jren._render_pass_impl(js, jc, cfg, jst, 4, 8, 0.0)
            tst = tren.render_pass(None, None, cfg, tst, 4, 8)
        want_img = np.asarray(jren.display_image(jst, cfg))
    assert tst.passes == 2
    np.testing.assert_array_equal(tst.accum.numpy(), np.asarray(jst.accum))
    np.testing.assert_allclose(tren.display_image(tst, cfg).numpy(), want_img, rtol=0,
                               atol=1e-5)
    static = cfg.replace(render_mode=RenderMode.STATIC)
    assert not np.allclose(tren.display_image(tst, static).numpy(), want_img, atol=1e-3)


def test_animated_sample_radiance_matches_jax():
    """An ANIMATED `sample_radiance` pass with ReSTIR off (per-light NEE; the
    plain integrator here, K1 on the card) at 8x32 and time_s = 0.9 against
    JAX's under the parity contract (tests/test_megakernel.py:94)."""
    js, jc = jax_realtime_scene()
    cfg = restir_cfg(use_restir=False)
    with jax.disable_jit():
        want = np.asarray(jren.sample_radiance(js, cfg, jc, H, W, 1, jnp.float32(0.9)))
    got = tren.sample_radiance(port_scene(js), cfg, port_camera(jc), H, W, 1, 0.9).numpy()
    err = np.abs(got - want).max(axis=-1)
    print(f"max |Δ| {err.max():.3e}, {int((err > 0).sum())} pixels differ")
    assert (err < 1e-5).mean() >= 0.99 and np.median(err) < 1e-4
    assert want.max() > 0.01


@pytest.fixture(scope="module")
def animated_passes():
    return jax_restir_passes(restir_cfg())


@pytest.mark.parametrize("p", range(4))
def test_render_sample_animated_matches_jax(animated_passes, p):
    """The plain render_sample under ANIMATED accumulation against JAX's,
    pass p of 4 at the moving frame time p/30, on the JAX ring of that pass
    (temporal reuse is live from pass 3)."""
    state, ref_rad, ref_new = animated_passes[p]
    js, jc = jax_realtime_scene()
    rad, new = trestir.render_sample(port_scene(js), restir_cfg(), port_camera(jc),
                                     port_ring(state, H, W), H, W, p, p / 30)
    pass_contract(rad.numpy(), {k: v.numpy() for k, v in new.fields().items()},
                  ref_rad, ref_new)
    assert (ref_new["light_index"] >= 0).mean() > 0.5
    if p == 3:
        assert ref_new["m"].max() > 4.0   # temporal reuse has merged


def test_animated_gates():
    """ANIMATED is inside the port's class on both devices: the integrator,
    K1 and K2 (the scene is animated on the host before the table is
    built), K6, K7 and K4 admit the real-time scene; `animated_restir`
    itself, with MAT_METAL's METAL texture on its SDF mesh, renders under
    ReSTIR on both devices, and K7 differentiates it in its whole-SDF copy
    (`test_animated_restir_refused`)."""
    from raytracer0_tpu_torch.ops import megakernel as tmk

    scene, cam, cfg = tpresets.animated_untextured(device="cpu")
    assert tint.unsupported(scene, cfg) is None
    assert tmk.unsupported(scene, cfg.replace(use_restir=False)) is None
    cornell, _, ccfg = tpresets.cornell_default(device="cpu")
    assert tmk.unsupported_bwd(cornell, ccfg.replace(render_mode=RenderMode.ANIMATED)) is None
    assert tk6.unsupported_restir(scene, cfg) is None
    assert tk6.unsupported_restir_bwd(scene, cfg) is None
    assert tsplit.unsupported_gbuffer(scene, cfg.replace(restir_adhoc_motion=True)) is None


def test_animated_restir_refused():
    """The preset ported exactly: 18 rows, 9 sphere lights, a ROUND_BOX of
    MAT_METAL.  Under ReSTIR the port renders it on the CPU and admits it
    on CUDA to K4 and K6v's whole-SDF copies, with and without the ad-hoc
    reprojection; K7 admits a gradient through it in its whole-SDF copy
    and refuses one w.r.t. a texel array (its noise LUT) before any launch,
    naming item 14.  Without ReSTIR it renders, through K1's whole-SDF copy
    on CUDA and the plain version on the CPU."""
    scene, cam, cfg = tpresets.animated_restir(device="cpu")
    js, jc, jcfg = jpresets.animated_restir()
    assert scene.num_meshes == 18 and scene.num_lights == 9
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in cfg.__dataclass_fields__}
    for k in ("pos", "joker", "color", "emission", "tex_type"):
        np.testing.assert_array_equal(getattr(scene, k).numpy(), np.asarray(getattr(js, k)))
    assert tren._route("cuda", scene, cfg.replace(use_restir=False)) == "kernel"
    from raytracer0_tpu_torch.ops import megakernel as tmk

    assert tmk.whole_sdf(scene)
    out = tren.sample_radiance(scene, cfg.replace(use_restir=False, max_bounces=2), cam, 4, 8,
                               0, 0.5)
    assert out.shape == (4, 8, 3) and bool(torch.isfinite(out).all())
    small = cfg.replace(max_bounces=2, marching_steps=16)
    for c in (small, small.replace(restir_adhoc_motion=True)):
        img = tren.Renderer(scene, cam, c, 4, 8).render(1, 0.5)
        assert img.shape == (4, 8, 3) and bool(torch.isfinite(img).all())
    assert tk6.unsupported_restir(scene, cfg) is None
    assert tsplit.unsupported_gbuffer(scene, cfg.replace(restir_adhoc_motion=True)) is None
    assert tsplit.gbuffer_copy(scene) == 3
    assert tk6.unsupported_restir_bwd(scene, cfg) is None and tk6.bwd_copy(scene) == "whole_sdf"
    noise = scene.noise.clone().requires_grad_(True)
    ro, rd = generate_rays(cam, 4, 8, 0)
    ring = RenderState.create(4, 8, "cpu")
    before = (tk6.LAUNCHES, tk6.BWD_LAUNCHES)
    with pytest.raises(NotImplementedError, match="K7.*noise.*item 14"):
        tk6._fused(scene.replace(noise=noise), cfg, ro, rd, trng.pixel_ids(4, 8), 0, 0,
                   ring.restir_back, ring.restir_hist1, ring.restir_hist2)
    assert (tk6.LAUNCHES, tk6.BWD_LAUNCHES) == before
