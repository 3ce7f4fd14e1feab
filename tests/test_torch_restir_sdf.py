"""ReSTIR over the whole SDF class and blended textures against the JAX
package, on the same inputs, and K7's gate over that class.

* the plain `restir.render_sample` against JAX's on the reference's preset 7
  as shipped (`animated_restir`: a METAL texture blended into its rounded
  box), STATIC and ANIMATED at t = 0.37 and t = 2.75, at pass 3 on the
  ring of 3 passes;
* the same on the `mandelbulb`, `every_shape` and `polygons` ReSTIR views
  (`presets.restir_sdf_view`) and `textured_cornell` with ReSTIR and MIS
  off, at pass 1 on the ring the port's pass 0 leaves, which both packages
  read;
* the split route on the CPU (`restir_split.render_sample_fast`: the plain
  G-buffer and caster, the reservoir phases per slot) and the plain
  `render_sample` with the ad-hoc reprojection against JAX's route on the
  preset as shipped;
* the plain gradient of a ReSTIR pass of the preset w.r.t. emission
  against `jax.grad` at tests/test_restir.py:151-175's sizes;
* fault 15's rule: K7's gate admits each class K6 admits now that its
  whole-SDF copy is held, and refuses what it still does not cover (texel
  arrays, a cubemap, more than 32 candidates, SDF lights) before any
  launch.

The contract is the parity contract of tests/test_megakernel.py:79-94
(max error below 1e-4, at least 99 % of pixels within 1e-5) on the
radiance, the light indices agreeing at 99.5 % and the other reservoir
fields within 1e-4 (plus 1e-4 of their size) where they do.  The
Mandelbulb's silhouettes flip between hit and miss under an ULP (ROADMAP,
Hazards), so `mandelbulb` is held as the JAX package holds its own kernel
on the fractals (tests/test_megakernel.py:357-385): at least 97 % of the
pixels within 1e-4, and the means and standard deviations within 2 %.  No scene of this file has
GRADIENT_NOISE.  JAX runs op by op (`jax.disable_jit`): compiled XLA
contracts FMAs (tests/test_torch_restir.py).  Sizes follow the JAX
package's own test of the preset (2 bounces, 16 marching steps, 4
candidates; one bounce on `every_shape`, `polygons` and `textured_cornell`,
whose op-by-op JAX passes are the slowest), all at 16x32, so the
primitives JAX compiles op by op for one test serve the next.  JAX computes one pass per test, on a ring the
port's plain passes fill, which both packages then read.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu.config import OFFLINE_CONFIG as J_OFFLINE
from raytracer0_tpu.models import camera as jcam
from raytracer0_tpu.models import materials as jmat
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.models.scene import SceneBuilder as JBuilder
from raytracer0_tpu.ops import restir as jrestir
from raytracer0_tpu.render.state import RenderState as JState
from raytracer0_tpu.render.state import Reservoirs as JReservoirs
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.config import RenderMode
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models import scene as tscene
from raytracer0_tpu_torch.models.camera import generate_rays
from raytracer0_tpu_torch.ops import intersect as tisect
from raytracer0_tpu_torch.ops import restir as trestir
from raytracer0_tpu_torch.ops import restir_kernel as tk6
from raytracer0_tpu_torch.ops import restir_split as tsplit
from raytracer0_tpu_torch.render import integrator as tint
from raytracer0_tpu_torch.render.state import RenderState

from test_torch_animated import FIELDS, port_camera, port_ring, port_scene

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PARITY_TOL, PARITY_FRAC, MAX_TOL = 1e-5, 0.99, 1e-4
FRACTAL_TOL, FRACTAL_FRAC, FRACTAL_MEAN = 1e-4, 0.97, 0.02
H, W = 16, 32
METAL_BOX = 17   # the preset's rounded box, the METAL-textured SDF row


def small(cfg, **kw):
    """A config at the sizes of tests/test_restir.py:151-175 (remat_bounces
    only steers JAX's autodiff memory; off, its op-by-op run compiles each
    op once)."""
    return cfg.replace(**dict(dict(max_bounces=2, restir_samples=4, marching_steps=16,
                                   remat_bounces=False), **kw))


def contract(rad, new, ref_rad, ref_new, fractal=False):
    """The module's contract on a pass's radiance and new reservoirs."""
    err = np.abs(rad - ref_rad).max(axis=-1)
    agree = new["light_index"] == ref_new["light_index"]
    print(f"max |Δ| {err.max():.3e}, {int((err > PARITY_TOL).sum())} pixels beyond "
          f"{PARITY_TOL}, light index agrees at {agree.mean():.4f}")
    assert np.isfinite(rad).all() and ref_rad.max() > 0.0
    if fractal:
        assert (err < FRACTAL_TOL).mean() >= FRACTAL_FRAC
        assert abs(rad.mean() - ref_rad.mean()) <= FRACTAL_MEAN * ref_rad.mean()
        assert abs(rad.std() - ref_rad.std()) <= FRACTAL_MEAN * ref_rad.std()
    else:
        assert err.max() < MAX_TOL and (err < PARITY_TOL).mean() >= PARITY_FRAC
    assert agree.mean() >= 0.995
    for k in FIELDS:
        if k == "light_index":
            continue
        a, b = new[k][agree], ref_new[k][agree]
        if fractal:   # a spatial tap's flipped decision moves a neighbour's sums
            close = np.abs(a - b) <= 1e-4 + 1e-4 * np.abs(b)
            assert close.mean() >= FRACTAL_FRAC, k
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=k)


def as_numpy(res):
    return {k: np.asarray(getattr(res, k)) for k in FIELDS}


def jax_ring(state):
    """The port's RenderState's ring as a JAX RenderState."""
    conv = lambda g: JReservoirs(**{k: jnp.asarray(getattr(g, k).numpy()) for k in FIELDS})
    h, w = state.restir_back.m.shape
    return JState.create(h, w).replace(restir_back=conv(state.restir_back),
                                       restir_hist1=conv(state.restir_hist1),
                                       restir_hist2=conv(state.restir_hist2))


MODES = {"static": (RenderMode.STATIC, 0.0), "t0.37": (RenderMode.ANIMATED, 0.37),
         "t2.75": (RenderMode.ANIMATED, 2.75)}


def port_passes(scene, cfg, cam, passes, t=lambda p: 0.0, h=H, w=W):
    """The ring the port's plain `render_sample` leaves after `passes`
    passes from an empty one, pass p at the frame time t(p)."""
    state = RenderState.create(h, w, "cpu")
    for p in range(passes):
        state = state.rotate_reservoirs(
            trestir.render_sample(scene, cfg, cam, state, h, w, p, t(p))[1])
    return state


def held_pass(js, jc, cfg, state, p, t, fractal=False, h=H, w=W):
    """Pass p at the frame time t of the plain `render_sample` against
    JAX's, both reading the port's ring `state`; returns the port's pass."""
    scene, cam = port_scene(js), port_camera(jc)
    with jax.disable_jit():
        ref, nb = jrestir.render_sample(js, cfg, jc, jax_ring(state), h, w, p, jnp.float32(t))
    rad, new = trestir.render_sample(scene, cfg, cam, state, h, w, p, t)
    contract(rad.numpy(), {k: v.numpy() for k, v in new.fields().items()},
             np.asarray(ref), as_numpy(nb), fractal=fractal)
    assert (np.asarray(nb.light_index) >= 0).mean() > 0.5
    return rad, new, nb


def _view(name):
    """(JAX scene, JAX camera, config) of a ReSTIR view of the whole SDF
    class, or of `textured_cornell` with ReSTIR, built by JAX's builder."""
    if name in tpresets.SDF_SCENE_VIEWS:
        make, (origin, lookat, fov), kw = tpresets.SDF_SCENE_VIEWS[name]
        js, jc = make(device=None, builder=JBuilder, m=jmat), jcam.Camera.make(
            origin=origin, lookat=lookat, fov=fov)
        cfg = J_OFFLINE.replace(**kw)
    else:
        js, jc, cfg = getattr(jpresets, name)()
    return js, jc, cfg.replace(use_restir=True, use_mis=False)


#: bounces of each view's comparison: one where JAX's op-by-op pass would
#: take past 20 s with two (the primary hit's reservoir vertex, with its
#: shadow rays' marches, runs either way)
VIEWS = {"textured_cornell": 1, "polygons": 1, "mandelbulb": 2, "every_shape": 1}


@pytest.mark.parametrize("name", list(VIEWS))
def test_restir_sdf_views_match_jax(name):
    """The plain `render_sample` against JAX's on `textured_cornell` with
    ReSTIR and MIS off and on the `polygons`, `mandelbulb` and
    `every_shape` ReSTIR views (each the port's `restir_sdf_view`): pass 1
    (candidates, spatial reuse, the shadow rays' marches over every
    shape) on the ring the port's pass 0 leaves; the Mandelbulb under the
    fractals' contract (module docstring)."""
    js, jc, jcfg = _view(name)
    cfg = small(jcfg, max_bounces=VIEWS[name])
    scene, cam = port_scene(js), port_camera(jc)
    if name in tpresets.RESTIR_SDF_VIEWS:
        ts = tpresets.restir_sdf_view(name, device="cpu")[0]
        assert all(torch.equal(getattr(ts, k), getattr(scene, k)) for k in ("pos", "joker", "aux"))
    assert tk6.unsupported_restir(scene, cfg) is None
    assert tsplit.gbuffer_copy(scene) == (0 if name == "textured_cornell" else 3)
    held_pass(js, jc, cfg, port_passes(scene, cfg, cam, 1), 1, 0.0,
              fractal=name == "mandelbulb")


@pytest.mark.parametrize("mode", list(MODES))
def test_animated_restir_matches_jax(mode):
    """`animated_restir` as shipped at 16x32, STATIC or ANIMATED at a
    constant frame time: pass 3 of the plain `render_sample` against JAX's
    on the 3-pass ring the port's passes 0-2 leave (back, hist1 and hist2
    filled, so candidates, temporal and spatial reuse all run); primary
    rays hit the METAL box, so its texel is held too."""
    render_mode, t = MODES[mode]
    js, jc, jcfg = jpresets.animated_restir()
    cfg = small(jcfg, render_mode=render_mode)
    scene, cam = port_scene(js), port_camera(jc)
    assert tk6.unsupported_restir(scene, cfg) is None and tint.unsupported(scene, cfg) is None
    ro, rd = generate_rays(cam, H, W, 3)
    frame = tscene.animate_positions(scene, t, int(render_mode))
    assert int((tisect.intersect(frame, ro, rd, cfg).idx == METAL_BOX).sum()) > 0
    _, _, nb = held_pass(js, jc, cfg, port_passes(scene, cfg, cam, 3, lambda p: t), 3, t)
    assert np.asarray(nb.m).max() > 4.0   # temporal reuse has merged


def test_split_route_matches_jax():
    """The preset as shipped with the ad-hoc reprojection, ANIMATED, pass 3
    at the frame time 0.1 (temporal reuse, and so the reprojection, is live
    from pass 3) on the ring the port's plain passes 0-2 leave at the
    times p/30: the plain `render_sample` against JAX's under the module's
    contract, and the split route on the CPU (`render_sample_fast`: the
    plain G-buffer and caster) under JAX's fast-versus-wavefront contract
    (max 5e-3, median 1e-6, tests/test_restir.py:284-310), its reservoirs
    the plain `render_sample`'s bit for bit."""
    js, jc, jcfg = jpresets.animated_restir()
    cfg = small(jcfg, restir_adhoc_motion=True)
    scene, cam = port_scene(js), port_camera(jc)
    assert tsplit.unsupported_gbuffer(scene, cfg) is None
    state = port_passes(scene, cfg, cam, 3, lambda p: p / 30)
    rad, new, nb = held_pass(js, jc, cfg, state, 3, 0.1)
    fast, fast_new = tsplit.render_sample_fast(scene, cfg, cam, state, H, W, 3, 0.1)
    err = (fast - rad).abs()
    assert err.max().item() < 5e-3 and err.median().item() < 1e-6, err.max().item()
    for k, v in fast_new.fields().items():
        assert torch.equal(v, getattr(new, k)), k
    assert np.asarray(nb.m).max() > 4.0   # temporal reuse has merged


def test_restir_gradient_matches_jax():
    """d sum(pass 3) / d emission of the preset as shipped (2 bounces, 4
    candidates, 16 marching steps, as tests/test_restir.py:151-175 takes
    it, at 16x32) on a ring warmed by passes 0-1 (the port's; both
    packages read it): the plain autograd finite, nonzero and within 1e-4
    relative of `jax.grad` run op by op."""
    js, jc, jcfg = jpresets.animated_restir()
    cfg = small(jcfg)
    scene, cam = port_scene(js), port_camera(jc)
    state = port_passes(scene, cfg, cam, 2)
    ring = jax_ring(state)

    def loss(emission):
        rad, _ = jrestir.render_sample(js.replace(emission=emission), cfg, jc, ring, H, W,
                                       jnp.uint32(3))
        return jnp.sum(rad)

    with jax.disable_jit():
        want = np.asarray(jax.grad(loss)(js.emission))
    em = scene.emission.clone().requires_grad_(True)
    rad, _ = trestir.render_sample(scene.replace(emission=em), cfg, cam, state, H, W, 3)
    got = torch.autograd.grad(rad.sum(), em)[0].numpy()
    print(f"relative error {np.abs(got - want).max() / np.abs(want).max():.3e}")
    assert np.isfinite(got).all() and (got != 0).any()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _k7_case(name):
    if name == "animated_restir":
        return tpresets.animated_restir(device="cpu")
    if name == "textured_cornell":
        return tpresets.textured_cornell(device="cpu", use_restir=True, use_mis=False)
    if name == "textured_restir_demo":
        return tpresets.textured_restir_demo(device="cpu")
    return tpresets.restir_sdf_view(name, device="cpu")


@pytest.mark.parametrize("name", ["animated_restir", "mandelbulb", "every_shape", "polygons",
                                  "textured_cornell", "textured_restir_demo"])
def test_k7_gate_after_fault_15(name):
    """Fault 15's rule, the gate widened last: K6's gate, K4's, the split
    path's and the plain class admit each class slice 15 added (every SDF
    shape, textured SDF rows, textures blended into any row), and K7's
    admits it too now that its whole-SDF copy is held
    (tests/test_torch_kernel_host_restir_sdf.py, the card).  What K7 still
    refuses, it refuses before any launch, naming a ROADMAP item: a
    gradient w.r.t. a texel array (item 14), a cubemap under ReSTIR (K6's
    gate, item 11) and an SDF-bound light slot (item 11); more than 32
    candidates, which these scenes' few lights cannot reach, are held on
    the card (tests/test_torch_cuda.py)."""
    scene, cam, cfg = _k7_case(name)
    assert tk6.unsupported_restir(scene, cfg) is None
    assert tsplit.unsupported_gbuffer(scene, cfg) is None and tint.unsupported(scene, cfg) is None
    tsplit.check_split(scene, cfg.replace(restir_adhoc_motion=True), cam,
                       RenderState.create(4, 4, "cpu"))
    assert tk6.outside_k7_class(scene) is None and tk6.unsupported_restir_bwd(scene, cfg) is None
    assert tk6.bwd_copy(scene) == "whole_sdf"
    lit = scene.replace(lights_static=(scene.num_analytic,) + scene.lights_static[1:])
    refused = {
        "images": (scene.replace(images=scene.images.clone().requires_grad_(True)), cfg,
                   "images.*item 14"),
        "noise": (scene.replace(noise=scene.noise.clone().requires_grad_(True)), cfg,
                  "noise.*item 14"),
        "cubemap": (scene, cfg.replace(use_cubemap=True, use_procedural_sky=False),
                    "cubemap.*item 11"),
    }
    if scene.num_sdfs:   # the first light slot on the first SDF row
        refused["SDF light"] = (lit, cfg, "light slots.*item 11")
        assert "SDF-bound light slots" in tk6.outside_k7_class(lit)
        assert tk6.unsupported_restir_bwd(lit, cfg) == tk6.outside_k7_class(lit)
    em = scene.emission.clone().requires_grad_(True)
    ro, rd = generate_rays(cam, 4, 8, 0)
    ring = RenderState.create(4, 8, "cpu")
    before = (tk6.LAUNCHES, tk6.BWD_LAUNCHES, tsplit.GBUF_LAUNCHES)
    for what, (s, c, words) in refused.items():
        with pytest.raises(NotImplementedError, match="K[67] does not cover.*" + words):
            tk6._fused(s.replace(emission=em), c, ro, rd, trng.pixel_ids(4, 8), 0, 0,
                       ring.restir_back, ring.restir_hist1, ring.restir_hist2)
    assert (tk6.LAUNCHES, tk6.BWD_LAUNCHES, tsplit.GBUF_LAUNCHES) == before
