"""The whole SDF class against the JAX package, and the gates that keep it
off the kernels that do not model it.

The gates come first.  K1, its adjoint K2 and the plain version render
and differentiate every SDF shape, textures on SDF meshes and SDF-bound
lights; under ReSTIR K4, K6, K6v, the split path and the plain version
render every shape and textured SDF rows (K4's and K6v's whole-SDF
copies) and refuse SDF lights as the JAX `supported_restir` does (item
11); K5 serves BOX and ROUND_BOX rows, untextured and unlit, and K7
untextured ROUND_BOX rows, each refusing the rest before any launch,
naming ROADMAP queue 1 item 8 (`integrator.outside_box_sdf`,
`restir_kernel.outside_k7_class`).

Then the plain version against `raytracer0_tpu`, on seeded numpy inputs:
each of the 14 distances at a few hundred points within 1e-5, the scene
map, the 4-tap normal and the set of entries without a bounding sphere on
the scene that holds every shape the presets do not
(tests/test_torch_sdf_scenes.py), the uniform sphere direction and the
SDF light's pdf, and the plain integrator against JAX's
`integrator.trace` run op by op (`jax.disable_jit`, as
tests/test_torch_sdf.py explains) at 8x16 with 2 bounces on
`default_scene`, the SDF-light scene with and without MIS, the every-shape
scene, `menger_sponge` and `mandelbulb`.  The parity contract holds where
nothing flips (max error below 1e-4, at least 99 % of the pixels within
1e-5); the fractals, whose silhouettes flip between hit and miss under an
ULP, are held as the JAX package holds its own kernel on them
(`test_procedural_cubemap_presets_interpret`,
tests/test_megakernel.py:357-385): at least 97 % of the pixels within 1e-4
and the means within 2 %.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu import rng as jrng
from raytracer0_tpu.config import OFFLINE_CONFIG as J_OFFLINE
from raytracer0_tpu.models import camera as jcam
from raytracer0_tpu.models import materials as jmat
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.models.scene import SceneBuilder as JBuilder
from raytracer0_tpu.ops import lighting as jlighting
from raytracer0_tpu.ops import sampling as jsampling
from raytracer0_tpu.ops import sdf as jsdf
from raytracer0_tpu.render import integrator as jint
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models.camera import Camera
from raytracer0_tpu_torch.models.materials import SdfShape
from raytracer0_tpu_torch.ops import lighting as tlighting
from raytracer0_tpu_torch.ops import megakernel as tmk
from raytracer0_tpu_torch.ops import sampling as tsampling
from raytracer0_tpu_torch.ops import sdf as tsdf
from raytracer0_tpu_torch.render import integrator as tint
from raytracer0_tpu_torch.render.renderer import Renderer

from test_torch_sdf_scenes import GATES, NEW_CLASSES, expected_verdict, gate_reason, new_class_case

SCENE_VIEWS = tpresets.SDF_SCENE_VIEWS

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

T = torch.from_numpy
PARITY_TOL, PARITY_FRAC, MAX_TOL = 1e-5, 0.99, 1e-4
FRACTAL_TOL, FRACTAL_FRAC, FRACTAL_MEAN = 1e-4, 0.97, 0.02
FRACTALS = ("menger_sponge", "mandelbulb")


# ---------------------------------------------------------------- the gates

@pytest.mark.parametrize("where", NEW_CLASSES)
@pytest.mark.parametrize("gate", GATES)
def test_gates_refuse_the_new_classes(gate, where):
    """K5's gate refuses a Mandelbulb, a textured BOX SDF and an SDF
    light, naming item 8; the ReSTIR gates (K4, K6, the split path, K7,
    the plain class) admit the Mandelbulb and refuse the other two for
    what ReSTIR itself lacks there, naming item 11 (`expected_verdict`)."""
    scene, cam, cfg = new_class_case(where, "cpu")
    reason = gate_reason(gate, scene, cam, cfg)
    want = expected_verdict(gate, where)
    assert (reason is None) if want is None else (reason is not None and want in reason), reason


@pytest.mark.parametrize("where", NEW_CLASSES)
def test_k2_admits_the_new_classes(where):
    """K2 admits a Mandelbulb, a textured BOX SDF and an SDF light in its
    whole-SDF copy (K1's whole class), and still refuses a gradient through
    them w.r.t. a texel array (item 14) or under ReSTIR (K7's)."""
    scene, _, cfg = new_class_case(where, "cpu")
    assert tmk.unsupported_bwd(scene, cfg) is None
    assert tmk.bwd_copy(scene, cfg) == "whole_sdf" and not tmk.cornell_copy(scene, cfg)
    noise = scene.noise.clone().requires_grad_(True)
    assert "item 14" in tmk.unsupported_bwd(scene.replace(noise=noise), cfg)
    assert "K7" in tmk.unsupported_bwd(scene, cfg.replace(use_restir=True))


@pytest.mark.parametrize("where", NEW_CLASSES)
def test_k1_admits_the_new_classes(where):
    """K1 admits the three classes in its whole-SDF copy; the scenes of
    BOX and ROUND_BOX rows stay on the copies they ran before."""
    scene, _, cfg = new_class_case(where, "cpu")
    assert tmk.unsupported(scene, cfg) is None and tint.unsupported(scene, cfg) is None
    assert tmk.whole_sdf(scene) and tmk.tex_flags(scene) & 4
    for name in ("mis_demo", "restir_demo", "animated_untextured"):
        assert not tmk.whole_sdf(getattr(tpresets, name)(device="cpu")[0])


# ---------------------------------------------------------------- distances

@pytest.mark.parametrize("shape", [s.name for s in SdfShape])
def test_distance_matches_jax(shape):
    """Each distance of `_entry_distance` at 300 seeded points about its
    row (half of them near the surface), within 1e-5 of the JAX
    package's."""
    shape = int(SdfShape[shape])
    ts = tpresets.one_row_scene(shape, device="cpu")
    js = tpresets.one_row_scene(shape, device=None, builder=JBuilder)
    pos, joker, _ = (np.asarray(v, np.float32) for v in tpresets.shape_rows()[shape])
    center = (pos + joker[:3]) / 2 if shape == SdfShape.CAPSULE else pos
    r = np.random.default_rng(shape)
    p = (center + np.concatenate([r.uniform(-1.2, 1.2, (150, 3)),
                                  r.uniform(-0.35, 0.35, (150, 3))])).astype(np.float32)
    td, ti = tsdf.scene_map(ts, T(p))
    jd, ji = jsdf.scene_map(js, jnp.asarray(p))
    assert bool(torch.isfinite(td).all())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    assert (np.asarray(jd) < 0.05).any() and (np.asarray(jd) > 0.05).any()


def test_scene_map_normal_and_bounds_match_jax():
    """The every-shape scene: the scene map (distance and ordinal) and the
    4-tap normal at seeded points, and the entries without a bounding
    sphere (whose presence turns the march's gate off) with the radii of
    the others."""
    ts = tpresets.every_shape_scene(device="cpu")
    js = tpresets.every_shape_scene(device=None, builder=JBuilder, m=jmat)
    p = np.random.default_rng(7).uniform([-1.8, -1.6, -2.4], [1.8, 1.4, -0.6],
                                         (400, 3)).astype(np.float32)
    td, ti = tsdf.scene_map(ts, T(p))
    jd, ji = jsdf.scene_map(js, jnp.asarray(p))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    out = np.asarray(jd) > 0.01
    np.testing.assert_allclose(tsdf.calc_normal(ts, T(p[out]), 1e-3).numpy(),
                               np.asarray(jsdf.calc_normal(js, p[out], 1e-3)),
                               rtol=0, atol=1e-4)
    t_r = [tsdf.bound_radius(ts, k) for k in range(ts.num_sdfs)]
    j_r = [jsdf._bound_radius(js, k) for k in range(js.num_sdfs)]
    assert [r is None for r in t_r] == [r is None for r in j_r]
    assert {SdfShape(ts.sdf_shapes_static[k]).name for k, r in enumerate(t_r) if r is None} == {
        "TRI_PRISM", "CONE", "CAPSULE", "SEA_BOX", "SIGGRAPH", "TRIANGLE", "QUAD"}
    for a, b in zip(t_r, j_r):
        if a is not None:
            assert a.item() == float(np.asarray(b))


def test_sdf_light_sampling_matches_jax():
    """The uniform sphere direction of the NEE_SDF_POINT draw and an SDF
    light slot's MIS pdf (1/4π), against the JAX package's."""
    u = np.random.default_rng(3).random((2, 256)).astype(np.float32)
    np.testing.assert_allclose(tsampling.random_sphere_direction(T(u[0]), T(u[1])).numpy(),
                               np.asarray(jsampling.random_sphere_direction(u[0], u[1])),
                               rtol=0, atol=1e-6)
    make = SCENE_VIEWS["sdf_light"][0]
    ts, js = make(device="cpu"), make(device=None, builder=JBuilder, m=jmat)
    x = np.random.default_rng(4).uniform(-1.0, 1.0, (64, 3)).astype(np.float32)
    assert tlighting.slot_kind(ts, 0) == "sdf"
    np.testing.assert_array_equal(tlighting.light_pdf_slot(ts, 0, T(x)).numpy(),
                                  np.asarray(jlighting.light_pdf_slot(js, 0, x, J_OFFLINE)))


# ---------------------------------------------------------------- integrator

CASES = {                      # name: (scene view or preset, use_mis, marching steps)
    "default_scene": ("default_scene", False, 32),
    "sdf_light": ("sdf_light", False, 32),
    "sdf_light_mis": ("sdf_light", True, 32),
    "every_shape": ("every_shape", False, 16),
    "menger_sponge": ("menger_sponge", False, 32),
    "mandelbulb": ("mandelbulb", False, 32),
}


def _case(where, mis, steps):
    """(JAX scene, port scene, JAX camera, config) of a case."""
    if where in SCENE_VIEWS:
        make, (origin, lookat, fov), kw = SCENE_VIEWS[where]
        js, ts = make(device=None, builder=JBuilder, m=jmat), make(device="cpu")
        jc, cfg = jcam.Camera.make(origin=origin, lookat=lookat, fov=fov), J_OFFLINE.replace(**kw)
    else:
        js, jc, cfg = getattr(jpresets, where)()
        ts = getattr(tpresets, where)(device="cpu")[0]
    # remat_bounces only steers JAX's autodiff memory (tests/test_torch_sdf.py)
    return js, ts, jc, cfg.replace(max_bounces=2, marching_steps=steps, use_mis=mis,
                                   remat_bounces=False)


@pytest.fixture(scope="module")
def traces():
    """{case: (port image, JAX image op by op)} at 8x16."""
    h, w = 8, 16
    out = {}
    for name, args in CASES.items():
        js, ts, jc, cfg = _case(*args)
        ro, rd = (np.asarray(a) for a in jcam.generate_rays(jc, h, w, 0))
        with jax.disable_jit():
            ref = np.asarray(jint.trace(js, cfg, ro, rd, jrng.pixel_ids(h, w), 0, 0,
                                        sdf_march=jsdf.march))
        port = tint.trace(ts, cfg, T(ro.copy()), T(rd.copy()), trng.pixel_ids(h, w), 0, 0)
        out[name] = (port.numpy(), ref)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_plain_integrator_matches_jax(traces, name):
    """The plain integrator with the whole SDF class against JAX's
    integrator.trace op by op: the parity contract, the fractals as the
    JAX package holds them."""
    port, ref = traces[name]
    assert port.shape == (8, 16, 3) and np.isfinite(port).all() and ref.max() > 0.02
    err = np.abs(port - ref).max(axis=-1)
    print(f"{name}: {int((err > PARITY_TOL).sum())} pixels beyond {PARITY_TOL}, max {err.max():.3e}")
    if name in FRACTALS:
        assert (err < FRACTAL_TOL).mean() >= FRACTAL_FRAC
        assert abs(port.mean() - ref.mean()) <= FRACTAL_MEAN * ref.mean()
    else:
        assert err.max() < MAX_TOL and (err < PARITY_TOL).mean() >= PARITY_FRAC


@pytest.mark.parametrize("name", ["default_scene", "mandelbulb", "menger_sponge"])
def test_renderer_renders_the_presets(name):
    """The three presets through the port's Renderer on the CPU (the
    plain version): a finite image of the right shape that is not black."""
    scene, cam, cfg = getattr(tpresets, name)(device="cpu")
    r = Renderer(scene, cam, cfg.replace(max_bounces=2, marching_steps=32), 6, 8)
    img = r.render(1)
    assert img.shape == (6, 8, 3) and bool(torch.isfinite(img).all()) and img.mean() > 0.01
