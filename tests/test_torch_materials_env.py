"""The port's full surface-material set, directional lights and cubemaps
against the JAX package, on seeded numpy inputs.

Function by function (`bsdf.sample`, `sky.sample_cubemap`, directional-
light NEE) the port agrees with JAX to 1e-6 and makes the same discrete
decisions.  The plain integrator (the plain version of K1) meets the
parity contract against JAX `integrator.trace` and against the Pallas env
kernel K9 (`trace_forward_env`, in interpret mode): at least 99 % of
pixels within 1e-5 (max over RGB) and a median below 1e-4 (see
tests/test_torch_integrator.py for why the max is not bounded).
"""

import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer0_tpu import rng as jrng
from raytracer0_tpu.models import camera as jcam
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.models.dsl import parse_scene as jparse
from raytracer0_tpu.models.scene import SceneBuilder as JBuilder
from raytracer0_tpu.ops import bsdf as jbsdf
from raytracer0_tpu.ops import lighting as jlighting
from raytracer0_tpu.ops import megakernel as jmk
from raytracer0_tpu.ops import sky as jsky
from raytracer0_tpu.render import integrator as jint
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.config import RenderConfig
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models.dsl import parse_scene as tparse
from raytracer0_tpu_torch.models.materials import MatType, MeshType
from raytracer0_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracer0_tpu_torch.ops import bsdf as tbsdf
from raytracer0_tpu_torch.ops import lighting as tlighting
from raytracer0_tpu_torch.ops import megakernel as tmk
from raytracer0_tpu_torch.ops import sky as tsky
from raytracer0_tpu_torch.render import integrator as tint

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PARITY_TOL, PARITY_FRAC, MEDIAN_TOL = 1e-5, 0.99, 1e-4

# tests/test_golden_cornell.py:66-79: REFR_SCHLICK, a mirror and COAT
# under MIS in a closed box (config 2)
CONFIG2 = """
    MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, -1.0, 0.0), vec4(2.0)
    MAT_GREEN, PLANE, vec3(1.0, 0.0, 0.0), vec4(2.0)
    MAT_RED, PLANE, vec3(-1.0, 0.0, 0.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, 0.0, -1.0), vec4(2.0)
    MAT_LIGHT_4, SPHERE, vec3(0.0, 1.5, -1.0), vec4(0.3)
    MAT_REFR_CLEAR_2, SPHERE, vec3(-0.5, -0.6, 0.0), vec4(0.4)
    MAT_MIRROR, SPHERE, vec3(0.6, -0.6, -0.5), vec4(0.4)
    MAT_COAT_PURPLE, SPHERE, vec3(0.0, -1.4, 0.8), vec4(0.35)
"""

# one mesh of each material type, in MatType order
ALL_MATS = """
    MAT_LIGHT_4, SPHERE, vec3(0.0, 0.0, 0.0), vec4(1.0)
    MAT_DIRECT_SUNLIGHT, SPHERE, vec3(0.0, 0.0, 0.0), vec4(1.0)
    MAT_WHITE, SPHERE, vec3(0.0, 0.0, 0.0), vec4(1.0)
    MAT_MIRROR, SPHERE, vec3(0.0, 0.0, 0.0), vec4(1.0)
    MAT_REFR_CLEAR, SPHERE, vec3(0.0, 0.0, 0.0), vec4(1.0)
    MAT_REFR_CLEAR_2, SPHERE, vec3(0.0, 0.0, 0.0), vec4(1.0)
    MAT_COAT_NAVY, SPHERE, vec3(0.0, 0.0, 0.0), vec4(1.0)
"""


def assert_parity(out, ref):
    err = np.abs(out - ref).max(axis=-1)
    assert (err < PARITY_TOL).mean() >= PARITY_FRAC, \
        f"share within {PARITY_TOL}: {(err < PARITY_TOL).mean()}, max {err.max()}"
    assert np.median(err) < MEDIAN_TOL


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def dir_scene(builder, device=None, extra_sphere_light=False):
    """tests/test_megakernel.py:685-698: finite geometry under a
    directional sun whose mesh.pos is the direction; optionally a sphere
    light in a second slot."""
    sb = builder()
    sb.add("MAT_CORNELL_WHITE", MeshType.BOX, (0.0, -2.2, -1.0), (2.0,))
    sb.add("MAT_CORNELL_RED", MeshType.BOX, (-0.8, -0.8, -1.4), (0.8,))
    sb.add("MAT_MIRROR", MeshType.SPHERE, (0.6, -0.7, -1.0), (0.5,))
    sb.add("MAT_DIRECT_SUNLIGHT", MeshType.SPHERE, (0.5, 0.8, 0.3), (0.01,))
    if extra_sphere_light:
        sb.add("MAT_LIGHT_4", MeshType.SPHERE, (-0.5, 0.9, -0.8), (0.2,))
        sb.lights([3, 4])
    else:
        sb.lights([3])
    return sb.build() if device is None else sb.build(device=device)


def _scenes(name, **kw):
    """(jax scene, jax camera, jax cfg, torch scene) of a named case."""
    if name.startswith("cubemap"):
        js, jc, jcfg = jpresets.cubemap_demo(**kw)
        ts = tpresets.cubemap_demo(device="cpu")[0]
    elif name == "config2":
        js, ts = jparse(CONFIG2), tparse(CONFIG2, device="cpu")
        jc = jcam.Camera.make(origin=(0, 0, 1.99), lookat=(0, 0, -1), fov=60.0)
        jcfg = jpresets.cornell_default(use_mis=True, use_procedural_sky=False, **kw)[2]
    elif name == "dir":
        js, ts = dir_scene(JBuilder), dir_scene(TBuilder, device="cpu")
        jc = jcam.Camera.make(origin=(0.0, 0.3, 2.0), lookat=(0.0, -0.6, -1.0))
        jcfg = jpresets.cornell_default(**kw)[2]
    else:  # cornell
        js, jc, jcfg = jpresets.cornell_default(**kw)
        ts = tpresets.cornell_default(device="cpu")[0]
    return js, jc, jcfg, ts


@pytest.mark.parametrize("mat", list(MatType), ids=[m.name for m in MatType])
def test_bsdf_sample_matches_jax(mat):
    """Every lane hits a mesh of material `mat`: random points, normals,
    incoming directions (both sides), draws and glossiness."""
    n = 512
    rng = np.random.default_rng(int(mat) + 11)
    em = rng.uniform(0.0, 0.3, (7, 3)).astype(np.float32)
    js = jparse(ALL_MATS)
    js = js.replace(emission=jnp.asarray(em))
    ts = tparse(ALL_MATS, device="cpu")
    ts = ts.replace(emission=torch.from_numpy(em))
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    nrm = _unit(rng, n)
    rd = _unit(rng, n)
    inside = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0).astype(np.float32)
    c = rng.uniform(0.001, 1.0, (n, 3)).astype(np.float32)
    e = rng.uniform(0.001, 0.3, (n, 3)).astype(np.float32)
    u1, u2, uc = rng.uniform(size=(3, n)).astype(np.float32)
    idx = np.full(n, int(mat), np.int32)
    for biased in (True, False):
        cfg = RenderConfig(use_biased_sampling=biased)
        jhit = types.SimpleNamespace(pos=jnp.asarray(pos), n=jnp.asarray(nrm),
                                     idx=jnp.asarray(idx))
        ref = jbsdf.sample(js, cfg, jhit, jnp.asarray(c), jnp.asarray(e),
                           jnp.asarray(inside), jnp.asarray(rd),
                           jnp.full(n, 550.0), jnp.asarray(u1), jnp.asarray(u2),
                           jnp.asarray(uc))
        T = torch.from_numpy
        thit = types.SimpleNamespace(pos=T(pos), n=T(nrm), idx=T(idx).long())
        got = tbsdf.sample(ts, cfg, thit, T(c), T(e), T(inside), T(rd),
                           T(u1), T(u2), T(uc))
        for k in ("specular", "diff_inc", "spec_inc", "scatter_inc"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(ref, k)), err_msg=k)
        for k in ("o", "d", "mask_mult"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(ref, k)),
                                       rtol=0, atol=1e-6, err_msg=k)
    if mat in (MatType.REFR_FRESNEL, MatType.REFR_SCHLICK):
        # both outcomes of the reflect/refract choice occur
        assert 0 < int(got.scatter_inc.sum()) < n


def test_sample_cubemap_matches_jax():
    """Random directions plus axis ties, ±0 components and the zero
    vector, on a random non-square cubemap and on the synthetic sky."""
    rng = np.random.default_rng(3)
    ties = []
    for v in [(1, 1, 0), (1, 1, 1), (0, 1, 1), (1, 0, 1), (-1, -1, 0), (-1, 1, -1),
              (0, -1, -1), (1, -1, 1), (0.0, -0.0, 1.0), (-0.0, 0.0, -1.0),
              (1.0, -0.0, 0.0), (-1.0, 0.0, -0.0), (0.0, 1.0, -0.0),
              (-0.0, -1.0, 0.0), (0.0, 0.0, 0.0), (-0.0, -0.0, -0.0)]:
        a = np.asarray(v, np.float32)
        ties.append(a / max(np.linalg.norm(a), 1.0))
    dirs = np.concatenate([_unit(rng, 2000), np.stack(ties),
                           rng.normal(size=(200, 3)).astype(np.float32)])
    for cube in (rng.uniform(0, 2, (6, 8, 12, 3)).astype(np.float32),
                 tpresets.synthetic_sky()):
        ref = np.asarray(jsky.sample_cubemap(jnp.asarray(cube), jnp.asarray(dirs)))
        got = tsky.sample_cubemap(torch.from_numpy(cube), torch.from_numpy(dirs)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_mis", [False, True], ids=["nee", "mis"])
def test_dir_light_nee_matches_jax(use_mis):
    """NEE with a directional slot and a sphere slot at random points above
    the geometry, against `lighting.sample_lights_nee`."""
    n = 1024
    rng = np.random.default_rng(7)
    js = dir_scene(JBuilder, extra_sphere_light=True)
    ts = dir_scene(TBuilder, device="cpu", extra_sphere_light=True)
    x = rng.uniform([-1.5, -0.2, -2.0], [1.5, 0.6, 0.5], (n, 3)).astype(np.float32)
    nl = _unit(rng, n)
    nl[:, 1] = np.abs(nl[:, 1])
    mask = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    pix = np.arange(n, dtype=np.uint32)
    cfg = RenderConfig(use_mis=use_mis)
    ref = np.asarray(jlighting.sample_lights_nee(
        js, cfg, jnp.asarray(x), jnp.asarray(nl), jnp.asarray(mask),
        jnp.asarray(pix), 3, 0, 1))
    T = torch.from_numpy
    got = tlighting.sample_lights_nee(ts, cfg, T(x), T(nl), T(mask),
                                      T(pix.astype(np.int64)), 3, 0, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert ref.max() > 0.1
    sun_only = [i for i in range(2) if tlighting.slot_kind(ts, i) == "dir"]
    assert sun_only == [0]


CASES = {
    "cubemap_demo": ("cubemap", dict(max_bounces=3)),
    "cubemap_uniform": ("cubemap", dict(max_bounces=3, use_biased_sampling=False)),
    "config2": ("config2", dict(max_bounces=3)),
    "dir": ("dir", dict(max_bounces=3)),
    "dir_mis": ("dir", dict(max_bounces=3, use_mis=True)),
    "uniform": ("cornell", dict(max_bounces=3, use_mis=True, use_biased_sampling=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_integrator(case):
    name, kw = CASES[case]
    h, w = 16, 128
    js, jc, cfg, ts = _scenes(name, **kw)
    cfg = cfg.replace(**kw)
    assert tint.unsupported(ts, cfg) is None
    ro, rd = (np.asarray(a) for a in jcam.generate_rays(jc, h, w, 1))
    ref = np.asarray(jint.trace(js, cfg, ro, rd, jrng.pixel_ids(h, w), 1, 0))
    out = tint.trace(ts, cfg, torch.from_numpy(ro.copy()), torch.from_numpy(rd.copy()),
                     trng.pixel_ids(h, w), 1, 0).numpy()
    assert out.shape == (h, w, 3) and np.isfinite(out).all()
    assert_parity(out, ref)
    assert ref.max() > 0.1


def test_plain_matches_jax_env_kernel_interpret():
    """cubemap_demo through the Pallas env kernel K9 (`trace_forward_env`,
    deferred cubemap records resolved by XLA), in interpret mode."""
    h, w = 8, 128
    js, jc, cfg, ts = _scenes("cubemap")
    cfg = cfg.replace(max_bounces=2)
    assert jmk.supported_env(js, cfg)
    ro, rd = (np.asarray(a) for a in jcam.generate_rays(jc, h, w, 1))
    os.environ["RT0_PALLAS_INTERPRET"] = "1"
    try:
        ref = np.asarray(jmk.trace_forward_env(js, cfg, ro, rd,
                                               jrng.pixel_ids(h, w), 1, 0))
    finally:
        del os.environ["RT0_PALLAS_INTERPRET"]
    out = tint.trace(ts, cfg, torch.from_numpy(ro.copy()), torch.from_numpy(rd.copy()),
                     trng.pixel_ids(h, w), 1, 0).numpy()
    assert_parity(out, ref)
    assert ref.max() > 0.05


def test_gradient_gate_names_k2_class():
    """K2 differentiates the whole class K1 renders without ReSTIR: the
    cubemap, config 2 (glass, mirror, coat), the sun and uniform sampling
    run its wide copy (with the IOR's column under refraction), Cornell its
    own; what it refuses, before anything is launched, names the ROADMAP
    item that adds it: a gradient w.r.t. a texel array (item 14), ReSTIR
    (K7, item 11)."""
    cornell, _, cfg = tpresets.cornell_default(device="cpu", use_mis=True)
    assert tmk.unsupported(cornell, cfg) is None
    assert tmk.unsupported_bwd(cornell, cfg) is None and tmk.cornell_copy(cornell, cfg)
    cube, _, ccfg = tpresets.cubemap_demo(device="cpu")
    config2 = tparse(CONFIG2, device="cpu")
    sun = dir_scene(TBuilder, device="cpu")
    for scene, c in [(cube, ccfg), (config2, cfg), (sun, cfg),
                     (cornell, cfg.replace(use_biased_sampling=False))]:
        assert tmk.unsupported(scene, c) is None
        assert tmk.unsupported_bwd(scene, c) is None and not tmk.cornell_copy(scene, c)
    assert 13 in tmk.bwd_columns(config2, cfg) and 13 not in tmk.bwd_columns(sun, cfg)
    texel = cube.replace(cubemap=cube.cubemap.clone().requires_grad_(True))
    reason = tmk.unsupported_bwd(texel, ccfg)
    assert "cubemap" in reason and "ROADMAP queue 1 item 14" in reason, reason
    reason = tmk.unsupported_bwd(cornell, cfg.replace(use_restir=True))
    assert "K7" in reason and "item 11" in reason, reason
