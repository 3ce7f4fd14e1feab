"""The port's textures and procedural noise against the JAX package, on
seeded numpy inputs.

Function by function (`noise.*`, `textures.get_texel`, the UV of
`intersect.parse_hit`) the port computes the JAX values to float32
rounding: XLA's CPU compiler fuses elementwise chains and may contract a
product and a sum into one FMA, so Voronoi distances and fBm sums differ
by an ULP in well under 1 % of the points (held within 1e-6), and the sin
hash of gradient noise and asin/atan2 round differently in the two
frameworks.  The plain integrator, the plain version of K1, meets
the parity contract against JAX's XLA `integrator.trace` (the reference
with exact texels that the JAX package's own K10/K11 tests hold those
kernels to, tests/test_megakernel.py:532, :820) on the four textured
presets and on the procedural scene of tests/test_megakernel.py:168-202:
at least 99 % of pixels within 1e-5 (max over RGB) and a median below
1e-4.  Gradient noise agrees in mean and standard deviation
(tests/test_megakernel.py:247-279), the CHECK sphere everywhere but on
cell boundaries (tests/test_megakernel.py:780-817), and the gradient
w.r.t. the images and the colors within 1e-4 relative of `jax.grad`.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu import rng as jrng
from raytracer0_tpu.config import OFFLINE_CONFIG
from raytracer0_tpu.models import camera as jcam
from raytracer0_tpu.models import materials as jmat
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.models.scene import SceneBuilder as JBuilder
from raytracer0_tpu.ops import intersect as jisect
from raytracer0_tpu.ops import noise as jnoise
from raytracer0_tpu.ops import textures as jtex
from raytracer0_tpu.render import integrator as jint
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.models import materials as tmat
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracer0_tpu_torch.ops import intersect as tisect
from raytracer0_tpu_torch.ops import megakernel as tmk
from raytracer0_tpu_torch.ops import noise as tnoise
from raytracer0_tpu_torch.ops import textures as ttex
from raytracer0_tpu_torch.render import integrator as tint

from test_torch_texture_scenes import SCENE_VIEWS, check_sphere_scene, tex_material

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PARITY_TOL, PARITY_FRAC, MEDIAN_TOL = 1e-5, 0.99, 1e-4
T = torch.from_numpy


def scenes(name):
    """(jax scene, jax camera, cfg, torch scene) of a preset or a scene above."""
    if name in SCENE_VIEWS:
        make, (origin, lookat, fov), kw = SCENE_VIEWS[name]
        cam = jcam.Camera.make(origin=origin, lookat=lookat, fov=fov)
        return (make(JBuilder, jmat), cam, OFFLINE_CONFIG.replace(**kw),
                make(TBuilder, tmat, device="cpu"))
    js, jc, cfg = getattr(jpresets, name)(max_bounces=3)
    return js, jc, cfg, getattr(tpresets, name)(device="cpu")[0]


def traces(name, h=16, w=128):
    """(port, JAX) radiance of one pass of a named scene at h x w."""
    js, jc, cfg, ts = scenes(name)
    assert tint.unsupported(ts, cfg) is None
    ro, rd = (np.asarray(a) for a in jcam.generate_rays(jc, h, w, 1))
    ref = np.asarray(jint.trace(js, cfg, ro, rd, jrng.pixel_ids(h, w), 1, 0))
    out = tint.trace(ts, cfg, T(ro.copy()), T(rd.copy()), trng.pixel_ids(h, w), 1, 0).numpy()
    assert out.shape == (h, w, 3) and np.isfinite(out).all()
    return out, ref


def _points(rng, n, scale):
    return rng.uniform(-scale, scale, (n, 3)).astype(np.float32)


def assert_ulp_close(got, ref, what=""):
    """Within 1e-6, and bit for bit at 99 % of the values or more."""
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=what)
    assert (got == ref).mean() >= 0.99, what


def test_noise_matches_jax():
    """Value noise, Voronoi and metal fBm at random points near and far
    from the origin; gradient noise is exactly 0 on the lattice and agrees
    in distribution elsewhere (its sin hash amplifies a 1-ULP difference of
    sin 43758x)."""
    rng = np.random.default_rng(1)
    lut = trng.noise_lut()
    jlut = jnp.asarray(jrng.noise_lut())
    for scale in (1.5, 40.0):
        x = _points(rng, 4096, scale)
        for name in ("value_noise", "voronoi", "metal_fbm"):
            got = getattr(tnoise, name)(lut, T(x)).numpy()
            ref = np.asarray(getattr(jnoise, name)(jlut, jnp.asarray(x)))
            assert_ulp_close(got, ref, name)
        got = tnoise.gradient_noise(T(x)).numpy()
        ref = np.asarray(jnoise.gradient_noise(jnp.asarray(x)))
        assert abs(got.mean() - ref.mean()) < 0.02 and abs(got.std() - ref.std()) < 0.02
        assert (np.abs(got - ref) < 1e-4).mean() > 0.5
    lattice = np.floor(_points(rng, 256, 20.0))
    assert not tnoise.gradient_noise(T(lattice)).abs().max().item()


def _one_per_type(builder, m, device=None):
    """One SPHERE per texture type, in TexType order (NONE last), with
    random params (positive moduli)."""
    rng = np.random.default_rng(2)
    b = builder()
    for t in list(m.TexType)[1:] + [m.TexType.NONE]:
        params = tuple(float(v) for v in rng.uniform(0.5, 6.0, 4))
        b.add(tex_material(m, t, params), m.MeshType.SPHERE, (0.0, 0.0, 0.0), (1.0,))
    images = rng.uniform(0.0, 1.0, (4, 24, 40, 4)).astype(np.float32)
    b.images(images)
    return b.build() if device is None else b.build(device=device)


def test_get_texel_matches_jax():
    """All 10 types at random UVs (outside [0, 1) too) and hit positions:
    GRADIENT_NOISE agrees in distribution, the others to float32 rounding
    (the images and the UV patterns bit for bit)."""
    rng = np.random.default_rng(4)
    js, ts = _one_per_type(JBuilder, jmat), _one_per_type(TBuilder, tmat, device="cpu")
    n = 2048
    idx = rng.integers(0, js.num_meshes, n).astype(np.int32)
    uv = rng.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    pos = _points(rng, n, 2.0)
    ref = np.asarray(jtex.get_texel(js, jnp.asarray(idx), jnp.asarray(uv), jnp.asarray(pos)))
    got = ttex.get_texel(ts, T(idx).long(), T(uv), T(pos)).numpy()
    gn = idx == int(tmat.TexType.GRADIENT_NOISE)
    assert_ulp_close(got[~gn], ref[~gn])
    exact = idx <= int(tmat.TexType.IMAGE3)
    exact |= (idx == int(tmat.TexType.CHECK)) | (idx == int(tmat.TexType.RIPPLE))
    np.testing.assert_array_equal(got[exact], ref[exact])
    assert np.abs(got[gn] - ref[gn]).mean() < 0.05
    assert (got[idx == js.num_meshes - 1] == 0.0).all()   # NONE: alpha 0
    assert len({int(t) for t in idx}) == 11


def test_bilinear_wrap_matches_jax():
    """REPEAT wrapping at UVs far outside [0, 1), non-square images."""
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (5, 7, 4)).astype(np.float32)
    uv = np.concatenate([rng.uniform(-50, 50, (1000, 2)),
                         np.asarray([[0.0, 0.0], [1.0, 1.0], [-1e-8, 0.5], [0.9999999, -0.0]])]
                        ).astype(np.float32)
    np.testing.assert_array_equal(ttex.bilinear_wrap(T(img), T(uv)).numpy(),
                                  np.asarray(jtex.bilinear_wrap(jnp.asarray(img), jnp.asarray(uv))))


def test_parse_hit_uv_matches_jax():
    """UV of random rays on a sphere, planes and a box (spherical from the
    world position, planar by the dominant normal axis, -1 on a miss)."""
    rng = np.random.default_rng(8)
    js = check_sphere_scene(JBuilder, jmat)
    ts = check_sphere_scene(TBuilder, tmat, device="cpu")
    n = 4096
    ro = np.tile(np.asarray([[0.0, -0.2, 0.8]], np.float32), (n, 1))
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[: n // 2] = rd[: n // 2] * 0.2 + np.asarray([0.0, -0.4, -2.0], np.float32)  # at the sphere
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    cfg = OFFLINE_CONFIG
    jh = jisect.intersect(js, jnp.asarray(ro), jnp.asarray(rd), cfg)
    th = tisect.intersect(ts, T(ro), T(rd), cfg)
    np.testing.assert_array_equal(th.idx.numpy(), np.asarray(jh.idx))
    sphere = np.asarray(js.mesh_type)[np.asarray(jh.idx)] == int(jmat.MeshType.SPHERE)
    sphere &= ~np.asarray(jh.missed)
    juv, tuv = np.asarray(jh.uv), th.uv.numpy()
    np.testing.assert_array_equal(tuv[~sphere], juv[~sphere])
    # XLA's fused asin/atan2 rounds differently from libm's (the tests'
    # persistent compile cache may serve an executable built elsewhere)
    np.testing.assert_allclose(tuv[sphere], juv[sphere], rtol=0, atol=1e-4)
    assert np.median(np.abs(tuv[sphere] - juv[sphere])) < 1e-6
    assert sphere.sum() > 100 and np.asarray(jh.missed).sum() > 100
    assert (tuv[th.missed.numpy()] == -1.0).all()
    assert (tisect.intersect(ts, T(ro), T(rd), cfg, need_uv=False).uv == -1.0).all()


@pytest.mark.parametrize("name", ["textured_cornell", "textured_gloss", "textured_emitter",
                                  "cornell_box", "procedural"])
def test_plain_matches_jax_integrator(name):
    """16x128, 3 bounces: the parity contract against JAX's XLA trace."""
    out, ref = traces(name)
    err = np.abs(out - ref).max(axis=-1)
    assert (err < PARITY_TOL).mean() >= PARITY_FRAC, (err.max(), (err < PARITY_TOL).mean())
    assert np.median(err) < MEDIAN_TOL and err.max() < 1e-4
    assert ref.max() > 0.1


def test_gradient_noise_statistical():
    """tests/test_megakernel.py:277-278: mean within 2 %, std within 5 %."""
    out, ref = traces("gradient_noise")
    assert abs(out.mean() - ref.mean()) < 0.02 * max(ref.mean(), 1e-3)
    assert abs(out.std() - ref.std()) < 0.05 * max(ref.std(), 1e-3)


def test_check_sphere_boundary_fraction():
    """tests/test_megakernel.py:814-817: all but a vanishing share of
    pixels (those whose UV lands within an ULP of a cell boundary) agree."""
    out, ref = traces("check_sphere")
    err = np.abs(out - ref).max(axis=-1)
    assert (err < 1e-5).mean() > 0.995
    assert np.median(err) < MEDIAN_TOL and ref.max() > 0.1


def test_plain_grad_matches_jax_images_and_color():
    """d sum(trace) / d(images, color) on textured_cornell at 16x128, 2
    bounces: the port's plain autograd (the route of textured gradients
    until ROADMAP queue 1 item 14) against jax.grad."""
    h, w = 16, 128
    js, jc, cfg, ts = scenes("textured_cornell")
    cfg = cfg.replace(max_bounces=2)
    ro, rd = (np.asarray(a) for a in jcam.generate_rays(jc, h, w, 1))
    jpix = jrng.pixel_ids(h, w)

    def jloss(images, color):
        s = js.replace(images=images, color=color)
        return jnp.sum(jint.trace(s, cfg, jnp.asarray(ro), jnp.asarray(rd), jpix, 1, 0))

    want = jax.grad(jloss, argnums=(0, 1))(js.images, js.color)
    leaves = [ts.images.clone().requires_grad_(True), ts.color.clone().requires_grad_(True)]
    tint.trace(ts.replace(images=leaves[0], color=leaves[1]), cfg, T(ro.copy()),
               T(rd.copy()), trng.pixel_ids(h, w), 1, 0).sum().backward()
    for leaf, b in zip(leaves, want):
        a, b = leaf.grad.numpy(), np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0.0 and np.abs(a - b).max() / scale < 1e-4


def test_gradient_gate_refuses_textures():
    """K2 differentiates textured scenes through the scene table (its wide
    copy, with the blended texture's masks, and its params where they have
    a gradient, as columns): the four textured presets are in its class;
    a gradient w.r.t. the images or the noise LUT is refused by
    `unsupported_bwd` (ROADMAP queue 1 item 14), as the JAX package
    computes it outside its kernels too.  A texture that blends into
    nothing takes the wide copy all the same: a shadow ray reads the texel
    of any mesh it hits (lighting.direct_light_slot)."""
    for name in ("textured_cornell", "textured_gloss", "textured_emitter", "cornell_box"):
        ts, _, cfg = getattr(tpresets, name)(device="cpu")
        assert tmk.unsupported(ts, cfg) is None
        assert tmk.unsupported_bwd(ts, cfg) is None and not tmk.cornell_copy(ts, cfg)
        assert {30, 31, 32} <= set(tmk.bwd_columns(ts, cfg))
        for leaf in ("images", "noise"):
            grad_leaf = getattr(ts, leaf).clone().requires_grad_(True)
            reason = tmk.unsupported_bwd(ts.replace(**{leaf: grad_leaf}), cfg)
            assert leaf in reason and "ROADMAP queue 1 item 14" in reason, reason
    ts, _, cfg = tpresets.textured_emitter(device="cpu")
    assert {33, 34, 35} <= set(tmk.bwd_columns(ts, cfg))
    # a texture that blends into nothing: in K2's class, on its wide copy
    b = TBuilder()
    b.add(tex_material(tmat, tmat.TexType.CHECK, (5.0, 5.0, 2.0, 0.0), opts=(False,) * 4),
          tmat.MeshType.PLANE, (0.0, 1.0, 0.0), (2.0,))
    b.add("MAT_LIGHT_4", tmat.MeshType.SPHERE, (0.0, 1.5, 0.0), (0.4,))
    _, _, cfg = tpresets.cornell_default(device="cpu")
    plain = b.build(device="cpu")
    assert tmk.unsupported_bwd(plain, cfg) is None and not tmk.cornell_copy(plain, cfg)
    assert {26, 27, 28, 29} <= set(tmk.bwd_columns(plain, cfg))