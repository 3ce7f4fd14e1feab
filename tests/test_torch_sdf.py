"""The port's SDF march against the JAX package, on seeded numpy inputs.

`ops/sdf.py` (BOX and ROUND_BOX, the scene map, the tetrahedral normal,
the march with its bounding-sphere gate and implicit-function gradient)
against `raytracer0_tpu.ops.sdf`, and the plain integrator with SDF meshes
against JAX's `integrator.trace` on `mis_demo` and on `restir_demo`
rendered with per-light NEE, at 16x32 with 2 bounces and 16 marching
steps.

The JAX references run op by op (`jax.disable_jit`): compiled, XLA's CPU
backend contracts a*b + c into one FMA (the march's `ro + rd * t`, the
cone sampler's `1 - r_y * r_y`), which the port, like its CUDA kernels,
does not.  With restir_demo's tiny lights (radius 0.02-0.03) the cone is so
narrow that 1 - r_y² loses most of its digits, and an FMA there moves a
shadow ray by enough to flip it at a light's rim: against the compiled
`integrator.trace` 11 of 512 pixels differ by more than 1e-5 (printed
below), against the same function run op by op none does.  The parity
contract (>= 99 % of pixels within 1e-5, median below 1e-4,
tests/test_megakernel.py:94, tests/test_golden_cornell.py:35) is held
against the latter.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu import rng as jrng
from raytracer0_tpu.models import camera as jcam
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.ops import sdf as jsdf
from raytracer0_tpu.render import integrator as jint
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.ops import sdf as tsdf
from raytracer0_tpu_torch.render import integrator as tint

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PARITY_TOL, PARITY_FRAC, MEDIAN_TOL = 1e-5, 0.99, 1e-4
T = torch.from_numpy
PRESETS = ("mis_demo", "restir_demo")


def _scenes(name):
    js, jc, jcfg = getattr(jpresets, name)()
    ts, _, _ = getattr(tpresets, name)(device="cpu")
    # remat_bounces only steers JAX's autodiff memory; off, its op-by-op
    # trace compiles each op once (the port reads no such field)
    return js, jc, jcfg.replace(use_restir=False, marching_steps=16, remat_bounces=False), ts


def _rays(n, seed):
    """Seeded rays from around the scene toward the SDF entry at the origin
    of restir_demo and the ceiling box of mis_demo."""
    r = np.random.default_rng(seed)
    o = r.uniform([-1.5, -0.8, -1.5], [1.5, 1.5, 1.5], (n, 3)).astype(np.float32)
    target = r.uniform([-0.5, -0.1, -0.5], [0.5, 1.1, 0.5], (n, 3)).astype(np.float32)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _face_rays(n, seed):
    """Seeded rays onto the interior of the top and bottom faces of
    restir_demo's box (half-extents 0.3, 0.05, 0.3 at the origin), from
    1.2 away and at least 45 degrees from grazing."""
    r = np.random.default_rng(seed)
    side = np.where(r.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    target = np.stack([r.uniform(-0.2, 0.2, n), 0.05 * side, r.uniform(-0.2, 0.2, n)],
                      axis=-1).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -side * (np.abs(d[:, 1]) + np.hypot(d[:, 0], d[:, 2]))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return (target - 1.2 * d).astype(np.float32), d


def test_primitives_match_jax():
    """sd_box and ud_round_box at seeded points and half-extents."""
    r = np.random.default_rng(0)
    p = r.uniform(-1.5, 1.5, (4096, 3)).astype(np.float32)
    b = r.uniform(0.05, 0.8, (4096, 3)).astype(np.float32)
    rr = r.uniform(0.0, 0.2, (4096,)).astype(np.float32)
    np.testing.assert_allclose(tsdf.sd_box(T(p), T(b)).numpy(),
                               np.asarray(jsdf.sd_box(p, b)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsdf.ud_round_box(T(p), T(b), T(rr)).numpy(),
                               np.asarray(jsdf.ud_round_box(p, b, rr)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", PRESETS)
def test_scene_map_and_normal_match_jax(name):
    """scene_map (distance and ordinal) and calc_normal at seeded points."""
    js, _, cfg, ts = _scenes(name)
    p = np.random.default_rng(1).uniform(-1.2, 1.2, (4096, 3)).astype(np.float32)
    jd, ji = jsdf.scene_map(js, p)
    td, ti = tsdf.scene_map(ts, T(p))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the 4-tap normal sums distances ~1 that cancel to ~4·eps: an ULP of a
    # distance (torch's CPU sqrt is not always correctly rounded) moves a
    # component by up to ~6e-5 where the normal is defined, outside the shapes
    out = np.asarray(jd) > 0.01
    np.testing.assert_allclose(tsdf.calc_normal(ts, T(p[out]), cfg.epsilon).numpy(),
                               np.asarray(jsdf.calc_normal(js, p[out], cfg.epsilon)),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", PRESETS)
def test_march_matches_jax(name):
    """march: t, mesh index, normal and validity of seeded rays, up to
    the analytic limit 1e4 (infinity) and up to a near limit."""
    js, _, cfg, ts = _scenes(name)
    o, d = _rays(2048, 2)
    tmin = np.where(np.arange(2048) % 2 == 0, cfg.infinity, 1.5).astype(np.float32)
    with jax.disable_jit():
        jt, ji, jn, jv = jsdf.march(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), cfg)
    tt, ti, tn, tv = tsdf.march(ts, T(o), T(d), T(tmin), cfg)
    jv, tv = np.asarray(jv), tv.numpy()
    np.testing.assert_array_equal(tv, jv)
    assert 200 < jv.sum() < 1900       # hits and misses both
    np.testing.assert_allclose(tt.numpy()[jv], np.asarray(jt)[jv], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy()[jv], np.asarray(ji)[jv])
    # at a hit on a box edge the taps straddle two faces, and a hit point an
    # ULP apart turns the normal: the parity contract's form, >= 98 % of the
    # normals within 1e-5
    err = np.abs(tn.numpy()[jv] - np.asarray(jn)[jv]).max(axis=-1)
    assert (err < 1e-5).mean() >= 0.98, (err < 1e-5).mean()


def test_march_gradient_matches_jax():
    """d sum(t over valid lanes) / d(SDF row's pos, joker): the implicit
    reattachment, against jax.grad of sdf.march, within 1e-4 relative
    (tests/test_megakernel.py:128-129).  The rays hit face interiors: at a
    box edge the distance's derivative jumps, and a hit point an ULP apart
    (torch's CPU sqrt is not always correctly rounded) takes the other
    side."""
    js, _, cfg, ts = _scenes("restir_demo")
    o, d = _face_rays(1024, 3)
    tmin = np.full(1024, cfg.infinity, np.float32)
    row = ts.num_analytic

    def jloss(pos, joker):
        t, _, _, v = jsdf.march(js.replace(pos=pos, joker=joker), jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(tmin), cfg)
        return jnp.sum(jnp.where(v, t, 0.0))

    with jax.disable_jit():
        jg = jax.grad(jloss, argnums=(0, 1))(js.pos, js.joker)
    pos = ts.pos.clone().requires_grad_(True)
    joker = ts.joker.clone().requires_grad_(True)
    t, _, _, v = tsdf.march(ts.replace(pos=pos, joker=joker), T(o), T(d), T(tmin), cfg)
    assert bool(v.all())
    torch.where(v, t, torch.zeros_like(t)).sum().backward()
    for got, want in ((pos.grad, jg[0]), (joker.grad, jg[1])):
        want = np.asarray(want)
        scale = np.abs(want[row]).max()
        assert scale > 1.0
        assert np.abs(got.numpy() - want).max() / scale < 1e-4
        assert np.abs(np.delete(got.numpy(), row, 0)).max() == 0.0   # only the SDF row


@pytest.fixture(scope="module")
def traces():
    """{preset: (port image, JAX image op by op, JAX image compiled)} at
    16x32, 2 bounces, 16 marching steps."""
    h, w = 16, 32
    out = {}
    for name in PRESETS:
        js, jc, cfg, ts = _scenes(name)
        cfg = cfg.replace(max_bounces=2)
        ro, rd = (np.asarray(a) for a in jcam.generate_rays(jc, h, w, 0))
        args = (js, cfg, ro, rd, jrng.pixel_ids(h, w), 0, 0)
        with jax.disable_jit():
            eager = np.asarray(jint.trace(*args, sdf_march=jsdf.march))
        compiled = np.asarray(jint.trace(*args, sdf_march=jsdf.march))
        port = tint.trace(ts, cfg, T(ro.copy()), T(rd.copy()), trng.pixel_ids(h, w),
                          0, 0).numpy()
        out[name] = (port, eager, compiled)
    return out


def test_normal_gradient_finite_on_the_core():
    """A tap of the 4-tap normal that lands exactly on the rounded box's
    core (restir_demo's ROUND_BOX has radius 0, so a hit within epsilon of
    its top face puts the (1, -1, -1) tap at |y| = 0.05 when y = 0.051)
    has a zero distance gradient, not sqrt(0)'s 0 * inf: the normal's
    gradient stays finite (jax.grad gives NaN there; K7 follows the
    port)."""
    scene, _, _ = tpresets.restir_demo(device="cpu")
    y = np.float32(0.051)
    assert np.float32(y - np.float32(0.001)) == np.float32(0.05)
    pos = scene.pos.clone().requires_grad_(True)
    joker = scene.joker.clone().requires_grad_(True)
    p = torch.tensor([[0.1, float(y), 0.05]], requires_grad=True)
    n = tsdf.calc_normal(scene.replace(pos=pos, joker=joker), p, 1e-3)
    for g in torch.autograd.grad(n.sum(), [p, pos, joker]):
        assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("name", PRESETS)
def test_plain_integrator_matches_jax(traces, name):
    """The plain integrator with the SDF march against JAX's
    integrator.trace: the parity contract against the op-by-op run; the
    pixels that differ by more than 1e-5 from the compiled run are
    printed."""
    port, eager, compiled = traces[name]
    assert port.shape == (16, 32, 3) and np.isfinite(port).all()
    err = np.abs(port - eager).max(axis=-1)
    flipped = int((np.abs(port - compiled).max(axis=-1) > PARITY_TOL).sum())
    print(f"{name}: {int((err > PARITY_TOL).sum())} pixels beyond {PARITY_TOL} of the "
          f"op-by-op run, {flipped} of the compiled run (max {err.max():.3e})")
    assert (err < PARITY_TOL).mean() >= PARITY_FRAC and np.median(err) < MEDIAN_TOL
    assert np.median(np.abs(port - compiled).max(axis=-1)) < MEDIAN_TOL
    assert eager.max() > 0.02
