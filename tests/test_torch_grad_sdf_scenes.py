"""Gradients of the port's plain version against `jax.grad` over the whole
SDF class: every shape, textured SDF meshes and SDF-light NEE.

The plain version of K2 is `torch.autograd` through `render/integrator.
trace`; here it is held against `jax.grad` of the JAX `integrator.trace`
run op by op (`jax.disable_jit`, as tests/test_torch_grad_wide.py does and
explains) at 8x32 or 16x16 with at most 2 bounces and 32 marching steps
(below), on the scene that
holds every shape the presets do not, the SDF-light scene with and without
MIS, the textured SDF scene (an image on an SDF sphere, read at the UV of
its row's box normal; value noise on an SDF light, whose texel NEE's
shadow rays read at the hit of the SDF march) and the reference's presets
0, 2 and 3 (`default_scene`, its METAL texture on an SDF box's
glossiness; `mandelbulb`; `menger_sponge`), per leaf of the scene table
(pos, joker, color, emission, ior, aux, the texture columns) and of the
rays within GRAD_TOL = 1e-4 relative: max|a - b| / max|b|.  The host build
and the card hold K2 against the float32 plain autograd
(tests/test_torch_kernel_host.py, tests/test_torch_cuda.py).

Both packages run in float64 here (the JAX package under
`jax.enable_x64`, its leaves, rays and texel arrays cast up): the
adjoint of an SDF hit's tetrahedral normal sums four taps whose
gradients, of size 1/eps, cancel on a flat face, and over a batch each
tap's sum is rounded on its own.  In float32 the rest is noise of the
size of the leaf where the leaf is small: `default_scene`'s SDF rows'
pos, whose upper box's z is 3.5e-12 in float64 (both packages), 3.1e-5
from the port in float32 and 1.8e-3 from JAX in float32, against a leaf
of 6.6e-3.

The reference's `vecmath.length` runs with the port's zero gradient at 0
(`test_torch_grad_sdf.safe_jax_length`, the same forward values): with
its own, jax.grad is NaN at every pixel whose path evaluates a box, a
sponge or a sea box at a point inside it (0 * inf; 211 of the 256 pixels
of `menger_sponge`, and every entry of its SDF row's pos and joker),
which tests/test_torch_grad_sdf.py counts per shape.  Where jax.grad is
still NaN (the cone's own square root at a point inside it: 12 pixels of
the every-shape scene at two bounces, none at the one run here; in
float64 no Mandelbulb lane that is done overflows,
tests/test_torch_grad_sdf.py meets those in float32), the entry is left
out and the NaNs are counted, so a new one fails.  That NaN reaches every
leaf of a path that touches the cone, so the triangle's and the quad's
vertices (aux) are held on a scene of their own (`polygon_scene`).  The scenes slowest to trace op by op run one bounce:
the every-shape scene (16 marching steps) and the polygon scene (16
steps, lit directly) at 16x16, where their triangle and quad are in
view, and `mandelbulb` (32 steps) at 8x32; the textured scene two bounces
and 32 steps at 16x16; the others two bounces and 32 steps at 8x32.
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
from raytracer0_tpu.ops import sdf as jsdf
from raytracer0_tpu.render import integrator as jint
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.ops import megakernel as tmk
from raytracer0_tpu_torch.render import integrator as tint

from test_torch_grad_sdf import safe_jax_length

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GRAD_TOL = 1e-4
LEAVES = ("pos", "joker", "color", "emission", "ior", "aux", "tex_params", "tex_cmask",
          "tex_emask")
ASSETS = ("images", "noise", "cubemap")
# case: (scene view or preset, use_mis, bounces, marching steps, jax.grad's
# NaN entries per leaf); the every-shape, polygon and textured scenes at
# 16x16, where their SDF rows are in view, the others at 8x32
CASES = {
    "every_shape": ("every_shape", False, 1, 16, {}),
    "polygons": ("polygons", False, 1, 16, {}),
    "sdf_light": ("sdf_light", False, 2, 32, {}),
    "sdf_light_mis": ("sdf_light", True, 2, 32, {}),
    "textured_sdf": ("textured_sdf", False, 2, 32, {}),
    "default_scene": ("default_scene", False, 2, 32, {}),
    "mandelbulb": ("mandelbulb", False, 1, 32, {}),
    "menger_sponge": ("menger_sponge", False, 2, 32, {}),
}
SIZE = {"every_shape": (16, 16), "polygons": (16, 16), "textured_sdf": (16, 16)}
#: the cases tests/test_torch_grad_sdf.py runs, so the two files share the time
ELSEWHERE = ("every_shape", "mandelbulb")


def _case(where, mis, bounces, steps):
    """(JAX scene, JAX camera, config, port scene) of a case."""
    if where in tpresets.SDF_SCENE_VIEWS:
        make, (origin, lookat, fov), kw = tpresets.SDF_SCENE_VIEWS[where]
        js, ts = make(device=None, builder=JBuilder, m=jmat), make(device="cpu")
        jc, cfg = jcam.Camera.make(origin=origin, lookat=lookat, fov=fov), J_OFFLINE.replace(**kw)
    else:
        js, jc, cfg = getattr(jpresets, where)()
        ts = getattr(tpresets, where)(device="cpu")[0]
    # remat_bounces steers JAX's autodiff memory alone; off, its op-by-op
    # trace compiles each op once (the port reads no such field)
    return js, jc, cfg.replace(max_bounces=bounces, marching_steps=steps, use_mis=mis,
                               remat_bounces=False), ts


def plain_and_jax_grads(name):
    """(pixels whose radiance differs by more than 1e-5, {leaf: port
    gradient}, {leaf: jax.grad}) of sum(trace * wt * keep) w.r.t. LEAVES,
    ro and rd, with seeded weights wt and keep 0 at those pixels; both
    packages in float64 (module docstring)."""
    js, jc, cfg, ts = _case(*CASES[name][:4])
    h, w = SIZE.get(name, (8, 32))
    assert tmk.unsupported_bwd(ts, cfg) is None and tmk.whole_sdf(ts)
    ro, rd = (np.asarray(a, np.float64) for a in jcam.generate_rays(jc, h, w, 1))
    wt = np.random.default_rng(3).uniform(0.5, 1.5, (h, w, 3))
    f64 = LEAVES + ASSETS
    t_leaves = {k: getattr(ts, k).detach().double().requires_grad_(True) for k in LEAVES}
    o = torch.from_numpy(ro.copy()).requires_grad_(True)
    d = torch.from_numpy(rd.copy()).requires_grad_(True)
    out = tint.trace(ts.replace(**t_leaves, **{k: getattr(ts, k).double() for k in ASSETS}),
                     cfg, o, d, trng.pixel_ids(h, w), 1, 0)
    with jax.enable_x64(True), jax.disable_jit():
        js = js.replace(**{k: jnp.asarray(np.asarray(getattr(js, k)), jnp.float64) for k in f64})
        jpix = jrng.pixel_ids(h, w)

        def jtrace(*args):
            s = js.replace(**dict(zip(LEAVES, args[:-2])))
            return jint.trace(s, cfg, args[-2], args[-1], jpix, 1, 0, sdf_march=jsdf.march)

        ref, jvjp = jax.vjp(jtrace, *(getattr(js, k) for k in LEAVES),
                            jnp.asarray(ro), jnp.asarray(rd))
        flipped = np.abs(out.detach().numpy() - np.asarray(ref)).max(-1) > 1e-5
        wt = wt * ~flipped[..., None]
        jg = jvjp(jnp.asarray(wt))
    got = torch.autograd.grad((out * torch.from_numpy(wt)).sum(), [*t_leaves.values(), o, d],
                              allow_unused=True)
    names = LEAVES + ("ro", "rd")
    want = {k: np.asarray(v) for k, v in zip(names, jg)}
    got = {k: (np.zeros(want[k].shape) if g is None else g.numpy()) for k, g in zip(names, got)}
    assert all(v.dtype == np.float64 for v in (*want.values(), *got.values()))
    return flipped, got, want


def check_plain_grad(name, monkeypatch):
    """d sum(trace * w) / d(scene table leaves, ro, rd) on each case: the
    port's plain autograd against jax.grad op by op, per leaf within 1e-4
    relative, JAX's NaN entries counted and left out.  A pixel whose
    radiance differs by more than 1e-5 (a fractal's silhouette flipped by
    an ULP; tests/test_torch_sdf_shapes.py holds the forward so: at most
    3 % of the pixels) has a zero weight."""
    safe_jax_length(monkeypatch)
    flipped, got, want = plain_and_jax_grads(name)
    counted = {k: int((~np.isfinite(v)).sum()) for k, v in want.items() if not np.isfinite(v).all()}
    print(f"{name}: jax.grad NaN entries {counted}, {int(flipped.sum())} pixels flipped")
    assert flipped.mean() <= 0.03
    for k, b in want.items():
        a = got[k]
        assert a.shape == b.shape and np.isfinite(a).all(), k
        ok = np.isfinite(b)
        scale = max(np.abs(b[ok]).max(), 1e-12)
        assert np.abs(a[ok] - b[ok]).max() / scale < GRAD_TOL, \
            (k, np.abs(a[ok] - b[ok]).max(), scale)
    assert counted == CASES[name][4], counted
    for k in ("color", "pos", "joker", "rd"):
        assert np.nanmax(np.abs(want[k])) > 0.0, k
    if name == "polygons":   # the triangle's and the quad's vertices
        assert np.nanmax(np.abs(want["aux"])) > 0.0 and np.abs(got["aux"]).max() > 0.0
    elif name != "every_shape":
        assert not np.abs(got["aux"]).any()
    if name == "textured_sdf":   # the image on the sphere, the value noise on the light
        assert np.abs(want["tex_cmask"]).max() > 0.0 and np.abs(want["tex_emask"]).max() > 0.0
        assert np.abs(want["tex_params"]).max() > 0.0


@pytest.mark.parametrize("name", [n for n in CASES if n not in ELSEWHERE])
def test_plain_grad_matches_jax_whole_sdf(name, monkeypatch):
    """The port's plain gradient against jax.grad on each case
    (`check_plain_grad`); the every-shape and Mandelbulb cases run in
    tests/test_torch_grad_sdf.py, so the two files share the time."""
    check_plain_grad(name, monkeypatch)
