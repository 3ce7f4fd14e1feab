"""Gradients of the port's plain version against `jax.grad` over the class
the widened adjoint K2 covers: every surface material with the IOR,
directional lights, uniform sampling, a BOX SDF, a cubemap and textures
(the image presets, and the procedural types of tests/test_megakernel.py:
168-202, :247-266 and :795-806, whose params reach the texel through
remainder's divisor and the noise scales).

The plain version of K2 is `torch.autograd` through
`render/integrator.trace`; here it is held against `jax.grad` of the JAX
`integrator.trace` (tests/test_megakernel.py:97-129 holds the JAX
package's adjoint kernel against the same) on each scene class, per leaf
of the scene table and of the rays within GRAD_TOL = 1e-4 relative:
max|a - b| / max|b| (tests/test_megakernel.py:128-129).  The host build
of K2 is held against the plain version on the same scenes in
tests/test_torch_kernel_host.py.  The cubemap's texels, the images and
the noise LUT are not differentiated here: K2 refuses them (ROADMAP queue
1 item 14).

Where jax.grad gives NaN (`vecmath.length` at 0 in an SDF distance, whose
sqrt has an infinite derivative that a zero cotangent turns into
0 * inf; the port's length has a zero gradient there), the entry is left
out and the NaNs are counted, so a new one fails the test.  The JAX
reference runs op by op (`jax.disable_jit`), as tests/test_torch_sdf.py
does: compiled, XLA's CPU compiler contracts a*b+c into FMAs (the cone
sampler's 1 - r_y * r_y toward a small light, the march's o + d t),
which moves the samples the gradient depends on by more than 1e-4.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu import rng as jrng
from raytracer0_tpu.models import camera as jcam
from raytracer0_tpu.models import materials as jmat
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.models.dsl import parse_scene as jparse
from raytracer0_tpu.models.scene import SceneBuilder as JBuilder
from raytracer0_tpu.ops import noise as jnoise
from raytracer0_tpu.ops import sdf as jsdf
from raytracer0_tpu.render import integrator as jint
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.models import materials as tmat
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models.dsl import parse_scene as tparse
from raytracer0_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracer0_tpu_torch.ops import megakernel as tmk
from raytracer0_tpu_torch.ops import noise as tnoise
from raytracer0_tpu_torch.render import integrator as tint

from test_torch_materials_env import CONFIG2, dir_scene
from test_torch_texture_scenes import SCENE_VIEWS

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GRAD_TOL = 1e-4
BASE = ("pos", "joker", "color", "emission")
TEX = ("tex_params", "tex_cmask", "tex_emask")


def _case(name):
    """(jax scene, jax camera, jax cfg, torch scene, leaves, NaN counts of
    the JAX gradient) of a named case."""
    if name == "config2":
        js, ts = jparse(CONFIG2), tparse(CONFIG2, device="cpu")
        jc = jcam.Camera.make(origin=(0, 0, 1.99), lookat=(0, 0, -1), fov=60.0)
        cfg = jpresets.cornell_default(use_mis=True, use_procedural_sky=False)[2]
        return js, jc, cfg.replace(max_bounces=3), ts, BASE + ("ior",), {}
    if name == "mis_demo":
        js, jc, cfg = jpresets.mis_demo()
        ts = tpresets.mis_demo(device="cpu")[0]
        nans = {"pos": 18, "joker": 8, "ro": 45, "rd": 45}
        return js, jc, cfg.replace(max_bounces=2, marching_steps=16), ts, BASE, nans
    if name == "dir":
        js, ts = dir_scene(JBuilder), dir_scene(TBuilder, device="cpu")
        jc = jcam.Camera.make(origin=(0.0, 0.3, 2.0), lookat=(0.0, -0.6, -1.0))
        return js, jc, jpresets.cornell_default(max_bounces=2)[2], ts, BASE, {}
    if name == "uniform":
        js, jc, cfg = jpresets.cornell_default(use_mis=True, use_biased_sampling=False)
        ts = tpresets.cornell_default(device="cpu")[0]
        return js, jc, cfg.replace(max_bounces=2), ts, BASE, {}
    if name == "cubemap_demo":
        js, jc, cfg = jpresets.cubemap_demo()
        ts = tpresets.cubemap_demo(device="cpu")[0]
        return js, jc, cfg.replace(max_bounces=2), ts, BASE, {}
    if name in SCENE_VIEWS:   # procedural textures: CHECK, RIPPLE, the noises
        make, (origin, lookat, fov), kw = SCENE_VIEWS[name]
        js, ts = make(JBuilder, jmat), make(TBuilder, tmat, device="cpu")
        jc = jcam.Camera.make(origin=origin, lookat=lookat, fov=fov)
        cfg = jpresets.OFFLINE_CONFIG.replace(**kw)
        bounces = 2 if name == "check_sphere" else 1
        return js, jc, cfg.replace(max_bounces=bounces), ts, BASE + TEX, {}
    # cornell_box (a textured light, whose texel NEE's shadow rays blend into
    # its color; glass), textured_gloss (a texel that colors and steers a
    # SPEC bounce)
    js, jc, cfg = getattr(jpresets, name)()
    ts = getattr(tpresets, name)(device="cpu")[0]
    bounces = 3 if name == "cornell_box" else 2   # into the glass sphere and out
    return js, jc, cfg.replace(max_bounces=bounces), ts, BASE + ("ior",) + TEX, {}


CASES = ["config2", "mis_demo", "dir", "uniform", "cubemap_demo", "cornell_box",
         "textured_gloss", "procedural", "check_sphere", "gradient_noise"]


@pytest.mark.parametrize("name", CASES)
def test_plain_grad_matches_jax_wide(name, monkeypatch):
    """d sum(trace * w) / d(scene table leaves, ro, rd) at 8x16 (seeded
    weights w): the port's plain autograd against jax.grad, on each scene
    class of K2's wide copy, per leaf within 1e-4 relative."""
    h, w = 8, 16
    js, jc, cfg, ts, leaves, nans = _case(name)
    # remat_bounces steers JAX's autodiff memory alone; off, its op-by-op
    # trace compiles each op once (the port reads no such field)
    cfg = cfg.replace(remat_bounces=False)
    assert tmk.unsupported_bwd(ts, cfg) is None and not tmk.cornell_copy(ts, cfg)
    ro, rd = (np.asarray(a) for a in jcam.generate_rays(jc, h, w, 1))
    wt = np.random.default_rng(3).uniform(0.5, 1.5, (h, w, 3)).astype(np.float32)
    jpix, tpix = jrng.pixel_ids(h, w), trng.pixel_ids(h, w)

    def jtrace(*args):
        s = js.replace(**dict(zip(leaves, args[:-2])))
        return jint.trace(s, cfg, args[-2], args[-1], jpix, 1, 0,
                          sdf_march=jsdf.march if js.num_sdfs else None)

    if name == "gradient_noise":
        # its sin hash amplifies the ULP by which XLA's and torch's sin may
        # differ 43758x, so the packages' hashes agree in distribution only
        # (test_gradient_noise_statistical); at a hit on a lattice plane a
        # hash's component along the normal reaches the gradient and not the
        # radiance.  The hash of a lattice point carries no gradient: the
        # port takes the reference's here, and the rest is held op by op
        def jhash(p):
            return torch.from_numpy(np.array(jnoise._gradient_hash(jnp.asarray(p.detach().numpy()))))
        monkeypatch.setattr(tnoise, "_gradient_hash", jhash)
    t_leaves = {k: getattr(ts, k).detach().clone().requires_grad_(True) for k in leaves}
    o = torch.from_numpy(ro.copy()).requires_grad_(True)
    d = torch.from_numpy(rd.copy()).requires_grad_(True)
    out = tint.trace(ts.replace(**t_leaves), cfg, o, d, tpix, 1, 0)
    with jax.disable_jit():
        _, jvjp = jax.vjp(jtrace, *(getattr(js, k) for k in leaves),
                          jnp.asarray(ro), jnp.asarray(rd))
        jg = jvjp(jnp.asarray(wt))
    want = {k: np.asarray(v) for k, v in zip(leaves + ("ro", "rd"), jg)}

    got = torch.autograd.grad((out * torch.from_numpy(wt)).sum(), [*t_leaves.values(), o, d],
                              allow_unused=True)
    got = {k: (np.zeros(want[k].shape, np.float32) if g is None else g.numpy())
           for k, g in zip(leaves + ("ro", "rd"), got)}

    for k, b in want.items():
        a = got[k]
        assert a.shape == b.shape and np.isfinite(a).all(), k
        ok = np.isfinite(b)
        scale = max(np.abs(b[ok]).max(), 1e-12)
        assert np.abs(a[ok] - b[ok]).max() / scale < GRAD_TOL, \
            (k, np.abs(a[ok] - b[ok]).max(), scale)
    counted = {k: int((~np.isfinite(v)).sum()) for k, v in want.items() if not np.isfinite(v).all()}
    assert counted == nans, counted
    for k in ("color", "pos", "rd"):
        assert np.nanmax(np.abs(want[k])) > 0.0, k
    if "ior" in leaves and name != "textured_gloss":   # glass: the IOR is engaged
        assert np.abs(want["ior"]).max() > 0.0
    if name == "textured_gloss":
        assert np.abs(want["tex_cmask"]).max() > 0.0
    if name in SCENE_VIEWS:   # the divisors of CHECK and RIPPLE, the noise scales
        assert np.abs(want["tex_params"]).max() > 0.0 and np.abs(want["tex_cmask"]).max() > 0.0
