"""The plain ReSTIR gradient over the whole SDF class and blended textures
against `jax.grad`.

The plain version of K7 (both its copies) is `torch.autograd` through
`ops/restir.render_sample`.  Here it is held against `jax.grad` of the JAX
`render_sample` (raytracer0_tpu/ops/restir.py:643), run op by op
(`jax.disable_jit`: compiled XLA contracts FMAs, tests/test_torch_restir.py),
on the scenes K7's whole-SDF copy serves: `animated_restir` as shipped (its
METAL texture blended into the emission of its rounded box), ANIMATED at
the frame time 0.37, the `mandelbulb` and `polygons` ReSTIR views
(`presets.restir_sdf_view`) and `textured_restir_demo` (a CHECK texture
blended into a wall's color).  Each test runs one JAX pass on a ring the
port's plain passes fill, which both packages read: pass 3 on the ring of
passes 0-2 (candidates, temporal and spatial reuse) for the two presets,
pass 1 on the ring of pass 0 for the views, at 8x16 with one bounce (two
on `textured_restir_demo`).  The `every_shape` view is not held here:
jax.grad is NaN in all 33 pos entries of its SDF rows, in the 21 aux
entries of its triangle's and quad's vertices and in 22 joker entries
(the reservoir vertex's shadow rays march every row, the cone's and the
boxes' square roots among them), so its op-by-op vjp, about 30 s on one
core and 65 s under the suite's 8 virtual CPU devices, would hold little
beyond what the other scenes hold.  Each shape's plain gradient is held
against jax.grad in tests/test_torch_grad_sdf_scenes.py, and K7's
whole-SDF copy against the plain autograd on `every_shape` in
tests/test_torch_kernel_host_restir_sdf.py and on the card.  The loss
weighs the radiance and the new ring's float fields with seeded weights;
the leaves are every column of the scene
table (pos, joker, color, emission, ior, aux, tex_params, tex_cmask,
tex_emask).  Tolerance: per leaf, max|a - b| / max|b| below 1e-4
(tests/test_megakernel.py:128-129).

Both packages run in float32, as the kernels do.  Where `jax.grad` is NaN
the entry is left out and the NaNs are counted, so a new one fails: the
reference's `vecmath.length` differentiates sqrt(0) (inside a box's core, a
rounded box's, a sponge's) and the cone its own square root, and its
`calc_normal` and march evaluate every SDF row at lanes whose hit is
elsewhere, so 0 * inf reaches the rows' pos, joker and aux
(tests/test_torch_restir_grad.py, ROADMAP §3).  The port's plain gradient
is finite everywhere.  The radiance and the new light indices are compared
first: no selection flips between the two packages on these inputs (on
the Mandelbulb, a pixel whose radiance differs by more than 1e-5 is given
a zero weight; its silhouettes flip under an ULP).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu.models import dsl as jdsl
from raytracer0_tpu.models import materials as jmat
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.ops import restir as jrestir
from raytracer0_tpu.render.state import RenderState as JState
from raytracer0_tpu.render.state import Reservoirs as JReservoirs
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.ops import restir as trestir
from raytracer0_tpu_torch.ops import restir_kernel as tk6

from test_torch_animated import FIELDS, port_camera, port_scene
from test_torch_restir_sdf import _view, port_passes, small

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GRAD_TOL = 1e-4
LEAVES = ("pos", "joker", "color", "emission", "ior", "aux", "tex_params", "tex_cmask",
          "tex_emask")
FLOATS = ("weight_sum", "m", "w", "age")
H, W = 8, 16
# case: (bounces, marching steps, the pass held on the ring of the passes
# before it, frame time, the aux and texture leaves the pass reads with a
# gradient, jax.grad's NaN entries per leaf).  One bounce (the primary
# hit's reservoir vertex and its two shadow rays) and 8 marching steps on
# the views keep the op-by-op JAX passes short; `textured_restir_demo`
# takes two, where its CHECK texture's params get a gradient.  The
# polygons hold aux.  At its second bounce `textured_restir_demo` meets
# restir_demo's NaNs in the ROUND_BOX row's pos and joker
# (tests/test_torch_restir_grad.py).
CASES = {
    "animated_restir": (1, 16, 3, 0.37, (), {}),
    "textured_restir_demo": (2, 16, 3, 0.0, ("tex_params", "tex_cmask"),
                             {"joker": 8, "pos": 15}),
    "mandelbulb": (1, 8, 1, 0.0, (), {}),
    "polygons": (1, 8, 1, 0.0, ("aux",), {}),
}


def _case(name):
    """(JAX scene, JAX camera, config) of a case, built by JAX's builder."""
    if name == "animated_restir":
        return jpresets.animated_restir()
    if name == "textured_restir_demo":
        # the port's preset: restir_demo with a CHECK texture on its back wall
        back_wall = "MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0)"
        text = tpresets._RESTIR_9_LIGHTS.replace(
            back_wall, "MAT_CHECK_WHITE, PLANE, vec3(0.0, 0.0, 1.0)")
        _, jc, cfg = jpresets.restir_demo()
        return jdsl.parse_scene(text, sdf_shapes=[jmat.SdfShape.ROUND_BOX]), jc, cfg
    return _view(name)


def _weights():
    """Seeded weights: the radiance, then the new ring's float fields."""
    r = np.random.default_rng(7)
    return (r.uniform(0.5, 1.5, (H, W, 3)).astype(np.float32),
            [r.uniform(0.5, 1.5, (H, W)).astype(np.float32) for _ in FLOATS])


@pytest.mark.parametrize("name", list(CASES))
def test_plain_restir_gradient_matches_jax(name):
    """d(weighted pass and new ring) / d(every table leaf) of the plain
    `render_sample` against `jax.grad` of JAX's, both reading the port's
    ring: per leaf within 1e-4 relative, JAX's NaN entries counted and left
    out; the leaves the scene reads engaged, and the port's plain version
    the class of K7's whole-SDF copy."""
    bounces, steps, pass_idx, t, reads, nans = CASES[name]
    js, jc, jcfg = _case(name)
    cfg = small(jcfg, max_bounces=bounces, marching_steps=steps)
    scene, cam = port_scene(js), port_camera(jc)
    if name == "textured_restir_demo":
        ts = tpresets.textured_restir_demo(device="cpu")[0]
        assert all(torch.equal(getattr(ts, k), getattr(scene, k)) for k in LEAVES)
    assert tk6.unsupported_restir_bwd(scene, cfg) is None and tk6.bwd_copy(scene) == "whole_sdf"
    state = port_passes(scene, cfg, cam, pass_idx, lambda p: t, h=H, w=W)
    ct, cw = _weights()
    ring = {g: JReservoirs(**{k: jnp.asarray(getattr(getattr(state, g), k).numpy())
                              for k in FIELDS})
            for g in ("restir_back", "restir_hist1", "restir_hist2")}
    jstate = JState.create(H, W).replace(**ring)

    def run(leaves):
        rad, nb = jrestir.render_sample(js.replace(**leaves), cfg, jc, jstate, H, W,
                                        jnp.uint32(pass_idx), jnp.float32(t))
        return (rad, tuple(getattr(nb, k) for k in FLOATS)), nb.light_index

    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in LEAVES}
    rad, new = trestir.render_sample(scene.replace(**leaves), cfg, cam, state, H, W, pass_idx, t)
    with jax.disable_jit():
        (ref, _), vjp, ref_idx = jax.vjp(run, {k: getattr(js, k) for k in LEAVES}, has_aux=True)
        # a pixel whose radiance flips between the packages (a fractal's
        # silhouette under an ULP) is left out of the loss
        flipped = np.abs(rad.detach().numpy() - np.asarray(ref)).max(-1) > 1e-5
        wt = ct * ~flipped[..., None]
        want = vjp((jnp.asarray(wt), tuple(jnp.asarray(c) for c in cw)))[0]
    print(f"{name}: {int(flipped.sum())} pixels flipped")
    assert flipped.mean() <= (0.03 if name == "mandelbulb" else 0.0)
    agree = new.light_index.numpy() == np.asarray(ref_idx)
    assert agree.mean() >= (0.97 if name == "mandelbulb" else 1.0)
    loss = (rad * torch.from_numpy(wt)).sum() + sum(
        (getattr(new, k) * torch.from_numpy(c)).sum() for k, c in zip(FLOATS, cw))
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    got = {k: (torch.zeros_like(leaves[k]) if g is None else g).numpy()
           for k, g in zip(LEAVES, got)}
    want = {k: np.asarray(v) for k, v in want.items()}
    counted = {k: int((~np.isfinite(v)).sum()) for k, v in want.items() if not np.isfinite(v).all()}
    print(f"{name}: jax.grad NaN entries {counted}")
    for k in LEAVES:
        a, b = got[k], want[k]
        assert a.shape == b.shape and np.isfinite(a).all(), k
        ok = np.isfinite(b)
        scale = max(np.abs(b[ok]).max(initial=0.0), 1e-12)
        err = np.abs(a[ok] - b[ok]).max(initial=0.0) / scale
        print(f"  {k}: {err:.2e} of {scale:.3e}")
        assert err < GRAD_TOL, (k, err, scale)
    assert counted == nans, counted
    for k in ("pos", "color", "emission") + reads:
        assert np.nanmax(np.abs(want[k])) > 0.0 and np.abs(got[k]).max() > 0.0, k
