"""Gradients through ReSTIR in the port against the JAX package.

The plain version of the adjoint kernel K7 is `torch.autograd` through
`ops/restir.render_sample` (and through `optimize.render_linear`, which
threads the reservoir ring through its passes); it is held against
`jax.grad` of the JAX `render_sample` and `render_linear` on `restir_demo`
at 8x32 with 2 bounces, 4 candidates and 16 marching steps.  The JAX
references run op by op (`jax.disable_jit`): compiled, XLA contracts
a*b + c into FMAs, which the port and its kernels do not
(tests/test_torch_restir.py).  Tolerance: per leaf, max|a - b| / max|b| <
1e-4, the gradient contract of tests/test_megakernel.py:128-129; no
selection flips between the two on these inputs (the per-pass radiance and
light indices are compared first).  The JAX runs are shared through module
fixtures.

Then the port's own checks of the same path: the emission finite-difference
linearity of tests/test_restir.py:183-216, `render_linear` against explicit
ring threading and against per-light NEE (tests/test_optimize.py:11-40),
and a CPU `fit` through the ring.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu import optimize as jopt
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.ops import restir as jrestir
from raytracer0_tpu.render.state import RenderState as JState
from raytracer0_tpu.render.state import Reservoirs as JReservoirs
from raytracer0_tpu_torch import optimize as topt
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.ops import restir as trestir
from raytracer0_tpu_torch.render.renderer import render_pass
from raytracer0_tpu_torch.render.state import RESERVOIR_FIELDS, RenderState, Reservoirs

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

H, W = 8, 32
PASS = 3                      # temporal reuse runs from pass 3
GRAD_TOL = 1e-4               # tests/test_megakernel.py:128-129
SCENE_LEAVES = ("emission", "color", "pos", "joker", "ior")
FLOATS = ("weight_sum", "m", "w", "age")
GRIDS = ("restir_back", "restir_hist1", "restir_hist2")


def _cfg(cfg):
    # remat_bounces only steers JAX's autodiff memory; the port reads no such field
    return cfg.replace(max_bounces=2, max_diff_bounces=2, restir_samples=4,
                       marching_steps=16, remat_bounces=False)


def _weights():
    """Seeded cotangent weights: the radiance, then the new ring's floats."""
    r = np.random.default_rng(11)
    return (r.uniform(0.5, 1.5, (H, W, 3)).astype(np.float32),
            [r.uniform(0.5, 1.5, (H, W)).astype(np.float32) for _ in FLOATS])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _assert_close(got, want):
    """Per leaf within GRAD_TOL relative, the port's gradient finite
    everywhere.  Where the JAX gradient is NaN, it is left out (see
    `test_render_sample_gradient_matches_jax`)."""
    for k, b in want.items():
        a = np.asarray(got[k])
        assert np.isfinite(a).all(), k
        ok = np.isfinite(b)
        assert _rel(a[ok], b[ok]) < GRAD_TOL, (k, _rel(a[ok], b[ok]))


@pytest.fixture(scope="module")
def jax_linear():
    """JAX render_linear(passes=4) on restir_demo, op by op, and jax.grad
    of a weighted sum of it w.r.t. emission and pos."""
    js, jc, cfg = jpresets.restir_demo()
    cfg = _cfg(cfg)
    ct, _ = _weights()

    def loss(em, pos):
        img = jopt.render_linear(js.replace(emission=em, pos=pos), cfg, jc, H, W, passes=4)
        return jnp.sum(img * ct), img

    with jax.disable_jit():
        (_, img), (g_em, g_pos) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            js.emission, js.pos)
    return np.asarray(img), {"emission": np.asarray(g_em), "pos": np.asarray(g_pos)}


def test_render_linear_gradient_matches_jax(jax_linear):
    """(b) `optimize.render_linear(passes=4)` through the reservoir ring on
    the CPU against JAX's, image and d(weighted image) / d(emission, pos):
    the gradient flows through the ring from pass to pass on both sides."""
    ref_img, want = jax_linear
    scene, cam, cfg = tpresets.restir_demo(device="cpu")
    ct, _ = _weights()
    em = scene.emission.clone().requires_grad_(True)
    pos = scene.pos.clone().requires_grad_(True)
    img = topt.render_linear(scene.replace(emission=em, pos=pos), _cfg(cfg), cam, H, W, passes=4)
    assert np.abs(img.detach().numpy() - ref_img).max() < 1e-5
    got = torch.autograd.grad((img * torch.from_numpy(ct)).sum(), [em, pos])
    _assert_close({"emission": got[0].numpy(), "pos": got[1].numpy()}, want)


@pytest.fixture(scope="module")
def warm_ring():
    """The port's ring after passes 0-2 on restir_demo, as numpy arrays
    {grid: {field: array}}; both frameworks read the same one."""
    scene, cam, cfg = tpresets.restir_demo(device="cpu")
    state = RenderState.create(H, W, "cpu")
    with torch.no_grad():
        for _ in range(PASS):
            state = render_pass(scene, cam, _cfg(cfg), state, H, W)
    return {g: {k: getattr(getattr(state, g), k).numpy().copy() for k in RESERVOIR_FIELDS}
            for g in GRIDS}


@pytest.fixture(scope="module")
def jax_pass_grads(warm_ring):
    """jax.grad of a weighted loss on pass 3 of JAX's render_sample, op by
    op, w.r.t. the scene leaves and the warm ring's float fields; and the
    pass's radiance and light indices."""
    js, jc, cfg = jpresets.restir_demo()
    cfg = _cfg(cfg)
    ct, cw = _weights()
    ring = [{k: jnp.asarray(warm_ring[g][k]) for k in FLOATS} for g in GRIDS]
    fixed = {g: JReservoirs(**{k: jnp.asarray(v) for k, v in warm_ring[g].items()})
             for g in GRIDS}

    def run(leaves, ring):
        grids = {g: fixed[g].replace(**ring[i]) for i, g in enumerate(GRIDS)}
        state = JState.create(H, W).replace(**grids)
        return jrestir.render_sample(js.replace(**leaves), cfg, jc, state, H, W, jnp.uint32(PASS))

    def loss(leaves, ring):
        rad, nb = run(leaves, ring)
        value = jnp.sum(rad * ct) + sum(jnp.sum(getattr(nb, k) * c) for k, c in zip(FLOATS, cw))
        return value, (rad, nb.light_index)

    leaves = {k: getattr(js, k) for k in SCENE_LEAVES}
    with jax.disable_jit():
        (_, (rad, idx)), (g_leaves, g_ring) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(leaves, ring)
    grads = {k: np.asarray(v) for k, v in g_leaves.items()}
    for i, g in enumerate(GRIDS):
        grads.update({f"{g}.{k}": np.asarray(v) for k, v in g_ring[i].items()})
    return grads, np.asarray(rad), np.asarray(idx)


def test_render_sample_gradient_matches_jax(warm_ring, jax_pass_grads):
    """(a) Plain autograd of `restir.render_sample` on pass 3 of
    restir_demo on a warm ring against jax.grad of the JAX render_sample:
    the scene's emission, color, pos, joker and ior and the ring's
    weight_sum, m, w and age (back, hist1, hist2) for seeded weights on the
    radiance and the new ring's floats.  The ring's light data is a
    constant on both sides.

    jax.grad gives NaN in 7 of joker's 72 entries and 12 of pos's 54, the
    ROUND_BOX row among them: its calc_normal also evaluates the rounded
    box at the lanes whose hit is analytic, and where such a point lies in
    the box's core, the distance's sqrt(0) has an infinite derivative that
    the zero cotangent of the untaken branch turns into 0 * inf
    (jax_debug_nans: raytracer0_tpu/ops/sdf.py:43 via vecmath.length).  The
    port's gradient is finite there; the test compares the other entries
    and counts the NaNs, so a new one fails it."""
    want, ref_rad, ref_idx = jax_pass_grads
    scene, cam, cfg = tpresets.restir_demo(device="cpu")
    ct, cw = _weights()
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in SCENE_LEAVES}
    grids = {}
    for g in GRIDS:
        fields = {k: torch.from_numpy(v.copy()) for k, v in warm_ring[g].items()}
        for k in FLOATS:
            fields[k].requires_grad_(True)
        grids[g] = Reservoirs(**fields)
    state = RenderState.create(H, W, "cpu").replace(**grids)
    rad, new = trestir.render_sample(scene.replace(**leaves), _cfg(cfg), cam, state, H, W, PASS)
    # the same decisions: no selection flips between the frameworks here
    np.testing.assert_array_equal(new.light_index.numpy(), ref_idx)
    assert np.abs(rad.detach().numpy() - ref_rad).max() < 1e-5
    loss = (rad * torch.from_numpy(ct)).sum() + sum(
        (getattr(new, k) * torch.from_numpy(c)).sum() for k, c in zip(FLOATS, cw))
    order = list(leaves.values()) + [getattr(grids[g], k) for g in GRIDS for k in FLOATS]
    got = torch.autograd.grad(loss, order, allow_unused=True)
    names = list(SCENE_LEAVES) + [f"{g}.{k}" for g in GRIDS for k in FLOATS]
    got = {n: (torch.zeros_like(t) if v is None else v).numpy()
           for n, t, v in zip(names, order, got)}
    _assert_close(got, want)
    assert {k: int((~np.isfinite(v)).sum()) for k, v in want.items() if not np.isfinite(v).all()} \
        == {"joker": 7, "pos": 12}
    for k in ("emission", "color", "pos", "restir_hist1.m", "restir_hist1.w"):
        assert np.nanmax(np.abs(want[k])) > 0.0, k


def test_emission_gradient_matches_finite_differences():
    """(c) tests/test_restir.py:183-216 on the port: scaling every light's
    emission by s scales the candidate weights, target values and shading
    linearly and leaves the selections and W unchanged, so the radiance is
    linear in s and d loss / ds equals the central difference and loss(1)
    itself, through passes 0-4 of render_linear."""
    scene, cam, cfg = tpresets.restir_demo(device="cpu")
    cfg = _cfg(cfg)
    h = w = 16
    lmask = (scene.mat_type == 0).float()[:, None]

    def loss(s):
        em = scene.emission * (1.0 + (s - 1.0) * lmask)
        return topt.render_linear(scene.replace(emission=em), cfg, cam, h, w, passes=5).sum()

    s = torch.tensor(1.0, requires_grad=True)
    value = loss(s)
    g = torch.autograd.grad(value, s)[0].item()
    eps = 0.05
    with torch.no_grad():
        fd = (loss(torch.tensor(1.0 + eps)).item() - loss(torch.tensor(1.0 - eps)).item()) / (2 * eps)
    assert np.isfinite(g) and g > 0.0
    assert abs(g - fd) <= 0.10 * abs(fd), (g, fd)
    # and loss(1) itself, up to the clamps that break the scaling (a
    # contribution's 200, the validity bounds): 0.11 % here
    assert abs(g - value.item()) <= 1e-2 * abs(value.item()), (g, value.item())


def test_render_linear_engages_restir():
    """(d) tests/test_optimize.py:11-40 on the port: with use_restir,
    render_linear equals explicit render_sample ring threading, differs
    from the per-light NEE render, and its gradient is finite and nonzero."""
    scene, cam, cfg = tpresets.restir_demo(device="cpu")
    cfg = _cfg(cfg)
    h = w = 16
    got = topt.render_linear(scene, cfg, cam, h, w, passes=2)
    state = RenderState.create(h, w, "cpu")
    total = torch.zeros((h, w, 3))
    for p in range(2):
        rad, new = trestir.render_sample(scene, cfg, cam, state, h, w, p)
        state = state.rotate_reservoirs(new)
        total = total + rad
    assert torch.equal(got, total / 2)
    nee = topt.render_linear(scene, cfg.replace(use_restir=False), cam, h, w, passes=2)
    assert (got - nee).abs().max().item() > 1e-4
    em = scene.emission.clone().requires_grad_(True)
    g = torch.autograd.grad(topt.render_linear(scene.replace(emission=em), cfg, cam, h, w,
                                               passes=2).sum(), em)[0]
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())


def test_fit_through_restir_lowers_the_loss():
    """(e) `optimize.fit` of the lights' emission on restir_demo through the
    reservoir ring (2 passes per step) on the CPU at 8x8: the loss falls."""
    scene, cam, cfg = tpresets.restir_demo(device="cpu")
    cfg = _cfg(cfg)
    target = topt.render_linear(scene, cfg, cam, 8, 8, passes=2)
    is_light = (scene.mat_type == 0).float()[:, None]
    start = scene.replace(emission=scene.emission * (1.0 + 0.6 * is_light))
    fitted, losses = topt.fit(start, cfg, cam, target, ("emission",), steps=4,
                              learning_rate=0.3, passes=2, param_mask={"emission": is_light})
    assert len(losses) == 4 and losses[-1] < losses[0], losses
    assert torch.equal(fitted.emission[~is_light[:, 0].bool()],
                       scene.emission[~is_light[:, 0].bool()])
