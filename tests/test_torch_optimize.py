"""Inverse rendering in the port (`optimize.fit`) against the JAX package's
`optimize.fit`, and the recovery recipe of tests/test_optimize.py.

Both fits start from the same numpy arrays (the port's scene is built with
`Scene.from_arrays` from the JAX scene's leaves).  The losses and the final
parameters agree within 1e-4 relative: torch.optim.Adam and optax.adam run
the same update with the same defaults, and the renders agree to float32
rounding (tests/test_torch_grad.py).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer0_tpu import optimize as jopt
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu_torch import optimize as topt
from raytracer0_tpu_torch.models.camera import Camera
from raytracer0_tpu_torch.models.presets import cornell_default
from raytracer0_tpu_torch.models.scene import STATIC_FIELDS, TENSOR_FIELDS, Scene
from raytracer0_tpu_torch.render.renderer import render_pass
from raytracer0_tpu_torch.render.state import RenderState

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REL_TOL = 1e-4


def _port_of(js, jc):
    scene = Scene.from_arrays({k: np.asarray(getattr(js, k)) for k in TENSOR_FIELDS},
                              {k: getattr(js, k) for k in STATIC_FIELDS}, "cpu")
    cam = Camera.from_arrays({k: np.asarray(getattr(jc, k)) for k in
                              ("origin", "lookat", "fov", "aperture", "focal_length")},
                             "cpu")
    return scene, cam


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def test_fit_matches_jax_fit():
    """12x12, 2 bounces, 5 Adam steps on the light's emission and every
    color: the same losses and final parameters as the JAX fit."""
    h = w = 12
    js, jc, cfg = jpresets.cornell_default(use_mis=True)
    cfg = cfg.replace(max_bounces=2)
    ts, tc = _port_of(js, jc)
    target = np.array(jopt.render_linear(js, cfg, jc, h, w, passes=1))
    light = (np.asarray(js.mat_type) == 0)[:, None].astype(np.float32)
    em0 = np.asarray(js.emission) * (1.0 + 0.5 * light)
    col0 = np.asarray(js.color) * np.float32(0.8)

    jfit, jlosses = jopt.fit(
        js.replace(emission=jnp.asarray(em0), color=jnp.asarray(col0)), cfg, jc,
        jnp.asarray(target), ("emission", "color"), steps=5, learning_rate=0.05,
        passes=1, param_mask={"emission": jnp.asarray(light)})
    tfit, tlosses = topt.fit(
        ts.replace(emission=torch.from_numpy(em0), color=torch.from_numpy(col0)),
        cfg, tc, torch.from_numpy(target), ("emission", "color"), steps=5,
        learning_rate=0.05, passes=1,
        param_mask={"emission": torch.from_numpy(light)})

    assert len(tlosses) == len(jlosses) == 5
    assert _rel(tlosses, jlosses) < REL_TOL, (tlosses, jlosses)
    for k in ("emission", "color"):
        assert _rel(getattr(tfit, k).numpy(), getattr(jfit, k)) < REL_TOL, k
    # masked rows stay frozen, and the fit moved the free ones
    np.testing.assert_array_equal(tfit.emission.numpy()[light[:, 0] == 0],
                                  em0[light[:, 0] == 0])
    assert tlosses[-1] < tlosses[0]


def test_fit_recovers_light_emission():
    """tests/test_optimize.py:49-74 on the port: perturb the light's
    emission, fit it back; the loss drops by >10x and the emission lands
    within 10 % of the truth, other rows untouched."""
    scene, cam, cfg = cornell_default(device="cpu")
    cfg = cfg.replace(max_bounces=2, samples_per_pass=1)
    h = w = 24
    target = topt.render_linear(scene, cfg, cam, h, w, passes=2)

    is_light = scene.mat_type.numpy() == 0
    mask = torch.from_numpy(is_light[:, None].astype(np.float32))
    true_em = scene.emission.numpy().copy()
    start = scene.replace(emission=scene.emission * (1.0 + 0.6 * mask))
    fitted, losses = topt.fit(start, cfg, cam, target, ("emission",), steps=60,
                              learning_rate=0.08, passes=2,
                              param_mask={"emission": mask})

    assert losses[-1] < losses[0] / 10.0, (losses[0], losses[-1])
    np.testing.assert_allclose(fitted.emission.numpy()[is_light],
                               true_em[is_light], rtol=0.10)
    np.testing.assert_array_equal(fitted.emission.numpy()[~is_light],
                                  true_em[~is_light])


def test_render_linear_restir_not_ported():
    """render_linear with use_restir, which raised before the ReSTIR
    gradient path was ported, now threads the reservoir ring through its
    passes on the CPU: it equals explicit render_pass threading, differs
    from per-light NEE, and its gradient w.r.t. emission is finite and
    nonzero (tests/test_torch_restir_grad.py holds it against JAX)."""
    scene, cam, cfg = cornell_default(device="cpu")
    cfg = cfg.replace(use_restir=True, max_bounces=2, restir_samples=4)
    em = scene.emission.clone().requires_grad_(True)
    img = topt.render_linear(scene.replace(emission=em), cfg, cam, 4, 4, passes=2)
    state = RenderState.create(4, 4, "cpu")
    with torch.no_grad():
        for _ in range(2):
            state = render_pass(scene, cam, cfg, state, 4, 4)
    assert torch.equal(img.detach(), state.accum / 2)
    nee = topt.render_linear(scene, cfg.replace(use_restir=False), cam, 4, 4, passes=2)
    assert (img.detach() - nee).abs().max().item() > 1e-4
    g = torch.autograd.grad(img.sum(), em)[0]
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
