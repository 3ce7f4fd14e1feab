"""Port ops (vecmath, sampling, intersect, sky, lighting, tonemap)
against the JAX package on the same numpy inputs.

Tolerances: +, -, *, / and sqrt round the same in both frameworks, so
pure arithmetic agrees to a few float32 ULP (1e-6 at unit scale).
Functions that call sin, cos or pow get 1e-5: torch's and XLA's CPU
transcendentals differ by one ULP on a few percent of inputs.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer0_tpu.config import RenderConfig, TonemapOp
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.ops import intersect as jisect
from raytracer0_tpu.ops import lighting as jlight
from raytracer0_tpu.ops import sampling as jsmp
from raytracer0_tpu.ops import sky as jsky
from raytracer0_tpu.ops import tonemap as jtone
from raytracer0_tpu.ops import vecmath as jvm
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.ops import intersect as tisect
from raytracer0_tpu_torch.ops import lighting as tlight
from raytracer0_tpu_torch.ops import sampling as tsmp
from raytracer0_tpu_torch.ops import sky as tsky
from raytracer0_tpu_torch.ops import tonemap as ttone
from raytracer0_tpu_torch.ops import vecmath as tvm

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ARITH_TOL = 1e-6
TRANS_TOL = 1e-5
N = 4096


def _rand(*shape, seed=0, lo=-1.0, hi=1.0):
    r = np.random.default_rng(seed)
    return r.uniform(lo, hi, size=shape).astype(np.float32)


def _unit(n, seed):
    v = _rand(n, 3, seed=seed)
    v[:8] = [[0, 0, 1], [0, 0, -1], [0, 1e-7, 1], [1e-4, 0, -1],
             [1, 0, 0], [0, -1, 0], [0, 0, 0], [0.6, 0.8, 0]]
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-6)


def _close(a, b, tol):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)


def test_vecmath_matches_jax():
    a, b = _rand(N, 3, seed=1), _rand(N, 3, seed=2)
    a[:4] = 0.0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(tvm.vdot(ta, tb), jvm.vdot(a, b), ARITH_TOL)
    _close(tvm.safe_length(ta), jvm.safe_length(a), ARITH_TOL)
    _close(tvm.normalize(ta), jvm.normalize(a), ARITH_TOL)
    _close(tvm.safe_div(ta, tb), jvm.safe_div(a, b), ARITH_TOL * 1e3)
    _close(tvm.safe_sqrt(ta[:, 0]), jvm.safe_sqrt(a[:, 0]), ARITH_TOL)
    n = _unit(N, 3)
    for x, y in zip(tvm.onb(torch.from_numpy(n)), jvm.onb(jnp.asarray(n))):
        _close(x, y, ARITH_TOL)


def test_sampling_matches_jax():
    w = _unit(N, 4)
    u1, u2 = _rand(N, seed=5, lo=0, hi=1), _rand(N, seed=6, lo=0, hi=1)
    ext = _rand(N, seed=7, lo=0, hi=1)
    tw, t1, t2 = map(torch.from_numpy, (w, u1, u2))
    _close(tsmp.sample_biased(tw, 1.0, t1, t2),
           jsmp.sample_biased(w, 1.0, u1, u2), TRANS_TOL)
    _close(tsmp.sample_cone(tw, torch.from_numpy(ext), t1, t2),
           jsmp.sample_cone(w, ext, u1, u2), TRANS_TOL)
    _close(tsmp.power_heuristic(1.0, t1 * 4, 1.0, t2),
           jsmp.power_heuristic(1.0, u1 * 4, 1.0, u2), ARITH_TOL)
    _close(tsmp.cosine_hemisphere_pdf(tw, torch.from_numpy(_unit(N, 8))),
           jsmp.cosine_hemisphere_pdf(w, _unit(N, 8)), ARITH_TOL)
    # 1 / (1 - cos_max) magnifies one ULP of cos_max near the light:
    # relative 1e-4 (pdf values reach ~60 here)
    x = _rand(N, 3, seed=9) * 2.0
    lp = np.array([0.0, 1.4, -1.2], np.float32)
    np.testing.assert_allclose(
        tsmp.sphere_light_pdf(torch.from_numpy(lp), torch.tensor(0.3),
                              torch.from_numpy(x)).numpy(),
        np.asarray(jsmp.sphere_light_pdf(lp, np.float32(0.3), x)),
        rtol=1e-4, atol=ARITH_TOL)


def test_procedural_sky_matches_jax():
    d = _unit(N, 10)
    _close(tsky.procedural_sky(torch.from_numpy(d)), jsky.procedural_sky(d),
           TRANS_TOL)
    np.testing.assert_array_equal(tsky.default_cubemap(16),
                                  jsky.default_cubemap(16))


def _cornell_rays(n, seed):
    """Rays from inside the Cornell box in random directions."""
    ro = _rand(n, 3, seed=seed) * np.float32(0.9)
    rd = _unit(n, seed + 1)
    rd[6] = [0.3, 0.2, -0.9]   # replace the zero vector of _unit
    return ro, rd / np.linalg.norm(rd, axis=-1, keepdims=True)


def test_intersect_matches_jax():
    ts, _, cfg = tpresets.cornell_default(device="cpu")
    js, _, _ = jpresets.cornell_default()
    ro, rd = _cornell_rays(N, 11)
    th = tisect.intersect(ts, torch.from_numpy(ro), torch.from_numpy(rd), cfg)
    jh = jisect.intersect(js, jnp.asarray(ro), jnp.asarray(rd), cfg)
    np.testing.assert_array_equal(th.idx.numpy(), np.asarray(jh.idx))
    np.testing.assert_array_equal(th.missed.numpy(), np.asarray(jh.missed))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5, atol=0)
    _close(th.pos, jh.pos, 1e-5)
    _close(th.n, jh.n, ARITH_TOL)


def test_sample_lights_nee_matches_jax():
    """Sphere-cone NEE with MIS from points on the Cornell walls."""
    ts, _, cfg = tpresets.cornell_default(device="cpu", use_mis=True)
    js, _, _ = jpresets.cornell_default(use_mis=True)
    ro, rd = _cornell_rays(512, 21)
    jh = jisect.intersect(js, jnp.asarray(ro), jnp.asarray(rd), cfg)
    x = np.array(jh.pos)
    nl = -np.asarray(jh.n) * np.sign(np.sum(rd * np.asarray(jh.n), -1,
                                            keepdims=True))
    mask = _rand(512, 3, seed=22, lo=0.1, hi=1.0)
    pix = np.arange(512, dtype=np.uint32)
    ref = np.asarray(jlight.sample_lights_nee(js, cfg, x, nl, mask, pix, 2, 0, 1))
    out = tlight.sample_lights_nee(ts, cfg, torch.from_numpy(x),
                                   torch.from_numpy(nl.astype(np.float32)),
                                   torch.from_numpy(mask),
                                   trng.pixel_ids(1, 512)[0], 2, 0, 1)
    err = np.abs(out.numpy() - ref).max(-1)
    assert (err < TRANS_TOL).mean() > 0.99, err.max()
    assert ref.max() > 0.0   # some points see the light


@pytest.mark.parametrize("op", list(TonemapOp))
def test_tonemap_matches_jax(op):
    cfg = RenderConfig(tonemap=op)
    acc = _rand(64, 3, seed=30, lo=-0.5, hi=8.0)
    _close(ttone.display(torch.from_numpy(acc), 0.5, cfg),
           jtone.display(jnp.asarray(acc), 0.5, cfg), TRANS_TOL)
