"""The plain PyTorch integrator (the plain version of K1) against the JAX
integrator and the JAX megakernel in Pallas interpret mode.

Parity contract across frameworks: at least 99 % of pixels within 1e-5
(max over RGB) — tests/test_megakernel.py:94 — and a median absolute
error below 1e-4 — tests/test_golden_cornell.py:35.  The max error is not
bounded: torch's and XLA's CPU sin/cos/sqrt differ by one ULP on a few
percent of inputs, and a near-tie compare (u < p, t < tmin) can then send
one pixel down another path.
"""

import os

import numpy as np
import pytest
import torch

from raytracer0_tpu import rng as jrng
from raytracer0_tpu.models import camera as jcam
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.ops import megakernel as jmk
from raytracer0_tpu.render import integrator as jint
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models.dsl import parse_scene
from raytracer0_tpu_torch.models.materials import MeshType, SdfShape
from raytracer0_tpu_torch.models.scene import SceneBuilder
from raytracer0_tpu_torch.ops import megakernel as tmk
from raytracer0_tpu_torch.render import integrator as tint

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PARITY_TOL, PARITY_FRAC, MEDIAN_TOL = 1e-5, 0.99, 1e-4


def assert_parity(out, ref):
    err = np.abs(out - ref).max(axis=-1)
    assert (err < PARITY_TOL).mean() >= PARITY_FRAC, \
        f"share within {PARITY_TOL}: {(err < PARITY_TOL).mean()}, max {err.max()}"
    assert np.median(err) < MEDIAN_TOL


def _inputs(h, w, **cfg_kw):
    js, jc, jcfg = jpresets.cornell_default(use_mis=True)
    ts, _, _ = tpresets.cornell_default(device="cpu", use_mis=True)
    cfg = jcfg.replace(**cfg_kw)
    ro, rd = jcam.generate_rays(jc, h, w, 1)
    ro, rd = np.asarray(ro), np.asarray(rd)
    return js, ts, cfg, ro, rd


def _plain(ts, cfg, ro, rd, h, w, pass_idx=1):
    return tint.trace(ts, cfg, torch.from_numpy(ro.copy()),
                      torch.from_numpy(rd.copy()), trng.pixel_ids(h, w),
                      pass_idx, 0).numpy()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_mis=False),
    dict(sample_lights=False),
], ids=["nee_mis", "nee", "bsdf_only"])
def test_plain_matches_jax_integrator(kw):
    h, w = 16, 128
    js, ts, cfg, ro, rd = _inputs(h, w, max_bounces=3, **kw)
    ref = np.asarray(jint.trace(js, cfg, ro, rd, jrng.pixel_ids(h, w), 1, 0))
    out = _plain(ts, cfg, ro, rd, h, w)
    assert out.shape == (h, w, 3) and np.isfinite(out).all()
    assert_parity(out, ref)
    assert ref.max() > 0.1   # paths reach the light


def test_plain_matches_jax_megakernel_interpret():
    """Same inputs through the Pallas kernel K1, run as test_megakernel.py
    runs it on the CPU (interpret mode)."""
    h, w = 8, 128
    js, ts, cfg, ro, rd = _inputs(h, w, max_bounces=2)
    os.environ["RT0_PALLAS_INTERPRET"] = "1"
    try:
        ref = np.asarray(jmk.trace_forward(js, cfg, ro, rd,
                                           jrng.pixel_ids(h, w), 1, 0))
    finally:
        del os.environ["RT0_PALLAS_INTERPRET"]
    assert_parity(_plain(ts, cfg, ro, rd, h, w), ref)


def test_wrapper_on_cpu_runs_plain_version():
    """megakernel.trace_forward on CPU tensors is the plain version and
    launches nothing."""
    h, w = 4, 24
    _, ts, cfg, ro, rd = _inputs(h, w, max_bounces=3)
    before = tmk.LAUNCHES
    out = tmk.trace_forward(ts, cfg, torch.from_numpy(ro.copy()),
                            torch.from_numpy(rd.copy()), trng.pixel_ids(h, w),
                            1, 0)
    np.testing.assert_array_equal(out.numpy(), _plain(ts, cfg, ro, rd, h, w))
    assert tmk.LAUNCHES == before


def test_plain_raises_outside_the_class():
    """What the port does not render yet raises, naming its ROADMAP item:
    GRID_SDF meshes (8), spectral transport and the medium under ReSTIR
    (10), ReSTIR outside the fused kernel's class (11).  Mirrors, glass,
    coats, directional lights, cubemaps, uniform sampling, textures, SDF
    meshes of every shape (a Mandelbulb renders), spectral transport and
    the medium without ReSTIR, and ReSTIR in K6's class are inside the
    class."""
    sdf = SceneBuilder()
    sdf.add("MAT_WHITE", MeshType.PLANE, (0.0, 1.0, 0.0), (2.0,))
    sdf.add("MAT_LIGHT_4", MeshType.SPHERE, (0.0, 1.5, -1.0), (0.3,))
    sdf.add("MAT_WHITE", MeshType.SDF, (0.0, -0.5, -1.0), (0.3, 0.3, 0.3, 0.05),
            sdf_shape=SdfShape.MANDELBULB)
    bulb = sdf.build(device="cpu")
    sdf.add("MAT_WHITE", MeshType.GRID_SDF, (0.5, -0.5, -1.0), (0.3, 0.3, 0.3, 0.0))
    sdf = sdf.build(device="cpu")
    textured = parse_scene("""
        MAT_CHECK_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_LIGHT_4, SPHERE, vec3(0.0, 1.5, -1.0), vec4(0.3)
    """, device="cpu")
    _, _, cfg = tpresets.cornell_default(device="cpu")
    ro = torch.zeros(2, 2, 3)
    rd = torch.zeros(2, 2, 3)
    rd[..., 2] = -1.0
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        tint.trace(sdf, cfg, ro, rd, trng.pixel_ids(2, 2), 0, 0)
    assert tint.unsupported(bulb, cfg) is None
    assert bool(torch.isfinite(tint.trace(bulb, cfg, ro, rd, trng.pixel_ids(2, 2), 0, 0)).all())
    assert tint.unsupported(textured, cfg) is None
    assert tint.trace(textured, cfg, ro, rd, trng.pixel_ids(2, 2), 0, 0).shape == (2, 2, 3)
    ts, _, _ = tpresets.cornell_default(device="cpu")
    for kw, item in [(dict(use_restir=True, use_mis=True), "11"),
                     (dict(use_restir=True, use_spectral=True), "10"),
                     (dict(use_restir=True, use_volumetrics=True), "10")]:
        assert f"item {item}" in tint.unsupported(ts, cfg.replace(**kw))
    assert tint.unsupported(ts, cfg) is None
    for kw in (dict(use_spectral=True), dict(use_volumetrics=True)):
        assert tint.unsupported(ts, cfg.replace(**kw)) is None
    for name in ("mis_demo", "restir_demo", "restir_stress"):
        preset, _, pcfg = getattr(tpresets, name)(device="cpu")
        assert tint.unsupported(preset, pcfg) is None
    mirror = parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_LIGHT_4, SPHERE, vec3(0.0, 1.5, -1.0), vec4(0.3)
        MAT_MIRROR, SPHERE, vec3(0.6, -0.6, -0.5), vec4(0.4)
    """, device="cpu")
    assert tint.unsupported(mirror, cfg) is None
    for kw in (dict(use_cubemap=True, use_procedural_sky=False),
               dict(use_biased_sampling=False)):
        assert tint.unsupported(ts, cfg.replace(**kw)) is None
