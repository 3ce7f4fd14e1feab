"""The split ReSTIR path (`ops/restir_split.py`: the G-buffer kernel K4, the
reservoir phases, the ray-cast kernel K5) and the ad-hoc temporal
reprojection against the JAX package, on the same inputs.

* the plain `restir.render_sample` with `restir_adhoc_motion` under STATIC
  and ANIMATED accumulation against JAX's `render_sample`, passes 0-3 at a
  moving frame time (temporal reuse, and so the reprojection, is live from
  pass 3), each pass fed the JAX ring, under tests/test_torch_restir.py's
  pass contract;
* the port's `render_sample_fast` with the plain K4 and K5 against JAX's
  `render_sample` on the same rings, under JAX's fast-versus-wavefront
  contract (max 5e-3, median 1e-6, tests/test_restir.py:284-310);
* the plain K4 (`integrator.trace` with `gbuffer_slots`) against JAX's
  `trace_forward_gbuffer` in Pallas interpret mode at one 8x128 block and 2
  bounces (the size tests/test_restir.py:284 runs);
* the gates: K4's is the JAX `supported_restir`, K6 refuses the ad-hoc
  reprojection naming K4 and K5, K7 admits ANIMATED, a gradient through the
  split path is refused on the card.

JAX runs op by op (`jax.disable_jit`): compiled XLA contracts FMAs.
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
from raytracer0_tpu.ops import megakernel as jmk
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.config import RenderMode
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.ops import restir as trestir
from raytracer0_tpu_torch.ops import restir_kernel as tk6
from raytracer0_tpu_torch.ops import restir_split as tsplit
from raytracer0_tpu_torch.render.state import RenderState

from test_torch_animated import (H, W, jax_realtime_scene, jax_restir_passes, pass_contract,
                                 port_camera, port_ring, port_scene, restir_cfg)

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

T = torch.from_numpy
MODES = {"static": RenderMode.STATIC, "animated": RenderMode.ANIMATED}


def adhoc_cfg(mode):
    return restir_cfg(restir_adhoc_motion=True, render_mode=MODES[mode])


@pytest.fixture(scope="module")
def adhoc_passes():
    """{mode: JAX render_sample passes 0-3 with the ad-hoc reprojection}."""
    return {mode: jax_restir_passes(adhoc_cfg(mode)) for mode in MODES}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("p", range(4))
def test_render_sample_adhoc_matches_jax(adhoc_passes, mode, p):
    """The plain render_sample with the ad-hoc reprojection (jitter draw,
    border gate, history gathered at the reprojected pixel) against JAX's,
    pass p at the frame time p/30, on the JAX ring of that pass."""
    state, ref_rad, ref_new = adhoc_passes[mode][p]
    js, jc = jax_realtime_scene()
    rad, new = trestir.render_sample(port_scene(js), adhoc_cfg(mode), port_camera(jc),
                                     port_ring(state, H, W), H, W, p, p / 30)
    pass_contract(rad.numpy(), {k: v.numpy() for k, v in new.fields().items()},
                  ref_rad, ref_new)
    if p == 3:
        assert ref_new["m"].max() > 4.0   # temporal reuse has merged


@pytest.mark.parametrize("mode", list(MODES))
def test_render_sample_fast_plain_matches_jax(adhoc_passes, mode):
    """`render_sample_fast` on the CPU (the plain K4 and K5, the reservoir
    phases per slot, the last valid slot's reservoir) against JAX's
    `render_sample` at passes 0-3 on the same rings, under JAX's
    fast-versus-wavefront contract; its reservoirs are the plain
    render_sample's bit for bit."""
    js, jc = jax_realtime_scene()
    scene, cam, cfg = port_scene(js), port_camera(jc), adhoc_cfg(mode)
    for p, (state, ref_rad, _) in enumerate(adhoc_passes[mode]):
        ring = port_ring(state, H, W)
        rad, new = tsplit.render_sample_fast(scene, cfg, cam, ring, H, W, p, p / 30)
        err = np.abs(rad.numpy() - ref_rad)
        assert err.max() < 5e-3 and np.median(err) < 1e-6, (p, err.max())
        _, plain_new = trestir.render_sample(scene, cfg, cam, ring, H, W, p, p / 30)
        for k, v in new.fields().items():
            assert torch.equal(v, getattr(plain_new, k)), (p, k)


def test_gbuffer_plain_matches_jax_interpret():
    """The plain K4 against JAX's `trace_forward_gbuffer` in Pallas
    interpret mode on `restir_demo` at one 8x128 block, 2 bounces: each
    slot's mesh index, depth and valid flag equal; the radiance without
    diffuse NEE under the parity contract (within 1e-5 at >= 99 % of
    pixels); position, normal and throughput within 1e-5 at >= 99.9 % of
    their values and within 1e-4 relative at all.  The Pallas kernel
    computes a bounce with its own formulas (its Mosaic workarounds), so a
    second vertex can move by a few ULPs: 2 of 3072 position values differ
    by 1.5e-5 (1.4e-4 of their size), op by op as compiled."""
    js, jc, cfg = jpresets.restir_demo()
    cfg = cfg.replace(max_bounces=2, max_diff_bounces=2, restir_samples=4, marching_steps=16,
                      remat_bounces=False)
    h, w = 8, 128
    ro, rd = jcam.generate_rays(jc, h, w, 1)
    pix = jrng.pixel_ids(h, w)
    os.environ["RT0_PALLAS_INTERPRET"] = "1"
    try:
        ref, ref_gbuf = jmk.trace_forward_gbuffer(js, cfg, ro, rd, pix, 1, 0)
    finally:
        del os.environ["RT0_PALLAS_INTERPRET"]
    scene = port_scene(js)
    rad, gbuf = tsplit.trace_forward_gbuffer(scene, cfg, T(np.array(ro)), T(np.array(rd)),
                                             trng.pixel_ids(h, w), 1, 0)
    assert len(gbuf) == len(ref_gbuf) == tsplit.gbuffer_slots(cfg)
    err = np.abs(rad.numpy() - np.asarray(ref)).max(axis=-1)
    assert (err < 1e-5).mean() >= 0.99 and np.median(err) < 1e-4, err.max()
    for k, (got, want) in enumerate(zip(gbuf, ref_gbuf)):
        for f in ("idx", "depth", "valid"):
            np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]), err_msg=f"{k} {f}")
        for f in ("pos", "nl", "mask"):
            a, b = got[f].numpy(), np.asarray(want[f])
            assert (np.abs(a - b) <= 1e-5).mean() >= 0.999, (k, f)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=f"{k} {f}")
    assert np.asarray(ref_gbuf[1]["valid"]).any()


def _jax_scene(name):
    if name == "realtime":
        return jax_realtime_scene()[0], jpresets.animated_restir()[2]
    return getattr(jpresets, name)()[::2]


@pytest.mark.parametrize("name,kw", [
    ("restir_demo", {}), ("restir_demo", dict(restir_adhoc_motion=True)),
    ("restir_stress", {}), ("realtime", dict(restir_adhoc_motion=True)),
    ("realtime", dict(restir_adhoc_motion=True, render_mode=RenderMode.STATIC)),
    ("restir_demo", dict(use_restir=False)), ("restir_demo", dict(use_biased_sampling=False)),
    ("cornell_default", dict(use_restir=True, use_mis=True)),
    ("cubemap_demo", dict(use_restir=True)),
])
def test_gbuffer_gate_is_supported_restir(name, kw):
    """K4's gate admits exactly what the JAX `supported_restir` admits
    (megakernel.py:545-560), scene for scene."""
    js, cfg = _jax_scene(name)
    cfg = cfg.replace(**kw)
    assert (tsplit.unsupported_gbuffer(port_scene(js), cfg) is None) == \
        bool(jmk.supported_restir(js, cfg))


def test_split_gate_after_fault_11():
    """On the card the split path refuses, before any launch, the class no
    test holds K4 and K6v's split form to, as K6 does: a cubemap under
    ReSTIR with the ad-hoc reprojection, naming ROADMAP queue 1 item 11,
    though K4's own gate admits it.  Blended textures it admits since K4
    and K6v's split form were held on them.  The CPU route (the plain
    G-buffer and caster) renders both."""
    scene, cam, cfg = tpresets.restir_demo(device="cpu")
    adhoc = cfg.replace(restir_adhoc_motion=True)
    state = RenderState.create(4, 8, "cpu")
    tsplit.check_split(scene, adhoc, cam, state)
    textured = tpresets.textured_restir_demo(device="cpu")[0]
    cube = adhoc.replace(use_cubemap=True, use_procedural_sky=False)
    assert tsplit.unsupported_gbuffer(textured, adhoc) is None
    assert tsplit.unsupported_gbuffer(scene, cube) is None
    tsplit.check_split(textured, adhoc, cam, state)
    with pytest.raises(NotImplementedError, match="cubemap.*item 11"):
        tsplit.check_split(scene, cube, cam, state)
    small = dict(max_bounces=2, marching_steps=8)
    for sc, c in ((textured, adhoc), (scene, cube)):
        rad, _ = tsplit.render_sample_fast(sc, c.replace(**small), cam, state, 4, 8, 0)
        assert rad.shape == (4, 8, 3) and bool(torch.isfinite(rad).all())


def test_split_gates():
    """K6 refuses the ad-hoc reprojection itself and names the split path;
    K7 admits ANIMATED (its reverse sweep takes the animated fades); a
    gradient through the split path, or a scene outside K4's class, is
    refused before any launch (`check_split`, which `render_sample_fast`
    runs on the card); on the CPU the split pass is differentiable."""
    scene, cam, cfg = tpresets.animated_untextured(device="cpu")
    adhoc = cfg.replace(restir_adhoc_motion=True)
    reason = tk6.unsupported_restir(scene, adhoc)
    assert "ad-hoc" in reason and "K4" in reason and "item 11" in reason
    assert tk6.unsupported_restir_bwd(scene, cfg) is None
    state = RenderState.create(4, 8, "cpu")
    tsplit.check_split(scene, adhoc, cam, state)
    em = scene.emission.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no adjoint.*K6 and K7"):
        tsplit.check_split(scene.replace(emission=em), adhoc, cam, state)
    warm = state.replace(restir_hist1=state.restir_hist1.__class__(
        **dict(state.restir_hist1.fields(), m=torch.zeros(4, 8, requires_grad=True))))
    with pytest.raises(NotImplementedError, match="no adjoint"):
        tsplit.check_split(scene, adhoc, cam, warm)
    with pytest.raises(NotImplementedError, match="uniform"):
        tsplit.check_split(scene, adhoc.replace(use_biased_sampling=False), cam, state)
    rad, _ = tsplit.render_sample_fast(scene.replace(emission=em),
                                       adhoc.replace(max_bounces=2, marching_steps=8), cam,
                                       state, 4, 8, 0, 0.2)
    g = torch.autograd.grad(rad.sum(), em)[0]
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
