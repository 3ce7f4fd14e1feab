"""The port's whole slice (rays → trace → accumulate → tonemap) against the
JAX Renderer, the CPU/CUDA routing, and the import boundary.

Renderer parity uses the contract of tests/test_golden_cornell.compare:
median absolute error below 1e-4 and at least 99 % of pixels within 2e-3.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer0_tpu.config import RenderMode, TonemapOp
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.render import renderer as jren
from raytracer0_tpu.render.state import RenderState as JState
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models.dsl import parse_scene
from raytracer0_tpu_torch.ops import megakernel as tmk
from raytracer0_tpu_torch.render import renderer as tren
from raytracer0_tpu_torch.render.state import RenderState as TState

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

H = W = 24
PASSES = 2
REPO = Path(__file__).resolve().parents[1]


def test_renderer_matches_jax_renderer():
    js, jc, cfg = jpresets.cornell_default(use_mis=True)
    ts, tc, _ = tpresets.cornell_default(device="cpu", use_mis=True)
    cfg = cfg.replace(max_bounces=3)
    jr = jren.Renderer(js, jc, cfg, H, W)
    tr = tren.Renderer(ts, tc, cfg, H, W)
    for _ in range(PASSES):
        jr.step()
        tr.step()
    assert tr.state.passes == PASSES
    ref = np.asarray(jr.state.accum) / PASSES
    dev = tr.state.accum.numpy() / PASSES
    err = np.abs(dev - ref).max(axis=-1)
    assert np.median(err) < 1e-4, np.median(err)
    assert (err < 2e-3).mean() >= 0.99
    assert dev.mean() > 0.01
    # the display image of the whole slice
    np.testing.assert_allclose(tr.image().numpy(), np.asarray(jr.image()),
                               rtol=0, atol=2e-3)


@pytest.mark.parametrize("op", list(TonemapOp))
def test_display_image_matches_jax(op):
    """Tonemapped image of the same accumulator (1e-5: pow rounds
    differently by one ULP in the two frameworks)."""
    cfg = jpresets.cornell_default(tonemap=op)[2]
    acc = np.random.default_rng(3).uniform(-0.2, 6.0, (8, 8, 3)).astype(np.float32)
    jst = JState.create(8, 8).replace(accum=jnp.asarray(acc),
                                      passes=jnp.asarray(3, jnp.int32))
    tst = TState(accum=torch.from_numpy(acc), passes=3)
    np.testing.assert_allclose(tren.display_image(tst, cfg).numpy(),
                               np.asarray(jren.display_image(jst, cfg)),
                               rtol=0, atol=1e-5)


def test_route():
    scene, _, cfg = tpresets.cornell_default(device="cpu", use_mis=True)
    assert tren._route("cuda", scene, cfg) == "kernel"
    assert tren._route("cpu", scene, cfg) == "plain"
    mis_style = parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_LIGHT_4, SPHERE, vec3(0.0, 1.5, -1.0), vec4(0.3)
        MAT_REFR_CLEAR_2, SPHERE, vec3(-0.5, -0.6, 0.0), vec4(0.4)
        MAT_MIRROR, SPHERE, vec3(0.6, -0.6, -0.5), vec4(0.4)
    """, device="cpu")
    cube, _, cube_cfg = tpresets.cubemap_demo(device="cpu")
    for s, c in [(mis_style, cfg), (cube, cube_cfg)]:
        assert tren._route("cuda", s, c) == "kernel"
        assert tren._route("cpu", s, c) == "plain"
    textured = parse_scene("""
        MAT_CHECK_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_LIGHT_4, SPHERE, vec3(0.0, 1.5, -1.0), vec4(0.3)
    """, device="cpu")
    assert tren._route("cuda", textured, cfg) == "kernel"   # textures: K1 (item 9)
    with pytest.raises(NotImplementedError, match="item 11"):
        tren._route("cuda", scene, cfg.replace(use_restir=True))
    animated = cfg.replace(render_mode=RenderMode.ANIMATED)
    assert tren._route("cuda", scene, animated) == "kernel"   # K1 serves ANIMATED
    assert tren._route("cpu", scene, animated) == "plain"


def test_cpu_render_launches_no_kernel():
    scene, cam, cfg = tpresets.cornell_default(device="cpu", use_mis=True)
    before = tmk.LAUNCHES
    img = tren.Renderer(scene, cam, cfg.replace(max_bounces=2), 8, 16).render(2)
    assert tmk.LAUNCHES == before == 0
    assert img.shape == (8, 16, 3) and bool(torch.isfinite(img).all())


def test_port_imports_no_jax():
    """Importing every port module loads neither jax nor any module of the
    JAX package: the port has its own config and materials."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "raytracer0_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.startswith('raytracer0_tpu.') or k == 'raytracer0_tpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    assert len(mods) > 15
    assert eval(out) == []
