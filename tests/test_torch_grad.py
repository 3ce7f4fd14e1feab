"""Gradients of the port against the JAX package, and the port's own
config, materials, import boundary and kernel build cache.

The plain version of the adjoint kernel K2 is `torch.autograd` through
`render/integrator.trace`; it is held against `jax.grad` of the JAX
`integrator.trace` (the plain reference the JAX package's own
tests/test_megakernel.py:97-129 holds its adjoint kernel against), and the
whole slice (`sample_radiance`) against `jax.grad` of the JAX
`sample_radiance` on its XLA route.  Tolerance: per leaf,
max|a - b| / max|b| < 1e-4 (tests/test_megakernel.py:128-129); the two
frameworks differ by float32 rounding in the order of their sums.
"""

import ast
import dataclasses
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu import config as jconfig
from raytracer0_tpu import rng as jrng
from raytracer0_tpu.models import camera as jcam
from raytracer0_tpu.models import materials as jmat
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.ops import megakernel as jmk
from raytracer0_tpu.render import integrator as jint
from raytracer0_tpu.render import renderer as jren
from raytracer0_tpu_torch import config as tconfig
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.models import camera as tcam
from raytracer0_tpu_torch.models import dsl as tdsl
from raytracer0_tpu_torch.models import materials as tmat
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models.scene import SceneBuilder
from raytracer0_tpu_torch.ops import cuda_build
from raytracer0_tpu_torch.ops import megakernel as tmk
from raytracer0_tpu_torch.render import integrator as tint
from raytracer0_tpu_torch.render import renderer as tren
from raytracer0_tpu_torch.render.state import RenderState

GRAD_TOL = 1e-4
LEAVES = ("color", "emission", "pos", "joker")
REPO = Path(__file__).resolve().parents[1]


def assert_grads_close(got, want):
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert np.isfinite(a).all(), k
        scale = max(np.abs(b).max(), 1e-12)
        assert np.abs(a - b).max() / scale < GRAD_TOL, (k, np.abs(a - b).max(), scale)


def _torch_grads(fn, scene, extra=()):
    """Gradient of fn(scene with LEAVES as fresh leaves, *extra) w.r.t. the
    leaves and `extra` (numpy arrays made leaves)."""
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in LEAVES}
    xs = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in extra]
    fn(scene.replace(**leaves), *xs).sum().backward()
    grads = {k: v.grad for k, v in leaves.items()}
    return grads, [x.grad for x in xs]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_mis=False),
    dict(sample_lights=False),
], ids=["nee_mis", "nee", "bsdf_only"])
def test_plain_grad_matches_jax_integrator(kw):
    """d sum(trace) / d(color, emission, pos, joker, ro, rd) at 16x128, 3
    bounces: the port's plain autograd against jax.grad."""
    h, w = 16, 128
    js, jc, jcfg = jpresets.cornell_default(use_mis=True)
    ts, _, _ = tpresets.cornell_default(device="cpu", use_mis=True)
    cfg = jcfg.replace(max_bounces=3, **kw)
    ro, rd = (np.asarray(a) for a in jcam.generate_rays(jc, h, w, 1))
    jpix, tpix = jrng.pixel_ids(h, w), trng.pixel_ids(h, w)

    def jloss(color, emission, pos, joker, o, d):
        s = js.replace(color=color, emission=emission, pos=pos, joker=joker)
        return jnp.sum(jint.trace(s, cfg, o, d, jpix, 1, 0))

    jg = jax.grad(jloss, argnums=tuple(range(6)))(
        *(getattr(js, k) for k in LEAVES), jnp.asarray(ro), jnp.asarray(rd))
    want = dict(zip(LEAVES + ("ro", "rd"), jg))

    got, (g_ro, g_rd) = _torch_grads(
        lambda s, o, d: tint.trace(s, cfg, o, d, tpix, 1, 0), ts, (ro, rd))
    got.update(ro=g_ro, rd=g_rd)
    assert_grads_close(got, want)
    assert np.abs(np.asarray(want["emission"])).max() > 0.0


def test_sample_radiance_grad_matches_jax():
    """The slice as a whole: d sum(sample_radiance) / d(scene leaves) of
    cornell_default(use_mis=True) at 16x16 with OFFLINE_CONFIG (12
    bounces), the port's plain route against the JAX XLA route."""
    h = w = 16
    js, jc, cfg = jpresets.cornell_default(use_mis=True)
    ts, tc, _ = tpresets.cornell_default(device="cpu", use_mis=True)
    assert cfg.max_bounces == 12

    def jloss(color, emission, pos, joker):
        s = js.replace(color=color, emission=emission, pos=pos, joker=joker)
        return jnp.sum(jren.sample_radiance(s, cfg, jc, h, w, jnp.uint32(1)))

    want = dict(zip(LEAVES, jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(getattr(js, k) for k in LEAVES))))
    got, _ = _torch_grads(
        lambda s: tren.sample_radiance(s, cfg, tc, h, w, 1), ts)
    assert_grads_close(got, want)


def test_render_pass_carries_the_gradient():
    """render_pass adds sample_radiance into the accumulator: the gradient
    of the accumulated sum is the gradient of the pass (CPU route)."""
    h, w = 8, 8
    ts, tc, cfg = tpresets.cornell_default(device="cpu", use_mis=True)
    cfg = cfg.replace(max_bounces=3)
    state = RenderState.create(h, w, device="cpu")
    via_pass, _ = _torch_grads(
        lambda s: tren.render_pass(s, tc, cfg, state, h, w).accum, ts)
    via_radiance, _ = _torch_grads(
        lambda s: tren.sample_radiance(s, cfg, tc, h, w, state.passes), ts)
    for k in LEAVES:
        torch.testing.assert_close(via_pass[k], via_radiance[k], rtol=0, atol=0)
    assert via_pass["emission"].abs().max().item() > 0.0


def test_wrapper_on_cpu_gives_plain_gradient():
    """megakernel.trace_forward on CPU tensors that require grad is the
    plain version: the same gradient, and no kernel launches."""
    h, w = 4, 24
    ts, tc, cfg = tpresets.cornell_default(device="cpu", use_mis=True)
    cfg = cfg.replace(max_bounces=3)
    ro, rd = tcam.generate_rays(tc, h, w, 1)
    pix = trng.pixel_ids(h, w)
    before = (tmk.LAUNCHES, tmk.BWD_LAUNCHES)
    got, g_wrap = _torch_grads(
        lambda s, o, d: tmk.trace_forward(s, cfg, o, d, pix, 1, 0), ts,
        (ro.numpy(), rd.numpy()))
    want, g_plain = _torch_grads(
        lambda s, o, d: tint.trace(s, cfg, o, d, pix, 1, 0), ts,
        (ro.numpy(), rd.numpy()))
    for k in LEAVES:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    for a, b in zip(g_wrap, g_plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (tmk.LAUNCHES, tmk.BWD_LAUNCHES) == before


def test_kernel_class_checks_on_cpu():
    """K2's own limits, computed without a card: its stash depth and the
    shared memory of its per-thread cotangent accumulators."""
    ts, _, cfg = tpresets.cornell_default(device="cpu", use_mis=True)
    assert tmk.bwd_slots(cfg) == 5            # 4 diffuse bounces + the last hit
    assert tmk.bwd_slots(cfg.replace(max_bounces=3)) == 3
    assert tmk.bwd_threads(ts) == 128
    assert tmk.bwd_smem_bytes(ts, 128) == 4 * (8 * 36 + 2 * 8 + 1) + 4 * 8 * 10 * 128
    assert tmk.unsupported_bwd(ts, cfg) is None
    deep = cfg.replace(max_bounces=40, max_diff_bounces=30)
    assert "stash" in tmk.unsupported_bwd(ts, deep)
    sb = SceneBuilder()
    for i in range(60):
        sb.add("MAT_WHITE", tmat.MeshType.SPHERE, (0.0, float(i), -3.0), (0.1,))
    big = sb.build(device="cpu")
    assert tmk.bwd_threads(big) == 64
    assert tmk.unsupported(big, cfg) is None


@pytest.mark.slow
@pytest.mark.parametrize("slotted", ["1", "0"], ids=["K2_slotted", "K3_whole"])
def test_plain_grad_matches_jax_adjoint_kernels_interpret(slotted):
    """The plain gradient against the JAX adjoint kernels themselves, in
    Pallas interpret mode at 1 bounce and one 8x128 block: the per-slot
    body K2 (RT0_BWD_SLOTTED=1) and the whole-trace body K3 (=0).  Too slow
    for tier 1 (about half a minute each on a 2-core host)."""
    h, w = 8, 128
    js, jc, jcfg = jpresets.cornell_default(use_mis=True)
    ts, _, _ = tpresets.cornell_default(device="cpu", use_mis=True)
    cfg = jcfg.replace(max_bounces=1)
    ro, rd = (np.asarray(a) for a in jcam.generate_rays(jc, h, w, 0))
    jpix, tpix = jrng.pixel_ids(h, w), trng.pixel_ids(h, w)

    def jloss(color, emission, pos, joker, o, d):
        s = js.replace(color=color, emission=emission, pos=pos, joker=joker)
        return jnp.sum(jmk.trace_forward(s, cfg, o, d, jpix, 0, 0))

    env = {"RT0_PALLAS_INTERPRET": "1", "RT0_BWD_SLOTTED": slotted}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        jg = jax.grad(jloss, argnums=tuple(range(6)))(
            *(getattr(js, k) for k in LEAVES), jnp.asarray(ro), jnp.asarray(rd))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    got, (g_ro, g_rd) = _torch_grads(
        lambda s, o, d: tint.trace(s, cfg, o, d, tpix, 0, 0), ts, (ro, rd))
    got.update(ro=g_ro, rd=g_rd)
    assert_grads_close(got, dict(zip(LEAVES + ("ro", "rd"), jg)))


def test_config_and_materials_equal_jax():
    """The port's own copies keep the JAX package's names and values."""
    assert ([f.name for f in dataclasses.fields(tconfig.RenderConfig)]
            == [f.name for f in dataclasses.fields(jconfig.RenderConfig)])
    for t, j in [(tconfig.RenderConfig(), jconfig.RenderConfig()),
                 (tconfig.OFFLINE_CONFIG, jconfig.OFFLINE_CONFIG),
                 (tconfig.ANIMATED_CONFIG, jconfig.ANIMATED_CONFIG)]:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for name in ("TonemapOp", "RenderMode"):
        assert ({m.name: int(m) for m in getattr(tconfig, name)}
                == {m.name: int(m) for m in getattr(jconfig, name)})
    for name in ("MatType", "TexType", "MeshType", "SdfShape"):
        assert ({m.name: int(m) for m in getattr(tmat, name)}
                == {m.name: int(m) for m in getattr(jmat, name)})
    assert list(tmat.MATERIALS) == list(jmat.MATERIALS)
    for k, m in tmat.MATERIALS.items():
        assert dataclasses.asdict(m) == dataclasses.asdict(jmat.MATERIALS[k]), k
    for k in dir(jmat):
        if k.startswith(("IOR_", "TEX_")) or k == "NULL_TEX":
            a, b = getattr(tmat, k), getattr(jmat, k)
            assert (dataclasses.asdict(a) if dataclasses.is_dataclass(a) else a) == \
                (dataclasses.asdict(b) if dataclasses.is_dataclass(b) else b), k
    # a JAX config drives the port: fields are read by name
    assert tint.unsupported(tpresets.cornell_default(device="cpu")[0],
                            jconfig.OFFLINE_CONFIG) is None


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_ast():
    """No module of the port, and not chip_smoke.py, imports jax or
    anything of the JAX package, at any place in the file."""
    files = sorted((REPO / "raytracer0_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 18
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "raytracer0_tpu")]
    assert bad == []


def test_entry_points_default_to_the_card():
    """cornell_default, parse_scene, SceneBuilder.build, Camera.make and
    RenderState.create put their tensors on `cuda` unless given
    device="cpu"; without a card they raise instead of falling back."""
    calls = [
        lambda **kw: tpresets.cornell_default(**kw)[0].pos,
        lambda **kw: tdsl.parse_scene(
            "MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(1.0)", **kw).pos,
        lambda **kw: SceneBuilder().add(
            "MAT_WHITE", tmat.MeshType.SPHERE, (0, 0, 0), (1.0,)).build(**kw).pos,
        lambda **kw: tcam.Camera.make(**kw).origin,
        lambda **kw: RenderState.create(2, 2, **kw).accum,
    ]
    for call in calls:
        assert call(device="cpu").device.type == "cpu"
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_build_cache_key_covers_headers(tmp_path):
    """The build directory's hash changes with any file under csrc/, so an
    edited header never loads a stale library (run on a copy)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    key = lambda: cuda_build.build_dir("megakernel", tmk.SOURCES, csrc_dir=csrc)
    first = key()
    assert first == key()
    assert first.parent == cuda_build.BUILD_DIR
    header = csrc / "trace_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = key()
    assert second != first
    (csrc / "megakernel_bwd.cu").write_text("// another source\n")
    assert key() != second
    assert cuda_build.build_dir("megakernel_bwd", tmk.BWD_SOURCES,
                                csrc_dir=csrc) != key()
    assert cuda_build.build_dir("megakernel", tmk.SOURCES) == \
        cuda_build.build_dir("megakernel", tmk.SOURCES, csrc_dir=cuda_build.CSRC_DIR)
