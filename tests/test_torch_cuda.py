"""K1, its adjoint K2, the ReSTIR pass K6 (the G-buffer kernel K4, then
the reservoir-vertex kernel K6v) and its adjoint K7, and the ray-cast
kernel K5 on the GPU against their plain versions on the same card: K1 on
the Cornell class and on the widened class (mirror, glass and coat,
directional lights, cubemaps, uniform sampling, textures, SDF meshes), K2
on the Cornell class (47 meshes too, and the same bits on two launches),
in its wide copy on the rest of that class and in its whole-SDF copy on
every SDF shape, textured SDF meshes and SDF lights (and `fit` through it),
K6 on the ReSTIR presets (with MIS too, and under
ANIMATED accumulation), K6v in both forms, K7 against the plain version's
autograd over chains of passes, `fit` through the reservoir ring, K4 and
K5 bit for bit and the split ReSTIR pass K4 and K6v serve, K4 and K6v in
their whole-SDF copies (every SDF shape, blended textures on any row) with
their old copies' code unchanged, K7's whole-SDF copy against the plain
autograd on the scenes of that class (and `fit` through it) with its
ROUND_BOX copy's code unchanged, K1's medium copy (hero-wavelength spectral
transport and the homogeneous medium) bit for bit on the reference's preset
8 and across K1's class with K1's old copies' code unchanged, and the
refusal of gradients outside K2's and K7's classes (texel arrays, mesh
types K1 does not render, K7's own class before K6's, spectral transport
and the medium) and through the split path, of cubemaps on the split path,
and of spectral transport and the medium on every ReSTIR route.

These tests need a CUDA device and nvcc (the kernels are built on first
use); without them they skip.  On the GPU machine run:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

K1's tolerance is the parity contract (>= 99 % of pixels within 1e-5,
median below 1e-4): it follows the plain version's operations in order and
is built without fast math or FMA contraction, so it agrees bit for bit
wherever the two libm calls round alike.  K2's is the JAX contract for the
adjoint kernel (tests/test_megakernel.py:128-129): per leaf,
max|a - b| / max|b| < 1e-4, since its sums over pixels run in another
order than autograd's.
"""

import pytest
import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.config import OFFLINE_CONFIG
from raytracer0_tpu_torch.models import materials, presets
from raytracer0_tpu_torch.models.camera import generate_rays
from raytracer0_tpu_torch.models.camera import Camera
from raytracer0_tpu_torch.models.dsl import parse_scene
from raytracer0_tpu_torch.models.materials import MeshType, SdfShape
from raytracer0_tpu_torch import optimize
from raytracer0_tpu_torch.models.presets import cornell_default, cubemap_demo
from raytracer0_tpu_torch.models.scene import SceneBuilder
from raytracer0_tpu_torch.ops import megakernel, restir, restir_kernel, restir_split
from raytracer0_tpu_torch.ops import restir_vertex
from raytracer0_tpu_torch.render import integrator
from raytracer0_tpu_torch.render.renderer import Renderer, render_pass
from raytracer0_tpu_torch.render.state import RenderState

from raytracer0_tpu_torch.models import scene as scene_mod
from test_torch_kernel_host import (LAUNCH_COUNTS, MEDIUM_CASES, SHAPE_SCENES, TABLE_LEAVES,
                                    adjoint_case, assert_grads_close, assert_grads_close_f64,
                                    medium_case, refreshed_ring, restir_chain_grads)
from test_torch_kernel_host_restir_sdf import READS, animated, chain_grads, k7_case
from test_torch_kernel_host_restir_sdf import SCENES as K7_SDF_SCENES
from test_torch_texture_scenes import SCENE_VIEWS
from test_torch_sdf_scenes import GATES, NEW_CLASSES, expected_verdict, gate_reason, new_class_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


LEAVES = ("color", "emission", "pos", "joker")
CONFIGS = [
    (16, 128, dict(max_bounces=3)),
    (13, 77, dict(max_bounces=5)),                       # ragged edge
    (16, 128, dict(max_bounces=4, use_mis=False)),
    (16, 128, dict(max_bounces=4, sample_lights=False)),
]
IDS = ["cornell", "ragged", "no_mis", "bsdf_only"]


def _parity(out, ref):
    err = (out - ref).abs().amax(dim=-1)
    assert (err < 1e-5).float().mean().item() >= 0.99, err.max().item()
    assert err.median().item() < 1e-4


@pytest.mark.parametrize("h,w,kw", CONFIGS, ids=IDS)
def test_kernel_matches_plain(cuda, h, w, kw):
    scene, cam, cfg = cornell_default(device=cuda, use_mis=True)
    cfg = cfg.replace(**kw)
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w, device=cuda)
    before = megakernel.LAUNCHES
    out = megakernel.trace_forward(scene, cfg, ro, rd, pix, 2, 0)
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before + 1
    assert bool(torch.isfinite(out).all())
    _parity(out, ref)


def test_kernel_raises_outside_the_class(cuda):
    """A GRID_SDF mesh is outside K1's class (item 8) and raises before any
    launch; every SDF shape is inside it (test_whole_sdf_kernel_matches_plain)."""
    sb = SceneBuilder()
    sb.add("MAT_WHITE", MeshType.PLANE, (0.0, 1.0, 0.0), (2.0,))
    sb.add("MAT_LIGHT_4", MeshType.SPHERE, (0.0, 1.5, -1.0), (0.3,))
    sb.add("MAT_WHITE", MeshType.GRID_SDF, (0.0, -0.5, -1.0), (0.3, 0.3, 0.3, 0.05))
    scene = sb.build(device=cuda)
    _, cam, cfg = cornell_default(device=cuda)
    ro, rd = generate_rays(cam, 8, 8, 0)
    with pytest.raises(NotImplementedError, match="item 8"):
        megakernel.trace_forward(scene, cfg, ro, rd,
                                 rng.pixel_ids(8, 8, device=cuda), 0, 0)
    with pytest.raises(NotImplementedError, match="item 8"):
        Renderer(scene, cam, cfg, 8, 8).step()


def test_renderer_goes_through_kernel(cuda):
    scene, cam, cfg = cornell_default(device=cuda, use_mis=True)
    before = megakernel.LAUNCHES
    img = Renderer(scene, cam, cfg, 32, 48).render(3)
    assert megakernel.LAUNCHES == before + 3
    assert img.shape == (32, 48, 3) and bool(torch.isfinite(img).all())
    assert img.mean().item() > 0.05


def _grads(trace, scene, cfg, ro, rd, pix):
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in LEAVES}
    o = ro.detach().clone().requires_grad_(True)
    d = rd.detach().clone().requires_grad_(True)
    trace(scene.replace(**leaves), cfg, o, d, pix, 2, 0).sum().backward()
    return {**{k: v.grad for k, v in leaves.items()}, "ro": o.grad, "rd": d.grad}


@pytest.mark.parametrize("h,w,kw", CONFIGS, ids=IDS)
def test_adjoint_matches_plain_autograd(cuda, h, w, kw):
    """K2 against torch.autograd of the plain version on the card: one K1
    and one K2 launch per forward and backward."""
    scene, cam, cfg = cornell_default(device=cuda, use_mis=True)
    cfg = cfg.replace(**kw)
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w, device=cuda)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    got = _grads(megakernel.trace_forward, scene, cfg, ro, rd, pix)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = _grads(integrator.trace, scene, cfg, ro, rd, pix)
    for k, b in want.items():
        a = got[k]
        assert bool(torch.isfinite(a).all()), k
        scale = max(b.abs().max().item(), 1e-12)
        assert (a - b).abs().max().item() / scale < 1e-4, k
    # deterministic: the same inputs give the same bits
    again = _grads(megakernel.trace_forward, scene, cfg, ro, rd, pix)
    for k in got:
        assert torch.equal(got[k], again[k]), k


def test_adjoint_many_meshes_matches_plain_autograd(cuda):
    """K2 on a scene of 47 meshes (six planes and 41 sphere lights, MIS
    on: `presets.many_lights`) in 128-thread blocks against
    torch.autograd of the plain version: one launch of each kernel, every
    leaf within 1e-4 relative.  Its lanes add into a warp's column in
    groups by mesh, which the host build (one-lane warps) cannot show."""
    scene, cam, cfg = presets.many_lights(device=cuda)
    cfg = cfg.replace(max_bounces=4)
    assert scene.num_meshes == 47 and megakernel.unsupported_bwd(scene, cfg) is None
    h, w = 16, 128
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w, device=cuda)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    got = _grads(megakernel.trace_forward, scene, cfg, ro, rd, pix)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert_grads_close(got, _grads(integrator.trace, scene, cfg, ro, rd, pix))
    assert got["emission"][6:].abs().max().item() > 0.0


@pytest.mark.parametrize("where", ["cornell", "many_meshes"])
def test_adjoint_same_bits_twice(cuda, where):
    """Two K2 launches on the same inputs (512x512 Cornell at 12 bounces,
    or the 47-mesh scene at 128x128) give the same d_table, d_ro and d_rd
    bits: the warps' groups and the sums over them follow the data."""
    if where == "cornell":
        scene, cam, cfg = cornell_default(device=cuda, use_mis=True)
        h = w = 512
    else:
        scene, cam, cfg = presets.many_lights(device=cuda)
        h = w = 128
    ro, rd = generate_rays(cam, h, w, 0)
    pix = rng.pixel_ids(h, w, device=cuda)
    ct = torch.rand((h, w, 3), generator=torch.Generator(cuda).manual_seed(3), device=cuda)
    table = megakernel.scene_table(scene)
    first = megakernel._launch_backward(scene, cfg, table, ro, rd, pix, 0, 0, ct)
    second = megakernel._launch_backward(scene, cfg, table, ro, rd, pix, 0, 0, ct)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


def _table_grads(trace, scene, cfg, ro, rd, pix, dtype=torch.float32, mask=None):
    """(radiance, gradients of sum(trace * w) (w seeded on the card) w.r.t.
    every scene-table leaf, ro and rd), with the scene's float tensors and
    the rays in `dtype` and w kept on the (H, W) `mask`; a leaf the trace
    does not read has a zero gradient."""
    f = {k: getattr(scene, k).to(dtype) for k in ("images", "noise", "cubemap")}
    leaves = {k: getattr(scene, k).detach().to(dtype).requires_grad_(True) for k in TABLE_LEAVES}
    o, d = (v.detach().to(dtype).requires_grad_(True) for v in (ro, rd))
    out = trace(scene.replace(**leaves, **f), cfg, o, d, pix, 2, 0)
    wt = torch.rand(out.shape, generator=torch.Generator(out.device).manual_seed(5),
                    device=out.device).to(dtype) + 0.5
    if mask is not None:
        wt = wt * mask[..., None]
    g = torch.autograd.grad((out * wt).sum(), [*leaves.values(), o, d], allow_unused=True)
    keys = (*TABLE_LEAVES, "ro", "rd")
    vals = [*leaves.values(), o, d]
    return out.detach(), {k: torch.zeros_like(v) if x is None else x
                          for k, v, x in zip(keys, vals, g)}


WIDE = ["config2", "mis_demo", "dir", "cornell_uniform", "cubemap", "cornell_box",
        "textured_light", "textured_cornell", "textured_gloss", "textured_emitter", "procedural",
        "gradient_noise", "check_sphere"]


@pytest.mark.parametrize("where", WIDE)
def test_wide_adjoint_matches_plain_autograd(cuda, where):
    """K2's wide copy against torch.autograd of the plain version on the
    card at 64x64 and 4 bounces, per table leaf and the rays within 1e-4
    relative (where a pixel's gradient passes through a float32
    cancellation, arbitrated by the plain autograd in float64,
    `assert_grads_close_f64`): one K1 and one K2 launch, and two K2
    launches give the same bits where it keeps a column per thread."""
    scene, cam, cfg = adjoint_case("cornell" if where == "cornell_uniform" else where, cuda)
    cfg = cfg.replace(max_bounces=4, use_biased_sampling=where != "cornell_uniform")
    assert megakernel.unsupported_bwd(scene, cfg) is None
    assert not megakernel.cornell_copy(scene, cfg)
    h = w = 64
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w, device=cuda)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    _, got = _table_grads(megakernel.trace_forward, scene, cfg, ro, rd, pix)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _, want = _table_grads(integrator.trace, scene, cfg, ro, rd, pix)
    assert_grads_close_f64(got, want, lambda kind, mask: _table_grads(
        megakernel.trace_forward if kind == "kernel" else integrator.trace, scene, cfg, ro, rd,
        pix, torch.float64 if kind == "plain64" else torch.float32, mask))
    assert got["color"].abs().max().item() > 0.0
    if not megakernel.bwd_layout(scene, cfg)[0]:   # a column per thread: the same bits
        ct = torch.rand((h, w, 3), generator=torch.Generator(cuda).manual_seed(3), device=cuda)
        table = megakernel.scene_table(scene)
        runs = [megakernel._launch_backward(scene, cfg, table, ro, rd, pix, 2, 0, ct)
                for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_render_pass_differentiates_through_kernels(cuda):
    """A loss on render_pass's accumulator reaches the scene through K1 and
    K2, with the plain route's gradient."""
    scene, cam, cfg = cornell_default(device=cuda, use_mis=True)
    cfg = cfg.replace(max_bounces=4)
    h, w = 16, 40
    before = megakernel.BWD_LAUNCHES
    em = scene.emission.clone().requires_grad_(True)
    state = render_pass(scene.replace(emission=em), cam, cfg,
                        RenderState.create(h, w, device=cuda), h, w)
    state.accum.sum().backward()
    torch.cuda.synchronize()
    assert megakernel.BWD_LAUNCHES == before + 1
    em2 = scene.emission.clone().requires_grad_(True)
    ro, rd = generate_rays(cam, h, w, 0)
    integrator.trace(scene.replace(emission=em2), cfg, ro, rd,
                     rng.pixel_ids(h, w, device=cuda), 0, 0).sum().backward()
    scale = em2.grad.abs().max().item()
    assert scale > 0.0 and (em.grad - em2.grad).abs().max().item() / scale < 1e-4


def test_forward_only_launches_no_adjoint(cuda):
    """A render that needs no gradient launches K1 alone."""
    scene, cam, cfg = cornell_default(device=cuda, use_mis=True)
    before = megakernel.BWD_LAUNCHES
    Renderer(scene, cam, cfg, 32, 48).render(2)
    with torch.no_grad():
        leaves = scene.replace(emission=scene.emission.clone().requires_grad_(True))
        Renderer(leaves, cam, cfg, 32, 48).render(1)
    torch.cuda.synchronize()
    assert megakernel.BWD_LAUNCHES == before


def test_adjoint_raises_outside_the_class(cuda):
    """A gradient through a scene K1/K2 do not cover raises; it never runs
    the plain backward instead: a GRID_SDF mesh (item 8; K2 differentiates
    every SDF shape K1 renders), and paths longer than K2's stash."""
    sb = SceneBuilder()
    sb.add("MAT_WHITE", MeshType.PLANE, (0.0, 1.0, 0.0), (2.0,))
    sb.add("MAT_LIGHT_4", MeshType.SPHERE, (0.0, 1.5, -1.0), (0.3,))
    sb.add("MAT_WHITE", MeshType.GRID_SDF, (0.0, 0.0, 0.0), (0.3, 0.3, 0.3, 0.05))
    scene = sb.build(device=cuda)
    _, cam, cfg = cornell_default(device=cuda)
    ro, rd = generate_rays(cam, 8, 8, 0)
    em = scene.emission.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="item 8"):
        megakernel.trace_forward(scene.replace(emission=em), cfg, ro, rd,
                                 rng.pixel_ids(8, 8, device=cuda), 0, 0)
    cornell, _, _ = cornell_default(device=cuda)
    deep = cfg.replace(max_bounces=40, max_diff_bounces=30)
    with pytest.raises(NotImplementedError, match="stash"):
        megakernel.trace_forward(
            cornell.replace(emission=cornell.emission.clone().requires_grad_(True)),
            deep, ro, rd, rng.pixel_ids(8, 8, device=cuda), 0, 0)


CONFIG2 = """
    MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, -1.0, 0.0), vec4(2.0)
    MAT_GREEN, PLANE, vec3(1.0, 0.0, 0.0), vec4(2.0)
    MAT_RED, PLANE, vec3(-1.0, 0.0, 0.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, 0.0, -1.0), vec4(2.0)
    MAT_LIGHT_4, SPHERE, vec3(0.0, 1.5, -1.0), vec4(0.3)
    MAT_REFR_CLEAR_2, SPHERE, vec3(-0.5, -0.6, 0.0), vec4(0.4)
    MAT_MIRROR, SPHERE, vec3(0.6, -0.6, -0.5), vec4(0.4)
    MAT_COAT_PURPLE, SPHERE, vec3(0.0, -1.4, 0.8), vec4(0.35)
"""


def _widened(where, dev):
    """(scene, camera, cfg): cubemap_demo, config 2
    (tests/test_golden_cornell.py:66-79), the directional-sun scene
    (tests/test_megakernel.py:685-698) or Cornell."""
    if where == "cubemap":
        return cubemap_demo(device=dev)
    if where == "config2":
        cam = Camera.make(origin=(0, 0, 1.99), lookat=(0, 0, -1), fov=60.0, device=dev)
        return (parse_scene(CONFIG2, device=dev), cam,
                cornell_default(device=dev, use_mis=True, use_procedural_sky=False)[2])
    if where == "dir":
        sb = SceneBuilder()
        sb.add("MAT_CORNELL_WHITE", MeshType.BOX, (0.0, -2.2, -1.0), (2.0,))
        sb.add("MAT_CORNELL_RED", MeshType.BOX, (-0.8, -0.8, -1.4), (0.8,))
        sb.add("MAT_MIRROR", MeshType.SPHERE, (0.6, -0.7, -1.0), (0.5,))
        sb.add("MAT_DIRECT_SUNLIGHT", MeshType.SPHERE, (0.5, 0.8, 0.3), (0.01,))
        sb.lights([3])
        cam = Camera.make(origin=(0.0, 0.3, 2.0), lookat=(0.0, -0.6, -1.0), device=dev)
        return sb.build(device=dev), cam, cornell_default(device=dev)[2]
    return cornell_default(device=dev)


@pytest.mark.parametrize("where,kw", [
    ("cubemap", dict(max_bounces=3)),
    ("cubemap", dict(max_bounces=12, use_biased_sampling=False)),
    ("config2", dict(max_bounces=3)),
    ("config2", dict(max_bounces=12)),
    ("dir", dict(max_bounces=3)),
    ("dir", dict(max_bounces=3, use_mis=True)),
    ("cornell", dict(max_bounces=3, use_mis=True, use_biased_sampling=False)),
], ids=["cubemap", "cubemap_uniform_12", "config2", "config2_12", "dir", "dir_mis",
        "cornell_uniform"])
def test_widened_kernel_matches_plain(cuda, where, kw):
    """K1 beyond the Cornell class, one launch each."""
    scene, cam, cfg = _widened(where, cuda)
    cfg = cfg.replace(**kw)
    h, w = 16, 128
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w, device=cuda)
    before = megakernel.LAUNCHES
    out = megakernel.trace_forward(scene, cfg, ro, rd, pix, 2, 0)
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before + 1
    assert bool(torch.isfinite(out).all()) and ref.max().item() > 0.1
    _parity(out, ref)


def test_cubemap_render_goes_through_kernel_only(cuda):
    """Renderer(cubemap_demo) launches K1 once per pass and K2 never, and
    the cubemap shows."""
    scene, cam, cfg = cubemap_demo(device=cuda)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    img = Renderer(scene, cam, cfg, 32, 48).render(3)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 3, before[1])
    assert img.shape == (32, 48, 3) and bool(torch.isfinite(img).all())
    assert img[:4].mean().item() > 0.2   # the top rows see the sky


def test_gradient_outside_k2_class_launches_nothing(cuda):
    """A gradient w.r.t. cubemap_demo's cubemap texels on the card raises,
    naming ROADMAP item 14, before K1 or K2 is launched; it never falls back
    to the plain backward.  (Its table leaves run through K2.)"""
    scene, cam, cfg = cubemap_demo(device=cuda)
    cube = scene.cubemap.clone().requires_grad_(True)
    ro, rd = generate_rays(cam, 8, 8, 0)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    with pytest.raises(NotImplementedError, match="cubemap.*item 14"):
        megakernel.trace_forward(scene.replace(cubemap=cube), cfg, ro, rd,
                                 rng.pixel_ids(8, 8, device=cuda), 0, 0)
    with pytest.raises(NotImplementedError, match="item 14"):
        render_pass(scene.replace(cubemap=cube), cam, cfg,
                    RenderState.create(8, 8, device=cuda), 8, 8)
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == before


TEXTURED = ["textured_cornell", "textured_gloss", "textured_emitter", "cornell_box",
            "procedural", "gradient_noise", "check_sphere"]


def _textured(where, dev):
    """(scene, camera, cfg) of a textured preset or of a scene of
    tests/test_torch_texture_scenes.py."""
    if where in SCENE_VIEWS:
        make, (origin, lookat, fov), kw = SCENE_VIEWS[where]
        return (make(SceneBuilder, materials, device=dev),
                Camera.make(origin=origin, lookat=lookat, fov=fov, device=dev),
                OFFLINE_CONFIG.replace(**kw))
    return getattr(presets, where)(device=dev)


@pytest.mark.parametrize("where", TEXTURED)
def test_textured_kernel_matches_plain(cuda, where):
    """K1 with textures of all ten types, one launch, at 16x128 and 3
    bounces: the parity contract; gradient noise, whose sin hash amplifies
    any ULP by which two sin routines differ 43758x, in mean and
    standard deviation (tests/test_megakernel.py:277-278)."""
    scene, cam, cfg = _textured(where, cuda)
    cfg = cfg.replace(max_bounces=min(cfg.max_bounces, 3))
    h, w = 16, 128
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w, device=cuda)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    out = megakernel.trace_forward(scene, cfg, ro, rd, pix, 2, 0)
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 1, before[1])
    assert bool(torch.isfinite(out).all()) and ref.max().item() > 0.02
    if where == "gradient_noise":
        assert abs(out.mean() - ref.mean()).item() < 0.02 * ref.mean().item()
        assert abs(out.std() - ref.std()).item() < 0.05 * ref.std().item()
    else:
        _parity(out, ref)


def test_textured_render_goes_through_kernel_only(cuda):
    """Renderer(textured_cornell) launches K1 once per pass and K2 never;
    the textured sphere's pixels vary."""
    scene, cam, cfg = presets.textured_cornell(device=cuda)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    img = Renderer(scene, cam, cfg, 32, 48).render(3)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 3, before[1])
    assert img.shape == (32, 48, 3) and bool(torch.isfinite(img).all())
    assert img.mean().item() > 0.05


def test_gradient_through_textures_launches_nothing(cuda):
    """A gradient w.r.t. the texel arrays of a textured scene (the images,
    the noise LUT) on the card raises, naming ROADMAP item 14, before K1 or
    K2 is launched; the color's gradient runs through K2's wide copy."""
    scene, cam, cfg = presets.textured_cornell(device=cuda)
    ro, rd = generate_rays(cam, 8, 8, 0)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    for leaf in ("images", "noise"):
        s = scene.replace(**{leaf: getattr(scene, leaf).clone().requires_grad_(True)})
        with pytest.raises(NotImplementedError, match=f"{leaf}.*item 14"):
            megakernel.trace_forward(s, cfg, ro, rd, rng.pixel_ids(8, 8, device=cuda), 0, 0)
        with pytest.raises(NotImplementedError, match="item 14"):
            render_pass(s, cam, cfg, RenderState.create(8, 8, device=cuda), 8, 8)
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == before
    s = scene.replace(color=scene.color.clone().requires_grad_(True))
    megakernel.trace_forward(s, cfg, ro, rd, rng.pixel_ids(8, 8, device=cuda), 0, 0).sum().backward()
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("where,kw", [
    ("mis_demo", dict(max_bounces=3)),
    ("mis_demo", dict(max_bounces=12, use_mis=True)),
    ("restir_demo", dict(max_bounces=3, use_restir=False)),
], ids=["mis_demo", "mis_demo_mis_12", "restir_demo_nee"])
def test_sdf_kernel_matches_plain(cuda, where, kw):
    """K1 with the SDF march, one launch, against the plain version: the
    parity contract, and no pixel differs where both call CUDA's libm."""
    scene, cam, cfg = getattr(presets, where)(device=cuda)
    cfg = cfg.replace(**kw)
    h, w = 16, 128
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w, device=cuda)
    before = megakernel.LAUNCHES
    out = megakernel.trace_forward(scene, cfg, ro, rd, pix, 2, 0)
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before + 1
    assert bool(torch.isfinite(out).all()) and ref.max().item() > 0.02
    _parity(out, ref)


def _whole_sdf_case(where, device):
    if where in presets.SDF_SCENE_VIEWS:
        return presets.sdf_view(where, device=device)
    return getattr(presets, where)(device=device)


@pytest.mark.parametrize("where,kw", [
    ("default_scene", {}), ("mandelbulb", {}), ("menger_sponge", {}), ("sdf_light", {}),
    ("sdf_light", dict(use_mis=True)), ("every_shape", {}),
], ids=["default_scene", "mandelbulb", "menger_sponge", "sdf_light", "sdf_light_mis",
        "every_shape"])
def test_whole_sdf_kernel_matches_plain(cuda, where, kw):
    """K1's whole-SDF copy (every shape, textured SDF meshes, SDF lights),
    one launch at 64x64 with 12 bounces and 128 marching steps, against
    the plain version: the same bits."""
    scene, cam, cfg = _whole_sdf_case(where, cuda)
    cfg = cfg.replace(max_bounces=12, marching_steps=128, **kw)
    assert megakernel.whole_sdf(scene)
    ro, rd = generate_rays(cam, 64, 64, 1)
    pix = rng.pixel_ids(64, 64, device=cuda)
    before = megakernel.LAUNCHES
    out = megakernel.trace_forward(scene, cfg, ro, rd, pix, 1, 0)
    ref = integrator.trace(scene, cfg, ro, rd, pix, 1, 0)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before + 1
    assert bool(torch.isfinite(out).all()) and ref.max().item() > 0.02
    assert int((out != ref).any(-1).sum()) == 0


@pytest.mark.parametrize("where", NEW_CLASSES)
def test_new_sdf_classes_refused_before_any_launch(cuda, where):
    """Each gate takes or refuses a Mandelbulb, a textured BOX SDF and an
    SDF light as `expected_verdict` states (K5 and K7 refuse all three
    naming item 8), and the routes behind a refusing gate raise before any
    launch: a ReSTIR pass (K4, K6), the split path (K4, K6v), a ReSTIR
    gradient (K6's gate, then K7's with fault 15's check first) and K5's
    cast."""
    scene, cam, cfg = new_class_case(where, cuda)
    counts = lambda: (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES, restir_kernel.LAUNCHES,
                      restir_kernel.BWD_LAUNCHES, restir_split.GBUF_LAUNCHES,
                      restir_split.CAST_LAUNCHES, restir_vertex.VERTEX_LAUNCHES)
    before = counts()
    for gate in GATES:
        reason, want = gate_reason(gate, scene, cam, cfg), expected_verdict(gate, where)
        assert (reason is None) if want is None else (want in reason), (gate, reason)
    rcfg = cfg.replace(use_restir=True, use_mis=False)
    em = scene.emission.clone().requires_grad_(True)
    ro, rd = generate_rays(cam, 8, 8, 0)
    calls = [
        ("K6", lambda: Renderer(scene, cam, rcfg, 8, 8).step()),
        ("split", lambda: Renderer(scene, cam, rcfg.replace(restir_adhoc_motion=True), 8,
                                   8).step(0.1)),
        ("K7", lambda: optimize.render_linear(scene.replace(emission=em), rcfg, cam, 8, 8,
                                              passes=2)),
        ("K5", lambda: restir_split.cast_rays(scene, cfg, ro, rd)),
    ]
    for gate, call in calls:
        # a ReSTIR gradient's route asks K6's gate before K7's
        want = (expected_verdict("K6", where) or expected_verdict("K7", where) if gate == "K7"
                else expected_verdict(gate, where))
        if want is not None:
            with pytest.raises(NotImplementedError, match=want):
                call()
    assert counts() == before


@pytest.mark.parametrize("shape", [s.name for s in SdfShape] + ["every_shape"])
def test_sdf_map_adjoint_matches_plain(cuda, shape):
    """K2's adjoint of each SDF shape's distance on the card, in the scene
    that holds it (tests/test_torch_kernel_host.py's SHAPE_SCENES) at
    64x64, 2 bounces and 64 marching steps, one launch of the whole-SDF
    copy: the cotangents of the rows of that shape and of the rays whose
    first hit is one of them, against the plain autograd on the card under
    `assert_grads_close_f64` (as test_whole_sdf_adjoint_matches_plain_autograd
    holds those scenes)."""
    from raytracer0_tpu_torch.ops import intersect

    where = SHAPE_SCENES.get(shape, "every_shape")
    scene, cam, cfg = _whole_sdf_case(where, cuda)
    cfg = cfg.replace(max_bounces=2, marching_steps=64)
    ro, rd = generate_rays(cam, 64, 64, 2)
    pix = rng.pixel_ids(64, 64, device=cuda)
    rows = [scene.num_analytic + k for k, sh in enumerate(scene.sdf_shapes_static)
            if shape == "every_shape" or sh == int(SdfShape[shape])]
    hit = intersect.intersect(scene, ro, rd, cfg, need_normal=False)
    on = ~hit.missed & torch.isin(hit.idx, torch.tensor(rows, device=cuda))
    assert int(on.sum()) >= 8

    def grads_of(kind, mask):
        out, g = _table_grads(megakernel.trace_forward if kind == "kernel" else integrator.trace,
                              scene, cfg, ro, rd, pix,
                              torch.float64 if kind == "plain64" else torch.float32, mask)
        return out, {k: v[on] if k in ("ro", "rd") else v[rows] for k, v in g.items()}

    before = megakernel.BWD_LAUNCHES
    _, got = grads_of("kernel", None)
    torch.cuda.synchronize()
    assert megakernel.BWD_LAUNCHES == before + 1
    _, want = grads_of("plain", None)
    assert_grads_close_f64(got, want, grads_of, ill_conditioned=where == "menger_sponge",
                           f64_leaves=("pos", "joker", "ro", "rd") if where == "default_scene"
                           else ())
    assert got["pos"].abs().max().item() > 0.0


#: K2's whole-SDF copy on the card: (scene, config overrides)
WHOLE_SDF_ADJOINT = {
    "every_shape": ("every_shape", dict(max_bounces=4)),
    "polygons": ("polygons", dict(max_bounces=4)),
    "sdf_light": ("sdf_light", dict(max_bounces=4)),
    "sdf_light_mis": ("sdf_light", dict(max_bounces=4, use_mis=True)),
    "textured_sdf": ("textured_sdf", dict(max_bounces=4, use_mis=True)),
    "default_scene": ("default_scene", dict(max_bounces=4)),
    "mandelbulb": ("mandelbulb", dict(max_bounces=4, use_mis=True)),
    "menger_sponge": ("menger_sponge", dict(max_bounces=4)),
}


@pytest.mark.parametrize("name", list(WHOLE_SDF_ADJOINT))
def test_whole_sdf_adjoint_matches_plain_autograd(cuda, name):
    """K2's whole-SDF copy against torch.autograd of the plain version on
    the card at 64x64, 4 bounces and 64 marching steps, per table leaf
    (aux among them) and the rays within 1e-4 relative, arbitrated in
    float64 as `assert_grads_close_f64` does (`menger_sponge` on the pixels
    where float32 and float64 take the same decisions, `default_scene`'s
    pos, joker and rays held against float64): one K1 and one K2 launch,
    K1's radiance the plain version's bit for bit."""
    where, kw = WHOLE_SDF_ADJOINT[name]
    scene, cam, cfg = _whole_sdf_case(where, cuda)
    cfg = cfg.replace(marching_steps=64, **kw)
    assert megakernel.unsupported_bwd(scene, cfg) is None
    assert megakernel.bwd_copy(scene, cfg) == "whole_sdf"
    h = w = 64
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w, device=cuda)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    out, got = _table_grads(megakernel.trace_forward, scene, cfg, ro, rd, pix)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref, want = _table_grads(integrator.trace, scene, cfg, ro, rd, pix)
    assert torch.equal(out, ref)
    assert_grads_close_f64(got, want, lambda kind, mask: _table_grads(
        megakernel.trace_forward if kind == "kernel" else integrator.trace, scene, cfg, ro, rd,
        pix, torch.float64 if kind == "plain64" else torch.float32, mask),
        ill_conditioned=where == "menger_sponge",
        f64_leaves=("pos", "joker", "ro", "rd") if where == "default_scene" else ())
    assert got["color"].abs().max().item() > 0.0 and got["pos"].abs().max().item() > 0.0
    assert (got["aux"].abs().max().item() > 0.0) == (where in ("every_shape", "polygons"))


@pytest.mark.parametrize("where", ["mandelbulb", "menger_sponge", "sdf_light"])
def test_whole_sdf_fit_goes_through_k1_and_k2_only(cuda, monkeypatch, where):
    """`optimize.fit` at 32x32 for 5 steps of `mandelbulb`'s light emission
    and colors, `menger_sponge`'s color and the SDF light's position (a
    geometric leaf through the implicit t of its shadow rays): the loss
    falls, K1 and K2 launch once per step, the plain version never runs.
    (`menger_sponge`'s joker is left out: its gradient, as the plain
    version's, is the tetrahedral normal's derivative where its taps
    straddle carvings finer than a step, and a fit of it may not descend.)"""
    scene, cam, cfg = _whole_sdf_case(where, cuda)
    cfg = cfg.replace(max_bounces=4, marching_steps=64)
    mask = None
    if where == "mandelbulb":
        names, start = ("emission", "color"), dict(emission=scene.emission * 0.7,
                                                   color=scene.color * 0.7)
    elif where == "menger_sponge":
        names, start = ("color",), dict(color=scene.color * 0.7)
    else:
        row = (torch.arange(scene.num_meshes, device=cuda) == 6).float()[:, None]
        names, mask = ("pos",), {"pos": row}
        start = dict(pos=scene.pos - 0.1 * row * torch.tensor([0.0, 1.0, 0.0], device=cuda))
    target = megakernel.trace_forward(
        scene, cfg, *generate_rays(cam, 32, 32, 0), rng.pixel_ids(32, 32, device=cuda), 0, 0)
    plain_calls = []
    plain = integrator.trace
    monkeypatch.setattr(integrator, "trace", lambda *a, **k: plain_calls.append(1) or plain(*a, **k))
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    _, losses = optimize.fit(scene.replace(**start), cfg, cam, target, list(names), steps=5,
                             learning_rate=2e-2, param_mask=mask)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES - before[0], megakernel.BWD_LAUNCHES - before[1]) == (5, 5)
    assert not plain_calls
    assert losses[-1] < losses[0], losses


def _restir_contract(out, ref, new, new_ref):
    """The fused-versus-wavefront contract of tests/test_restir.py:312-352."""
    err = (out - ref).abs()
    assert err.max().item() < 5e-3 and err.median().item() < 1e-6, err.max().item()
    agree = new.light_index == new_ref.light_index
    assert agree.float().mean().item() >= 0.995
    for k in ("weight_sum", "m", "w", "age", "light_pos", "light_color"):
        assert (getattr(new, k)[agree] - getattr(new_ref, k)[agree]).abs().max().item() <= 1e-4, k


@pytest.mark.parametrize("where,kw", [
    ("restir_demo", dict(max_bounces=3)),
    ("restir_stress", dict(max_bounces=3, restir_samples=8)),
    ("restir_demo", dict(max_bounces=3, use_mis=True)),
])
def test_restir_kernel_matches_plain(cuda, where, kw):
    """K6 against the plain `restir.render_sample`, each threading its own
    reservoir ring through passes 0-11 (temporal reuse from pass 3, all
    spatial taps from pass 10), one K6 pass (one K4 and one K6v launch) and
    no K1 launch per pass."""
    scene, cam, cfg = getattr(presets, where)(device=cuda)
    cfg = cfg.replace(**kw)
    h, w = 16, 128
    kernel = RenderState.create(h, w, device=cuda)
    plain = RenderState.create(h, w, device=cuda)
    counts = lambda: (restir_kernel.LAUNCHES, restir_split.GBUF_LAUNCHES,
                      restir_vertex.VERTEX_LAUNCHES, megakernel.LAUNCHES)
    for p in range(12):
        before = counts()
        out, new = restir_kernel.render_sample_fused(scene, cfg, cam, kernel, h, w, p)
        ref, new_ref = restir.render_sample(scene, cfg, cam, plain, h, w, p)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
        assert bool(torch.isfinite(out).all())
        _restir_contract(out, ref, new, new_ref)
        kernel, plain = kernel.rotate_reservoirs(new), plain.rotate_reservoirs(new_ref)
    assert int((new.light_index >= 0).sum()) > h * w // 2 and ref.max().item() > 0.0


def test_restir_render_goes_through_k6_only(cuda):
    """Renderer(restir_demo) runs one K6 pass (K4 then K6v) per pass and
    launches neither K1 nor K2, and fills the reservoirs."""
    scene, cam, cfg = presets.restir_demo(device=cuda, max_bounces=4)
    counts = lambda: (restir_kernel.LAUNCHES, restir_split.GBUF_LAUNCHES,
                      restir_vertex.VERTEX_LAUNCHES, megakernel.LAUNCHES,
                      megakernel.BWD_LAUNCHES)
    before = counts()
    r = Renderer(scene, cam, cfg, 32, 48)
    img = r.render(4)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 4, before[1] + 4, before[2] + 4, before[3], before[4])
    assert img.shape == (32, 48, 3) and bool(torch.isfinite(img).all())
    assert r.state.restir_back.m.max().item() > 0.0
    assert r.state.restir_back.w.max().item() <= 12.0


def test_gradient_through_sdf_or_restir_launches_nothing(cuda):
    """A gradient through a mesh type K1 does not render (`mis_demo`'s box
    made a GRID_SDF, item 8), or through a ReSTIR pass of `restir_demo` that
    asks for a leaf K7 does not compute (aux), raises before any kernel is
    launched; the BOX of `mis_demo` runs through K2's wide copy."""
    counts = lambda: (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES, restir_kernel.LAUNCHES,
                      restir_kernel.BWD_LAUNCHES)
    before = counts()
    scene, cam, cfg = presets.mis_demo(device=cuda)
    grid = tuple(int(MeshType.GRID_SDF) if t == int(MeshType.SDF) else t
                 for t in scene.mesh_types_static)
    other = scene.replace(mesh_types_static=grid,
                          mesh_type=torch.tensor(grid, dtype=scene.mesh_type.dtype, device=cuda),
                          emission=scene.emission.clone().requires_grad_(True))
    with pytest.raises(NotImplementedError, match="SDF.*item 8"):
        render_pass(other, cam, cfg, RenderState.create(8, 8, device=cuda), 8, 8)
    scene, cam, cfg = presets.restir_demo(device=cuda)
    s = scene.replace(aux=scene.aux.clone().requires_grad_(True))
    with pytest.raises(NotImplementedError, match="K7"):
        render_pass(s, cam, cfg, RenderState.create(8, 8, device=cuda), 8, 8)
    assert counts() == before
    scene, cam, cfg = presets.mis_demo(device=cuda)
    s = scene.replace(emission=scene.emission.clone().requires_grad_(True))
    render_pass(s, cam, cfg, RenderState.create(8, 8, device=cuda), 8, 8).accum.sum().backward()
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1) + before[2:]


@pytest.mark.parametrize("where", ["restir_demo", "restir_stress"])
def test_restir_adjoint_matches_plain_autograd(cuda, where):
    """K7 against the plain `restir.trace_sample`'s autograd on the card,
    over passes 0-3 from an empty ring at 16x128 with 3 bounces: the scene
    leaves and every pass's rays within 1e-4 relative
    (tests/test_megakernel.py:128-129), one K6 and one K7 launch per pass;
    a second run gives the same bits."""
    scene, cam, cfg = getattr(presets, where)(device=cuda)
    cfg = cfg.replace(max_bounces=3)
    before = (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES, megakernel.LAUNCHES)
    _, got = restir_chain_grads(restir_kernel.trace_forward_restir_fused, scene, cfg, cam,
                                16, 128, 4)
    torch.cuda.synchronize()
    assert (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES, megakernel.LAUNCHES) == \
        (before[0] + 4, before[1] + 4, before[2])
    _, want = restir_chain_grads(restir.trace_sample, scene, cfg, cam, 16, 128, 4)
    assert_grads_close(got, want)
    _, again = restir_chain_grads(restir_kernel.trace_forward_restir_fused, scene, cfg, cam,
                                  16, 128, 4)
    for k in got:
        assert torch.equal(got[k], again[k]), k


@pytest.mark.parametrize("where", ["restir_demo", "restir_stress"])
def test_restir_adjoint_loss_scale_cotangents(cuda, where):
    """K7 under `make_loss`'s cotangents at the scale of a 512x512 image
    (`restir_chain_grads(l2_over=...)`), over passes 0-3 at 16x128 with 12
    bounces, against plain autograd: per leaf within 1e-4 relative."""
    scene, cam, cfg = getattr(presets, where)(device=cuda)
    n = 512 * 512 * 3
    loss, got = restir_chain_grads(restir_kernel._fused, scene, cfg, cam, 16, 128, 4, l2_over=n)
    ref_loss, want = restir_chain_grads(restir.trace_sample, scene, cfg, cam, 16, 128, 4,
                                        l2_over=n)
    assert abs(loss - ref_loss).item() <= 1e-5 * abs(ref_loss).item()
    assert_grads_close(got, want)
    assert got["emission"].abs().max().item() > 0.0


def test_kernel_occupancy_exports(cuda):
    """Every library's `*_occupancy` export answers on the card: K1, K4, K5
    and K6v (both forms) at 128 threads, K2 and K7 at their block sizes,
    each at least one block per SM with its registers; K7 on restir_demo
    fits one block (its per-thread cotangent columns take 132 KB)."""
    from raytracer0_tpu_torch.ops import cuda_build

    cornell = cornell_default(device=cuda)[0]
    demo = presets.restir_demo(device=cuda)[0]
    k2_t, k7_t = megakernel.BWD_THREADS, restir_kernel.bwd_threads(demo)
    rows = [("megakernel", megakernel.SOURCES, "rt0_trace_forward", 128,
             megakernel.packed_smem_bytes(cornell)),
            ("megakernel_bwd", megakernel.BWD_SOURCES, "rt0_trace_backward", k2_t,
             megakernel.bwd_layout(cornell, cornell_default(device=cuda)[2], k2_t)[1]),
            ("gbuffer", restir_split.GBUF_SOURCES, "rt0_gbuffer_forward", 128,
             megakernel.packed_smem_bytes(demo)),
            ("cast", restir_split.CAST_SOURCES, "rt0_cast_rays", 128,
             restir_split.cast_smem_bytes(demo)),
            ("restir_bwd", restir_kernel.BWD_SOURCES, "rt0_restir_backward", k7_t,
             restir_kernel.bwd_smem_bytes(demo, k7_t))]
    occ = {lib: cuda_build.occupancy(lib, src, sym + "_occupancy", t, smem, True)
           for lib, src, sym, t, smem in rows}
    for split in (False, True):   # the export's flag selects K6v's form
        occ[f"restir_vertex {split}"] = cuda_build.occupancy(
            "restir_vertex", restir_vertex.SOURCES, "rt0_restir_vertex_occupancy", 128,
            restir_vertex.smem_bytes(demo), split)
    for lib, o in occ.items():
        assert o["blocks"] >= 1 and o["registers"] > 0, (lib, o)
    assert occ["restir_bwd"]["blocks"] == 1 and occ["restir_bwd"]["smem"] > 128 * 1024


@pytest.mark.parametrize("n_lights", [None, 8, 9], ids=["cornell", "14_meshes", "15_meshes"])
def test_adjoint_layout_matches_occupancy(cuda, n_lights):
    """K2's launcher keeps a column of cotangent accumulators per thread
    exactly where the occupancy calculator gives that copy 3 blocks per SM
    or more (`megakernel.bwd_layout`, by the card's shared memory per SM
    and per block): Cornell and 14 meshes per thread, 15 meshes per warp."""
    from raytracer0_tpu_torch.ops import cuda_build

    if n_lights is None:
        scene, _, cfg = cornell_default(device=cuda)
    else:
        scene, _, cfg = presets.many_lights(device=cuda, n_lights=n_lights)
    n = scene.num_meshes
    scene_bytes = 4 * (n * (36 + 2) + scene.num_lights)
    per_thread = -(-scene_bytes // 16) * 16 + 4 * (4 + 5 * n) + 4 * n * 10 * 128
    warp, smem = megakernel.bwd_layout(scene, cfg)
    o = cuda_build.occupancy("megakernel_bwd", megakernel.BWD_SOURCES,
                             "rt0_trace_backward_occupancy", 128, per_thread, False)
    assert warp == (o["blocks"] < 3) and warp == (n_lights == 9), (n, o)
    assert smem == (per_thread - 4 * n * 10 * (128 - 4) if warp else per_thread)


def test_restir_fit_goes_through_k6_and_k7_only(cuda):
    """`optimize.fit` on restir_demo with passes=2: each step launches K6
    and K7 twice and neither K1 nor K2, and the loss falls."""
    scene, cam, cfg = presets.restir_demo(device=cuda, max_bounces=4)
    with torch.no_grad():
        target = optimize.render_linear(scene, cfg, cam, 32, 32, passes=2)
    is_light = (scene.mat_type == 0).float()[:, None]
    start = scene.replace(emission=scene.emission * (1.0 + 0.6 * is_light))
    counts = lambda: (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES, megakernel.LAUNCHES,
                      megakernel.BWD_LAUNCHES)
    before = counts()
    _, losses = optimize.fit(start, cfg, cam, target, ("emission",), steps=4,
                             learning_rate=0.3, passes=2, param_mask={"emission": is_light})
    torch.cuda.synchronize()
    assert counts() == (before[0] + 8, before[1] + 8, before[2], before[3])
    assert losses[-1] < losses[0], losses


def test_restir_adjoint_refuses_outside_its_class(cuda):
    """A ReSTIR gradient K7 does not model raises on the card before any
    launch: an SDF shape without its adjoint there (BOX, in a scene K4 and
    K6v march without the whole SDF class), a gradient w.r.t. a texel
    array (the images), a path deeper than the stash, more candidates than
    the tape holds (restir_stress's 41 lights)."""
    scene, cam, cfg = presets.restir_demo(device=cuda)
    stress, _, scfg = presets.restir_stress(device=cuda)
    em = scene.emission.clone().requires_grad_(True)
    images = scene.images.clone().requires_grad_(True)
    cases = [(scene.replace(emission=em, sdf_shapes_static=(0,)), cfg, "ROUND_BOX"),
             (scene.replace(emission=em, images=images), cfg, "images.*item 14"),
             (scene.replace(emission=em), cfg.replace(max_bounces=17, max_spec_bounces=17),
              "stash"),
             (stress.replace(emission=stress.emission.clone().requires_grad_(True)),
              scfg.replace(restir_samples=40), "candidates")]
    before = (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES)
    for s, c, words in cases:
        with pytest.raises(NotImplementedError, match=words):
            render_pass(s, cam, c, RenderState.create(8, 8, device=cuda), 8, 8)
    assert (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES) == before


def test_restir_kernel_refuses_outside_its_class(cuda):
    """A ReSTIR config K6 does not cover raises on the card; it never runs
    the plain version instead.  The ad-hoc reprojection renders through the
    split path, K4 and K6v's split form, and runs no K6 pass and no K5."""
    scene, cam, cfg = presets.restir_demo(device=cuda)
    before = restir_kernel.LAUNCHES
    with pytest.raises(NotImplementedError, match="item 11"):
        render_pass(scene, cam, cfg.replace(use_biased_sampling=False),
                    RenderState.create(8, 8, device=cuda), 8, 8)
    assert restir_kernel.LAUNCHES == before
    k4, k5, k6v = (restir_split.GBUF_LAUNCHES, restir_split.CAST_LAUNCHES,
                   restir_vertex.VERTEX_LAUNCHES)
    state = render_pass(scene, cam, cfg.replace(use_mis=True, restir_adhoc_motion=True),
                        RenderState.create(8, 8, device=cuda), 8, 8)
    torch.cuda.synchronize()
    assert (restir_split.GBUF_LAUNCHES, restir_split.CAST_LAUNCHES,
            restir_vertex.VERTEX_LAUNCHES) == (k4 + 1, k5, k6v + 1)
    assert restir_kernel.LAUNCHES == before and bool(torch.isfinite(state.accum).all())


def _realtime(cuda, **kw):
    return presets.animated_untextured(device=cuda, **kw)


@pytest.mark.parametrize("where", ["restir_demo", "animated_untextured"])
def test_gbuffer_kernel_matches_plain(cuda, where):
    """K4 against its plain version bit for bit: the radiance without
    diffuse NEE and every slot's position, normal, throughput, mesh index,
    depth and valid flag, at 16x128 (a ragged 13x77 too)."""
    scene, cam, cfg = getattr(presets, where)(device=cuda)
    scene = scene_mod.animate_positions(scene, 0.7, int(cfg.render_mode))
    for h, w in ((16, 128), (13, 77)):
        ro, rd = generate_rays(cam, h, w, 3)
        pix = rng.pixel_ids(h, w, device=cuda)
        before = restir_split.GBUF_LAUNCHES
        out, gbuf = restir_split.trace_forward_gbuffer(scene, cfg, ro, rd, pix, 3, 0)
        ref, ref_gbuf = restir_split.gbuffer_plain(scene, cfg, ro, rd, pix, 3, 0)
        torch.cuda.synchronize()
        assert restir_split.GBUF_LAUNCHES == before + 1
        assert torch.equal(out, ref)
        for got, want in zip(gbuf, ref_gbuf, strict=True):
            for f in got:
                assert torch.equal(got[f], want[f]), f


@pytest.mark.parametrize("grid", ["resident", "one_block"])
def test_gbuffer_persistent_grid_matches_plain(cuda, monkeypatch, grid):
    """K4's persistent launch at 512x512 on `restir_demo`, on the grid of
    its resident blocks and on one block (every lane regenerates some 16
    times), against its plain version bit for bit, twice (the last block
    resets the ticket counter for the next launch)."""
    if grid == "one_block":
        monkeypatch.setattr(restir_split, "resident_blocks", lambda dev, sdf, smem: 1)
    else:
        scene = presets.restir_demo(device=cuda)[0]
        assert restir_split.resident_blocks(cuda, True, megakernel.packed_smem_bytes(scene)) > 132
    scene, cam, cfg = presets.restir_demo(device=cuda)
    ro, rd = generate_rays(cam, 512, 512, 3)
    pix = rng.pixel_ids(512, 512, device=cuda)
    ref, ref_gbuf = restir_split.gbuffer_plain(scene, cfg, ro, rd, pix, 3, 0)
    for _ in range(2):
        out, gbuf = restir_split.trace_forward_gbuffer(scene, cfg, ro, rd, pix, 3, 0)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        for got, want in zip(gbuf, ref_gbuf, strict=True):
            for f in got:
                assert torch.equal(got[f], want[f]), f
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert restir_split.ticket_counter(cuda, stream).tolist() == [0, 0]


@pytest.mark.parametrize("where", ["restir_demo", "mis_demo", "animated_untextured"])
def test_cast_kernel_matches_plain(cuda, where):
    """K5 against the plain `intersect.intersect` bit for bit (t, index,
    missed) on the primary rays and on rays from the primary hits toward
    the lights."""
    scene, cam, cfg = getattr(presets, where)(device=cuda)
    scene = scene_mod.animate_positions(scene, 1.3, int(cfg.render_mode))
    ro, rd = generate_rays(cam, 16, 128, 1)
    t0, _, _ = restir.default_cast(scene, cfg)(ro, rd)
    x = ro + rd * t0[..., None]
    lp = scene.pos[torch.clamp_min(scene.light_idx.long(), 0)][0]
    d = (lp - x) / torch.linalg.vector_norm(lp - x, dim=-1, keepdim=True)
    for o_, d_ in ((ro, rd), ((x + d * cfg.epsilon).contiguous(), d.contiguous())):
        before = restir_split.CAST_LAUNCHES
        t, idx, missed = restir_split.cast_rays(scene, cfg, o_, d_)
        t_ref, idx_ref, missed_ref = restir.default_cast(scene, cfg)(o_, d_)
        torch.cuda.synchronize()
        assert restir_split.CAST_LAUNCHES == before + 1
        assert torch.equal(t, t_ref) and torch.equal(idx.long(), idx_ref)
        assert torch.equal(missed, missed_ref)


@pytest.mark.parametrize("moving", [False, True], ids=["constant_time", "moving_time"])
def test_restir_kernel_animated_matches_plain(cuda, moving):
    """K6 under ANIMATED accumulation against the plain render_sample bit
    for bit at passes 0-3 of the real-time scene at 16x128: at a constant
    frame time, and at a moving one with the plain ring's light data
    refreshed to the frame's before each pass (what K6 reads)."""
    scene, cam, cfg = _realtime(cuda)
    h, w = 16, 128
    kernel, plain = RenderState.create(h, w, device=cuda), RenderState.create(h, w, device=cuda)
    for p in range(4):
        t = p / 30 if moving else 0.9
        if moving:
            plain = refreshed_ring(scene_mod.animate_positions(scene, t, 1), plain)
        out, new = restir_kernel.render_sample_fused(scene, cfg, cam, kernel, h, w, p, t)
        ref, new_ref = restir.render_sample(scene, cfg, cam, plain, h, w, p, t)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), p
        for k, v in new.fields().items():
            assert torch.equal(v, getattr(new_ref, k)), (p, k)
        kernel, plain = kernel.rotate_reservoirs(new), plain.rotate_reservoirs(new_ref)


def test_restir_adjoint_animated(cuda):
    """K7 under ANIMATED accumulation against the plain autograd over passes
    0-3 of the real-time scene at a constant frame time, 16x128, within
    1e-4 relative per leaf; a second run gives the same bits."""
    scene, cam, cfg = _realtime(cuda)
    animate = lambda s: scene_mod.animate_positions(s, 0.9, 1)
    kernel = lambda s, *a: restir_kernel.trace_forward_restir_fused(animate(s), *a)
    _, got = restir_chain_grads(kernel, scene, cfg, cam, 16, 128, 4)
    _, want = restir_chain_grads(lambda s, *a: restir.trace_sample(animate(s), *a), scene, cfg,
                                 cam, 16, 128, 4)
    assert_grads_close(got, want)
    _, again = restir_chain_grads(kernel, scene, cfg, cam, 16, 128, 4)
    for k in got:
        assert torch.equal(got[k], again[k]), k


def test_split_pass_matches_plain(cuda):
    """Four real-time frames through `render_pass` with the ad-hoc
    reprojection on the card: one K4 and one K6v launch each (split form),
    no K5 and no K6 pass; each frame equals the split pass with the plain
    G-buffer and caster bit for bit, and the plain render_sample under JAX's
    fast-versus-wavefront contract (max 5e-3, median 1e-6); a gradient
    through it raises before any launch."""
    scene, cam, cfg = _realtime(cuda, restir_adhoc_motion=True)
    h, w = 16, 128
    state = plain = RenderState.create(h, w, device=cuda)
    for p in range(4):
        t = p / 30
        counts = lambda: (restir_split.GBUF_LAUNCHES, restir_split.CAST_LAUNCHES,
                          restir_vertex.VERTEX_LAUNCHES, restir_kernel.LAUNCHES)
        before = counts()
        rad, new = restir_split.render_sample_fast(scene, cfg, cam, state, h, w, p, t)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, before[1], before[2] + 1, before[3])
        ref, new_ref = restir_split.render_sample_split(
            scene, cfg, cam, state, h, w, p, t, restir_split.gbuffer_plain, restir.default_cast)
        assert torch.equal(rad, ref)
        for k, v in new.fields().items():
            assert torch.equal(v, getattr(new_ref, k)), (p, k)
        wave, _ = restir.render_sample(scene, cfg, cam, state, h, w, p, t)
        err = (rad - wave).abs()
        assert err.max().item() < 5e-3 and err.median().item() < 1e-6, p
        state = state.rotate_reservoirs(new)
    before = counts()
    em = scene.emission.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no adjoint"):
        render_pass(scene.replace(emission=em), cam, cfg, plain, h, w, 0.1)
    assert counts() == before


def test_split_refuses_textures_and_cubemap_before_any_launch(cuda):
    """Fault 11: under ReSTIR with the ad-hoc reprojection the split path
    refuses a cubemap, naming ROADMAP queue 1 item 11, before any launch
    (`render_sample_fast` and `render_pass` alike): no test holds K4 and
    K6v's split form on such scenes.  Blended textures, which it refused
    until K4 and K6v were held on them, it renders bit for bit against its
    plain version."""
    scene, cam, cfg = presets.restir_demo(device=cuda)
    adhoc = cfg.replace(restir_adhoc_motion=True)
    h, w = 16, 128
    state = RenderState.create(h, w, device=cuda)
    counts = lambda: (restir_split.GBUF_LAUNCHES, restir_vertex.VERTEX_LAUNCHES,
                      restir_split.CAST_LAUNCHES, restir_kernel.LAUNCHES)
    before = counts()
    cube = adhoc.replace(use_cubemap=True, use_procedural_sky=False)
    with pytest.raises(NotImplementedError, match="cubemap.*item 11"):
        restir_split.render_sample_fast(scene, cube, cam, state, h, w, 0)
    with pytest.raises(NotImplementedError, match="item 11"):
        render_pass(scene, cam, cube, state, h, w)
    torch.cuda.synchronize()
    assert counts() == before
    textured = presets.textured_restir_demo(device=cuda)[0]
    out, new = restir_split.render_sample_fast(textured, adhoc, cam, state, h, w, 0)
    ref, new_ref = restir_split.render_sample_split(textured, adhoc, cam, state, h, w, 0, 0.0,
                                                    restir_split.gbuffer_plain,
                                                    restir.default_cast)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2], before[3])
    assert torch.equal(out, ref)
    assert all(torch.equal(v, getattr(new_ref, k)) for k, v in new.fields().items())


@pytest.mark.parametrize("form,where", [("fused", "restir_demo"), ("fused", "restir_stress"),
                                        ("split", "animated_untextured"),
                                        ("split", "restir_demo")])
def test_vertex_kernel_matches_plain(cuda, form, where):
    """K6v in both forms bit for bit against its plain versions at 64x256
    over passes 0-3, each threading its own ring: the fused form (K6's
    route) against `restir.render_sample`, the split form (the ad-hoc
    reprojection; on the real-time scene under ANIMATED at a moving frame
    time) against `render_sample_split` with the plain G-buffer and
    caster."""
    scene, cam, cfg = getattr(presets, where)(device=cuda)
    split = form == "split"
    cfg = cfg.replace(restir_adhoc_motion=split)
    h, w = 64, 256
    kernel = plain = RenderState.create(h, w, device=cuda)
    for p in range(4):
        t = p / 30
        before = restir_vertex.VERTEX_LAUNCHES
        if split:
            out, new = restir_split.render_sample_fast(scene, cfg, cam, kernel, h, w, p, t)
            ref, new_ref = restir_split.render_sample_split(
                scene, cfg, cam, plain, h, w, p, t, restir_split.gbuffer_plain,
                restir.default_cast)
        else:
            out, new = restir_kernel.render_sample_fused(scene, cfg, cam, kernel, h, w, p)
            ref, new_ref = restir.render_sample(scene, cfg, cam, plain, h, w, p)
        torch.cuda.synchronize()
        assert restir_vertex.VERTEX_LAUNCHES == before + 1
        assert torch.equal(out, ref), (p, int((out != ref).any(-1).sum()))
        for k, v in new.fields().items():
            assert torch.equal(v, getattr(new_ref, k)), (p, k)
        kernel, plain = kernel.rotate_reservoirs(new), plain.rotate_reservoirs(new_ref)
    assert int((new.light_index >= 0).sum()) > h * w // 2 and ref.max().item() > 0.0


def test_restir_adjoint_registers_unchanged(cuda):
    """K7 includes the reservoir vertex K6v templates (csrc/restir.cuh)
    and, since its whole-SDF copy came, is a template itself; its ROUND_BOX
    copy compiles to the code K7 had before: 168 registers and a 1,328-byte
    stack per thread (ptxas, PERF.md §6), one block of 128 threads per SM
    on restir_demo."""
    from raytracer0_tpu_torch.ops import cuda_build

    demo = presets.restir_demo(device=cuda)[0]
    t = restir_kernel.bwd_threads(demo)
    o = cuda_build.occupancy("restir_bwd", restir_kernel.BWD_SOURCES,
                             "rt0_restir_backward_occupancy", t,
                             restir_kernel.bwd_smem_bytes(demo, t), True)
    assert (o["registers"], o["local_bytes"], o["blocks"], t) == (168, 1328, 1, 128), o


def _restir_sdf_case(where, device):
    """(scene, camera, cfg) of a ReSTIR scene of the whole SDF class or with
    blended textures: `animated_restir` as shipped, the ReSTIR views of
    `presets.RESTIR_SDF_VIEWS`, `textured_cornell` with ReSTIR and MIS off."""
    if where == "animated_restir":
        return presets.animated_restir(device=device)
    if where == "textured_cornell":
        return presets.textured_cornell(device=device, use_restir=True, use_mis=False)
    return presets.restir_sdf_view(where, device=device)


@pytest.mark.parametrize("where", ["animated_restir", "mandelbulb", "every_shape", "polygons",
                                   "textured_cornell"])
def test_restir_whole_sdf_matches_plain(cuda, where):
    """K4 and the K6 pass (K4, then K6v's fused form, in their whole-SDF
    copies where `megakernel.whole_sdf` says so) bit for bit against the
    plain `gbuffer_plain` and `restir.render_sample` at 64x64 over passes
    0-2, each threading its own ring, at a constant frame time; one K4 and
    one K6v launch per pass and no other."""
    scene, cam, cfg = _restir_sdf_case(where, cuda)
    cfg = cfg.replace(max_bounces=min(cfg.max_bounces, 4), marching_steps=64)
    t = 0.5 if int(cfg.render_mode) else 0.0
    h = w = 64
    frame = scene_mod.animate_positions(scene, t, int(cfg.render_mode))
    ro, rd = generate_rays(cam, h, w, 0)
    pix = rng.pixel_ids(h, w, device=cuda)
    out, gbuf = restir_split.trace_forward_gbuffer(frame, cfg, ro, rd, pix, 0, 0)
    ref, ref_gbuf = restir_split.gbuffer_plain(frame, cfg, ro, rd, pix, 0, 0)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert all(torch.equal(a[f], b[f]) for a, b in zip(gbuf, ref_gbuf) for f in a)
    kernel = plain = RenderState.create(h, w, device=cuda)
    counts = lambda: (restir_split.GBUF_LAUNCHES, restir_vertex.VERTEX_LAUNCHES,
                      megakernel.LAUNCHES, restir_split.CAST_LAUNCHES)
    for p in range(3):
        before = counts()
        out, new = restir_kernel.render_sample_fused(scene, cfg, cam, kernel, h, w, p, t)
        ref, new_ref = restir.render_sample(scene, cfg, cam, plain, h, w, p, t)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, before[1] + 1, before[2], before[3])
        assert torch.equal(out, ref), (p, int((out != ref).any(-1).sum()))
        for k, v in new.fields().items():
            assert torch.equal(v, getattr(new_ref, k)), (p, k)
        kernel, plain = kernel.rotate_reservoirs(new), plain.rotate_reservoirs(new_ref)
    assert int((new.light_index >= 0).sum()) > h * w // 2 and ref.max().item() > 0.0


@pytest.mark.parametrize("where", ["animated_restir", "every_shape"])
def test_restir_whole_sdf_split_matches_plain(cuda, where):
    """The split path (K4, then K6v's split form, each in its whole-SDF
    copy) bit for bit against `render_sample_split` with the plain G-buffer
    and caster at 64x128 over 5 passes at the frame times (p+1)/30 (the
    preset as shipped under ANIMATED), each threading its own ring."""
    scene, cam, cfg = _restir_sdf_case(where, cuda)
    cfg = cfg.replace(restir_adhoc_motion=True, marching_steps=64)
    h, w = 64, 128
    kernel = plain = RenderState.create(h, w, device=cuda)
    for p in range(5):
        t = (p + 1) / 30
        before = (restir_split.GBUF_LAUNCHES, restir_vertex.VERTEX_LAUNCHES)
        out, new = restir_split.render_sample_fast(scene, cfg, cam, kernel, h, w, p, t)
        ref, new_ref = restir_split.render_sample_split(
            scene, cfg, cam, plain, h, w, p, t, restir_split.gbuffer_plain, restir.default_cast)
        torch.cuda.synchronize()
        assert (restir_split.GBUF_LAUNCHES, restir_vertex.VERTEX_LAUNCHES) == \
            (before[0] + 1, before[1] + 1)
        assert torch.equal(out, ref), (p, int((out != ref).any(-1).sum()))
        for k, v in new.fields().items():
            assert torch.equal(v, getattr(new_ref, k)), (p, k)
        kernel, plain = kernel.rotate_reservoirs(new), plain.rotate_reservoirs(new_ref)


@pytest.mark.parametrize("where", ["animated_restir", "mandelbulb", "textured_cornell"])
def test_k7_refuses_the_new_class_before_any_launch(cuda, where):
    """What K7 still refuses on a scene of the class its whole-SDF copy now
    differentiates (an SDF shape other than ROUND_BOX, a texture blended
    into any row) raises in K7's gate before any launch: a gradient w.r.t.
    a texel array (the noise LUT), naming item 14."""
    scene, cam, cfg = _restir_sdf_case(where, cuda)
    assert restir_kernel.unsupported_restir(scene, cfg) is None
    assert restir_kernel.unsupported_restir_bwd(scene, cfg) is None
    noise = scene.noise.clone().requires_grad_(True)
    counts = lambda: (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES,
                      restir_split.GBUF_LAUNCHES, restir_vertex.VERTEX_LAUNCHES,
                      megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    before = counts()
    with pytest.raises(NotImplementedError, match="K7 does not cover.*noise.*item 14"):
        optimize.render_linear(scene.replace(noise=noise), cfg, cam, 8, 8, passes=2)
    torch.cuda.synchronize()
    assert counts() == before


#: the scenes of K7's whole-SDF copy on the card: the host build's, and the
#: preset under STATIC accumulation
K7_CARD = K7_SDF_SCENES + ("animated_restir_static",)
#: (passes, size) of a hold on the card, each scene at its own depth: 4
#: passes at 32x32; the `mandelbulb` view, whose plain passes at 12 bounces
#: and 128 marching steps take ~30 s each (its launches, not its pixels), 2
K7_CARD_SIZE = {"mandelbulb": (2, 32)}


def _k7_card_case(where, dev):
    if where == "animated_restir_static":
        return k7_case("animated_restir", dev, render_mode=0)
    return k7_case(where, dev)


@pytest.mark.parametrize("where", K7_CARD)
def test_restir_whole_sdf_adjoint_matches_plain_autograd(cuda, where):
    """K7's whole-SDF copy against the plain autograd on the card, each
    scene at its own depth (the preset's 6 bounces, the `mandelbulb`
    view's 12 bounces and 128 marching steps), over the passes of
    `K7_CARD_SIZE` from an empty ring (the ANIMATED preset at a constant
    frame time): every table leaf and ray within 1e-4 of the leaf
    (`assert_grads_close`), the aux and texture leaves each scene reads
    engaged, one K6 and one K7 launch per pass and no other kernel; a
    second run gives the same bits."""
    scene, cam, cfg = _k7_card_case(where, cuda)
    passes, n = K7_CARD_SIZE.get(where, (4, 32))
    assert restir_kernel.bwd_copy(scene) == "whole_sdf"
    counts = lambda: (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES, megakernel.LAUNCHES,
                      megakernel.BWD_LAUNCHES, restir_split.CAST_LAUNCHES)
    before = counts()
    _, got = chain_grads(animated(restir_kernel._fused, cfg), scene, cfg, cam, n, n, passes)
    torch.cuda.synchronize()
    assert counts() == (before[0] + passes, before[1] + passes) + before[2:]
    _, want = chain_grads(animated(restir.trace_sample, cfg), scene, cfg, cam, n, n, passes)
    assert_grads_close(got, want)
    for k in ("emission", "color", "pos", "rd") + READS.get(where, ()):
        assert got[k].abs().max().item() > 0.0, k
    _, again = chain_grads(animated(restir_kernel._fused, cfg), scene, cfg, cam, n, n, passes)
    for k in got:
        assert torch.equal(got[k], again[k]), k


def test_restir_whole_sdf_fit_goes_through_k6_and_k7_only(cuda):
    """`optimize.fit` through K7's whole-SDF copy on `animated_restir` as
    shipped (a constant frame time; its METAL rounded box's color and the
    lights' emission, toward a target rendered from the shipped values):
    each step launches K6 and K7 twice and neither K1 nor K2, and the loss
    falls."""
    scene, cam, cfg = presets.animated_restir(device=cuda, max_bounces=4)
    with torch.no_grad():
        target = optimize.render_linear(scene, cfg, cam, 32, 32, passes=2)
    is_light = (scene.mat_type == 0).float()[:, None]
    box = torch.zeros_like(is_light)
    box[-1] = 1.0
    start = scene.replace(emission=scene.emission * (1.0 + 0.6 * is_light),
                          color=scene.color * (1.0 - 0.5 * box))
    counts = lambda: (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES, megakernel.LAUNCHES,
                      megakernel.BWD_LAUNCHES)
    before = counts()
    _, losses = optimize.fit(start, cfg, cam, target, ("emission", "color"), steps=4,
                             learning_rate=0.1, passes=2,
                             param_mask={"emission": is_light, "color": box})
    torch.cuda.synchronize()
    assert counts() == (before[0] + 8, before[1] + 8, before[2], before[3])
    assert losses[-1] < losses[0], losses


def test_k7_whole_sdf_occupancy(cuda):
    """K7's whole-SDF copy fits at least one block per SM on each scene of
    its class at the block size `bwd_threads` picks (128, or 64 on
    `every_shape`, whose 17 meshes keep 33 columns)."""
    from raytracer0_tpu_torch.ops import cuda_build

    for where in K7_SDF_SCENES:
        sc = k7_case(where, cuda)[0]
        t = restir_kernel.bwd_threads(sc)
        o = cuda_build.occupancy("restir_bwd_sdf", restir_kernel.BWD_SDF_SOURCES,
                                 "rt0_restir_backward_occupancy", t,
                                 restir_kernel.bwd_smem_bytes(sc, t), 2)
        assert o["blocks"] >= 1 and t == (64 if where == "every_shape" else 128), (where, o)


def test_gbuffer_and_vertex_old_copies_unchanged(cuda):
    """K4's and K6v's copies that ran before their whole-SDF copies came
    keep their code: K4 80 registers and 56 bytes of local memory on
    `restir_demo` (6 blocks per SM), K6v 64 and 32 (fused form) and 72
    and 32 (split form); and the whole-SDF copies fit blocks of 128."""
    from raytracer0_tpu_torch.ops import cuda_build

    demo = presets.restir_demo(device=cuda)[0]
    bulb = presets.mandelbulb(device=cuda)[0]
    k4 = lambda sc, flags: cuda_build.occupancy(
        "gbuffer", restir_split.GBUF_SOURCES, "rt0_gbuffer_forward_occupancy", 128,
        megakernel.packed_smem_bytes(sc), flags)
    k6v = lambda sc, flags: cuda_build.occupancy(
        "restir_vertex", restir_vertex.SOURCES, "rt0_restir_vertex_occupancy", 128,
        restir_vertex.smem_bytes(sc), flags)
    o = k4(demo, restir_split.gbuffer_copy(demo))
    assert (o["registers"], o["local_bytes"], o["blocks"]) == (80, 56, 6), o
    for split, want in ((False, (64, 32)), (True, (72, 32))):
        o = k6v(demo, restir_vertex.vertex_copy(demo, split))
        assert (o["registers"], o["local_bytes"]) == want, o
    assert k4(bulb, restir_split.gbuffer_copy(bulb))["blocks"] >= 1
    for split in (False, True):
        assert k6v(bulb, restir_vertex.vertex_copy(bulb, split))["blocks"] >= 1


@pytest.mark.parametrize("name", list(MEDIUM_CASES))
def test_medium_kernel_matches_plain(cuda, name):
    """K1's medium copy, through `trace_forward` (its RGB scale applied
    after the launch), against the plain version on the card bit for bit
    at 64x64, each scene at its own depth (preset 8: 12 bounces), one
    launch: both call the card's libm, and the kernel follows the plain
    version's operations in order without FMA contraction."""
    scene, cam, cfg = medium_case(name, device=cuda)
    ro, rd = generate_rays(cam, 64, 64, 2)
    pix = rng.pixel_ids(64, 64, device=cuda)
    before = megakernel.LAUNCHES
    out = megakernel.trace_forward(scene, cfg, ro, rd, pix, 2, 0)
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before + 1
    assert bool(torch.isfinite(out).all()) and ref.max().item() > 0.02
    n_diff = int((out != ref).any(dim=-1).sum())
    assert n_diff == 0, f"{n_diff} pixels differ, max {(out - ref).abs().max().item():.3e}"


def test_medium_render_goes_through_k1_only(cuda, monkeypatch):
    """`Renderer(*spectral_caustics()).render(2)` launches K1 twice and
    nothing else, and never calls the plain version."""
    scene, cam, cfg = presets.spectral_caustics(device=cuda)
    calls = []
    plain = integrator.trace
    monkeypatch.setattr(integrator, "trace", lambda *a, **k: calls.append(1) or plain(*a, **k))
    counts = {(m, a): getattr(m, a) for m, a in LAUNCH_COUNTS}
    img = Renderer(scene, cam, cfg, 32, 32).render(2)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == counts[(megakernel, "LAUNCHES")] + 2 and not calls
    assert all(getattr(m, a) == n for (m, a), n in counts.items() if a != "LAUNCHES"
               or m is not megakernel)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0.01


def test_medium_refused_by_k2_and_restir_before_any_launch(cuda):
    """A gradient through preset 8 w.r.t. a texel array (K2's medium copy,
    as every copy, differentiates the scene table and the rays: item 14),
    and a ReSTIR pass, the split path and a ReSTIR gradient with spectral
    transport or the medium (item 10) raise NotImplementedError naming
    their ROADMAP item, and launch nothing."""
    scene, cam, cfg = presets.spectral_caustics(device=cuda)
    counts = {(m, a): getattr(m, a) for m, a in LAUNCH_COUNTS}
    ro, rd = generate_rays(cam, 16, 16, 0)
    noise = scene.noise.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="item 14"):
        megakernel.trace_forward(scene.replace(noise=noise), cfg, ro, rd,
                                 rng.pixel_ids(16, 16, device=cuda), 0, 0)
    demo, dcam, dcfg = presets.restir_demo(device=cuda)
    for kw in (dict(use_volumetrics=True), dict(use_spectral=True),
               dict(use_volumetrics=True, restir_adhoc_motion=True)):
        with pytest.raises(NotImplementedError, match="item 10"):
            Renderer(demo, dcam, dcfg.replace(**kw), 16, 16).step()
    em = demo.emission.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="item 10"):
        render_pass(demo.replace(emission=em), dcam, dcfg.replace(use_volumetrics=True),
                    RenderState.create(16, 16, cuda), 16, 16)
    assert all(getattr(m, a) == n for (m, a), n in counts.items())


#: K1's copies other than the medium copy, by the flags of its occupancy
#: export (bit 0 the SDF march, bit 1 the shadow hit's texel, bit 2 the
#: whole SDF class), with the registers and bytes of local memory they had
#: before the medium copy came (PERF.md §6)
K1_OLD_COPIES = {0: (64, 88), 1: (64, 152), 2: (64, 128), 3: (64, 184), 5: (64, 256),
                 7: (64, 256)}


def test_medium_copy_and_k1_old_copies(cuda):
    """K1's old copies keep their code beside the medium copy (registers
    and local memory per copy, as before it came: K1_OLD_COPIES), and the
    medium copy fits blocks of 128 on preset 8."""
    from raytracer0_tpu_torch.ops import cuda_build

    occ = lambda sc, flags: cuda_build.occupancy(
        "megakernel", megakernel.SOURCES, "rt0_trace_forward_occupancy", 128,
        megakernel.packed_smem_bytes(sc), flags)
    scene = presets.spectral_caustics(device=cuda)[0]
    for flags, want in K1_OLD_COPIES.items():
        o = occ(scene, flags)
        assert (o["registers"], o["local_bytes"]) == want, (flags, o)
    assert occ(scene, 8)["blocks"] >= 1


@pytest.mark.parametrize("name", list(MEDIUM_CASES))
def test_medium_adjoint_matches_plain_autograd(cuda, name):
    """K2's medium copy against torch.autograd of the plain version on the
    card at 64x64, each scene at its own depth (preset 8: 12 bounces, where
    the flint's IOR carries a gradient), per table leaf and the rays within
    1e-4 relative, arbitrated in float64 as `assert_grads_close_f64` does
    (`default_scene`'s pos, joker and rays held against float64, as for
    the whole-SDF copy): one K1, one K2 launch (of the medium copy), K1's
    radiance the plain version's bit for bit; a second launch of the copy
    on the same cotangent gives the same bits."""
    scene, cam, cfg = medium_case(name, device=cuda)
    assert megakernel.unsupported_bwd(scene, cfg) is None
    assert megakernel.bwd_copy(scene, cfg) == "medium"
    h = w = 64
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w, device=cuda)
    counts = lambda: (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES, megakernel.BWD_MEDIUM_LAUNCHES)
    before = counts()
    out, got = _table_grads(megakernel.trace_forward, scene, cfg, ro, rd, pix)
    torch.cuda.synchronize()
    assert counts() == tuple(n + 1 for n in before)
    ref, want = _table_grads(integrator.trace, scene, cfg, ro, rd, pix)
    assert torch.equal(out, ref)
    assert_grads_close_f64(got, want, lambda kind, mask: _table_grads(
        megakernel.trace_forward if kind == "kernel" else integrator.trace, scene, cfg, ro, rd,
        pix, torch.float64 if kind == "plain64" else torch.float32, mask),
        f64_leaves=("pos", "joker", "ro", "rd") if name == "default_scene" else ())
    assert got["color"].abs().max().item() > 0.0
    if name in ("spectral_caustics", "spectral_only"):
        assert got["ior"].abs().max().item() > 0.0
    table = megakernel.scene_table(scene)
    ct = torch.rand(ro.shape, generator=torch.Generator(cuda).manual_seed(3), device=cuda)
    first, second = (megakernel._launch_backward(scene, cfg, table, ro, rd, pix, 2, 0, ct)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_medium_recorded_and_unrecorded_forward_agree(cuda):
    """`trace_forward` on preset 8 gives the same image bits whether the
    call is recorded for a gradient (K1 under `_TraceCore`) or not: both
    routes scale K1's radiance by the hero wavelength's RGB weight."""
    scene, cam, cfg = presets.spectral_caustics(device=cuda)
    ro, rd = generate_rays(cam, 64, 64, 1)
    pix = rng.pixel_ids(64, 64, device=cuda)
    plain = megakernel.trace_forward(scene, cfg, ro, rd, pix, 1, 0)
    em = scene.emission.clone().requires_grad_(True)
    recorded = megakernel.trace_forward(scene.replace(emission=em), cfg, ro, rd, pix, 1, 0)
    assert recorded.requires_grad and torch.equal(recorded.detach(), plain)
    assert torch.equal(plain, integrator.trace(scene, cfg, ro, rd, pix, 1, 0))


def test_medium_fit_goes_through_k1_and_k2_only(cuda, monkeypatch):
    """`optimize.fit` of preset 8's two lights' emission at 64x64 for 5
    steps from 0.7 of it: the loss falls, K1's and K2's medium copies
    launch once per step, the plain version never runs."""
    scene, cam, cfg = presets.spectral_caustics(device=cuda)
    rows = torch.zeros(scene.num_meshes, 1, device=cuda)
    rows[[5, 6]] = 1.0
    target = megakernel.trace_forward(
        scene, cfg, *generate_rays(cam, 64, 64, 0), rng.pixel_ids(64, 64, device=cuda), 0, 0)
    calls = []
    plain = integrator.trace
    monkeypatch.setattr(integrator, "trace", lambda *a, **k: calls.append(1) or plain(*a, **k))
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES, megakernel.BWD_MEDIUM_LAUNCHES)
    start = scene.emission * (1.0 - 0.3 * rows)
    _, losses = optimize.fit(scene.replace(emission=start), cfg, cam, target, ["emission"],
                             steps=5, learning_rate=5e-2, param_mask={"emission": rows})
    torch.cuda.synchronize()
    after = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES, megakernel.BWD_MEDIUM_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == (5, 5, 5) and not calls
    assert losses[-1] < losses[0], losses


def test_k2_medium_copy_and_old_copies(cuda):
    """K2's medium copy is a library of its own: the Cornell, wide and
    whole-SDF copies keep their registers and local memory (phase 2 of
    chip_smoke.py holds their ptxas lines), and the medium copy fits
    blocks of 128 on preset 8."""
    from raytracer0_tpu_torch.ops import cuda_build

    scene, _, cfg = presets.spectral_caustics(device=cuda)
    warp, smem = megakernel.bwd_layout(scene, cfg)
    o = cuda_build.occupancy(*megakernel.bwd_library("medium"), "rt0_trace_backward_occupancy",
                             megakernel.BWD_THREADS, smem, 8 | 2 | int(warp))
    print(f"K2's medium copy on preset 8: {o}")
    assert o["blocks"] >= 1
    for where, want in (("cornell", (128, 928)), ("mis_demo", (128, 2160))):
        sc, c = ((cornell_default(device=cuda)[0], cornell_default(device=cuda)[2])
                 if where == "cornell" else presets.mis_demo(device=cuda)[::2])
        w2, sm2 = megakernel.bwd_layout(sc, c)
        copy = megakernel.bwd_copy(sc, c)
        flags = int(w2) | (2 if copy != "cornell" else 0)
        o2 = cuda_build.occupancy(*megakernel.bwd_library(copy), "rt0_trace_backward_occupancy",
                                  megakernel.BWD_THREADS, sm2, flags)
        assert (o2["registers"], o2["local_bytes"]) == want, (where, o2)
