"""K1 and its adjoint K2 on the GPU against their plain versions on the
same card.

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
from raytracer0_tpu_torch.models.camera import generate_rays
from raytracer0_tpu_torch.models.dsl import parse_scene
from raytracer0_tpu_torch.models.presets import cornell_default
from raytracer0_tpu_torch.ops import megakernel
from raytracer0_tpu_torch.render import integrator
from raytracer0_tpu_torch.render.renderer import Renderer, render_pass
from raytracer0_tpu_torch.render.state import RenderState

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
    scene = parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_LIGHT_4, SPHERE, vec3(0.0, 1.5, -1.0), vec4(0.3)
        MAT_MIRROR, SPHERE, vec3(0.6, -0.6, -0.5), vec4(0.4)
    """, device=cuda)
    _, cam, cfg = cornell_default(device=cuda)
    ro, rd = generate_rays(cam, 8, 8, 0)
    with pytest.raises(NotImplementedError):
        megakernel.trace_forward(scene, cfg, ro, rd,
                                 rng.pixel_ids(8, 8, device=cuda), 0, 0)
    with pytest.raises(NotImplementedError):
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
    the plain backward instead."""
    scene = parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_LIGHT_4, SPHERE, vec3(0.0, 1.5, -1.0), vec4(0.3)
        MAT_MIRROR, SPHERE, vec3(0.6, -0.6, -0.5), vec4(0.4)
    """, device=cuda)
    _, cam, cfg = cornell_default(device=cuda)
    ro, rd = generate_rays(cam, 8, 8, 0)
    em = scene.emission.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError):
        megakernel.trace_forward(scene.replace(emission=em), cfg, ro, rd,
                                 rng.pixel_ids(8, 8, device=cuda), 0, 0)
    cornell, _, _ = cornell_default(device=cuda)
    deep = cfg.replace(max_bounces=40, max_diff_bounces=30)
    with pytest.raises(NotImplementedError, match="stash"):
        megakernel.trace_forward(
            cornell.replace(emission=cornell.emission.clone().requires_grad_(True)),
            deep, ro, rd, rng.pixel_ids(8, 8, device=cuda), 0, 0)
