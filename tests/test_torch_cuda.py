"""K1 on the GPU against its plain version on the same card.

These tests need a CUDA device and nvcc (the kernel is built on first use);
without them they skip.  On the GPU machine run:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: the parity contract (>= 99 % of pixels within 1e-5, median
below 1e-4).  The kernel follows the plain version's operations in order
and is built without fast math or FMA contraction, so it agrees bit for
bit wherever the two libm calls round alike.
"""

import pytest
import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.models.camera import generate_rays
from raytracer0_tpu_torch.models.dsl import parse_scene
from raytracer0_tpu_torch.models.presets import cornell_default
from raytracer0_tpu_torch.ops import megakernel
from raytracer0_tpu_torch.render import integrator
from raytracer0_tpu_torch.render.renderer import Renderer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _parity(out, ref):
    err = (out - ref).abs().amax(dim=-1)
    assert (err < 1e-5).float().mean().item() >= 0.99, err.max().item()
    assert err.median().item() < 1e-4


@pytest.mark.parametrize("h,w,kw", [
    (16, 128, dict(max_bounces=3)),
    (13, 77, dict(max_bounces=5)),                       # ragged edge
    (16, 128, dict(max_bounces=4, use_mis=False)),
    (16, 128, dict(max_bounces=4, sample_lights=False)),
], ids=["cornell", "ragged", "no_mis", "bsdf_only"])
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
