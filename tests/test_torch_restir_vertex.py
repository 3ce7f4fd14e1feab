"""The reservoir-vertex kernel K6v (`csrc/restir_vertex.cu`), compiled for
the host with the G-buffer kernel K4 through the shim of
tests/test_torch_kernel_host.py, in both of its forms:

- fused (K6's route, `restir_kernel._launch`): K4 + K6v against the plain
  `restir.render_sample`;
- split (`restir_split.render_sample_fast`'s route on the card): K4 + K6v
  against `render_sample_split` with the plain G-buffer and caster, with
  and without the ad-hoc reprojection, STATIC and ANIMATED at a moving
  frame time.

Against the plain version the contract is `test_host_restir_matches_plain`'s:
host libm's sinf/cosf and torch's CPU sin/cos may differ by an ULP in a
bounce direction, so K4's positions and the paths that follow them may
differ (on the card the kernels and the plain versions agree bit for bit,
tests/test_torch_cuda.py and chip_smoke.py phases 16, 17 and 24).
"""

import os

import pytest
import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.models import presets
from raytracer0_tpu_torch.models.camera import generate_rays
from raytracer0_tpu_torch.ops import restir, restir_kernel, restir_split, restir_vertex
from raytracer0_tpu_torch.render.state import RenderState

from test_torch_kernel_host import HOST_LIBRARIES, build_host, on_cpu

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

H, W = 8, 32


@pytest.fixture(scope="module")
def vertex_kernels(tmp_path_factory):
    """{kernel: ctypes function} of the host build of K4 and K6v."""
    return build_host(tmp_path_factory.mktemp("vertex_kernels"),
                      {k: HOST_LIBRARIES[k][2:] for k in ("K4", "K6v")})


@pytest.fixture
def vertex_on_cpu(vertex_kernels, monkeypatch):
    """The launchers launching the host K4 and K6v on CPU tensors."""
    on_cpu(monkeypatch, vertex_kernels)


def _case(where, **kw):
    scene, cam, cfg = (presets.restir_sdf_view(where, device="cpu", **kw)
                       if where in presets.RESTIR_SDF_VIEWS
                       else getattr(presets, where)(device="cpu", **kw))
    return scene, cam, cfg.replace(max_bounces=2, max_diff_bounces=2, restir_samples=4,
                                   marching_steps=16)


def _held(out, ref, new, new_ref, scale=None):
    """`test_host_restir_matches_plain`'s contract: per pass max |Δ| < 5e-3
    and median |Δ| < 1e-6 of the radiance, light indices agreeing at
    >= 99.5 % of pixels, the other reservoir fields within 1e-4 where they
    agree (times `scale(value)` when given); and at most 1 % of the pixels
    off by more than 1e-5 (a flipped decision; ULPs of libm move the others
    by less than 1e-6)."""
    err = (out - ref).abs()
    assert bool(torch.isfinite(out).all())
    assert err.max().item() < 5e-3 and err.median().item() < 1e-6, err.max().item()
    assert (err.amax(-1) > 1e-5).float().mean().item() <= 0.01
    agree = new.light_index == new_ref.light_index
    assert agree.float().mean().item() >= 0.995
    for k in ("weight_sum", "m", "w", "age", "light_pos", "light_color"):
        a, b = getattr(new, k)[agree], getattr(new_ref, k)[agree]
        tol = 1e-4 if scale is None else 1e-4 * scale(b)
        assert bool(((a - b).abs() <= tol).all()), k


@pytest.mark.parametrize("where", ["restir_demo", "restir_stress"])
def test_host_vertex_fused_matches_plain(vertex_on_cpu, where):
    """K4 then K6v (fused form) through `render_sample_fused`'s launcher
    against the plain `restir.render_sample` over passes 0-3 (temporal
    reuse starts at pass 3), each threading its own ring, under
    `_held`'s contract; one K4 and one K6v launch per pass."""
    scene, cam, cfg = _case(where)
    pix = rng.pixel_ids(H, W)
    kernel, plain = RenderState.create(H, W, "cpu"), RenderState.create(H, W, "cpu")
    for p in range(4):
        ro, rd = generate_rays(cam, H, W, p)
        before = (restir_split.GBUF_LAUNCHES, restir_vertex.VERTEX_LAUNCHES,
                  restir_kernel.LAUNCHES)
        out, new = restir_kernel._launch(scene, cfg, ro, rd, pix, p, 0, kernel.restir_back,
                                         kernel.restir_hist1, kernel.restir_hist2)
        assert (restir_split.GBUF_LAUNCHES, restir_vertex.VERTEX_LAUNCHES,
                restir_kernel.LAUNCHES) == tuple(b + 1 for b in before)
        ref, new_ref = restir.render_sample(scene, cfg, cam, plain, H, W, p)
        _held(out, ref, new, new_ref)
        kernel, plain = kernel.rotate_reservoirs(new), plain.rotate_reservoirs(new_ref)
    assert int((new.light_index >= 0).sum()) > H * W // 2


def test_host_vertex_fused_one_block_grid(vertex_on_cpu, monkeypatch):
    """The K6 pass with K4 on a persistent grid of one block (each lane
    traces two pixels, drawn from the ticket counter) equals it on a grid
    of one pixel per thread (two blocks at 8x32), bit for bit, over passes
    0-3 of `restir_stress`, each threading its own ring: K6v reads K4's
    G-buffer whichever lane wrote it."""
    scene, cam, cfg = _case("restir_stress")
    pix = rng.pixel_ids(H, W)
    rings = {1: RenderState.create(H, W, "cpu"), 2: RenderState.create(H, W, "cpu")}
    for p in range(4):
        ro, rd = generate_rays(cam, H, W, p)
        outs = {}
        for grid, st in rings.items():
            monkeypatch.setattr(restir_split, "resident_blocks", lambda dev, sdf, smem: grid)
            outs[grid] = restir_kernel._launch(scene, cfg, ro, rd, pix, p, 0, st.restir_back,
                                               st.restir_hist1, st.restir_hist2)
            rings[grid] = st.rotate_reservoirs(outs[grid][1])
        (a, new_a), (b, new_b) = outs[1], outs[2]
        assert torch.equal(a, b)
        assert all(torch.equal(x, y) for x, y in zip(new_a.fields().values(),
                                                     new_b.fields().values()))
    assert int((new_a.light_index >= 0).sum()) > H * W // 2


@pytest.mark.parametrize("where,adhoc,moving", [
    ("restir_demo", True, False),
    ("animated_untextured", True, True),
    ("restir_demo", False, False),
    ("animated_restir", True, True),
    ("every_shape", True, False),
], ids=["static_adhoc", "animated_adhoc_moving", "static_own_pixel",
        "as_shipped_adhoc_moving", "every_shape_adhoc"])
def test_host_vertex_split_matches_plain(vertex_on_cpu, where, adhoc, moving):
    """`render_sample_fast`'s route on the card, K4 then K6v (split form:
    carried light data, the ad-hoc reprojection with `adhoc`), against
    `render_sample_split` with the plain G-buffer and caster over passes
    0-3, each threading its own ring, under `_held`'s contract, the fields
    relative to max(1, |value|) since the wider image gathers more ULPs of
    libm into its weight sums; ANIMATED at a moving frame time, where the
    history's light data is refreshed and the spatial taps' is the stored
    copy.  `animated_restir` as shipped (a METAL texture on its ROUND_BOX)
    and the `every_shape` ReSTIR view run K4's and K6v's whole-SDF copies."""
    scene, cam, cfg = _case(where, restir_adhoc_motion=adhoc)
    # with the reprojection, wide enough that the motion vector moves a
    # pixel's history and the border test rejects columns
    h, w = (8, 128) if adhoc else (H, W)
    kernel, plain = RenderState.create(h, w, "cpu"), RenderState.create(h, w, "cpu")
    for p in range(4):
        t = p / 30 if moving else 0.0
        before = (restir_split.GBUF_LAUNCHES, restir_vertex.VERTEX_LAUNCHES,
                  restir_split.CAST_LAUNCHES)
        out, new = restir_split._render_sample_kernels(scene, cfg, cam, kernel, h, w, p, t)
        assert (restir_split.GBUF_LAUNCHES, restir_vertex.VERTEX_LAUNCHES,
                restir_split.CAST_LAUNCHES) == (before[0] + 1, before[1] + 1, before[2])
        ref, new_ref = restir_split.render_sample_split(
            scene, cfg, cam, plain, h, w, p, t, restir_split.gbuffer_plain, restir.default_cast)
        _held(out, ref, new, new_ref, scale=lambda b: b.abs().clamp_min(1.0))
        kernel, plain = kernel.rotate_reservoirs(new), plain.rotate_reservoirs(new_ref)
    assert int((new.light_index >= 0).sum()) > h * w // 2 and ref.max().item() > 0.0
