"""K7's whole-SDF copy, compiled for the host, against the plain autograd.

K7, the adjoint of the ReSTIR pass K6, has two copies: the ROUND_BOX copy
(`csrc/restir_bwd.cu`, the library `restir_bwd`) and the whole-SDF copy
(the same source with RT0_K7_WHOLE_SDF set, `csrc/restir_bwd_sdf.cu`, the
library `restir_bwd_sdf`), which replays every SDF shape, the texel
blended into a hit's color and emission, and keeps the scene's aux and
texture columns (`restir_kernel.bwd_copy`, `bwd_columns`).  This file
builds the whole-SDF copy with g++ through the shim of
tests/test_torch_kernel_host.py (`build_host`, whose `HOST_CACHE` it
shares), beside the host builds of K4, K6v and the ROUND_BOX copy, and
drives it through `restir_kernel._RestirCore` on CPU tensors.

It holds the copy against the plain `restir.trace_sample`'s autograd over
chains of passes from an empty ring, on `animated_restir` as shipped
(ANIMATED, at a constant frame time), the `mandelbulb`, `every_shape` and
`polygons` ReSTIR views, `textured_restir_demo` and `textured_cornell`
under ReSTIR: every table leaf (pos, joker, color, emission, ior, aux,
tex_params, tex_cmask, tex_emask) and every pass's rays within 1e-4 of
the leaf (`assert_grads_close`, the criterion the ROUND_BOX copy meets),
also under `make_loss`-scale cotangents and on a warm ring's float fields,
with the same bits on two launches.  No float64 arbitration is needed at
these sizes.  Host libm's logf moves Mandelbulb pixels (ROADMAP, Hazards),
so the `mandelbulb` view runs one bounce here; the card holds every scene
at its own depth, the view at its 12 bounces and 128 marching steps
(tests/test_torch_cuda.py, chip_smoke.py phase 29).
"""

import os

import pytest
import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.models import presets
from raytracer0_tpu_torch.models import scene as scene_mod
from raytracer0_tpu_torch.models.materials import SdfShape
from raytracer0_tpu_torch.ops import megakernel, restir, restir_kernel

import test_torch_kernel_host as host

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

#: every leaf of the scene table K7's whole-SDF copy differentiates
LEAVES = ("emission", "color", "pos", "joker", "ior", "aux", "tex_params", "tex_cmask",
          "tex_emask")
#: the host build of the whole-SDF copy, as tests/test_torch_kernel_host.py
#: lists its libraries: (name, sources, symbol, argtypes)
K7_SDF = ("restir_bwd_sdf", restir_kernel.BWD_SDF_SOURCES, "rt0_restir_backward",
          restir_kernel._BWD_ARGTYPES)
#: the scenes of the whole-SDF copy
SCENES = ("animated_restir", "mandelbulb", "every_shape", "polygons", "textured_restir_demo",
          "textured_cornell")
#: frame time of the ANIMATED preset (constant over a chain: K6 and the plain
#: version read the same light data then, ops/restir_kernel.py)
TIME_S = 0.9


@pytest.fixture(scope="module")
def host_k7(tmp_path_factory):
    """{kernel: ctypes function} of the host builds of K4, K6v and both
    copies of K7."""
    libs = {k: host.HOST_LIBRARIES[k][2:] for k in ("K4", "K6v", "K7")}
    libs["K7 whole-SDF"] = K7_SDF
    return host.build_host(tmp_path_factory.mktemp("host_k7_sdf"), libs)


@pytest.fixture
def k7_on_cpu(host_k7, monkeypatch):
    """The launchers of K6 and K7 launching the host builds on CPU
    tensors."""
    host.on_cpu(monkeypatch, {k: host_k7[k] for k in ("K4", "K6v", "K7")})
    monkeypatch.setattr(restir_kernel, "build_bwd_sdf", lambda: (host_k7["K7 whole-SDF"], None))
    monkeypatch.setattr(restir_kernel, "BWD_SDF_LAUNCHES", restir_kernel.BWD_SDF_LAUNCHES)


def k7_case(where, device="cpu", **cfg_kw):
    """(scene, camera, cfg) of a ReSTIR scene of K7's whole-SDF copy;
    `box_restir_demo` is `restir_demo` with its rounded box a BOX, which K7
    refuses (`outside_k7_class`: K4 and K6v march it without the whole SDF
    class; the BOX row of `every_shape`, a scene of that class, is held)."""
    if where == "box_restir_demo":
        scene, cam, cfg = presets.restir_demo(device=device, **cfg_kw)
        return scene.replace(sdf_shapes_static=(int(SdfShape.BOX),)), cam, cfg
    if where == "animated_restir":
        return presets.animated_restir(device=device, **cfg_kw)
    if where == "textured_cornell":
        return presets.textured_cornell(device=device, use_restir=True, use_mis=False, **cfg_kw)
    if where == "textured_restir_demo":
        return presets.textured_restir_demo(device=device, **cfg_kw)
    return presets.restir_sdf_view(where, device=device, **cfg_kw)


def animated(trace, cfg, time_s=TIME_S):
    """`trace` of the scene animated to `time_s` (a no-op under STATIC)."""
    return lambda s, *a: trace(scene_mod.animate_positions(s, time_s, int(cfg.render_mode)), *a)


def chain_grads(trace, scene, cfg, cam, h, w, passes, seed=5, l2_over=None):
    """`test_torch_kernel_host.restir_chain_grads` over every leaf of
    LEAVES (a leaf the passes do not read has a zero gradient)."""
    return host.restir_chain_grads(trace, scene, cfg, cam, h, w, passes, seed, l2_over, LEAVES)


#: the aux and texture leaves each scene's passes read with a gradient: the
#: polygons' vertices, a texture blended into a color (its mask, and the
#: params of a CHECK or noise texture); `animated_restir`'s METAL texel
#: blends into the emission of a SPEC box, its glossiness, which bends the
#: bounce detached
READS = {"every_shape": ("aux", "tex_params"), "polygons": ("aux",),
         "textured_restir_demo": ("tex_params", "tex_cmask"), "textured_cornell": ("tex_cmask",)}


#: (bounces, passes, height, width) of a scene: 2 bounces over 4 passes at
#: 8x16, 1 bounce on the `mandelbulb` view (module docstring)
SIZES = {"mandelbulb": (1, 4, 8, 16)}


@pytest.mark.parametrize("where", SCENES)
def test_host_k7_whole_sdf_matches_plain(k7_on_cpu, where):
    """K7's whole-SDF copy (one K6 and one K7 launch per pass, through
    `_RestirCore`) against the plain autograd over a chain of passes from
    an empty ring: the loss within 1e-5 and every leaf and ray within 1e-4
    of the leaf; the aux and texture columns the scene reads engaged."""
    bounces, passes, h, w = SIZES.get(where, (2, 4, 8, 16))
    scene, cam, cfg = k7_case(where, max_bounces=bounces, restir_samples=4, marching_steps=16)
    assert restir_kernel.unsupported_restir_bwd(scene, cfg) is None
    assert restir_kernel.bwd_copy(scene) == "whole_sdf"
    counts = lambda: (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES,
                      restir_kernel.BWD_SDF_LAUNCHES)
    before = counts()
    loss, got = chain_grads(animated(restir_kernel._fused, cfg), scene, cfg, cam, h, w, passes)
    assert counts() == tuple(b + passes for b in before)
    ref_loss, want = chain_grads(animated(restir.trace_sample, cfg), scene, cfg, cam, h, w,
                                 passes)
    assert abs(loss - ref_loss).item() <= 1e-5 * abs(ref_loss).item()
    host.assert_grads_close(got, want)
    for k in ("emission", "color", "pos", "joker", "rd") + READS.get(where, ()):
        assert got[k].abs().max().item() > 0.0, k


@pytest.mark.parametrize("where", ["animated_restir", "textured_restir_demo"])
def test_host_k7_whole_sdf_loss_scale_cotangents(k7_on_cpu, where):
    """The whole-SDF copy under the cotangents `optimize.fit` gives it
    (`make_loss` scaled to a 512x512 image, about 1e-7 per pixel and pass)
    against the plain autograd of the same loss, over passes 0-3 at 8x16
    with 2 bounces: every leaf and ray within 1e-4 of the leaf, and the
    gradients engaged."""
    scene, cam, cfg = k7_case(where, max_bounces=2, restir_samples=4, marching_steps=16)
    n = 512 * 512 * 3
    loss, got = chain_grads(animated(restir_kernel._fused, cfg), scene, cfg, cam, 8, 16, 4,
                            l2_over=n)
    ref_loss, want = chain_grads(animated(restir.trace_sample, cfg), scene, cfg, cam, 8, 16, 4,
                                 l2_over=n)
    assert abs(loss - ref_loss).item() <= 1e-5 * abs(ref_loss).item()
    host.assert_grads_close(got, want)
    for k in ("emission", "color", "pos") + READS.get(where, ()):
        assert 0.0 < got[k].abs().max().item() < 1e-2, k


def test_host_k7_whole_sdf_same_bits_twice(k7_on_cpu):
    """Two launches of the whole-SDF copy on the same inputs give the same
    bits (its reductions run in a fixed order): the `every_shape` view,
    passes 0-2."""
    scene, cam, cfg = k7_case("every_shape", restir_samples=4, marching_steps=16)
    _, got = chain_grads(restir_kernel._fused, scene, cfg, cam, 8, 16, 3)
    _, again = chain_grads(restir_kernel._fused, scene, cfg, cam, 8, 16, 3)
    for k in got:
        assert torch.equal(got[k], again[k]), k


def test_host_k7_whole_sdf_ring_fields(k7_on_cpu):
    """One pass of `textured_restir_demo` on a warm ring (after 6 passes,
    M above 30): the whole-SDF copy's cotangents of the ring's m, w and age
    against the plain autograd (`test_torch_kernel_host._ring_field_grads`)."""
    scene, cam, cfg = presets.textured_restir_demo(device="cpu", max_bounces=3,
                                                   restir_samples=4, marching_steps=16)
    assert restir_kernel.bwd_copy(scene) == "whole_sdf"
    host._ring_field_grads(scene, cam, cfg, min_m=30.0)


@pytest.mark.parametrize("where", SCENES + ("box_restir_demo", "restir_demo", "restir_stress",
                                            "animated_untextured"))
def test_host_k7_copy_per_scene(host_k7, where):
    """Which copy of K7 each scene runs (`bwd_copy`: the whole-SDF copy
    where K4 and K6v run theirs or a texture is blended in), its columns
    and block size: the ROUND_BOX copy keeps the 14 columns 0:14 and its
    128 or 64 threads, and its library refuses a wider column mask before
    any launch.  A BOX row outside the whole SDF class (`box_restir_demo`)
    is refused by K7's gate, naming item 8."""
    if where in ("restir_demo", "restir_stress", "animated_untextured"):
        scene, _, cfg = getattr(presets, where)(device="cpu")
    else:
        scene, _, cfg = k7_case(where)
    if where == "box_restir_demo":
        reason = restir_kernel.outside_k7_class(scene)
        assert "BOX SDF rows" in reason and "ROADMAP queue 1 item 8" in reason
        assert restir_kernel.unsupported_restir_bwd(scene, cfg) == reason
        return
    whole = where in SCENES
    assert restir_kernel.unsupported_restir_bwd(scene, cfg) is None
    assert restir_kernel.bwd_copy(scene) == ("whole_sdf" if whole else "round_box")
    cols = restir_kernel.bwd_columns(scene)
    assert cols[:14] == tuple(range(14))
    assert (len(cols) > 14) == (whole and where != "mandelbulb")
    threads = restir_kernel.bwd_threads(scene)
    assert threads in (128, 64)
    if len(cols) == 14:
        return
    # the ROUND_BOX copy's library refuses the whole-SDF copy's columns
    h = w = 4
    pix = rng.pixel_ids(h, w)
    table = megakernel.scene_table(scene)
    ro = torch.zeros((h, w, 3))
    args, _keep = megakernel.forward_args(scene, cfg, table, ro, ro, pix, None, 0, 0)
    z = torch.zeros((h, w))
    idx = torch.full((h, w), -1, dtype=torch.int32)
    ins = (restir_kernel.ctypes.c_void_p * 15)(*([z.data_ptr()] * 4 + [idx.data_ptr()]) * 3)
    cts = (restir_kernel.ctypes.c_void_p * 4)(*[z.data_ptr()] * 4)
    rc = host_k7["K7"](*args, ins, restir_kernel.restir_vertex.TAPS, h, w,
                       *restir_kernel.restir_vertex.restir_args(cfg, scene.num_lights),
                       ro.data_ptr(), cts, *[ro.data_ptr()] * 3, table.data_ptr(),
                       *[ro.data_ptr()] * 3, megakernel._cols_mask(cols), threads, None)
    assert rc != 0
