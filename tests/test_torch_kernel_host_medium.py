"""K2's medium copy, compiled for the host, against the plain autograd.

K2's medium copy (`csrc/megakernel_bwd.cu` with RT0_K2_MEDIUM set,
`csrc/megakernel_bwd_medium.cu`, the library `megakernel_bwd_medium`) is
the adjoint of K1's medium copy: the hero wavelength and Cauchy's IOR of
negative-IOR glass, the medium event with its in-scatter NEE and
Henyey-Greenstein continuation, and the fog on sphere-light shadow rays,
over K1's whole class.  This file builds it with g++ through the shim of
tests/test_torch_kernel_host.py (`build_host`, whose `HOST_CACHE` it
shares), beside the host build of K1, and drives both through
`megakernel._TraceCore` on CPU tensors, scaled by the hero wavelength's
RGB weight after the launch as `trace_forward` scales it on the card.

It holds the copy against the plain `integrator.trace`'s autograd on the
reference's preset 8 (`spectral_caustics`) in its three modes and on two
more scenes of `MEDIUM_CASES` (the SDF box of `mis_demo` under MIS, the
photographic cubemap of `cubemap_demo`) at 8x16 with 3 bounces: every
table leaf (color, emission, pos, joker, ior, and the aux and texture
columns, which stay 0) and the rays within 1e-4 of the leaf
(`assert_grads_close`), the flint's IOR carrying a gradient from 3 bounces
on.  It also checks the gate and the copy each case runs, and that two
launches give the same bits.  The card holds every `MEDIUM_CASES` scene at
64x64 and its own depth (tests/test_torch_cuda.py, chip_smoke.py phase 31).
"""

import os

import pytest
import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.config import OFFLINE_CONFIG
from raytracer0_tpu_torch.models.camera import generate_rays
from raytracer0_tpu_torch.ops import megakernel
from raytracer0_tpu_torch.render import integrator

import test_torch_kernel_host as host

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

#: the host build of the medium copy, as tests/test_torch_kernel_host.py
#: lists its libraries: (name, sources, symbol, argtypes)
K2_MEDIUM = ("megakernel_bwd_medium", megakernel.BWD_MEDIUM_SOURCES, "rt0_trace_backward",
             megakernel._BWD_MEDIUM_ARGTYPES)
#: the cases held here: preset 8 in its three modes, an SDF scene, a cubemap
CASES = ("spectral_caustics", "spectral_only", "media_only", "mis_demo", "cubemap_demo")


@pytest.fixture(scope="module")
def host_medium(tmp_path_factory):
    """{kernel: ctypes function} of the host builds of K1 and K2's medium
    copy."""
    libs = {"K1": host.HOST_LIBRARIES["K1"][2:], "K2 medium": K2_MEDIUM}
    return host.build_host(tmp_path_factory.mktemp("host_k2_medium"), libs)


@pytest.fixture
def medium_on_cpu(host_medium, monkeypatch):
    """K1's and K2's launchers launching the host builds on CPU tensors."""
    host.on_cpu(monkeypatch, {"K1": host_medium["K1"]})
    monkeypatch.setattr(megakernel, "build_bwd_medium", lambda: (host_medium["K2 medium"], None))
    monkeypatch.setattr(megakernel, "BWD_MEDIUM_LAUNCHES", megakernel.BWD_MEDIUM_LAUNCHES)


def _kernel(scene, cfg, ro, rd, pix):
    """K1 then K2's medium copy through `_TraceCore`, scaled by the RGB
    weight as `trace_forward` scales them on the card."""
    out = megakernel._TraceCore.apply(megakernel.scene_table(scene), ro, rd, scene, cfg, pix, 2, 0)
    return out * megakernel.spectral_rgb(pix, 2, 0) if cfg.use_spectral else out


def _plain(scene, cfg, ro, rd, pix):
    return integrator.trace(scene, cfg, ro, rd, pix, 2, 0)


def _case(name):
    scene, cam, cfg = host.medium_case(name)
    cfg = cfg.replace(max_bounces=3, marching_steps=32)
    h, w = 8, 16
    ro, rd = generate_rays(cam, h, w, 2)
    return scene, cfg, ro, rd, rng.pixel_ids(h, w)


@pytest.mark.parametrize("name", CASES)
def test_host_medium_adjoint_matches_plain(medium_on_cpu, name):
    """One K1 and one launch of K2's medium copy against the plain
    autograd at 8x16 and 3 bounces: the radiance under the parity
    contract, every table leaf and the rays within 1e-4 of the leaf; the
    flint's IOR carries a gradient under spectral transport."""
    scene, cfg, ro, rd, pix = _case(name)
    assert megakernel.unsupported_bwd(scene, cfg) is None
    counts = lambda: (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES, megakernel.BWD_MEDIUM_LAUNCHES)
    before = counts()
    out, got = host._grads(_kernel, scene, cfg, ro, rd, pix)
    assert counts() == tuple(n + 1 for n in before)
    ref, want = host._grads(_plain, scene, cfg, ro, rd, pix)
    err = (out - ref).abs().amax(-1)
    assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4
    host.assert_grads_close(got, want)
    for k in ("color", "emission", "pos", "joker", "rd"):
        assert got[k].abs().max().item() > 0.0, k
    for k in ("aux", "tex_params", "tex_cmask", "tex_emask"):
        assert bool((got[k] == 0.0).all()), k
    if name in ("spectral_caustics", "spectral_only"):   # Cauchy's IOR of the flint
        assert got["ior"].abs().max().item() > 0.0


def test_host_medium_adjoint_repeats(medium_on_cpu):
    """Two launches of the medium copy on the same inputs and cotangent
    give the same d_table, d_ro and d_rd bits (its per-block sums run in a
    fixed order)."""
    scene, cfg, ro, rd, pix = _case("spectral_caustics")
    table = megakernel.scene_table(scene)
    ct = torch.rand(ro.shape, generator=torch.Generator().manual_seed(7))
    first, second = (megakernel._launch_backward(scene, cfg, table, ro, rd, pix, 2, 0, ct)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert first[0].abs().max().item() > 0.0


@pytest.mark.parametrize("name", list(host.MEDIUM_CASES))
def test_host_medium_copy_per_scene(name):
    """Every scene of K1's medium class runs K2's medium copy, in the wide
    layout (not the Cornell copy) with the wide copy's columns, and fits
    its stash at the scene's own budgets (12 slots under OFFLINE_CONFIG)."""
    scene, _, cfg = host.medium_case(name)
    assert megakernel.unsupported_bwd(scene, cfg) is None
    assert megakernel.bwd_copy(scene, cfg) == "medium" and not megakernel.cornell_copy(scene, cfg)
    assert megakernel.bwd_columns(scene, cfg) == megakernel.wide_columns(scene)
    assert megakernel.bwd_library("medium") == ("megakernel_bwd_medium", K2_MEDIUM[1])
    assert megakernel.bwd_slots(scene, cfg) <= megakernel.MAX_SLOTS
    if cfg.max_bounces == OFFLINE_CONFIG.max_bounces:
        assert megakernel.bwd_slots(scene, cfg) == 12
