"""The CUDA sources of K1 and K2, compiled for the host, against the plain
version and its autograd.

CUDA kernels have no interpret mode, and a machine without a card may
have no nvcc.  The device code of `csrc/` is plain C++ apart from a few
CUDA words, so this test compiles it with the host's g++ through a small
shim header: `__device__` and friends expand to nothing, the threads of a
block run as std::threads that meet at a std::barrier for
`__syncthreads()` (every thread of a block must reach each of the
kernel's barriers, as the kernels do), blocks run one after another, and
a `<<<...>>>` launch becomes a call of the shim's launcher.  The launchers
`rt0_trace_forward` and `rt0_trace_backward` are compiled unchanged and
driven through `ops/megakernel.py`'s own `_TraceCore`, so the test covers
the kernels' arithmetic, their block reductions and the wrapper's ctypes
calls; only nvcc's code generation is left to the card
(tests/test_torch_cuda.py, chip_smoke.py).  Host libm rounds sin/cos/sqrt
like torch on the CPU to within an ULP, so K1 meets the parity contract
and K2's gradients agree within 1e-4 relative per leaf
(tests/test_megakernel.py:128-129).
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.models.camera import Camera, generate_rays
from raytracer0_tpu_torch.models.dsl import parse_scene
from raytracer0_tpu_torch.models.presets import cornell_default
from raytracer0_tpu_torch.ops import cuda_build
from raytracer0_tpu_torch.ops import megakernel
from raytracer0_tpu_torch.render import integrator

LEAVES = ("color", "emission", "pos", "joker")

SHIM = r"""
#pragma once
#include <math.h>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx;
inline dim3_ blockIdx, blockDim;
inline std::barrier<> *g_bar = nullptr;
inline std::vector<float> g_smem;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
typedef void *cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 0 };
inline int cudaGetLastError() { return 0; }
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
template <class K, class... A>
void emu_launch(K k, unsigned grid, unsigned block, size_t smem, void *, A... args) {
  // one std::thread per CUDA thread, reused block after block: the gate's
  // completion step moves blockIdx on once every thread left the last block
  blockDim.x = block;
  unsigned next = 0;
  auto enter = [&]() noexcept {
    blockIdx.x = next++;
    g_smem.assign(smem / 4 + 1, -12345.0f);  // garbage: catches unset reads
  };
  std::barrier<decltype(enter)> gate((std::ptrdiff_t)block, enter);
  std::barrier<> sync((std::ptrdiff_t)block);
  g_bar = &sync;
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < block; ++t)
    ts.emplace_back([&, t] {
      threadIdx.x = t;
      for (unsigned b = 0; b < grid; ++b) {
        gate.arrive_and_wait();
        k(args...);
      }
    });
  for (auto &th : ts) th.join();
}
"""


def _host_source(text):
    text = text.replace("extern __shared__ float smem[];", "float *smem = g_smem.data();")
    text = text.replace("__shared__ float", "static float")
    return re.sub(r"(\w+)<<<(.*)>>>\((.*)\);", r"emu_launch(\1, \2, \3);", text)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """(forward, backward) ctypes functions of the host build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' device code for the host")
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "cuda_runtime.h").write_text(SHIM)
    for p in cuda_build.CSRC_DIR.glob("*.cuh"):
        (out / p.name).write_text(p.read_text())
    fns = []
    for name, sources, symbol, argtypes in (
            ("megakernel", megakernel.SOURCES, "rt0_trace_forward", megakernel._ARGTYPES),
            ("megakernel_bwd", megakernel.BWD_SOURCES, "rt0_trace_backward",
             megakernel._BWD_ARGTYPES)):
        cpp = out / f"{name}.cpp"
        cpp.write_text("".join(_host_source((cuda_build.CSRC_DIR / s).read_text())
                               for s in sources))
        lib = out / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
                        "-shared", "-fPIC", "-pthread", f"-I{out}", "-o", str(lib), str(cpp)],
                       check=True, capture_output=True, timeout=600)
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns.append(fn)
    return tuple(fns)


@pytest.fixture
def kernels_on_cpu(host_kernels, monkeypatch):
    """ops/megakernel.py launching the host build on CPU tensors; the
    launch counts are restored afterwards, since they count launches on
    the card."""
    fwd, bwd = host_kernels
    monkeypatch.setattr(megakernel, "LAUNCHES", megakernel.LAUNCHES)
    monkeypatch.setattr(megakernel, "BWD_LAUNCHES", megakernel.BWD_LAUNCHES)
    monkeypatch.setattr(megakernel, "build", lambda: (fwd, None))
    monkeypatch.setattr(megakernel, "build_bwd", lambda: (bwd, None))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))


def _grads(trace, scene, cfg, ro, rd, pix):
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in LEAVES}
    o = ro.detach().clone().requires_grad_(True)
    d = rd.detach().clone().requires_grad_(True)
    out = trace(scene.replace(**leaves), cfg, o, d, pix)
    ct = torch.from_numpy(np.random.default_rng(5).uniform(0.5, 1.5, out.shape)
                          .astype(np.float32))
    (out * ct).sum().backward()
    return out.detach(), {**{k: v.grad for k, v in leaves.items()}, "ro": o.grad, "rd": d.grad}


def _open_scene():
    """A floor, a diffuse sphere, a box and a sphere light under the
    procedural sky: diffuse-sphere normals, and sky hits at every depth
    when NEE is off."""
    scene = parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(1.0)
        MAT_LIGHT_4, SPHERE, vec3(0.3, 1.2, -1.0), vec4(0.4)
        MAT_CORNELL_RED, SPHERE, vec3(-0.4, -0.5, -1.2), vec4(0.5)
        MAT_CORNELL_GREEN, BOX, vec3(0.6, -0.7, -1.4), vec4(0.6)
    """, device="cpu")
    cam = Camera.make(origin=(0.0, 0.2, 2.0), lookat=(0.0, -0.1, -1.0), device="cpu")
    return scene, cam


@pytest.mark.parametrize("where,h,w,kw", [
    ("cornell", 16, 128, dict(max_bounces=3)),
    ("cornell", 13, 77, dict(max_bounces=12)),           # ragged edge, full depth
    ("cornell", 16, 64, dict(max_bounces=4, use_mis=False)),
    ("cornell", 16, 64, dict(max_bounces=4, sample_lights=False)),
    ("open", 16, 64, dict(max_bounces=6)),
    ("open", 16, 64, dict(max_bounces=4, sample_lights=False)),
], ids=["cornell", "ragged_12", "no_mis", "bsdf_only", "open", "open_sky"])
def test_host_kernels_match_plain(kernels_on_cpu, where, h, w, kw):
    """K1's radiance and K2's gradients (one launch each, through
    `_TraceCore`) against the plain version and its autograd."""
    scene, cam, cfg = cornell_default(device="cpu", use_mis=True)
    if where == "open":
        scene, cam = _open_scene()
    cfg = cfg.replace(**kw)
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    out, got = _grads(lambda s, c, o, d, p: megakernel._TraceCore.apply(
        megakernel.scene_table(s), o, d, s, c, p, 2, 0), scene, cfg, ro, rd, pix)
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref, want = _grads(lambda s, c, o, d, p: integrator.trace(s, c, o, d, p, 2, 0),
                       scene, cfg, ro, rd, pix)
    err = (out - ref).abs().amax(-1)
    assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4
    for k, b in want.items():
        a = got[k]
        assert bool(torch.isfinite(a).all()), k
        scale = max(b.abs().max().item(), 1e-12)
        assert (a - b).abs().max().item() / scale < 1e-4, (k, (a - b).abs().max().item(), scale)
    assert got["emission"].abs().max().item() > 0.0


def test_host_adjoint_small_blocks_and_determinism(kernels_on_cpu, monkeypatch):
    """K2 with 32-thread blocks (its layout for scenes with many meshes)
    gives the same gradients, and the same bits on a second run."""
    scene, cam, cfg = cornell_default(device="cpu", use_mis=True)
    cfg = cfg.replace(max_bounces=5)
    ro, rd = generate_rays(cam, 8, 40, 1)
    pix = rng.pixel_ids(8, 40)
    trace = lambda s, c, o, d, p: megakernel._TraceCore.apply(
        megakernel.scene_table(s), o, d, s, c, p, 1, 0)
    _, wide = _grads(trace, scene, cfg, ro, rd, pix)
    _, again = _grads(trace, scene, cfg, ro, rd, pix)
    monkeypatch.setattr(megakernel, "bwd_threads", lambda s: 32)
    _, narrow = _grads(trace, scene, cfg, ro, rd, pix)
    for k in wide:
        assert torch.equal(wide[k], again[k]), k
        scale = max(wide[k].abs().max().item(), 1e-12)
        assert (narrow[k] - wide[k]).abs().max().item() / scale < 1e-5, k
