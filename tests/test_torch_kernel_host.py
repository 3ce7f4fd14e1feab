"""The CUDA sources of K1, K2, K4, K5, K6v and K7, compiled for the host,
against the plain version and its autograd.

CUDA kernels have no interpret mode, and a machine without a card may
have no nvcc.  The device code of `csrc/` is plain C++ apart from a few
CUDA words, so this test compiles it with the host's g++ through a small
shim header: `__device__` and friends expand to nothing, the threads of a
block run as std::threads that meet at a std::barrier for
`__syncthreads()` (every thread of a block must reach each of the
kernel's barriers, as the kernels do), blocks run one after another, and
a `<<<...>>>` launch becomes a call of the shim's launcher.  The launchers
`rt0_trace_forward`, `rt0_trace_backward`, `rt0_gbuffer_forward`,
`rt0_cast_rays`, `rt0_restir_vertex` and `rt0_restir_backward` are
compiled unchanged and driven through `ops/megakernel.py`'s own
`_TraceCore`, `ops/restir_split.py`'s launchers and `ops/restir_kernel.py`'s
launcher (K6: K4 then K6v) and `_RestirCore`, so the test covers
the kernels' arithmetic, their block reductions and the wrapper's ctypes
calls; only nvcc's code generation, and the work of a warp's lanes
together (K2's sums over lanes grouped by mesh, K4's shared ticket draw:
the shim's warps have one lane), is left to the card
(tests/test_torch_cuda.py, chip_smoke.py).  Host libm rounds sin/cos/sqrt
like torch on the CPU to within an ULP, so K1 meets the parity contract
and K2's gradients agree within 1e-4 relative per leaf
(tests/test_megakernel.py:128-129).
"""

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.config import OFFLINE_CONFIG, RenderMode
from raytracer0_tpu_torch.models.camera import Camera, generate_rays
from raytracer0_tpu_torch.models.dsl import parse_scene
from raytracer0_tpu_torch.models.materials import MeshType
from raytracer0_tpu_torch.models import materials, presets
from raytracer0_tpu_torch.models import scene as scene_mod
from raytracer0_tpu_torch.models.presets import cornell_default, cubemap_demo
from raytracer0_tpu_torch.models.scene import SceneBuilder
from raytracer0_tpu_torch.ops import cuda_build
from raytracer0_tpu_torch.ops import megakernel, restir, restir_kernel, restir_split, restir_vertex
from raytracer0_tpu_torch.render import integrator
from raytracer0_tpu_torch.render.renderer import render_pass
from raytracer0_tpu_torch.render.state import RenderState


# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

LEAVES = ("color", "emission", "pos", "joker")
#: every leaf of the scene table (megakernel.scene_table)
TABLE_LEAVES = LEAVES + ("ior", "aux", "tex_params", "tex_cmask", "tex_emask")

SHIM = r"""
#pragma once
#include <math.h>
#include <atomic>
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
#define __align__(n) alignas(n)
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx;
inline dim3_ blockIdx, blockDim, gridDim;
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
// a warp of one lane: the warp-aggregated ticket draw stays correct
inline unsigned __activemask() { return 1u << (threadIdx.x & 31u); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
template <class T> inline T __shfl_sync(unsigned, T v, int) { return v; }
inline unsigned __ballot_sync(unsigned, int p) { return p ? __activemask() : 0u; }
inline unsigned __match_any_sync(unsigned mask, int) { return mask & __activemask(); }
// K2 gives each warp a column of cotangent accumulators: one per thread here
constexpr int warpSize = 1;
inline unsigned atomicAdd(unsigned *p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline float atomicAdd(float *p, float v) { return std::atomic_ref<float>(*p).fetch_add(v); }
inline unsigned atomicExch(unsigned *p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).exchange(v);
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline std::barrier<> *g_bar = nullptr;
inline std::vector<float> g_smem;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
template <class T> inline T __ldg(const T *p) { return *p; }  // g++ knows __restrict__
typedef void *cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 0, cudaDevAttrWarpSize = 10,
       cudaDevAttrMaxSharedMemoryPerMultiprocessor = 81,
       cudaDevAttrReservedSharedMemoryPerBlock = 111 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int *d) { *d = 0; return 0; }
// an H100's shared memory per SM and per block reserved, with one-lane warps
inline int cudaDeviceGetAttribute(int *v, int attr, int) {
  *v = attr == cudaDevAttrWarpSize ? warpSize
       : attr == cudaDevAttrMaxSharedMemoryPerMultiprocessor ? 233472
       : attr == cudaDevAttrReservedSharedMemoryPerBlock ? 1024 : 0;
  return 0;
}
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F> inline int cudaFuncGetAttributes(cudaFuncAttributes *, F) { return 0; }
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int *n, F, int, size_t) {
  *n = 0;
  return 0;
}
template <class K, class... A>
void emu_launch(K k, unsigned grid, unsigned block, size_t smem, void *, A... args) {
  // one std::thread per CUDA thread, reused block after block: the gate's
  // completion step moves blockIdx on once every thread left the last block
  blockDim.x = block;
  gridDim.x = grid;
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
    # a source that includes another .cu (megakernel_bwd_sdf.cu) takes its text
    text = re.sub(r'#include "(\w+\.cu)"\n',
                  lambda m: (cuda_build.CSRC_DIR / m.group(1)).read_text(), text)
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float smem\[\];",
                  "float *smem = g_smem.data();", text)
    text = text.replace("__shared__ float", "static float")
    return re.sub(r"(\w+(?:<\w+>)?)<<<(.*)>>>\((.*)\);", r"emu_launch(\1, \2, \3);", text)


#: (module, build function, library name, sources, symbol, argtypes) of each
#: kernel library the host tests build, by the launch count's kernel.
HOST_LIBRARIES = {
    "K1": (megakernel, "build", "megakernel", megakernel.SOURCES, "rt0_trace_forward",
           megakernel._FWD_ARGTYPES),
    "K2": (megakernel, "build_bwd", "megakernel_bwd", megakernel.BWD_SOURCES,
           "rt0_trace_backward", megakernel._BWD_ARGTYPES),
    "K2 whole-SDF": (megakernel, "build_bwd_sdf", "megakernel_bwd_sdf",
                     megakernel.BWD_SDF_SOURCES, "rt0_trace_backward", megakernel._BWD_ARGTYPES),
    "K4": (restir_split, "build_gbuffer", "gbuffer", restir_split.GBUF_SOURCES,
           "rt0_gbuffer_forward", restir_split._GBUF_ARGTYPES),
    "K5": (restir_split, "build_cast", "cast", restir_split.CAST_SOURCES, "rt0_cast_rays",
           restir_split._CAST_ARGTYPES),
    "K6v": (restir_vertex, "build", "restir_vertex", restir_vertex.SOURCES,
            "rt0_restir_vertex", restir_vertex._ARGTYPES),
    "K7": (restir_kernel, "build_bwd", "restir_bwd", restir_kernel.BWD_SOURCES,
           "rt0_restir_backward", restir_kernel._BWD_ARGTYPES),
}
#: (module, attribute) of every launch count of the port.
LAUNCH_COUNTS = ((megakernel, "LAUNCHES"), (megakernel, "BWD_LAUNCHES"),
                 (restir_kernel, "LAUNCHES"), (restir_kernel, "BWD_LAUNCHES"),
                 (restir_split, "GBUF_LAUNCHES"), (restir_split, "CAST_LAUNCHES"),
                 (restir_vertex, "VERTEX_LAUNCHES"))


#: where `build_host` keeps its libraries between test modules and runs
HOST_CACHE = cuda_build.BUILD_DIR.parent / "host_kernels"
_GXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math", "-shared", "-fPIC",
              "-pthread")


def build_host(out, libraries):
    """Compile `libraries` ({key: (name, sources, symbol, argtypes)}) for
    the host into `out` through the shim, all at once with g++ -O1 and no
    contraction or fast math: {key: ctypes function}, each with its
    `library`.  A library is kept in
    `HOST_CACHE` under a hash of the shim, the flags, its source and every
    header, so the test modules that need it (and later runs) build it
    once.  Skips the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' device code for the host")
    (out / "cuda_runtime.h").write_text(SHIM)
    headers = sorted(cuda_build.CSRC_DIR.glob("*.cuh"))
    for p in headers:
        (out / p.name).write_text(p.read_text())
    procs, libs = {}, {}
    for key, (name, sources, _, _) in libraries.items():
        text = "".join(_host_source((cuda_build.CSRC_DIR / s).read_text()) for s in sources)
        digest = hashlib.sha256("\0".join((SHIM, *_GXX_FLAGS, text)).encode())
        for p in headers:
            digest.update(p.read_bytes())
        libs[key] = HOST_CACHE / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"
        if libs[key].exists():
            continue
        cpp = out / f"{name}.cpp"
        cpp.write_text(text)
        procs[key] = subprocess.Popen(
            [gxx, *_GXX_FLAGS, f"-I{out}", "-o", str(out / f"lib{name}.so"), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log
        libs[key].parent.mkdir(parents=True, exist_ok=True)
        tmp = libs[key].with_suffix(f".{os.getpid()}.tmp")
        shutil.copyfile(out / libs[key].name, tmp)
        os.replace(tmp, libs[key])  # atomic: a concurrent module sees all or nothing
    fns = {}
    for key, (_, _, symbol, argtypes) in libraries.items():
        lib = ctypes.CDLL(str(libs[key]))
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fn.library = lib   # the library's other exports
        fns[key] = fn
    return fns


def on_cpu(monkeypatch, fns, grid=2):
    """Have the launchers launch the host build `fns` ({kernel: ctypes
    function}, keys of HOST_LIBRARIES) on CPU tensors, K4 on a persistent
    grid of `grid` blocks (the shim's occupancy stub reports none, and a
    small grid has every lane regenerate many times); the launch counts
    are restored afterwards, since they count launches on the card."""
    monkeypatch.setattr(restir_split, "resident_blocks", lambda dev, sdf, smem: grid)
    for module, attr in LAUNCH_COUNTS:
        monkeypatch.setattr(module, attr, getattr(module, attr))
    for key, fn in fns.items():
        module, build = HOST_LIBRARIES[key][:2]
        monkeypatch.setattr(module, build, lambda fn=fn: (fn, None))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))


# K5's launcher over the packed scan of K1 and K4 (trace_common.cuh::
# intersect_packed), so `restir_split._launch_cast` can drive it: the
# nearest hit of each ray by the scan K1 and K4 run.
PACKED_CAST = r"""
#include "path.cuh"
namespace {
__global__ void packed_cast_kernel(TraceArgs a, SdfScene sd, const float *ro, const float *rd,
                                   float *t, int32_t *idx, long long n, float eps, float inf) {
  extern __shared__ __align__(16) float smem[];
  int *s_sdf = reinterpret_cast<int *>(smem) + scene_smem_bytes(a.n_mesh, 0) / sizeof(int);
  for (int i = threadIdx.x; i < sd.count; i += blockDim.x) s_sdf[i] = sd.shape[i];
  const SceneSmem s = load_scene(a, smem);
  sd.shape = s_sdf;
  const PackedScene pk = load_packed(s, sd, smem, scene_smem_bytes(a.n_mesh, 0) + 4 * sd.count);
  for (long long p = threadIdx.x; p < n; p += blockDim.x) {
    const V3 o = {ro[3 * p], ro[3 * p + 1], ro[3 * p + 2]};
    const V3 d = {rd[3 * p], rd[3 * p + 1], rd[3 * p + 2]};
    float tp;
    int ip;
    intersect_packed<true>(s, sd, pk, o, d, eps, inf, tp, ip);
    const bool missed = !(tp < inf);
    t[p] = missed ? inf : tp;
    idx[p] = missed ? 0 : ip;
  }
}
}  // namespace
extern "C" int rt0_cast_rays(const float *table, const int32_t *mesh, const int32_t *mat,
                             int n_mesh, const int32_t *sdf, int n_analytic, int n_sdf, int steps,
                             float fudge, float t0, const float *ro, const float *rd, float *t,
                             int32_t *idx, long long n, float eps, float inf, void *stream) {
  TraceArgs a = {};
  a.table = table;
  a.mesh = mesh;
  a.mat = mat;
  a.n_mesh = n_mesh;
  const SdfScene sd = {sdf, n_analytic, n_sdf, steps, fudge, t0};
  const size_t smem = packed_smem_bytes(scene_smem_bytes(n_mesh, 0) + 4 * n_sdf, n_mesh, n_sdf);
  packed_cast_kernel<<<1, 32, smem, stream>>>(a, sd, ro, rd, t, idx, n, eps, inf);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """{kernel: ctypes function} of the host build of every library, and
    of the packed scan's caster ("packed cast")."""
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "packed_cast.cu").write_text(PACKED_CAST)
    libs = {k: v[2:] for k, v in HOST_LIBRARIES.items()}
    libs["packed cast"] = ("packed_cast", (str(out / "packed_cast.cu"),), "rt0_cast_rays",
                           restir_split._CAST_ARGTYPES)
    return build_host(out, libs)


@pytest.fixture
def kernels_on_cpu(host_kernels, monkeypatch):
    """The launchers launching the host build on CPU tensors."""
    on_cpu(monkeypatch, {k: host_kernels[k] for k in HOST_LIBRARIES})


def _grads(trace, scene, cfg, ro, rd, pix, mask=None, dtype=torch.float32):
    """(radiance, gradients of its sum under a seeded cotangent w.r.t.
    every table leaf, ro and rd); a leaf the trace does not read has a
    zero gradient.  `mask` (H, W) keeps the cotangent of its pixels alone;
    with `dtype`, the scene's float tensors, the rays and the cotangent
    are in it."""
    assets = {k: getattr(scene, k).to(dtype) for k in ("images", "noise", "cubemap")}
    leaves = {k: getattr(scene, k).detach().to(dtype).requires_grad_(True) for k in TABLE_LEAVES}
    o = ro.detach().to(dtype).requires_grad_(True)
    d = rd.detach().to(dtype).requires_grad_(True)
    out = trace(scene.replace(**leaves, **assets), cfg, o, d, pix)
    ct = torch.from_numpy(np.random.default_rng(5).uniform(0.5, 1.5, out.shape)
                          .astype(np.float32)).to(dtype)
    if mask is not None:
        ct = ct * mask[..., None]
    (out * ct).sum().backward()
    grads = {k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in leaves.items()}
    return out.detach(), {**grads, "ro": o.grad, "rd": d.grad}


def _open_scene(device="cpu"):
    """A floor, a diffuse sphere, a box and a sphere light under the
    procedural sky: diffuse-sphere normals, and sky hits at every depth
    when NEE is off."""
    scene = parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(1.0)
        MAT_LIGHT_4, SPHERE, vec3(0.3, 1.2, -1.0), vec4(0.4)
        MAT_CORNELL_RED, SPHERE, vec3(-0.4, -0.5, -1.2), vec4(0.5)
        MAT_CORNELL_GREEN, BOX, vec3(0.6, -0.7, -1.4), vec4(0.6)
    """, device=device)
    cam = Camera.make(origin=(0.0, 0.2, 2.0), lookat=(0.0, -0.1, -1.0), device=device)
    return scene, cam


def adjoint_case(where, device="cpu"):
    """(scene, camera, cfg) on `device` of a scene K2 is held on: Cornell
    (its own copy), the open scene, and the scenes of its wide copy
    (mirror, glass and coat, a directional sun, a cubemap, a BOX SDF, the
    textured presets, a light textured by a varying image, and the
    procedural textures, an untextured mesh with blend flags)."""
    if where in ("cornell", "open"):
        scene, cam, cfg = cornell_default(device=device, use_mis=True)
        return (*_open_scene(device), cfg) if where == "open" else (scene, cam, cfg)
    if where in ("cubemap", "config2", "dir"):
        scene, cam = _widened_scene(where, device)
        cfg = cubemap_demo(device=device)[2] if where == "cubemap" else \
            cornell_default(device=device, use_procedural_sky=where == "dir")[2]
        return scene, cam, cfg
    if where == "mis_demo":
        return presets.mis_demo(device=device)
    if where == "untextured_flags":
        # a floor with no texture and both blend flags, beside a CHECK sphere
        # that blends into its color alone: no emission mask column is kept
        m = materials
        sb = SceneBuilder()
        sb.add(m.Material(c=(0.7, 0.7, 0.7), t=m.MatType.DIFF, opts=(True, True, False, False)),
               MeshType.PLANE, (0.0, 1.0, 0.0), (1.5,))
        sb.add(m.Material(c=(0.8, 0.6, 0.4), t=m.MatType.DIFF,
                          tex=m.Texture(t=m.TexType.CHECK, params=(8.0, 8.0, 2.0, 2.0)),
                          opts=(True, False, False, False)),
               MeshType.SPHERE, (0.0, -0.6, -1.2), (0.6,))
        sb.add("MAT_LIGHT_4", MeshType.SPHERE, (0.0, 1.4, -1.2), (0.3,))
        cam = Camera.make(origin=(0.0, 0.2, 1.5), lookat=(0.0, -0.6, -1.2), device=device)
        return sb.build(device=device), cam, OFFLINE_CONFIG
    if where == "textured_light":   # cornell_box's light textured by a varying image
        scene, cam, cfg = presets.cornell_box(device=device)
        images = torch.from_numpy(presets.synthetic_texture()).to(scene.device)
        return scene.replace(images=images), cam, cfg
    return textured_case(where, device)


@pytest.mark.parametrize("where,h,w,kw", [
    ("cornell", 16, 128, dict(max_bounces=3)),
    ("cornell", 13, 77, dict(max_bounces=12)),           # ragged edge, full depth
    ("cornell", 16, 64, dict(max_bounces=4, use_mis=False)),
    ("cornell", 16, 64, dict(max_bounces=4, sample_lights=False)),
    ("open", 16, 64, dict(max_bounces=6)),
    ("open", 16, 64, dict(max_bounces=4, sample_lights=False)),
    ("config2", 8, 64, dict(max_bounces=8, use_mis=True)),
    ("mis_demo", 8, 64, dict(max_bounces=4, marching_steps=32)),
    ("mis_demo", 8, 64, dict(max_bounces=3, marching_steps=32, use_mis=True)),
    ("dir", 8, 64, dict(max_bounces=5)),
    ("dir", 8, 64, dict(max_bounces=5, use_mis=True)),
    ("cornell", 8, 64, dict(max_bounces=5, use_biased_sampling=False)),
    ("cubemap", 8, 64, dict(max_bounces=5)),
    ("cubemap", 8, 64, dict(max_bounces=4, use_mis=True, use_biased_sampling=False)),
    ("cubemap", 8, 64, dict(max_bounces=4, sample_lights=False)),
    ("cornell_box", 8, 64, dict(max_bounces=5)),
    ("textured_light", 8, 64, dict(max_bounces=4, use_mis=True)),
    ("textured_gloss", 8, 64, dict(max_bounces=5)),
    ("textured_cornell", 8, 64, dict(max_bounces=4, use_mis=True)),
    ("textured_emitter", 8, 64, dict(max_bounces=4, use_mis=True)),
    # the noise walls at the primary hits, whose points the host computes as
    # torch does: at a later hit the host's sinf/cosf move the bounce
    # direction by an ULP now and then, which scale-16 noise amplifies
    ("procedural", 8, 64, dict(max_bounces=1)),
    ("check_sphere", 8, 64, dict(max_bounces=3)),
    ("untextured_flags", 8, 64, dict(max_bounces=3)),
], ids=["cornell", "ragged_12", "no_mis", "bsdf_only", "open", "open_sky", "config2",
        "mis_demo", "mis_demo_mis", "dir", "dir_mis", "cornell_uniform",
        "cubemap", "cubemap_uniform_mis", "cubemap_bsdf_only", "cornell_box", "textured_light",
        "textured_gloss",
        "textured_cornell", "textured_emitter", "procedural", "check_sphere",
        "untextured_flags"])
def test_host_kernels_match_plain(kernels_on_cpu, where, h, w, kw):
    """K1's radiance and K2's gradients w.r.t. every table leaf and the
    rays (one launch each, through `_TraceCore`) against the plain version
    and its autograd: Cornell on K2's Cornell copy, the rest on its wide
    copy (every material and the IOR, directional lights, uniform
    sampling, the cubemap's fetches and gather rays, a BOX SDF, image
    textures on color, emission and glossiness, CHECK, RIPPLE, value noise
    and METAL fBm)."""
    scene, cam, cfg = adjoint_case(where)
    cfg = cfg.replace(**kw)
    assert megakernel.unsupported_bwd(scene, cfg) is None
    assert megakernel.cornell_copy(scene, cfg) == (where in ("cornell", "open")
                                                   and cfg.use_biased_sampling)
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    out, got = _grads(lambda s, c, o, d, p: megakernel._TraceCore.apply(
        megakernel.scene_table(s), o, d, s, c, p, 2, 0), scene, cfg, ro, rd, pix)
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    plain = lambda s, c, o, d, p: integrator.trace(s, c, o, d, p, 2, 0)
    ref, want = _grads(plain, scene, cfg, ro, rd, pix)
    err = (out - ref).abs().amax(-1)
    assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4
    if megakernel.cornell_copy(scene, cfg):
        assert_grads_close(got, want)
    else:
        kernel = lambda s, c, o, d, p: megakernel._TraceCore.apply(
            megakernel.scene_table(s), o, d, s, c, p, 2, 0)
        assert_grads_close_f64(got, want, lambda kind, mask: _grads(
            kernel if kind == "kernel" else plain, scene, cfg, ro, rd, pix, mask,
            torch.float64 if kind == "plain64" else torch.float32))
    assert got["color"].abs().max().item() > 0.0
    if where != "cubemap":   # the lights' emission (or its texture); the cubemap lights alone
        assert (got["emission"].abs().max() + got["tex_emask"].abs().max()).item() > 0.0
    if cfg.sample_lights:   # the geometry
        assert got["pos"].abs().max().item() > 0.0 and got["rd"].abs().max().item() > 0.0


def test_host_adjoint_small_blocks_and_determinism(kernels_on_cpu, monkeypatch):
    """K2 with 32-thread blocks (one warp a block on the card) gives the
    same gradients, and the same bits on a second run."""
    scene, cam, cfg = cornell_default(device="cpu", use_mis=True)
    cfg = cfg.replace(max_bounces=5)
    ro, rd = generate_rays(cam, 8, 40, 1)
    pix = rng.pixel_ids(8, 40)
    trace = lambda s, c, o, d, p: megakernel._TraceCore.apply(
        megakernel.scene_table(s), o, d, s, c, p, 1, 0)
    _, wide = _grads(trace, scene, cfg, ro, rd, pix)
    _, again = _grads(trace, scene, cfg, ro, rd, pix)
    monkeypatch.setattr(megakernel, "BWD_THREADS", 32)
    _, narrow = _grads(trace, scene, cfg, ro, rd, pix)
    for k in wide:
        assert torch.equal(wide[k], again[k]), k
        scale = max(wide[k].abs().max().item(), 1e-12)
        assert (narrow[k] - wide[k]).abs().max().item() / scale < 1e-5, k


@pytest.mark.parametrize("where,warp,ng", [
    ("cornell", False, 10), (8, False, 10), (9, True, 10), (41, True, 10),
    ("config2", False, 11), ("mis_demo", False, 13), ("textured_cornell", False, 13),
    ("procedural", False, 20)],
    ids=["cornell", "14_meshes", "15_meshes", "47_meshes", "config2", "mis_demo",
         "textured_cornell", "procedural"])
def test_host_adjoint_layout(host_kernels, where, warp, ng):
    """K2's layout as its library picks it (`megakernel.bwd_layout`) for
    128-thread blocks, with the shim's H100 figures (233,472 bytes of
    shared memory an SM, 1,024 reserved a block): a column of cotangent
    accumulators per thread while 3 such blocks fit an SM (Cornell's 8
    meshes, 14 meshes), per warp beyond; the block's bytes are the scene,
    its packed records and the columns (one-lane warps here, so a column
    per warp is one per thread).  The Cornell copy keeps 10 columns a
    mesh; the wide copy the scene's (`megakernel.bwd_columns`: joker 4:7
    under SDF rows, the IOR under refraction, a blended texture's masks
    and params), after the scene with its texture codes, blend flags and
    SDF shapes, the packed records with the SDF gates and the column map.
    The card test `test_adjoint_layout_matches_occupancy` holds the rule
    against the occupancy calculator."""
    if where == "cornell":
        scene, _, cfg = cornell_default(device="cpu")
    elif isinstance(where, int):
        scene, _, cfg = presets.many_lights(device="cpu", n_lights=where)
    else:
        scene, _, cfg = adjoint_case(where)
    n, n_sdf = scene.num_meshes, scene.num_sdfs
    cornell = megakernel.cornell_copy(scene, cfg)
    assert cornell == (where == "cornell" or isinstance(where, int))
    assert len(megakernel.bwd_columns(scene, cfg)) == ng
    if cornell:   # table, codes, light slots
        scene_bytes, tail = 4 * (n * (36 + 2) + scene.num_lights), 0
    else:         # ... texture codes, blend flags, SDF shapes; the column map
        scene_bytes, tail = 4 * (n * (36 + 4) + scene.num_lights + n_sdf), 4 * 36
    per_thread = (-(-scene_bytes // 16) * 16 + 4 * (4 + 5 * n + n_sdf) + tail
                  + 4 * n * ng * 128)
    assert (3 * (per_thread + 1024) > 233472) == warp
    fn = host_kernels["K2"].library.rt0_trace_backward_layout
    assert megakernel.bwd_layout(scene, cfg, 128, fn) == (warp, per_thread)
    if where == "cornell":
        assert per_thread == 42368


def test_host_adjoint_many_meshes(kernels_on_cpu):
    """K2 on a scene of 47 meshes (`presets.many_lights`: six
    planes and 41 sphere lights, MIS on) at 128-thread blocks, which one
    column of accumulators per thread could not hold: the radiance and
    every gradient against the plain version and its autograd, one launch
    of each kernel.  The host build's warps have one lane, so each thread
    is its own group and column here; the grouping of a warp's lanes by
    mesh is held on the card (tests/test_torch_cuda.py)."""
    scene, cam, cfg = presets.many_lights(device="cpu")
    assert scene.num_meshes == 47 and megakernel.BWD_THREADS == 128
    cfg = cfg.replace(max_bounces=3)
    assert megakernel.unsupported_bwd(scene, cfg) is None
    h, w = 4, 64
    ro, rd = generate_rays(cam, h, w, 1)
    pix = rng.pixel_ids(h, w)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    out, got = _grads(lambda s, c, o, d, p: megakernel._TraceCore.apply(
        megakernel.scene_table(s), o, d, s, c, p, 1, 0), scene, cfg, ro, rd, pix)
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref, want = _grads(lambda s, c, o, d, p: integrator.trace(s, c, o, d, p, 1, 0),
                       scene, cfg, ro, rd, pix)
    err = (out - ref).abs().amax(-1)
    assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4
    assert_grads_close(got, want)
    assert got["emission"][6:].abs().max().item() > 0.0   # the lights' rows


def test_host_adjoint_loss_scale_cotangents(kernels_on_cpu):
    """K2 under the cotangents `optimize.fit` gives it: `make_loss`'s mean
    squared error of the radiance against a seeded target, divided by the
    values of a 512x512 image (about 1e-7 per value) instead of this
    image's, against the plain autograd of the same loss on Cornell at
    16x64, 4 bounces: every leaf within 1e-4 relative and engaged (K2's
    float sums keep contributions of any scale)."""
    scene, cam, cfg = cornell_default(device="cpu", use_mis=True)
    cfg = cfg.replace(max_bounces=4)
    h, w = 16, 64
    ro, rd = generate_rays(cam, h, w, 3)
    pix = rng.pixel_ids(h, w)
    target = torch.from_numpy(np.random.default_rng(7).uniform(0.0, 1.0, (h, w, 3))
                              .astype(np.float32))

    def grads(trace):
        leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in LEAVES}
        o, d = ro.detach().clone().requires_grad_(True), rd.detach().clone().requires_grad_(True)
        img = trace(scene.replace(**leaves), o, d)
        loss = ((img - target) ** 2).sum() / (512 * 512 * 3)
        got = torch.autograd.grad(loss, [*leaves.values(), o, d])
        return loss.detach(), dict(zip((*LEAVES, "ro", "rd"), got))

    loss, got = grads(lambda s, o, d: megakernel._TraceCore.apply(
        megakernel.scene_table(s), o, d, s, cfg, pix, 3, 0))
    ref_loss, want = grads(lambda s, o, d: integrator.trace(s, cfg, o, d, pix, 3, 0))
    assert abs(loss - ref_loss).item() <= 1e-5 * abs(ref_loss).item()
    assert_grads_close(got, want)
    for k in ("emission", "color", "pos"):
        assert 0.0 < got[k].abs().max().item() < 1e-2, k


@pytest.mark.parametrize("where", ["config2", "mis_demo"])
def test_host_adjoint_loss_scale_cotangents_wide(kernels_on_cpu, where):
    """K2's wide copy under `make_loss`-scale cotangents (about 1e-7 per
    value, as in `test_host_adjoint_loss_scale_cotangents`) against the
    plain autograd of the same loss at 16x64, 4 bounces: glass, mirror and
    coat with the IOR, a BOX SDF; every leaf within 1e-4 relative (or, at a pixel of float32
    cancellation, of the float64 plain value) and the geometry engaged."""
    scene, cam, cfg = adjoint_case(where)
    cfg = cfg.replace(max_bounces=4, marching_steps=32)
    assert not megakernel.cornell_copy(scene, cfg)
    h, w = 16, 64
    ro, rd = generate_rays(cam, h, w, 3)
    pix = rng.pixel_ids(h, w)
    target = torch.from_numpy(np.random.default_rng(7).uniform(0.0, 1.0, (h, w, 3))
                              .astype(np.float32))

    def grads(trace, dtype=torch.float32, mask=None):
        leaves = {k: getattr(scene, k).detach().to(dtype).requires_grad_(True)
                  for k in TABLE_LEAVES}
        assets = {k: getattr(scene, k).to(dtype) for k in ("images", "noise", "cubemap")}
        o, d = (v.detach().to(dtype).requires_grad_(True) for v in (ro, rd))
        img = trace(scene.replace(**leaves, **assets), o, d)
        sq = (img - target.to(dtype)) ** 2
        loss = (sq if mask is None else sq * mask[..., None]).sum() / (512 * 512 * 3)
        got = torch.autograd.grad(loss, [*leaves.values(), o, d], allow_unused=True)
        got = [torch.zeros_like(v) if g is None else g for g, v in zip(got, [*leaves.values(), o, d])]
        return loss.detach(), img.detach(), dict(zip((*TABLE_LEAVES, "ro", "rd"), got))

    plain = lambda s, o, d: integrator.trace(s, cfg, o, d, pix, 3, 0)
    kernel = lambda s, o, d: megakernel._TraceCore.apply(
        megakernel.scene_table(s), o, d, s, cfg, pix, 3, 0)
    loss, _, got = grads(kernel)
    ref_loss, _, want = grads(plain)
    assert abs(loss - ref_loss).item() <= 1e-5 * abs(ref_loss).item()
    assert_grads_close_f64(got, want, lambda kind, mask: grads(
        kernel if kind == "kernel" else plain,
        torch.float64 if kind == "plain64" else torch.float32, mask)[1:])
    for k in ("color", "pos"):
        assert 0.0 < got[k].abs().max().item() < 1e-2, k


@pytest.mark.parametrize("where", ["mis_demo", "restir_demo"])
def test_host_adjoint_aux_is_zero(kernels_on_cpu, where):
    """No BOX (`mis_demo`) or ROUND_BOX (`restir_demo`, per-light NEE)
    distance reads aux (table columns 14:26): K2's d_table is exactly 0
    there, as the plain autograd's gradient is, while the SDF row's pos and
    joker get theirs."""
    scene, cam, cfg = getattr(presets, where)(device="cpu")
    cfg = cfg.replace(use_restir=False, max_bounces=2, marching_steps=32)
    ro, rd = generate_rays(cam, 8, 32, 1)
    pix = rng.pixel_ids(8, 32)
    table = megakernel.scene_table(scene)
    assert 14 not in megakernel.bwd_columns(scene, cfg)
    d_table, _, _ = megakernel._launch_backward(scene, cfg, table, ro, rd, pix, 1, 0,
                                                torch.ones(8, 32, 3))
    assert bool((d_table[:, 14:26] == 0.0).all())
    row = scene.num_analytic
    assert d_table[row, 0:3].abs().max().item() > 0.0
    assert d_table[row, 3:6].abs().max().item() > 0.0
    aux = scene.aux.clone().requires_grad_(True)
    joker = scene.joker.clone().requires_grad_(True)
    out = integrator.trace(scene.replace(aux=aux, joker=joker), cfg, ro, rd, pix, 1, 0)
    g, g_joker = torch.autograd.grad(out.sum(), (aux, joker), allow_unused=True)
    assert g is None or bool((g == 0.0).all())
    assert g_joker[row, :3].abs().max().item() > 0.0


def _widened_scene(where, device="cpu"):
    """(scene, camera) of the scenes only the widened K1 renders: mirror,
    glass and coat in a closed box (tests/test_golden_cornell.py:66-79), a
    directional sun (tests/test_megakernel.py:685-698), a cubemap."""
    if where == "cubemap":
        scene, cam, _ = cubemap_demo(device=device)
        return scene, cam
    if where == "config2":
        scene = parse_scene("""
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
            MAT_REFR_CLEAR, SPHERE, vec3(0.5, 0.4, -1.2), vec4(0.3)
        """, device=device)
        return scene, Camera.make(origin=(0, 0, 1.99), lookat=(0, 0, -1), fov=60.0,
                                  device=device)
    sb = SceneBuilder()
    sb.add("MAT_CORNELL_WHITE", MeshType.BOX, (0.0, -2.2, -1.0), (2.0,))
    sb.add("MAT_CORNELL_RED", MeshType.BOX, (-0.8, -0.8, -1.4), (0.8,))
    sb.add("MAT_MIRROR", MeshType.SPHERE, (0.6, -0.7, -1.0), (0.5,))
    sb.add("MAT_DIRECT_SUNLIGHT", MeshType.SPHERE, (0.5, 0.8, 0.3), (0.01,))
    sb.add("MAT_LIGHT_4", MeshType.SPHERE, (-0.5, 0.9, -0.8), (0.2,))
    sb.lights([3, 4])
    return sb.build(device=device), Camera.make(origin=(0.0, 0.3, 2.0),
                                               lookat=(0.0, -0.6, -1.0), device=device)


@pytest.mark.parametrize("where,kw", [
    ("cubemap", dict(max_bounces=6)),
    ("cubemap", dict(max_bounces=5, use_mis=True, use_biased_sampling=False)),
    ("cubemap", dict(max_bounces=4, sample_lights=False)),
    ("config2", dict(max_bounces=8, use_mis=True)),
    ("config2", dict(max_bounces=6, max_spec_bounces=2)),
    ("dir", dict(max_bounces=5)),
    ("dir", dict(max_bounces=5, use_mis=True)),
    ("cornell", dict(max_bounces=5, use_mis=True, use_biased_sampling=False)),
], ids=["cubemap", "cubemap_uniform_mis", "cubemap_bsdf_only", "config2",
        "config2_spec_cap", "dir", "dir_mis", "cornell_uniform"])
def test_host_widened_forward_matches_plain(kernels_on_cpu, where, kw):
    """The widened K1 (BSDF dispatch, directional lights, cubemap fetches
    and gather rays, uniform sampling), one launch, against the plain
    version under the parity contract."""
    if where == "cornell":
        scene, cam, cfg = cornell_default(device="cpu")
    else:
        scene, cam = _widened_scene(where)
        cfg = cubemap_demo(device="cpu")[2] if where == "cubemap" else \
            cornell_default(device="cpu", use_procedural_sky=where == "dir")[2]
    cfg = cfg.replace(**kw)
    assert megakernel.unsupported(scene, cfg) is None
    h, w = 16, 64
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w)
    before = megakernel.LAUNCHES
    out = megakernel._launch_forward(scene, cfg, megakernel.scene_table(scene),
                                     ro, rd, pix, 2, 0)
    assert megakernel.LAUNCHES == before + 1
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    err = (out - ref).abs().amax(-1)
    assert bool(torch.isfinite(out).all())
    assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4, \
        err.max().item()
    assert ref.max().item() > 0.1


def textured_case(where, device="cpu"):
    """(scene, camera, cfg) of a textured preset or of a scene of
    tests/test_torch_texture_scenes.py (procedural types, gradient noise,
    a CHECK sphere)."""
    from test_torch_texture_scenes import SCENE_VIEWS

    if where in SCENE_VIEWS:
        make, (origin, lookat, fov), kw = SCENE_VIEWS[where]
        cam = Camera.make(origin=origin, lookat=lookat, fov=fov, device=device)
        return make(SceneBuilder, materials, device=device), cam, OFFLINE_CONFIG.replace(**kw)
    return getattr(presets, where)(device=device)


@pytest.mark.parametrize("where,kw", [
    ("textured_cornell", dict(max_bounces=5, use_mis=True)),
    ("textured_gloss", dict(max_bounces=5)),
    ("textured_emitter", dict(max_bounces=4, use_mis=True)),
    ("cornell_box", dict(max_bounces=6)),
    ("procedural", dict(max_bounces=4)),
    ("procedural", dict(max_bounces=3, sample_lights=False)),
    ("gradient_noise", dict(max_bounces=2)),
    ("check_sphere", dict(max_bounces=3)),
])
def test_host_textured_forward_matches_plain(kernels_on_cpu, where, kw):
    """K1 with textures of all ten types (image texels on color, emission
    and glossiness; UV patterns on planes and spheres; the noise types),
    one launch, against the plain version under the parity contract; on
    gradient noise, whose sin hash amplifies the ULP by which the host's
    sinf and torch's sin may differ 43758x, in mean and standard deviation
    (tests/test_megakernel.py:277-278)."""
    scene, cam, cfg = textured_case(where)
    cfg = cfg.replace(**kw)
    assert megakernel.unsupported(scene, cfg) is None
    h, w = 16, 64
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w)
    before = megakernel.LAUNCHES
    out = megakernel._launch_forward(scene, cfg, megakernel.scene_table(scene),
                                     ro, rd, pix, 2, 0)
    assert megakernel.LAUNCHES == before + 1
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    err = (out - ref).abs().amax(-1)
    assert bool(torch.isfinite(out).all()) and ref.max().item() > 0.02
    if where == "gradient_noise":
        assert abs(out.mean() - ref.mean()).item() < 0.02 * ref.mean().item()
        assert abs(out.std() - ref.std()).item() < 0.05 * ref.std().item()
    else:
        assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4, \
            err.max().item()


@pytest.mark.parametrize("where", ["mis_demo", "restir_demo"])
def test_host_sdf_forward_matches_plain(kernels_on_cpu, where):
    """K1 with the SDF march (a BOX under the light of `mis_demo`, the
    ROUND_BOX of `restir_demo` rendered with per-light NEE), one launch,
    against the plain version under the parity contract, and with a mean
    error at float32 rounding: the host's sinf/cosf flip a pixel now and
    then (mean error <= 3e-8 here), while a march that steps without its
    fudge factor moves the SDF hits of ~10 % of the pixels (mean >= 2.6e-6)
    and still meets the parity contract."""
    scene, cam, cfg = getattr(presets, where)(device="cpu")
    cfg = cfg.replace(use_restir=False, max_bounces=3, marching_steps=32)
    assert megakernel.unsupported(scene, cfg) is None
    h, w = 16, 64
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w)
    before = megakernel.LAUNCHES
    out = megakernel._launch_forward(scene, cfg, megakernel.scene_table(scene),
                                     ro, rd, pix, 2, 0)
    assert megakernel.LAUNCHES == before + 1
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    err = (out - ref).abs().amax(-1)
    assert bool(torch.isfinite(out).all()) and ref.max().item() > 0.02
    assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4, \
        err.max().item()
    assert err.mean().item() < 5e-7, err.mean().item()


def whole_sdf_case(where, device="cpu"):
    """(scene, camera, cfg) of a preset K1 renders with its whole-SDF copy
    (presets 0, 2 and 3 and `presets.SDF_SCENE_VIEWS`)."""
    if where in presets.SDF_SCENE_VIEWS:
        return presets.sdf_view(where, device=device)
    return getattr(presets, where)(device=device)


@pytest.mark.parametrize("where,kw", [
    ("default_scene", dict(max_bounces=4)),
    ("mandelbulb", dict(max_bounces=3, use_mis=True)),
    ("menger_sponge", dict(max_bounces=3)),
    ("sdf_light", dict(max_bounces=3)),
    ("sdf_light", dict(max_bounces=3, use_mis=True)),
    ("every_shape", dict(max_bounces=2)),
], ids=["default_scene", "mandelbulb", "menger_sponge", "sdf_light", "sdf_light_mis",
        "every_shape"])
def test_host_whole_sdf_forward_matches_plain(kernels_on_cpu, where, kw):
    """K1's whole-SDF copy (the 14 distances, a METAL texture on an SDF
    box, a CHECK texture on an SDF quad, SDF-light NEE with and without
    MIS), one launch, against the plain version under the parity contract
    at 16x32 with 32 marching steps; the fractals, whose march and normal
    an ULP of the host's logf or of torch's CPU sqrt moves, as the JAX
    package's `test_procedural_cubemap_presets_interpret` holds them
    (tests/test_megakernel.py:357-385): at least 97 % of the pixels within
    1e-4 and the means within 2 %."""
    scene, cam, cfg = whole_sdf_case(where)
    cfg = cfg.replace(marching_steps=32, **kw)
    assert megakernel.unsupported(scene, cfg) is None and megakernel.whole_sdf(scene)
    h, w = 16, 32
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w)
    before = megakernel.LAUNCHES
    out = megakernel._launch_forward(scene, cfg, megakernel.scene_table(scene),
                                     ro, rd, pix, 2, 0)
    assert megakernel.LAUNCHES == before + 1
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    err = (out - ref).abs().amax(-1)
    print(f"{where}: {int((err > 0).sum())} of {h * w} pixels differ, max {err.max().item():.3e}")
    assert bool(torch.isfinite(out).all()) and ref.max().item() > 0.02
    if where in ("mandelbulb", "menger_sponge"):
        assert (err < 1e-4).float().mean().item() >= 0.97
        assert abs(out.mean() - ref.mean()).item() <= 0.02 * ref.mean().item()
    else:
        assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4, \
            err.max().item()


#: the scene that holds a row of each SDF shape: the every-shape scene, and
#: for BOX, MENGER_SPONGE and MANDELBULB the preset of the reference that
#: holds it
SHAPE_SCENES = {"BOX": "default_scene", "MENGER_SPONGE": "menger_sponge",
                "MANDELBULB": "mandelbulb"}


_SHAPE_SCENE_GRADS = {}


def shape_scene(where):
    """(scene, first hit per pixel (its mesh row, -1 on a miss), grads_of)
    of the scene `where` of SHAPE_SCENES at 32x32 (the every-shape scene,
    whose triangle takes 10 pixels there) or 8x32 (the presets, as
    `test_host_whole_sdf_adjoint_matches_plain`), 2 bounces (the first
    hit's NEE and its bounce) and 32 marching steps, for `test_host_sdf_map_adjoint_matches_plain`:
    `grads_of(kind, mask)` as `assert_grads_close_f64` takes it, kept on
    the pixels whose radiance K1 and the plain version give alike, and
    cached, so the shapes of one scene share one launch of each kind (call
    it with the host build patched in)."""
    if where not in _SHAPE_SCENE_GRADS:
        from raytracer0_tpu_torch.ops import intersect

        scene, cam, cfg = whole_sdf_case(where)
        cfg = cfg.replace(max_bounces=2, marching_steps=32)
        h, w = (32, 32) if where == "every_shape" else (8, 32)
        ro, rd = generate_rays(cam, h, w, 2)
        pix = rng.pixel_ids(h, w)
        hit = intersect.intersect(scene, ro, rd, cfg, need_normal=False)
        first = torch.where(hit.missed, -1, hit.idx)
        out = megakernel._launch_forward(scene, cfg, megakernel.scene_table(scene), ro, rd, pix,
                                         2, 0)
        keep = (out - integrator.trace(scene, cfg, ro, rd, pix, 2, 0)).abs().amax(-1) <= 1e-5
        assert (~keep).float().mean().item() <= 0.03
        kernel = lambda s, c, o, d, p: megakernel._TraceCore.apply(
            megakernel.scene_table(s), o, d, s, c, p, 2, 0)
        plain = lambda s, c, o, d, p: integrator.trace(s, c, o, d, p, 2, 0)
        cache = {}

        def grads_of(kind, mask):
            mask = keep if mask is None else mask & keep
            key = (kind, mask.numpy().tobytes())
            if key not in cache:
                cache[key] = _grads(kernel if kind == "kernel" else plain, scene, cfg, ro, rd,
                                    pix, mask, torch.float64 if kind == "plain64" else torch.float32)
            return cache[key]

        _SHAPE_SCENE_GRADS[where] = (scene, torch.where(keep, first, -1), grads_of)
    return _SHAPE_SCENE_GRADS[where]


@pytest.mark.parametrize("shape", [s.name for s in materials.SdfShape] + ["every_shape"])
def test_host_sdf_map_adjoint_matches_plain(kernels_on_cpu, shape):
    """K2's adjoint of each SDF shape's distance (`adjoint.cuh::
    sdf_map_all_bwd` and the shape's own adjoint, through the implicit t
    and the tetrahedral normal of its hits) in the scene that holds it
    (SHAPE_SCENES, `shape_scene`: one launch of the whole-SDF copy through
    `_TraceCore`), against the plain autograd: the cotangents of the rows
    of that shape (every SDF row of the every-shape scene for
    "every_shape") and of the rays whose first hit is one of them, under
    `assert_grads_close_f64` as `test_host_whole_sdf_adjoint_matches_plain`
    holds those scenes; the gradient w.r.t. the rows' pos is not 0."""
    where = SHAPE_SCENES.get(shape, "every_shape")
    scene, first, grads_all = shape_scene(where)
    rows = [scene.num_analytic + k for k, sh in enumerate(scene.sdf_shapes_static)
            if shape == "every_shape" or sh == int(materials.SdfShape[shape])]
    on = torch.isin(first, torch.tensor(rows))
    assert int(on.sum()) >= 8, int(on.sum())

    def grads_of(kind, mask):
        out, g = grads_all(kind, mask)
        return out, {k: v[on] if k in ("ro", "rd") else v[rows] for k, v in g.items()}

    _, got = grads_of("kernel", None)
    _, want = grads_of("plain", None)
    assert_grads_close_f64(got, want, grads_of, ill_conditioned=where == "menger_sponge",
                           f64_leaves=("pos", "joker", "ro", "rd") if where == "default_scene"
                           else ())
    assert got["pos"].abs().max().item() > 0.0


#: K2's whole-SDF copy on the host: (scene, config overrides); the every-
#: shape scene's triangle and quad and the polygon scene give aux its
#: cotangents
WHOLE_SDF_ADJOINT = {
    "every_shape": ("every_shape", dict(max_bounces=2, marching_steps=16)),
    "polygons": ("polygons", dict(max_bounces=3)),
    "sdf_light": ("sdf_light", dict(max_bounces=3)),
    "sdf_light_mis": ("sdf_light", dict(max_bounces=3, use_mis=True)),
    "textured_sdf": ("textured_sdf", dict(max_bounces=3, use_mis=True)),
    "default_scene": ("default_scene", dict(max_bounces=4)),
    "mandelbulb": ("mandelbulb", dict(max_bounces=3, use_mis=True)),
    "menger_sponge": ("menger_sponge", dict(max_bounces=3)),
}


@pytest.mark.parametrize("name", list(WHOLE_SDF_ADJOINT))
def test_host_whole_sdf_adjoint_matches_plain(kernels_on_cpu, name):
    """K2's whole-SDF copy (the 14 distances' adjoints, the texel of an SDF
    hit, SDF-light NEE with and without MIS, a textured SDF light), one
    launch through `_TraceCore`, against the plain autograd at 8x32 (16x16
    for the every-shape, polygon and textured scenes, whose SDF rows are in
    view there) with 32 marching steps, under `assert_grads_close_f64`
    (`menger_sponge` on the pixels where float32 and float64 take the same
    decisions, `default_scene`'s pos and joker held against float64), d aux of
    the TRIANGLE and QUAD rows included.  A pixel whose radiance K1 and the plain version take apart
    (host libm's logf moves a fractal's silhouette, as
    test_host_whole_sdf_forward_matches_plain says) keeps no cotangent: at
    most 3 % of them on the fractals, none elsewhere."""
    where, kw = WHOLE_SDF_ADJOINT[name]
    scene, cam, cfg = whole_sdf_case(where)
    cfg = cfg.replace(**{"marching_steps": 32, **kw})
    assert megakernel.unsupported_bwd(scene, cfg) is None
    assert megakernel.bwd_copy(scene, cfg) == "whole_sdf"
    h, w = (16, 16) if where in ("every_shape", "polygons", "textured_sdf") else (8, 32)
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w)
    kernel = lambda s, c, o, d, p: megakernel._TraceCore.apply(
        megakernel.scene_table(s), o, d, s, c, p, 2, 0)
    plain = lambda s, c, o, d, p: integrator.trace(s, c, o, d, p, 2, 0)
    out = megakernel._launch_forward(scene, cfg, megakernel.scene_table(scene), ro, rd, pix, 2, 0)
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    keep = (out - ref).abs().amax(-1) <= 1e-5
    assert (~keep).float().mean().item() <= (0.03 if where in ("mandelbulb", "menger_sponge")
                                              else 0.0)

    def grads_of(kind, mask):
        mask = keep if mask is None else mask & keep
        return _grads(kernel if kind == "kernel" else plain, scene, cfg, ro, rd, pix, mask,
                      torch.float64 if kind == "plain64" else torch.float32)

    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    _, got = grads_of("kernel", None)
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _, want = grads_of("plain", None)
    assert_grads_close_f64(got, want, grads_of, ill_conditioned=where == "menger_sponge",
                           f64_leaves=("pos", "joker", "ro", "rd") if where == "default_scene"
                           else ())
    for k in ("color", "pos", "joker", "rd"):
        assert got[k].abs().max().item() > 0.0, k
    if where in ("every_shape", "polygons"):
        assert got["aux"].abs().max().item() > 0.0
    else:
        assert bool((got["aux"] == 0.0).all())
    if where == "textured_sdf":
        assert got["tex_cmask"].abs().max().item() > 0.0
        assert got["tex_emask"].abs().max().item() > 0.0


@pytest.mark.parametrize("where", ["cornell", "config2", "mis_demo", "restir_demo",
                                   "animated_untextured", "default_scene", "mandelbulb",
                                   "menger_sponge", "every_shape", "sdf_light", "textured_sdf",
                                   "polygons"])
def test_host_adjoint_copy_per_scene(host_kernels, where):
    """Which copy of K2 each scene runs: the Cornell copy, the wide copy
    (BOX and ROUND_BOX rows, untextured and unlit, whose `sdf_entry` reads
    any other shape as a BOX) or the whole-SDF copy, and the `use_tex` bit 2
    by which the library picks the last (`rt0_trace_backward`)."""
    if where in ("cornell", "config2"):
        scene, _, cfg = adjoint_case(where)
    elif where in ("mis_demo", "restir_demo", "animated_untextured"):
        scene, _, cfg = getattr(presets, where)(device="cpu")
        cfg = cfg.replace(use_restir=False)
    else:
        scene, _, cfg = whole_sdf_case(where)
    want = ("cornell" if where == "cornell" else
            "wide" if where in ("config2", "mis_demo", "restir_demo", "animated_untextured")
            else "whole_sdf")
    assert megakernel.unsupported_bwd(scene, cfg) is None
    assert megakernel.bwd_copy(scene, cfg) == want
    assert bool(megakernel.tex_flags(scene) & 4) == (want == "whole_sdf")


def test_host_restir_matches_plain(kernels_on_cpu):
    """K6 against the plain `restir.render_sample` on `restir_demo`, each
    threading its own reservoir ring through passes 0-3 (temporal reuse
    starts at pass 3), under the fused-versus-wavefront contract of
    tests/test_restir.py:312-352: per pass max |Δ| < 5e-3 and median
    |Δ| < 1e-6 of the radiance, light indices agreeing at >= 99.5 % of
    pixels, the other reservoir fields within 1e-4 where they agree."""
    _host_restir_passes(*presets.restir_demo(device="cpu"))


def test_host_restir_mis_matches_plain(kernels_on_cpu):
    """The same on `restir_demo` with MIS: 9 lights keep ReSTIR engaged,
    and the emissive hits of diffuse paths take the BSDF-side MIS weight
    inside K6."""
    _host_restir_passes(*presets.restir_demo(device="cpu", use_mis=True))


def _host_restir_passes(scene, cam, cfg, times=(0.0,) * 4, refresh=False):
    """K6 against the plain render_sample at the frame times `times`, one
    pass each; with `refresh` the plain ring's light data is first replaced
    by the frame's (`restir_kernel.light_data`), which is what K6 reads."""
    cfg = cfg.replace(max_bounces=2, max_diff_bounces=2, restir_samples=4,
                      marching_steps=16)
    assert restir_kernel.unsupported_restir(scene, cfg) is None
    h, w = 8, 32
    pix = rng.pixel_ids(h, w)
    kernel, plain = RenderState.create(h, w, "cpu"), RenderState.create(h, w, "cpu")
    for p, t in enumerate(times):
        ro, rd = generate_rays(cam, h, w, p)
        frame = scene_mod.animate_positions(scene, t, int(cfg.render_mode))
        if refresh:
            plain = refreshed_ring(frame, plain)
        before = restir_kernel.LAUNCHES
        out, new = restir_kernel._launch(frame, cfg, ro, rd, pix, p, 0, kernel.restir_back,
                                         kernel.restir_hist1, kernel.restir_hist2)
        assert restir_kernel.LAUNCHES == before + 1
        ref, new_ref = restir.render_sample(scene, cfg, cam, plain, h, w, p, t)
        err = (out - ref).abs()
        assert bool(torch.isfinite(out).all())
        assert err.max().item() < 5e-3 and err.median().item() < 1e-6, (p, err.max().item())
        agree = new.light_index == new_ref.light_index
        assert agree.float().mean().item() >= 0.995, p
        for k in ("weight_sum", "m", "w", "age", "light_pos", "light_color"):
            a, b = getattr(new, k)[agree], getattr(new_ref, k)[agree]
            assert (a - b).abs().max().item() <= 1e-4, (p, k)
        kernel = kernel.rotate_reservoirs(new)
        plain = plain.rotate_reservoirs(new_ref)
    assert int((new.light_index >= 0).sum()) > h * w // 2
    assert new.m.max().item() > 0.0 and ref.max().item() > 0.0


def refreshed_ring(frame, state):
    """`state` with the light data of its three grids replaced by the
    frame's light data of their light indices (`restir_kernel.light_data`):
    the light data K6 reads, which under a moving ANIMATED time differs from
    the stored copies the plain version's spatial taps read."""
    def fresh(g):
        pos, col = restir_kernel.light_data(frame, g.light_index)
        return dataclasses.replace(g, light_pos=pos, light_color=col)
    return state.replace(restir_back=fresh(state.restir_back),
                         restir_hist1=fresh(state.restir_hist1),
                         restir_hist2=fresh(state.restir_hist2))


@pytest.mark.parametrize("where", ["animated_restir", "every_shape"])
def test_host_restir_whole_sdf_matches_plain(kernels_on_cpu, where):
    """The K6 pass in K4's and K6v's whole-SDF copies (their shadow rays
    march every shape) against the plain render_sample under the contract
    of `test_host_restir_matches_plain`: `animated_restir` as shipped at a
    constant frame time and the `every_shape` ReSTIR view, passes 0-3.
    (Host libm's logf moves Mandelbulb pixels by up to 3e-4 and the
    reservoirs' sums with them; the card holds the `mandelbulb` view bit
    for bit, chip_smoke.py phase 28.)"""
    if where == "animated_restir":
        scene, cam, cfg = presets.animated_restir(device="cpu")
        times = (0.9,) * 4
    else:
        scene, cam, cfg = presets.restir_sdf_view(where, device="cpu")
        times = (0.0,) * 4
    assert megakernel.whole_sdf(scene) and restir_vertex.vertex_copy(scene, False) == 2
    _host_restir_passes(scene, cam, cfg, times)


@pytest.mark.parametrize("moving", [False, True], ids=["constant_time", "moving_time"])
def test_host_restir_animated_matches_plain(kernels_on_cpu, moving):
    """K6 under ANIMATED accumulation (alpha x 0.85, spatial taps younger
    than 2 passes) on the real-time scene, passes 0-3, against the plain
    render_sample under the contract of `test_host_restir_matches_plain`:
    at a constant frame time, and at a moving one with the plain ring's
    light data refreshed to the frame's before each pass."""
    scene, cam, cfg = presets.animated_untextured(device="cpu")
    times = [k / 30 for k in range(4)] if moving else [0.9] * 4
    _host_restir_passes(scene, cam, cfg, times, refresh=moving)


RESTIR_LEAVES = ("emission", "color", "pos", "joker", "ior")


def restir_chain_grads(trace, scene, cfg, cam, h, w, passes, seed=5, l2_over=None,
                       names=RESTIR_LEAVES):
    """A loss over `passes` ReSTIR passes from an empty ring, each traced by
    `trace` (`restir_kernel._fused`, K6 with K7 under autograd, or the
    plain `restir.trace_sample`): seeded weights on every pass's radiance
    and on the last ring's weight_sum, m, w and age; or, with `l2_over` =
    n, `optimize.make_loss`'s L2 of the passes' mean radiance against a
    seeded target, divided by n values instead of h x w x 3 (the
    cotangents an n-value image gives).  Returns (loss, {scene leaf of
    `names`: gradient (zeros for a leaf the passes do not read), "ro"/"rd":
    the rays' gradients of all passes})."""
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in names}
    s = scene.replace(**leaves)
    state = RenderState.create(h, w, device=scene.device)
    pix = rng.pixel_ids(h, w, device=scene.device)
    r = np.random.default_rng(seed)
    weights = lambda shape: torch.from_numpy(r.uniform(0.5, 1.5, shape).astype(np.float32)
                                             ).to(scene.device)
    loss, rays, accum = 0.0, [], 0.0
    for p in range(passes):
        ro, rd = generate_rays(cam, h, w, p)
        rays += [ro.detach().requires_grad_(True), rd.detach().requires_grad_(True)]
        rad, new = trace(s, cfg, rays[-2], rays[-1], pix, p, 0, state.restir_back,
                         state.restir_hist1, state.restir_hist2)
        if l2_over is None:
            loss = loss + (rad * weights(rad.shape)).sum()
        accum = accum + rad
        state = state.rotate_reservoirs(new)
    if l2_over is None:
        for k in restir_kernel.RING_FLOATS:
            loss = loss + (getattr(state.restir_back, k) * weights((h, w))).sum() * 0.1
    else:
        loss = ((accum / passes - weights(accum.shape)) ** 2).sum() / l2_over
    got = torch.autograd.grad(loss, list(leaves.values()) + rays, allow_unused=True)
    out = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(names, got)}
    out["ro"], out["rd"] = torch.stack(got[-2 * passes::2]), torch.stack(got[-2 * passes + 1::2])
    return loss.detach(), out


def assert_grads_close(got, want, tol=1e-4):
    """Per leaf max|a - b| / max|b| below `tol` (tests/test_megakernel.py:
    128-129), every gradient finite."""
    for k, b in want.items():
        a = got[k]
        assert bool(torch.isfinite(a).all()), k
        scale = max(b.abs().max().item(), 1e-12)
        assert (a - b).abs().max().item() / scale < tol, (k, (a - b).abs().max().item(), scale)


# K2 against the plain float32 autograd at a pixel whose discrete decisions
# float64 takes otherwise, checked without arbitration (chip_smoke.py's
# GRAD_TOL_FULL)
GRAD_TOL_RAW = 1e-3
# the most pixels `ill_conditioned` leaves out, where the float32 and
# float64 plain radiances disagree: `menger_sponge` leaves out 26 of 256
# here (8x32, 3 bounces) and 2,047 of 16,384 on the card (chip_smoke.py
# phase 27, 128x128, 4 bounces)
ILL_CONDITIONED_LEFT_OUT = 0.15
# the most a leaf of `f64_leaves` may miss the float64 plain autograd by,
# of the leaf: `default_scene`'s pos and joker miss it by 2.6e-2 and 2.9e-2
# here (8x32, 4 bounces), its pos, joker, ro and rd by at most 1.13e-2 on
# the card (chip_smoke.py phase 27, 128x128)
F64_LEAF_TOL = 5e-2


def _agreeing_pixels(grads_of):
    """(H, W) bool: the pixels where the float32 and float64 plain radiances
    agree within 1e-3 (at the others float64 takes another discrete
    decision: a Fresnel choice, a hit, a cell, a step of the march)."""
    out32, out64 = grads_of("plain", None)[0], grads_of("plain64", None)[0]
    return (out32.double() - out64).abs().amax(-1) <= 1e-3 * out64.abs().amax(-1) + 1e-7


def assert_grads_close_f64(got, want, grads_of, tol=1e-4, ill_conditioned=False,
                           f64_leaves=()):
    """`assert_grads_close` of K2 (`got`) against the plain float32
    autograd (`want`), where an entry of a leaf misses it arbitrated by the
    plain autograd in float64.  At a pixel whose gradient passes through a
    cancellation (a grazing sphere hit, a noise texture of high frequency
    whose gradient along a plane's normal cancels), two float32 programs
    that order their operations differently differ by more than 1e-4 of
    the leaf, and either may be the nearer to the exact value.

    `grads_of(kind, mask)` gives (radiance, gradients) of "kernel", "plain"
    or "plain64" with the cotangent kept on the (H, W) `mask`.  Every
    entry stays within GRAD_TOL_RAW of the leaf unarbitrated.  Arbitration
    runs on the pixels where the float32 and float64 plain radiances agree
    within 1e-3 (`_agreeing_pixels`), at most 0.1 % of the pixels (or 4)
    left out; there K2 may differ from the float64 value by no more than
    the float32 plain version does plus `tol` of the leaf, on at most 0.1 %
    of the entries of a leaf (or a mesh's 3).

    Two scenes need more, each stated by its caller and returned:
    `ill_conditioned` (`menger_sponge`, whose march steps by eps and whose
    normal's taps straddle carvings finer than a step): every gradient is
    taken on the agreeing pixels, at most ILL_CONDITIONED_LEFT_OUT of them
    left out, and held there as above.  `f64_leaves` (`default_scene`'s
    pos, joker, ro and rd): those leaves are held against the float64 plain
    autograd on the agreeing pixels (at most 0.1 % or 4 left out): K2
    within F64_LEAF_TOL of the leaf, and within GRAD_TOL_RAW or within the
    float32 plain version's own miss plus `tol`.  Their true gradient is small beside the
    terms that make it up: an SDF hit's tetrahedral normal sums four taps
    whose gradients, of size 1/eps, cancel on a flat face, and the plain
    version sums each tap over the batch before they cancel (K2 per
    pixel), so the float32 plain autograd misses the float64 one there by
    far more than K2 does.

    Returns (pixels left out, {leaf of `f64_leaves`: (the float32 plain
    version's miss, K2's miss)}, each of the float64 leaf)."""
    left_out = 0
    if ill_conditioned:
        agree0 = _agreeing_pixels(grads_of)
        left_out = int((~agree0).sum().item())
        assert left_out <= ILL_CONDITIONED_LEFT_OUT * agree0.numel(), left_out
        grads_all = grads_of
        grads_of = lambda kind, mask: grads_all(kind, agree0 if mask is None else mask & agree0)
        (_, got), (_, want) = grads_of("kernel", None), grads_of("plain", None)
    held = {}
    if f64_leaves:
        agree = _agreeing_pixels(grads_of)
        assert (~agree).sum().item() <= max(4, 0.001 * agree.numel()) + left_out, \
            (~agree).sum().item()
        (_, a_m), (_, b_m), (_, c_m) = (grads_of(kind, agree)
                                        for kind in ("kernel", "plain", "plain64"))
        for k in f64_leaves:
            assert bool(torch.isfinite(a_m[k]).all()), k
            c = c_m[k]
            scale = max(c.abs().max().item(), 1e-12)
            e32 = (b_m[k].double() - c).abs().max().item() / scale
            e_k2 = (a_m[k].double() - c).abs().max().item() / scale
            assert e_k2 < F64_LEAF_TOL and (e_k2 <= e32 + tol or e_k2 < GRAD_TOL_RAW), \
                (k, e_k2, e32)
            held[k] = (e32, e_k2)
        want = {k: v for k, v in want.items() if k not in f64_leaves}
    scales = {}
    for k, b in want.items():
        a = got[k]
        assert bool(torch.isfinite(a).all()), k
        scales[k] = max(b.abs().max().item(), 1e-12)
        raw = (a - b).abs().max().item() / scales[k]
        assert raw < GRAD_TOL_RAW, (k, raw)
    missed = [k for k, b in want.items() if (got[k] - b).abs().max().item() / scales[k] >= tol]
    if not missed:
        return left_out, held
    agree = _agreeing_pixels(grads_of)
    assert (~agree).sum().item() <= max(4, 0.001 * agree.numel()) + left_out, \
        (~agree).sum().item()
    (_, a_m), (_, b_m), (_, c_m) = (grads_of(kind, agree) for kind in ("kernel", "plain", "plain64"))
    for k in want:
        a, b, c = a_m[k], b_m[k], c_m[k]
        miss = (a - b).abs() >= tol * scales[k]
        assert miss.sum().item() <= max(3, 0.001 * miss.numel()), (k, miss.sum().item())
        slack = ((a.double() - c).abs() - (b.double() - c).abs()).max().item()
        assert slack / scales[k] < tol, (k, (a - b).abs().max().item(), slack, scales[k])
    return left_out, held


@pytest.mark.parametrize("where,passes", [("restir_demo", 4), ("restir_stress", 4),
                                          ("restir_demo", 7)])
def test_host_restir_adjoint_matches_plain(kernels_on_cpu, where, passes):
    """K7 (one launch per pass, through `_RestirCore`) against the plain
    `restir.trace_sample`'s autograd over passes 0-3 (temporal reuse from
    pass 3) or 0-6 (M above 30, which engages the shading's sqrt(30 / M)) from
    an empty ring at 8x16 with 2 bounces: the scene leaves (emission, color,
    pos, joker, ior) and every pass's rays within 1e-4 relative; a second
    run gives the same bits.  Over a chain from an empty ring with one scene
    the plain gradient that reaches the ring's light data is the kernels'
    gradient of the slot table (ops/restir_kernel.py)."""
    scene, cam, cfg = getattr(presets, where)(device="cpu")
    cfg = cfg.replace(max_bounces=2, restir_samples=4, marching_steps=16)
    assert restir_kernel.unsupported_restir_bwd(scene, cfg) is None
    before = (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES)
    loss, got = restir_chain_grads(restir_kernel._fused, scene, cfg, cam, 8, 16, passes)
    assert (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES) == (before[0] + passes,
                                                                   before[1] + passes)
    ref_loss, want = restir_chain_grads(restir.trace_sample, scene, cfg, cam, 8, 16, passes)
    assert abs(loss - ref_loss).item() <= 1e-5 * abs(ref_loss).item()
    assert_grads_close(got, want)
    assert got["emission"].abs().max().item() > 0.0 and got["pos"].abs().max().item() > 0.0
    _, again = restir_chain_grads(restir_kernel._fused, scene, cfg, cam, 8, 16, passes)
    for k in got:
        assert torch.equal(got[k], again[k]), k


@pytest.mark.parametrize("where", ["restir_demo", "restir_stress"])
def test_host_restir_adjoint_loss_scale_cotangents(kernels_on_cpu, where):
    """K7 under the cotangents `optimize.fit` gives it: `make_loss`'s L2 of
    `render_linear(passes=4)` against a target, scaled to the per-value
    cotangents of a 512x512 image (about 1e-7 per pixel and pass), against
    the plain autograd of the same loss, over passes 0-3 at 8x16 with 2
    bounces: every scene leaf and ray within 1e-4 relative, and the
    gradients engaged (K7's float sums keep contributions of any scale)."""
    scene, cam, cfg = getattr(presets, where)(device="cpu")
    cfg = cfg.replace(max_bounces=2, restir_samples=4, marching_steps=16)
    n = 512 * 512 * 3
    loss, got = restir_chain_grads(restir_kernel._fused, scene, cfg, cam, 8, 16, 4, l2_over=n)
    ref_loss, want = restir_chain_grads(restir.trace_sample, scene, cfg, cam, 8, 16, 4,
                                        l2_over=n)
    assert abs(loss - ref_loss).item() <= 1e-5 * abs(ref_loss).item()
    assert_grads_close(got, want)
    for k in ("emission", "color", "pos"):
        assert 0.0 < got[k].abs().max().item() < 1e-2, k


def test_host_restir_adjoint_ring_fields(kernels_on_cpu):
    """One pass of `restir_demo` on a warm ring (after 6 passes, so that M
    exceeds 30 and the shading's sqrt(30 / M) factor is engaged) whose float
    fields are leaves: K7's cotangents of back, hist1 and hist2 (m, w and
    age; weight_sum only gates validity, so its cotangent is zero) against
    plain autograd, for seeded weights on the radiance and on the new
    ring's float fields.  The plain gradient of the ring's light data has no
    K7 counterpart (K7 reads the slot table), so only the float fields are
    compared."""
    scene, cam, cfg = presets.restir_demo(device="cpu", max_bounces=3, restir_samples=4,
                                          marching_steps=16)
    _ring_field_grads(scene, cam, cfg, min_m=30.0)


def _ring_field_grads(scene, cam, cfg, min_m, time_s=0.0):
    """K7's cotangents of a warm ring's float fields (after 6 passes of
    `scene` at the frame time `time_s`) against plain autograd; `min_m`:
    some back-grid M above it."""
    h, w = 8, 32
    state = RenderState.create(h, w, "cpu")
    with torch.no_grad():
        for _ in range(6):
            state = render_pass(scene, cam, cfg, state, h, w, time_s)
    scene = scene_mod.animate_positions(scene, time_s, int(cfg.render_mode))
    if min_m is not None:
        assert int((state.restir_back.m > min_m).sum()) > 10
    grids = [dataclasses.replace(g, **{k: getattr(g, k).detach().clone().requires_grad_(True)
                                       for k in restir_kernel.RING_FLOATS})
             for g in (state.restir_back, state.restir_hist1, state.restir_hist2)]
    floats = [getattr(g, k) for g in grids for k in restir_kernel.RING_FLOATS]
    ro, rd = generate_rays(cam, h, w, 6)
    pix = rng.pixel_ids(h, w)
    r = np.random.default_rng(9)
    ct = torch.from_numpy(r.uniform(0.5, 1.5, (h, w, 3)).astype(np.float32))
    cts = [torch.from_numpy(r.uniform(0.5, 1.5, (h, w)).astype(np.float32)) for _ in range(4)]

    def grads(trace):
        rad, new = trace(scene, cfg, ro, rd, pix, 6, 0, *grids)
        loss = (rad * ct).sum() + sum((getattr(new, k) * c).sum()
                                      for k, c in zip(restir_kernel.RING_FLOATS, cts))
        return torch.autograd.grad(loss, floats, allow_unused=True)

    got, want = grads(restir_kernel._fused), grads(restir.trace_sample)
    for i, (a, b) in enumerate(zip(got, want)):
        b = torch.zeros_like(a) if b is None else b
        name = f"{('back', 'hist1', 'hist2')[i // 4]}.{restir_kernel.RING_FLOATS[i % 4]}"
        assert bool(torch.isfinite(a).all()), name
        scale = max(b.abs().max().item(), 1e-12)
        assert (a - b).abs().max().item() / scale < 1e-4, (name, (a - b).abs().max().item())
        if restir_kernel.RING_FLOATS[i % 4] != "weight_sum":
            assert int((b != 0).sum()) > 10, name   # the taps and history levels are engaged


def _gbuffer_case(where):
    if where == "every_shape":
        scene, cam, cfg = presets.restir_sdf_view(where, device="cpu")
        return scene, cam, cfg.replace(marching_steps=16)
    scene, cam, cfg = getattr(presets, where)(device="cpu")
    if where == "restir_demo":
        return scene, cam, cfg.replace(max_bounces=4, marching_steps=16)
    return scene_mod.animate_positions(scene, 0.9, 1), cam, cfg.replace(marching_steps=16)


def _gbuffer_held(out, gbuf, ref, ref_gbuf, sdf_normals=False):
    """K4's radiance and G-buffer against the plain version's: the mesh
    index, depth and valid flag of every slot equal; the radiance under the
    parity contract and the positions, normals and throughputs within 1e-5,
    since the host's sinf/cosf and torch's CPU sin/cos may differ by an ULP
    in a bounce direction (on the card the two agree bit for bit).  With
    `sdf_normals` (SDF shapes whose distance takes a square root that
    torch's CPU `sqrt` may round an ULP off, tests/test_torch_sdf.py) the
    normals are held under the forward parity contract instead (within
    1e-5 at 99 % of the values, within 1e-4 at all): the tetrahedral normal
    divides that ULP by its 1e-3 tap."""
    err = (out - ref).abs().amax(-1)
    assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4
    assert len(gbuf) == len(ref_gbuf)
    for k, (got, want) in enumerate(zip(gbuf, ref_gbuf)):
        assert got.keys() == want.keys()
        for f in got:
            a, b = got[f], want[f]
            assert a.dtype == b.dtype and a.shape == b.shape, (k, f)
            d = (a - b).abs() if a.dtype != torch.bool else None
            if f in ("idx", "depth", "valid"):
                assert torch.equal(a, b), (k, f, int((a != b).sum()))
            elif f == "nl" and sdf_normals:
                assert d.max().item() < 1e-4 and (d < 1e-5).float().mean().item() >= 0.99, \
                    (k, f, d.max().item())
            else:
                assert d.max().item() < 1e-5, (k, f, d.max().item())


@pytest.mark.parametrize("where", ["restir_demo", "animated_untextured", "animated_restir",
                                   "every_shape"])
def test_host_gbuffer_matches_plain(kernels_on_cpu, where):
    """K4 (one launch) against its plain version, `integrator.trace` with
    `gbuffer_slots`: the radiance without diffuse NEE and each slot's
    fields as `_gbuffer_held` states; untouched slots read depth -1 and
    mesh 0; a slot ordinal off by one fails this.  `animated_restir` as
    shipped (a METAL texture on its ROUND_BOX) and the `every_shape`
    ReSTIR view (every shape the presets lack, a CHECK quad) run K4's
    whole-SDF copy."""
    scene, cam, cfg = _gbuffer_case(where)
    assert restir_split.unsupported_gbuffer(scene, cfg) is None
    assert restir_split.gbuffer_copy(scene) == (3 if where in ("animated_restir",
                                                               "every_shape") else 1)
    h, w = 16, 32
    ro, rd = generate_rays(cam, h, w, 3)
    pix = rng.pixel_ids(h, w)
    before = restir_split.GBUF_LAUNCHES
    out, gbuf = restir_split._launch_gbuffer(scene, cfg, megakernel.scene_table(scene), ro, rd,
                                             pix, 3, 0)
    assert restir_split.GBUF_LAUNCHES == before + 1
    ref, ref_gbuf = restir_split.gbuffer_plain(scene, cfg, ro, rd, pix, 3, 0)
    assert len(gbuf) == restir_split.gbuffer_slots(cfg) == len(ref_gbuf)
    _gbuffer_held(out, gbuf, ref, ref_gbuf, sdf_normals=where == "every_shape")
    for slot in gbuf:
        unset = ~slot["valid"]
        assert bool((slot["depth"][unset] == -1).all() and (slot["idx"][unset] == 0).all())
    assert bool(gbuf[0]["valid"].any()) and bool(gbuf[1]["valid"].any())
    assert bool((gbuf[1]["depth"][gbuf[1]["valid"]] > 0).all())


@pytest.mark.parametrize("where", ["restir_demo", "animated_untextured"])
@pytest.mark.parametrize("grid", [1, 2])
def test_host_gbuffer_regenerates(kernels_on_cpu, monkeypatch, where, grid):
    """K4's persistent launch on a grid of 1 or 2 blocks at 8x128 (every
    lane traces 4-8 pixels, drawn from the ticket counter), twice, since
    the last block resets the counter for the next launch: bit for bit
    against the same build on a grid of 8 blocks, where each lane draws
    one pixel, which holds the plain `integrator.trace` with
    `gbuffer_slots`: the integer fields exactly, the radiance and the
    float fields under the forward parity contract (max error below 1e-4,
    at least 99 % of pixels within 1e-5, tests/test_megakernel.py:79-94).
    The host's sinf/cosf and torch's CPU sin/cos may differ by an ULP in a
    bounce direction, which moves a third vertex on `restir_demo` by
    1.4e-5 at this size in either schedule, past `_gbuffer_held`'s 1e-5
    (on the card the two agree bit for bit).  The 1e-5 hold of the
    regenerating launch against the plain version is
    `test_host_gbuffer_matches_plain`'s: 16x32 on `on_cpu`'s 2-block grid,
    two pixels a lane."""
    scene, cam, cfg = _gbuffer_case(where)
    h, w = 8, 128
    ro, rd = generate_rays(cam, h, w, 5)
    pix = rng.pixel_ids(h, w)
    table = megakernel.scene_table(scene)
    counter = restir_split.ticket_counter(torch.device("cpu"), 0)
    runs = []
    for blocks in (h * w // 128, grid, grid):
        monkeypatch.setattr(restir_split, "resident_blocks", lambda dev, sdf, smem: blocks)
        runs.append(restir_split._launch_gbuffer(scene, cfg, table, ro, rd, pix, 5, 0))
        assert counter.tolist() == [0, 0]
    for out, gbuf in runs[1:]:
        assert torch.equal(out, runs[0][0])
        assert all(torch.equal(a[f], b[f]) for a, b in zip(gbuf, runs[0][1]) for f in a)
    out, gbuf = runs[0]
    ref, ref_gbuf = restir_split.gbuffer_plain(scene, cfg, ro, rd, pix, 5, 0)
    pairs = [(out, ref)] + [(got[f], want[f]) for got, want in zip(gbuf, ref_gbuf)
                            for f in got if f not in ("idx", "depth", "valid")]
    for a, b in pairs:
        err = (a - b).abs().amax(-1)
        assert err.max().item() < 1e-4 and (err < 1e-5).float().mean().item() >= 0.99
    for got, want in zip(gbuf, ref_gbuf):
        for f in ("idx", "depth", "valid"):
            assert torch.equal(got[f], want[f]), f
    assert bool(gbuf[1]["valid"].any()) and not bool(gbuf[1]["valid"].all())


def _tie_scene():
    """Meshes of different types that tie out of table order, and
    placeholders (joker.x = 0) that would win if scanned: upward rays at
    x in [-0.5, 0.5] meet the box's bottom (row 1) and the plane y = 0.25
    (row 3) both at t = 1.25, rays at x = 0.8 the plane and the sphere's
    bottom (row 4) at 1.25; the plane through the origin (row 0) and the
    zero-radius sphere (row 5) are placeholders; a ROUND_BOX SDF row
    follows."""
    sb = SceneBuilder()
    sb.add("MAT_CORNELL_WHITE", MeshType.PLANE, (0.0, 1.0, 0.0), (0.0,))
    sb.add("MAT_CORNELL_RED", MeshType.BOX, (0.0, 0.75, 0.0), (1.0,))
    sb.add("MAT_CORNELL_WHITE", MeshType.SPHERE, (-0.7, 0.6, -0.9), (0.3,))
    sb.add("MAT_CORNELL_GREEN", MeshType.PLANE, (0.0, 1.0, 0.0), (-0.25,))
    sb.add("MAT_CORNELL_WHITE", MeshType.SPHERE, (0.8, 0.75, 0.0), (0.5,))
    sb.add("MAT_CORNELL_WHITE", MeshType.SPHERE, (0.3, -0.5, 0.2), (0.0,))
    sb.add("MAT_CORNELL_WHITE", MeshType.SDF, (-0.8, -0.4, 0.0), (0.2, 0.2, 0.2, 0.05),
           sdf_shape=materials.SdfShape.ROUND_BOX)
    return sb.build(device="cpu")


def test_host_packed_scan_ties(host_kernels, kernels_on_cpu, monkeypatch):
    """The packed scan of K1 and K4 (one float4 record per mesh, grouped
    by type) against the plain `intersect.intersect`: t and the mesh index
    bit for bit on `_tie_scene`'s ties (the lower row wins, as the first
    index of the smallest t does in table order) and placeholders, and on
    rays in every direction."""
    monkeypatch.setattr(restir_split, "build_cast", lambda: (host_kernels["packed cast"], None))
    scene = _tie_scene()
    cfg = OFFLINE_CONFIG.replace(marching_steps=32)
    xs = np.append(np.linspace(-1.0, 1.0, 41), 0.8).astype(np.float32)  # 0.8: the sphere's axis
    up_o = np.stack(np.broadcast_arrays(xs[:, None], np.float32(-1.0),
                                        np.array([0.0, 0.1, -0.3], np.float32)), -1)
    up_d = np.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32), up_o.shape)
    r = np.random.default_rng(3)
    any_d = r.normal(size=(4, 64, 3)).astype(np.float32)
    any_d /= np.linalg.norm(any_d, axis=-1, keepdims=True)
    any_o = np.broadcast_to(r.uniform(-0.9, 0.9, (4, 1, 3)).astype(np.float32), any_d.shape)
    refs = []
    for o, d in ((up_o, up_d), (any_o, any_d)):
        o, d = torch.from_numpy(o.copy()), torch.from_numpy(d.copy())
        t, idx, missed = restir_split._launch_cast(scene, cfg, megakernel.scene_table(scene),
                                                   o, d)
        t_ref, idx_ref, missed_ref = restir.default_cast(scene, cfg)(o, d)
        assert torch.equal(idx.long(), idx_ref) and torch.equal(t, t_ref)
        assert torch.equal(missed, missed_ref)
        assert not bool(((idx == 0) | (idx == 5))[~missed].any())  # placeholders never win
        refs.append((t_ref, idx_ref))
    t_up, idx_up = refs[0]
    # the box wins its tie with the plane, the plane its tie with the sphere
    assert set(idx_up[t_up == 1.25].tolist()) == {1, 3}
    assert int((idx_up == 1).sum()) > 10 and bool((idx_up[-1] == 3).all())
    assert bool((idx_up == 6).any())  # the SDF row is hit too


@pytest.mark.parametrize("where", ["restir_demo", "mis_demo", "animated_untextured"])
def test_host_cast_matches_plain(kernels_on_cpu, where):
    """K5 (one launch) against the plain `intersect.intersect`
    (need_normal=False): t and the mesh index bit for bit on rays from the
    primary hits toward every light, on the primary rays themselves and on
    rays that miss, some of them hitting a wall beyond cfg.infinity
    (t = cfg.infinity, index 0)."""
    scene, cam, cfg = getattr(presets, where)(device="cpu")
    if where == "animated_untextured":
        scene = scene_mod.animate_positions(scene, 1.3, 1)
    cfg = cfg.replace(marching_steps=32)
    h, w = 16, 32
    ro, rd = generate_rays(cam, h, w, 1)
    hit = restir.default_cast(scene, cfg)(ro, rd)
    x = ro + rd * hit[0][..., None]
    lights = scene.pos[torch.clamp_min(scene.light_idx.long(), 0)]
    to = (lights[None, None] - x[:, :, None]).reshape(h, w * len(lights), 3)
    d = to / torch.linalg.vector_norm(to, dim=-1, keepdim=True)
    o = x.repeat_interleave(len(lights), dim=1) + d * cfg.epsilon
    # rays from outside the room away from it, and rays that reach a wall
    # only beyond cfg.infinity: every one misses
    away = torch.tensor([0.0, 0.0, 1.0]).expand(h, w, 3).contiguous()
    far = (ro + away * 2e4, (-away).contiguous())
    for o_, d_ in ((ro, rd), (o.contiguous(), d.contiguous()), far, (ro + away * 50.0, away)):
        before = restir_split.CAST_LAUNCHES
        t, idx, missed = restir_split._launch_cast(scene, cfg, megakernel.scene_table(scene),
                                                   o_, d_)
        assert restir_split.CAST_LAUNCHES == before + 1
        t_ref, idx_ref, missed_ref = restir.default_cast(scene, cfg)(o_, d_)
        assert idx.dtype == torch.int32 and torch.equal(idx.long(), idx_ref)
        assert torch.equal(t, t_ref) and torch.equal(missed, missed_ref)
    assert bool(missed.all()) and bool((t == cfg.infinity).all()) and bool((idx == 0).all())


def test_host_restir_adjoint_animated(kernels_on_cpu):
    """K7 under ANIMATED accumulation, through `_RestirCore`, against the
    plain `restir.trace_sample`'s autograd over passes 0-3 of the real-time
    scene animated to a constant frame time (its gradient reaches `pos`
    through `animate_positions`), within 1e-4 relative per leaf."""
    scene, cam, cfg = presets.animated_untextured(device="cpu")
    cfg = cfg.replace(max_bounces=2, restir_samples=4, marching_steps=16)
    assert restir_kernel.unsupported_restir_bwd(scene, cfg) is None
    animate = lambda s: scene_mod.animate_positions(s, 0.9, int(cfg.render_mode))
    kernel = lambda s, *a: restir_kernel._fused(animate(s), *a)
    plain = lambda s, *a: restir.trace_sample(animate(s), *a)
    before = (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES)
    loss, got = restir_chain_grads(kernel, scene, cfg, cam, 8, 16, 4)
    assert (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES) == (before[0] + 4,
                                                                   before[1] + 4)
    ref_loss, want = restir_chain_grads(plain, scene, cfg, cam, 8, 16, 4)
    assert abs(loss - ref_loss).item() <= 1e-5 * abs(ref_loss).item()
    assert_grads_close(got, want)
    assert got["emission"].abs().max().item() > 0.0 and got["pos"].abs().max().item() > 0.0


def test_host_restir_adjoint_ring_fields_animated(kernels_on_cpu):
    """`test_host_restir_adjoint_ring_fields` under ANIMATED accumulation on
    the real-time scene at a constant frame time: K7's cotangents of the
    ring's m, w and age (the history's faded by 0.95 x 0.85 and
    0.95 x 0.8 x 0.85) against plain autograd."""
    scene, cam, cfg = presets.animated_untextured(device="cpu", max_bounces=3,
                                                  restir_samples=4, marching_steps=16)
    _ring_field_grads(scene, cam, cfg, min_m=None, time_s=0.9)


def test_host_animated_forward_matches_plain(kernels_on_cpu):
    """K1 serves ANIMATED accumulation unchanged: the real-time scene
    animated to a frame time on the host, ReSTIR off (per-light NEE over 9
    lights, the glass and mirror spheres, the rounded box), one launch,
    against the plain version under the parity contract."""
    scene, cam, cfg = presets.animated_untextured(device="cpu", use_restir=False,
                                                  marching_steps=32)
    assert megakernel.unsupported(scene, cfg) is None
    scene = scene_mod.animate_positions(scene, 0.9, int(cfg.render_mode))
    h, w = 16, 64
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w)
    before = megakernel.LAUNCHES
    out = megakernel._launch_forward(scene, cfg, megakernel.scene_table(scene), ro, rd, pix, 2, 0)
    assert megakernel.LAUNCHES == before + 1
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    err = (out - ref).abs().amax(-1)
    assert bool(torch.isfinite(out).all()) and ref.max().item() > 0.02
    assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4, \
        err.max().item()


#: {case: (scene, config changes)} of K1's medium copy: the reference's
#: preset 8 as shipped (spectral transport and the medium), spectral alone
#: and the medium alone; the medium and spectral transport beside an SDF
#: box under MIS, a photographic cubemap, the procedural sky, a textured
#: SDF box under the cubemap (the whole SDF class), an SDF light and a
#: directional sun.  The card's tests and `chip_smoke.py` hold the same.
MEDIUM_CASES = {
    "spectral_caustics": ("spectral_caustics", {}),
    "spectral_only": ("spectral_caustics", dict(use_volumetrics=False)),
    "media_only": ("spectral_caustics", dict(use_spectral=False)),
    "mis_demo": ("mis_demo", dict(use_mis=True, use_spectral=True, use_volumetrics=True)),
    "cubemap_demo": ("cubemap_demo", dict(use_spectral=True, use_volumetrics=True)),
    "procedural_sky": ("cubemap_demo", dict(use_cubemap=False, use_procedural_sky=True,
                                            use_volumetrics=True)),
    "default_scene": ("default_scene", dict(use_volumetrics=True)),
    "sdf_light": ("sdf_light", dict(use_mis=True, use_volumetrics=True)),
    "sun": ("sun", dict(use_volumetrics=True)),
}


def medium_case(name, device="cpu"):
    """(scene, camera, cfg) of K1's medium case `name` (MEDIUM_CASES)."""
    where, kw = MEDIUM_CASES[name]
    if where == "sun":   # tests/test_megakernel.py:685-698's sun scene
        sb = SceneBuilder()
        sb.add("MAT_CORNELL_WHITE", MeshType.BOX, (0.0, -2.2, -1.0), (2.0,))
        sb.add("MAT_CORNELL_RED", MeshType.BOX, (-0.8, -0.8, -1.4), (0.8,))
        sb.add("MAT_MIRROR", MeshType.SPHERE, (0.6, -0.7, -1.0), (0.5,))
        sb.add("MAT_DIRECT_SUNLIGHT", MeshType.SPHERE, (0.5, 0.8, 0.3), (0.01,))
        sb.lights([3])
        cam = Camera.make(origin=(0.0, 0.3, 2.0), lookat=(0.0, -0.6, -1.0), device=device)
        scene, cfg = sb.build(device=device), OFFLINE_CONFIG
    elif where in presets.SDF_SCENE_VIEWS:
        scene, cam, cfg = presets.sdf_view(where, device=device)
    else:
        scene, cam, cfg = getattr(presets, where)(device=device)
    return scene, cam, cfg.replace(**kw)


@pytest.mark.parametrize("name", list(MEDIUM_CASES))
def test_host_medium_forward_matches_plain(kernels_on_cpu, name):
    """K1's medium copy (the hero wavelength, Cauchy dispersion, the medium
    event with its in-scatter NEE and HG direction, fog on sphere-light
    shadow rays), one launch, times the hero wavelength's RGB weight
    (`megakernel.spectral_rgb`, which `trace_forward` applies on the card),
    against the plain version under the parity contract at 16x32 with 4
    bounces and 32 marching steps: host libm's logf, expf, sinf and cosf
    round like torch's CPU functions to within an ULP."""
    scene, cam, cfg = medium_case(name)
    cfg = cfg.replace(max_bounces=min(cfg.max_bounces, 4), marching_steps=32)
    assert megakernel.unsupported(scene, cfg) is None
    assert megakernel.unsupported_bwd(scene, cfg) is None   # K2's medium copy
    assert megakernel.bwd_copy(scene, cfg) == "medium"
    h, w = 16, 32
    ro, rd = generate_rays(cam, h, w, 2)
    pix = rng.pixel_ids(h, w)
    before = megakernel.LAUNCHES
    out = megakernel._launch_forward(scene, cfg, megakernel.scene_table(scene), ro, rd, pix, 2, 0)
    assert megakernel.LAUNCHES == before + 1
    if cfg.use_spectral:
        out = out * megakernel.spectral_rgb(pix, 2, 0)
    ref = integrator.trace(scene, cfg, ro, rd, pix, 2, 0)
    err = (out - ref).abs().amax(-1)
    print(f"{name}: {int((err > 0).sum())} of {h * w} pixels differ, max {err.max().item():.3e}")
    assert bool(torch.isfinite(out).all()) and ref.max().item() > 0.02
    assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4, \
        err.max().item()


def test_host_animated_adjoint_matches_plain(kernels_on_cpu):
    """K2 serves ANIMATED accumulation unchanged: Cornell animated to a
    frame time on the host (its boxes, rows 6-7, orbit), one K1 and one K2
    launch through `_TraceCore`, against the plain version and its
    autograd, the gradient reaching `pos` through `animate_positions`
    (within 1e-4 relative per leaf)."""
    scene, cam, cfg = cornell_default(device="cpu", use_mis=True, max_bounces=3,
                                      render_mode=RenderMode.ANIMATED)
    assert megakernel.unsupported_bwd(scene, cfg) is None
    animate = lambda s: scene_mod.animate_positions(s, 0.9, int(cfg.render_mode))
    ro, rd = generate_rays(cam, 16, 64, 2)
    pix = rng.pixel_ids(16, 64)
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    out, got = _grads(lambda s, c, o, d, p: megakernel._TraceCore.apply(
        megakernel.scene_table(animate(s)), o, d, animate(s), c, p, 2, 0), scene, cfg, ro, rd, pix)
    assert (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref, want = _grads(lambda s, c, o, d, p: integrator.trace(animate(s), c, o, d, p, 2, 0),
                       scene, cfg, ro, rd, pix)
    err = (out - ref).abs().amax(-1)
    assert (err < 1e-5).float().mean().item() >= 0.99 and err.median().item() < 1e-4
    assert_grads_close(got, want)
    assert got["pos"][6:8].abs().max().item() > 0.0
