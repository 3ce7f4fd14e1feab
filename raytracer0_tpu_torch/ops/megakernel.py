"""Forward megakernel K1 on Hopper: the wrapper of `csrc/megakernel.cu`.

Replaces the Pallas TPU kernel
`raytracer0_tpu/ops/megakernel.py::_fwd_kernel_body` (launched by
`_forward` / `trace_forward`), for the Cornell class that
`integrator.unsupported` states.  Its plain PyTorch version is
`render/integrator.py::trace`; on the same inputs the two trace the same
paths, pixel for pixel.

What bounds it on the H100: a pixel reads 28 bytes and writes 12, so it is
not memory-bound.  It is latency- and divergence-bound: a long,
data-dependent bounce loop per pixel, a scan over every mesh per ray and
one shadow ray per light per bounce, and paths that end at different
depths.  The design keeps one thread per pixel with the whole bounce loop
in registers, lets each thread leave the loop when its path ends (exact,
because the counter RNG keys on depth), and keeps the scene table, the
type codes and the light slots in shared memory, read by all threads of a
warp at once.  Mesh and material types are dispatched at run time by a
`switch` over the codes, so one binary serves every scene of the class.

The kernel is built with nvcc on first use (`cuda_build`) and launched
through ctypes on PyTorch's current stream.  On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from raytracer0_tpu.config import RenderConfig
from raytracer0_tpu_torch.ops import cuda_build
from raytracer0_tpu_torch.render import integrator

#: Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

SOURCES = ("megakernel.cu",)
_NCOLS = 36
# dynamic shared memory one block may take without an opt-in attribute
_SMEM_LIMIT = 48 * 1024

_c_void_p, _c_int, _c_uint = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_ARGTYPES = (
    _c_void_p, _c_void_p, _c_void_p, _c_int,      # table, mesh, mat, n_mesh
    _c_void_p, _c_int,                            # lights, n_lights
    _c_void_p, _c_void_p, _c_void_p, _c_void_p,   # ro, rd, pix, out
    ctypes.c_longlong, _c_uint, _c_uint,          # n_pix, pass, sample
    _c_int, _c_int, _c_int, _c_int,               # bounce budgets
    ctypes.c_float, ctypes.c_float,               # epsilon, infinity
    _c_int, _c_int, _c_int,                       # sample_lights, use_mis, sky
    _c_void_p,                                    # stream
)


def scene_table(scene):
    """The scene's parameters packed f32[n_mesh, 36], in the columns of the
    JAX `_scene_table`: pos 0:3, joker 3:7, color 7:10, emission 10:13,
    ior 13, aux 14:26, tex_params 26:30, tex_cmask 30:33, tex_emask 33:36."""
    return torch.cat([scene.pos, scene.joker, scene.color, scene.emission,
                      scene.ior[:, None], scene.aux, scene.tex_params,
                      scene.tex_cmask, scene.tex_emask], dim=1).contiguous()


def smem_bytes(scene) -> int:
    """Dynamic shared memory of one block: the table, two code arrays and
    the light slots."""
    return 4 * (scene.num_meshes * _NCOLS + 2 * scene.num_meshes
                + scene.num_lights)


def unsupported(scene, cfg: RenderConfig) -> Optional[str]:
    """Why K1 cannot render (scene, cfg), or None when it can: the Cornell
    class of `integrator.unsupported`, with a table that fits the shared
    memory."""
    reason = integrator.unsupported(scene, cfg)
    if reason is None and smem_bytes(scene) > _SMEM_LIMIT:
        reason = (f"the scene table needs {smem_bytes(scene)} bytes of shared "
                  f"memory, more than {_SMEM_LIMIT}")
    return reason


def supported(scene, cfg: RenderConfig) -> bool:
    """Can K1 render this (scene, cfg)?"""
    return unsupported(scene, cfg) is None


def build():
    """Build (or load from `build/kernels/`) the kernel library.
    Returns (ctypes function, cuda_build.BuildInfo)."""
    lib, info = cuda_build.load("megakernel", SOURCES)
    fn = lib.rt0_trace_forward
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn, info


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def trace_forward(scene, cfg: RenderConfig, ro, rd, pix, pass_idx, sample_idx):
    """Radiance f32[H, W, 3] of one sample per pixel.

    `ro`, `rd`: f32[H, W, 3] primary rays; `pix`: int64[H, W] pixel ids
    (uint32 values); `pass_idx`, `sample_idx`: ints.  CPU tensors take the
    plain version (`integrator.trace`); CUDA tensors launch K1.
    """
    global LAUNCHES
    if ro.device.type == "cpu":
        return integrator.trace(scene, cfg, ro, rd, pix, pass_idx, sample_idx)
    if ro.device.type != "cuda":
        raise ValueError(f"trace_forward: unsupported device {ro.device}")
    reason = unsupported(scene, cfg)
    if reason is not None:
        raise NotImplementedError(f"K1 does not cover this scene: {reason}")
    dev = ro.device
    h, w = pix.shape
    _check("ro", ro, torch.float32, (h, w, 3), dev)
    _check("rd", rd, torch.float32, (h, w, 3), dev)
    _check("pix", pix, torch.int64, (h, w), dev)
    if scene.device != dev:
        raise ValueError(f"scene is on {scene.device}, rays on {dev}")

    table = scene_table(scene)
    mesh = scene.mesh_type.to(torch.int32).contiguous()
    mat = scene.mat_type.to(torch.int32).contiguous()
    lights = scene.light_idx.to(torch.int32).contiguous()
    out = torch.empty_like(ro)
    fn, _ = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(table.data_ptr(), mesh.data_ptr(), mat.data_ptr(),
                scene.num_meshes, lights.data_ptr(), scene.num_lights,
                ro.data_ptr(), rd.data_ptr(), pix.data_ptr(), out.data_ptr(),
                h * w, int(pass_idx) & 0xFFFFFFFF, int(sample_idx) & 0xFFFFFFFF,
                cfg.max_bounces, cfg.max_diff_bounces, cfg.max_spec_bounces,
                cfg.max_scattering_events, cfg.epsilon, cfg.infinity,
                int(cfg.sample_lights), int(cfg.use_mis),
                int(cfg.use_procedural_sky), stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
