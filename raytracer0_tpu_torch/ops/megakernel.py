"""The megakernel pair on Hopper: K1 (forward, `csrc/megakernel.cu`) and its
adjoint K2 (`csrc/megakernel_bwd.cu`), joined in a `torch.autograd.Function`.

K1 replaces the Pallas TPU kernel
`raytracer0_tpu/ops/megakernel.py::_fwd_kernel_body` (launched by
`_forward`); K2 replaces `_bwd_slotted_kernel_body` (launched by
`_backward`) and computes the same outputs as its whole-trace twin
`_bwd_kernel_body`.  `_TraceCore` pairs them as the JAX `_trace_core`
custom_vjp does: forward launches K1, backward launches K2.  Both cover
the Cornell class that `integrator.unsupported` states.  Their plain
PyTorch version is `render/integrator.py::trace` (K1) and its
`torch.autograd` backward (K2); on the same inputs K1 traces the same
paths, pixel for pixel, and K2 gives the same gradients up to float32
rounding.

What bounds them on the H100: a pixel reads 28 bytes and writes 12 (K2: 40
and 24), so neither is memory-bound.  They are latency- and
divergence-bound: a long, data-dependent bounce loop per pixel, a scan over
every mesh per ray and one shadow ray per light per bounce, and paths that
end at different depths.  The design keeps one thread per pixel with the
whole bounce loop in registers, lets each thread leave the loop when its
path ends (exact, because the counter RNG keys on depth), and keeps the
scene table, the type codes and the light slots in shared memory, read by
all threads of a warp at once.  K2 stashes the carry entering each slot in
local memory and replays the slots newest first through a hand-derived
adjoint; it sums the scene-table cotangents per thread in shared memory,
per block in thread order and across blocks in a second, fixed-order
kernel, so its result is deterministic.

The kernels are built with nvcc on first use (`cuda_build`) and launched
through ctypes on PyTorch's current stream.  On CPU tensors
`trace_forward` is the plain version and plain autograd gives the
gradient; on CUDA tensors it launches the kernels or raises, forward and
backward alike.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from raytracer0_tpu_torch.config import RenderConfig
from raytracer0_tpu_torch.ops import cuda_build
from raytracer0_tpu_torch.render import integrator

#: K1 launches since import (or since a caller reset it to 0).
LAUNCHES = 0
#: K2 launches since import (or since a caller reset it to 0); one per
#: backward of `trace_forward`, adjoint and partial-sum reduction together.
BWD_LAUNCHES = 0

SOURCES = ("megakernel.cu",)
BWD_SOURCES = ("megakernel_bwd.cu",)
_NCOLS = 36
# dynamic shared memory one block may take without an opt-in attribute
_SMEM_LIMIT = 48 * 1024
# K2: stash depth (MAX_SLOTS in megakernel_bwd.cu), cotangent columns kept
# per thread (NG), the opt-in shared memory of one block, and block sizes
# tried in order until the per-thread accumulators fit
MAX_SLOTS = 16
_BWD_NG = 10
_BWD_SMEM_LIMIT = 227 * 1024
_BWD_THREADS = (128, 64, 32)

_c_void_p, _c_int, _c_uint = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_c_ll, _c_float = ctypes.c_longlong, ctypes.c_float
_ARGTYPES = (
    _c_void_p, _c_void_p, _c_void_p, _c_int,      # table, mesh, mat, n_mesh
    _c_void_p, _c_int,                            # lights, n_lights
    _c_void_p, _c_void_p, _c_void_p, _c_void_p,   # ro, rd, pix, out
    _c_ll, _c_uint, _c_uint,                      # n_pix, pass, sample
    _c_int, _c_int, _c_int, _c_int,               # bounce budgets
    _c_float, _c_float,                           # epsilon, infinity
    _c_int, _c_int, _c_int,                       # sample_lights, use_mis, sky
    _c_void_p,                                    # stream
)
_BWD_ARGTYPES = (
    _c_void_p, _c_void_p, _c_void_p, _c_int,      # table, mesh, mat, n_mesh
    _c_void_p, _c_int,                            # lights, n_lights
    _c_void_p, _c_void_p, _c_void_p, _c_void_p,   # ro, rd, pix, ct
    _c_void_p, _c_void_p, _c_void_p, _c_void_p,   # d_ro, d_rd, partials, d_table
    _c_ll, _c_uint, _c_uint,                      # n_pix, pass, sample
    _c_int, _c_int, _c_int, _c_int,               # bounce budgets
    _c_float, _c_float,                           # epsilon, infinity
    _c_int, _c_int, _c_int,                       # sample_lights, use_mis, sky
    _c_int, _c_void_p,                            # threads per block, stream
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


def bwd_slots(cfg: RenderConfig) -> int:
    """The most bounce slots a path runs, hence K2's stash depth: every slot
    that does not end the path is a diffuse bounce, and the path stops once
    `max_diff_bounces` of them ran (or at `max_bounces`)."""
    return min(cfg.max_bounces, max(cfg.max_diff_bounces, 1) + 1)


def bwd_smem_bytes(scene, threads: int) -> int:
    """Dynamic shared memory of one K2 block: K1's, plus `threads` columns
    of 10 cotangent accumulators per mesh."""
    return smem_bytes(scene) + 4 * scene.num_meshes * _BWD_NG * threads


def bwd_threads(scene) -> Optional[int]:
    """K2's block size: the largest of 128, 64, 32 whose accumulators fit
    the shared memory of one block; None when none does."""
    for t in _BWD_THREADS:
        if bwd_smem_bytes(scene, t) <= _BWD_SMEM_LIMIT:
            return t
    return None


def unsupported_bwd(scene, cfg: RenderConfig) -> Optional[str]:
    """Why K2 cannot differentiate (scene, cfg), or None when it can: K1's
    class, a stash of at most MAX_SLOTS slots, and accumulators that fit
    the shared memory of a block of 32 threads."""
    reason = unsupported(scene, cfg)
    if reason is None and bwd_slots(cfg) > MAX_SLOTS:
        reason = (f"paths of {bwd_slots(cfg)} slots, more than K2's stash of "
                  f"{MAX_SLOTS}")
    if reason is None and bwd_threads(scene) is None:
        reason = (f"{scene.num_meshes} meshes: K2's cotangent accumulators do "
                  f"not fit {_BWD_SMEM_LIMIT} bytes of shared memory")
    return reason


def build():
    """Build (or load from `build/kernels/`) the K1 library.
    Returns (ctypes function, cuda_build.BuildInfo)."""
    lib, info = cuda_build.load("megakernel", SOURCES)
    fn = lib.rt0_trace_forward
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn, info


def build_bwd():
    """Build (or load from `build/kernels/`) the K2 library.
    Returns (ctypes function, cuda_build.BuildInfo)."""
    lib, info = cuda_build.load("megakernel_bwd", BWD_SOURCES)
    fn = lib.rt0_trace_backward
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn, info


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _codes(scene):
    """The mesh and material codes and the light slots, int32."""
    return (scene.mesh_type.to(torch.int32).contiguous(),
            scene.mat_type.to(torch.int32).contiguous(),
            scene.light_idx.to(torch.int32).contiguous())


def _cfg_args(cfg: RenderConfig, pass_idx, sample_idx):
    return (int(pass_idx) & 0xFFFFFFFF, int(sample_idx) & 0xFFFFFFFF,
            cfg.max_bounces, cfg.max_diff_bounces, cfg.max_spec_bounces,
            cfg.max_scattering_events, cfg.epsilon, cfg.infinity,
            int(cfg.sample_lights), int(cfg.use_mis), int(cfg.use_procedural_sky))


def _launch_forward(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx):
    """Launch K1: radiance f32[H, W, 3]."""
    global LAUNCHES
    h, w = pix.shape
    mesh, mat, lights = _codes(scene)
    out = torch.empty_like(ro)
    fn, _ = build()
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        rc = fn(table.data_ptr(), mesh.data_ptr(), mat.data_ptr(),
                scene.num_meshes, lights.data_ptr(), scene.num_lights,
                ro.data_ptr(), rd.data_ptr(), pix.data_ptr(), out.data_ptr(),
                h * w, *_cfg_args(cfg, pass_idx, sample_idx), stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def _launch_backward(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx, ct):
    """Launch K2 for the radiance cotangent `ct`: (d_table, d_ro, d_rd)."""
    global BWD_LAUNCHES
    reason = unsupported_bwd(scene, cfg)
    if reason is not None:
        raise NotImplementedError(f"K2 does not cover this scene: {reason}")
    h, w = pix.shape
    dev = ro.device
    _check("ct", ct, torch.float32, (h, w, 3), dev)
    threads = bwd_threads(scene)
    blocks = -(-(h * w) // threads)
    mesh, mat, lights = _codes(scene)
    d_ro, d_rd = torch.empty_like(ro), torch.empty_like(rd)
    partials = torch.empty((blocks, scene.num_meshes, _BWD_NG),
                           dtype=torch.float32, device=dev)
    d_table = torch.empty_like(table)
    fn, _ = build_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(table.data_ptr(), mesh.data_ptr(), mat.data_ptr(),
                scene.num_meshes, lights.data_ptr(), scene.num_lights,
                ro.data_ptr(), rd.data_ptr(), pix.data_ptr(), ct.data_ptr(),
                d_ro.data_ptr(), d_rd.data_ptr(), partials.data_ptr(),
                d_table.data_ptr(), h * w, *_cfg_args(cfg, pass_idx, sample_idx),
                threads, stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    return d_table, d_ro, d_rd


class _TraceCore(torch.autograd.Function):
    """K1 forward, K2 backward: the counterpart of the JAX `_trace_core`
    custom_vjp.  The gradient reaches the scene through `table`, whose
    `torch.cat` backward splits it into the leaves (pos, joker, color,
    emission, ior, aux and the texture columns), as JAX `_bwd` does with
    `replace`.  Only the inputs are saved: O(H*W) memory at any depth."""

    @staticmethod
    def forward(ctx, table, ro, rd, scene, cfg, pix, pass_idx, sample_idx):
        out = _launch_forward(scene, cfg, table, ro, rd, pix, pass_idx,
                              sample_idx)
        ctx.save_for_backward(table, ro, rd, pix)
        ctx.trace_args = (scene, cfg, pass_idx, sample_idx)
        return out

    @staticmethod
    def backward(ctx, ct):
        table, ro, rd, pix = ctx.saved_tensors
        scene, cfg, pass_idx, sample_idx = ctx.trace_args
        # the cotangent of .sum() is an expanded view with stride 0
        d_table, d_ro, d_rd = _launch_backward(
            scene, cfg, table, ro, rd, pix, pass_idx, sample_idx,
            ct.contiguous())
        need = ctx.needs_input_grad
        return (d_table if need[0] else None, d_ro if need[1] else None,
                d_rd if need[2] else None, None, None, None, None, None)


def trace_forward(scene, cfg: RenderConfig, ro, rd, pix, pass_idx, sample_idx):
    """Radiance f32[H, W, 3] of one sample per pixel.

    `ro`, `rd`: f32[H, W, 3] primary rays; `pix`: int64[H, W] pixel ids
    (uint32 values); `pass_idx`, `sample_idx`: ints.  CPU tensors take the
    plain version (`integrator.trace`).  CUDA tensors launch K1; when a
    gradient is needed (the scene's parameters, `ro` or `rd` require grad)
    the call is recorded as `_TraceCore` and its backward launches K2.
    """
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
    if torch.is_grad_enabled() and (table.requires_grad or ro.requires_grad
                                    or rd.requires_grad):
        reason = unsupported_bwd(scene, cfg)
        if reason is not None:
            raise NotImplementedError(f"K2 does not cover this scene: {reason}")
        return _TraceCore.apply(table, ro, rd, scene, cfg, pix, pass_idx,
                                sample_idx)
    return _launch_forward(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx)
