"""The fused ReSTIR forward kernel K6 on Hopper (`csrc/restir.cu`): its gate,
build, launcher and the render pass that uses it.

K6 replaces the Pallas TPU kernel
`raytracer0_tpu/ops/megakernel.py::_fused_restir_kernel_body` (launched by
`_fused_restir_fwd_impl`): one launch traces every pixel's path and runs the
reservoir pipeline (`restir.reservoir_direct`) at each diffuse vertex in
place of per-light NEE, returning the radiance and the pass's new back
reservoirs.  Its plain PyTorch version is `restir.render_sample`; on the
same inputs the two trace the same paths and make the same reservoir
decisions, and agree to float32 rounding.

What bounds it on the H100: like K1, instruction latency and divergence.
A pixel reads 28 bytes of rays and id, 60 bytes of reservoirs at its own
pixel and up to 160 bytes of spatial taps (mostly from L2, since
neighbouring threads read overlapping taps), and writes 56 bytes; its work
is K1's bounce loop plus, per diffuse vertex, up to 16 candidates, 10
combines and 2 shadow rays with SDF marches.  The design keeps one thread
per pixel with the reservoir in registers, reads the taps in place (no
pre-rolled copy of the grid), and keeps the light slots in shared memory.

Forward only: a render that needs a gradient raises before any launch
(the adjoint is K7, ROADMAP queue 1 item 11).  On a CUDA device nothing
here falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.config import RenderConfig
from raytracer0_tpu_torch.models import scene as scene_mod
from raytracer0_tpu_torch.models.camera import generate_rays
from raytracer0_tpu_torch.ops import cuda_build, megakernel, restir
from raytracer0_tpu_torch.render import integrator
from raytracer0_tpu_torch.render.state import RESERVOIR_FIELDS, Reservoirs

#: K6 launches since import (or since a caller reset it to 0).
LAUNCHES = 0

SOURCES = ("restir.cu",)
_IN_FIELDS = ("weight_sum", "m", "w", "age", "light_index")
# the spatial taps' (row, column) offsets, passed by value
_TAPS = (ctypes.c_int * 16)(*[v for tap in restir.TAP_OFFSETS for v in tap])
_ARGTYPES = megakernel._ARGTYPES[:-1] + (
    ctypes.c_void_p, ctypes.c_void_p,             # res_in[15], res_out[7]
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # taps (host), height, width
    ctypes.c_int, ctypes.c_int,                   # candidates, spatial taps
    ctypes.c_float, ctypes.c_float,               # epsilon * 2, epsilon * 10
    ctypes.c_void_p,                              # stream
)


def smem_bytes(scene) -> int:
    """Dynamic shared memory of one K6 block: K1's and the light-slot
    table (8 floats per slot)."""
    return megakernel.smem_bytes(scene) + 4 * 8 * scene.num_lights


def unsupported_restir(scene, cfg: RenderConfig) -> Optional[str]:
    """Why K6 cannot render (scene, cfg), or None when it can: a ReSTIR
    config in the class of `integrator.unsupported` (the JAX
    `supported_restir_fused`: ReSTIR engaged, LIGHT-sphere slots, no
    photographic cubemap, cosine sampling, the pixel's own history,
    static accumulation), with tables that fit the shared memory."""
    if not cfg.use_restir:
        return "not a ReSTIR config (use_restir is off): K1 renders it"
    return integrator.unsupported(scene, cfg) or megakernel.check_smem(smem_bytes(scene))


def build():
    """Build (or load from `build/kernels/`) the K6 library.
    Returns (ctypes function, cuda_build.BuildInfo)."""
    lib, info = cuda_build.load("restir", SOURCES)
    fn = lib.rt0_restir_forward
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn, info


def _restir_args(cfg: RenderConfig, num_lights: int):
    """(candidates, spatial taps, f32 epsilon*2, f32 epsilon*10), as
    `restir.reservoir_direct` derives them."""
    n_spatial = (restir.RESTIR_SPATIAL_SAMPLES if num_lights <= 10
                 else max(4, restir.RESTIR_SPATIAL_SAMPLES // 2))
    return (min(cfg.restir_samples, max(4, num_lights)), n_spatial,
            float(np.float32(cfg.epsilon * 2.0)), float(np.float32(cfg.epsilon * 10.0)))


def trace_forward_restir_fused(scene, cfg: RenderConfig, ro, rd, pix, pass_idx,
                               sample_idx, back: Reservoirs, hist1: Reservoirs,
                               hist2: Reservoirs):
    """Launch K6: (radiance f32[H, W, 3], new back Reservoirs).

    `ro`, `rd`: f32[H, W, 3] CUDA tensors; `pix`: int64[H, W] pixel ids of
    the [H, W] grid the reservoirs cover; `back`, `hist1`, `hist2`: the
    ring.  Raises for what K6 does not cover, or when the scene, the rays
    or the ring need a gradient."""
    if ro.device.type != "cuda":
        raise ValueError(f"K6 runs on a CUDA device, got {ro.device}")
    reason = unsupported_restir(scene, cfg)
    if reason is not None:
        raise NotImplementedError(f"K6 does not cover this scene: {reason}")
    return _launch(scene, cfg, ro, rd, pix, pass_idx, sample_idx, back, hist1, hist2)


def _launch(scene, cfg, ro, rd, pix, pass_idx, sample_idx, back, hist1, hist2):
    """Check the tensors and launch K6 (`trace_forward_restir_fused`
    without the device and class checks)."""
    global LAUNCHES
    dev = ro.device
    h, w = pix.shape
    megakernel._check("ro", ro, torch.float32, (h, w, 3), dev)
    megakernel._check("rd", rd, torch.float32, (h, w, 3), dev)
    megakernel._check("pix", pix, torch.int64, (h, w), dev)
    if scene.device != dev:
        raise ValueError(f"scene is on {scene.device}, rays on {dev}")
    table = megakernel.scene_table(scene)
    res_in = []
    for name, grid in (("back", back), ("hist1", hist1), ("hist2", hist2)):
        for k in _IN_FIELDS:
            t = getattr(grid, k)
            megakernel._check(f"{name}.{k}", t, RESERVOIR_FIELDS[k], (h, w), dev)
            res_in.append(t)
    if restir.requires_grad(scene, ro, rd, *res_in):
        raise NotImplementedError(
            "gradients through a ReSTIR pass come with its adjoint K7: "
            "ROADMAP queue 1 item 11")

    out = torch.empty_like(ro)
    new = Reservoirs(**{k: torch.empty((h, w, 3) if k in ("light_pos", "light_color")
                                       else (h, w), dtype=dt, device=dev)
                        for k, dt in RESERVOIR_FIELDS.items()})
    args, _keep = megakernel.forward_args(scene, cfg, table, ro, rd, pix, out,
                                          pass_idx, sample_idx)
    ins = (ctypes.c_void_p * 15)(*[t.data_ptr() for t in res_in])
    outs = (ctypes.c_void_p * 7)(*[getattr(new, k).data_ptr() for k in RESERVOIR_FIELDS])
    fn, _ = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, ins, outs, _TAPS, h, w,
                *_restir_args(cfg, scene.num_lights), stream)
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out, new


def render_sample_fused(scene, cfg: RenderConfig, camera, state, height, width,
                        pass_idx, time_s=0.0):
    """One ReSTIR pass on K6: (mean radiance f32[H, W, 3], new back
    Reservoirs), as `restir.render_sample` returns them."""
    scene = scene_mod.animate_positions(scene, time_s, int(cfg.render_mode))
    pix = rng.pixel_ids(height, width, device=scene.device)
    total = torch.zeros((height, width, 3), dtype=torch.float32, device=scene.device)
    new = None
    for s in range(cfg.samples_per_pass):
        ro, rd = generate_rays(camera, height, width, pass_idx, sample_idx=s)
        rad, new = trace_forward_restir_fused(scene, cfg, ro, rd, pix, pass_idx, s,
                                              state.restir_back, state.restir_hist1,
                                              state.restir_hist2)
        total = total + rad
    return total / cfg.samples_per_pass, new
