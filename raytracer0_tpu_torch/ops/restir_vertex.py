"""The reservoir-vertex kernel K6v (`csrc/restir_vertex.cu`) on Hopper: its
gate, build, launcher and launch count, and the reservoir arguments it
shares with the ReSTIR adjoint K7 (`ops/restir_kernel.py`).

K6v is the second stage of a ReSTIR pass.  The G-buffer kernel K4
(`ops/restir_split.py`) traces every path and records its diffuse vertices
in G-buffer slots; K6v then runs the reservoir pipeline
(`restir.reservoir_direct`: candidates, temporal and spatial reuse,
finalize and shade) at each pixel's vertices in slot order, one thread per
pixel, and keeps the last valid slot's reservoir as the pass's new back
reservoir.  Two forms:

- fused (`restir_kernel._launch`, K6's route): K4 + K6v replace the Pallas
  TPU kernel `raytracer0_tpu/ops/megakernel.py::_fused_restir_kernel_body`
  (launched by `_fused_restir_fwd_impl`, :2989).  Its plain version is
  `restir.render_sample`; the two agree bit for bit.
- split (`restir_split.render_sample_fast`, the ad-hoc reprojection): K4 +
  K6v replace the XLA reservoir phases of the JAX
  `restir.render_sample_fast` (raytracer0_tpu/ops/restir.py:689) and their
  shadow casts on the Pallas `cast_rays`.  Reservoirs carry their light
  data, the history is read at the reprojected pixel, and the shadow rays
  are cast in-kernel by the intersection the ray-cast kernel K5 runs.  Its
  plain version is `restir_split.render_sample_split` with
  `gbuffer_plain` and `restir.default_cast`; the two agree bit for bit.

What bounds it on the H100: instruction latency and divergence, like K1;
the G-buffer it reads (45 bytes per slot and pixel) is a few percent of the
time.  Run inside the bounce loop (as one fused kernel, the TPU kernel's
shape), the vertex occupies a warp whenever any of its lanes stands at a
diffuse vertex at that depth, with the whole bounce state live; here a
warp's lanes take their slots in step and no bounce state is live.

The launcher takes CUDA tensors only; the pass-level routes
(`restir_kernel.render_sample_fused`, `restir_split.render_sample_fast`,
`renderer.render_pass`) send CPU tensors to the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from raytracer0_tpu_torch.config import RenderConfig, RenderMode
from raytracer0_tpu_torch.ops import cuda_build, megakernel, restir
from raytracer0_tpu_torch.render.state import RESERVOIR_FIELDS, Reservoirs

#: K6v launches since import (or since a caller reset it to 0), both forms.
VERTEX_LAUNCHES = 0

SOURCES = ("restir_vertex.cu",)
#: The most G-buffer slots K6v reads (MAX_VERTEX_SLOTS in restir_vertex.cu).
MAX_SLOTS = 32
IN_FIELDS = ("weight_sum", "m", "w", "age", "light_index")

# the spatial taps' (row, column) offsets, passed by value
TAPS = (ctypes.c_int * 16)(*[v for tap in restir.TAP_OFFSETS for v in tap])
_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: The reservoir arguments K6v and K7 take after K1's: res_in, res_out
#: (K6v only), taps, grid size, candidates, spatial taps, the two epsilons,
#: ANIMATED accumulation.
RESTIR_ARGTYPES = (
    _c_void_p, _c_int, _c_int,        # taps (host), height, width
    _c_int, _c_int,                   # candidates, spatial taps
    _c_float, _c_float,               # epsilon * 2, epsilon * 10
    _c_int,                           # ANIMATED accumulation
)
_ARGTYPES = megakernel._ARGTYPES[:-1] + (_c_void_p, _c_void_p) + RESTIR_ARGTYPES + (
    _c_void_p, _c_void_p, _c_void_p,  # G-buffer pos, nl, mask
    _c_void_p, _c_void_p, _c_void_p,  # G-buffer idx, depth, valid
    _c_void_p, _c_int,                # the split form's running sum, slots
    _c_int, _c_int,                   # split form, ad-hoc reprojection
    _c_void_p,                        # stream
)
GBUF_FIELDS = ("pos", "nl", "mask", "idx", "depth", "valid")


def smem_bytes(scene) -> int:
    """Dynamic shared memory of one K6v block, either copy: K1's
    (`path.cuh::load_path`: the table, whose columns 14:26 hold the aux
    rows a TRIANGLE or QUAD reads, the codes, the light slots, the texture
    codes and blend flags, the SDF shapes) and the light-slot table (8
    floats per slot)."""
    return megakernel.smem_bytes(scene) + 4 * 8 * scene.num_lights


def vertex_copy(scene, split: bool) -> int:
    """The copy of K6v that `scene` runs, as `rt0_restir_vertex` picks it:
    bit 0 the split form, bit 1 the whole SDF class
    (`megakernel.whole_sdf`: its shadow rays march every shape)."""
    return int(split) | 2 * int(megakernel.whole_sdf(scene))


def unsupported(scene, slots: int) -> Optional[str]:
    """Why K6v cannot run the vertices of `slots` G-buffer slots in
    `scene`, or None when it can (the class of its G-buffer is K4's gate;
    its shadow rays march SDF rows of every shape, in its whole-SDF copy
    where `megakernel.whole_sdf` says so)."""
    if slots > MAX_SLOTS:
        return f"{slots} G-buffer slots, more than K6v's {MAX_SLOTS}"
    return megakernel.check_smem(smem_bytes(scene))


def build():
    """Build (or load from `build/kernels/`) the K6v library.
    Returns (ctypes function, cuda_build.BuildInfo)."""
    lib, info = cuda_build.load("restir_vertex", SOURCES)
    fn = lib.rt0_restir_vertex
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn, info


def restir_args(cfg: RenderConfig, num_lights: int):
    """(candidates, spatial taps, f32 epsilon*2, f32 epsilon*10, ANIMATED
    accumulation), as `restir.reservoir_direct` derives them."""
    n_spatial = (restir.RESTIR_SPATIAL_SAMPLES if num_lights <= 10
                 else max(4, restir.RESTIR_SPATIAL_SAMPLES // 2))
    return (min(cfg.restir_samples, max(4, num_lights)), n_spatial,
            float(np.float32(cfg.epsilon * 2.0)), float(np.float32(cfg.epsilon * 10.0)),
            int(int(cfg.render_mode) == int(RenderMode.ANIMATED)))


def check_ring(h, w, dev, *grids, light_data=False):
    """The input tensors of K6v and K7, checked: each grid's ws, m, w, age
    and light_index; with `light_data`, then each grid's light_pos and
    light_color (the split form)."""
    res_in = []
    names = ("back", "hist1", "hist2")
    for name, grid in zip(names, grids):
        for k in IN_FIELDS:
            t = getattr(grid, k)
            megakernel._check(f"{name}.{k}", t, RESERVOIR_FIELDS[k], (h, w), dev)
            res_in.append(t)
    if light_data:
        for name, grid in zip(names, grids):
            for k in ("light_pos", "light_color"):
                t = getattr(grid, k)
                megakernel._check(f"{name}.{k}", t, torch.float32, (h, w, 3), dev)
                res_in.append(t)
    return res_in


def launch(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx, grids, gbuf, rad,
           total=None, args=None):
    """Launch K6v on K4's G-buffer `gbuf` ({field: [slots, H, W, ...]}, as
    `restir_split.launch_gbuffer` returns it) and radiance `rad`, reading
    the ring `grids` (back, hist1, hist2 Reservoirs).  Fused form when
    `total` is None: writes its radiance over `rad` and returns (rad, new
    back Reservoirs).  Split form with `total`, the running sum
    f32[H, W, 3] of the pass's samples, which it updates in place to
    (total + rad) + direct: returns (total, new back Reservoirs carrying
    their light data).  `args`: K1's launch arguments with `rad` as the
    radiance, when the caller has them (`restir_split.launch_two_stage`)."""
    global VERTEX_LAUNCHES
    dev = ro.device
    h, w = pix.shape
    slots = gbuf["pos"].shape[0]
    reason = unsupported(scene, slots)
    if reason is not None:
        raise NotImplementedError(f"K6v does not cover this scene: {reason}")
    split = total is not None
    for k, dt in zip(GBUF_FIELDS, (torch.float32,) * 3 + (torch.int32,) * 2 + (torch.bool,)):
        megakernel._check(f"gbuf.{k}", gbuf[k], dt,
                          (slots, h, w, 3) if dt == torch.float32 else (slots, h, w), dev)
    megakernel._check("rad", rad, torch.float32, (h, w, 3), dev)
    res_in = check_ring(h, w, dev, *grids, light_data=split)
    if split:
        megakernel._check("total", total, torch.float32, (h, w, 3), dev)
    new = Reservoirs(**{k: torch.empty((h, w, 3) if k in ("light_pos", "light_color")
                                       else (h, w), dtype=dt, device=dev)
                        for k, dt in RESERVOIR_FIELDS.items()})
    if args is None:
        args, _keep = megakernel.forward_args(scene, cfg, table, ro, rd, pix, rad,
                                              pass_idx, sample_idx)
    ins = (ctypes.c_void_p * len(res_in))(*[t.data_ptr() for t in res_in])
    outs = (ctypes.c_void_p * 7)(*[getattr(new, k).data_ptr() for k in RESERVOIR_FIELDS])
    fn, _ = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, ins, outs, TAPS, h, w, *restir_args(cfg, scene.num_lights),
                *[gbuf[k].data_ptr() for k in GBUF_FIELDS],
                total.data_ptr() if split else None, slots, int(split),
                int(split and cfg.restir_adhoc_motion), stream)
    if rc != 0:
        raise RuntimeError(f"K6v launch failed: CUDA error {rc}")
    VERTEX_LAUNCHES += 1
    return (total if split else rad), new
