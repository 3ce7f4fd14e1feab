"""The split ReSTIR path on Hopper: the G-buffer kernel K4
(`csrc/gbuffer.cu`), the ray-cast kernel K5 (`csrc/cast.cu`), their gates,
builds, launchers and plain versions, and the render pass that joins K4
with the reservoir-vertex kernel K6v (`render_sample_fast`).

K4 replaces the Pallas TPU kernel
`raytracer0_tpu/ops/megakernel.py::_gbuf_kernel_body` (launched by
`trace_forward_gbuffer`): K1's bounce loop without the direct light of
diffuse vertices, which records each lane's k-th diffuse vertex in G-buffer
slot k instead.  It is also the first stage of K6's route
(`restir_kernel._launch`).  K5 replaces `_cast_kernel_body` (launched by
`cast_rays`): the nearest hit of each ray.  `render_sample_fast` is the
counterpart of the JAX `restir.render_sample_fast`, the route of a ReSTIR
pass with the ad-hoc temporal reprojection (`cfg.restir_adhoc_motion`): on
the card K4 traces the paths and one launch of K6v (its split form,
`ops/restir_vertex.py`) runs the reservoir pipeline of
`restir.reservoir_direct` at every G-buffer slot, its shadow rays cast
in-kernel by the intersection K5 runs, so K5 is not launched on this path
(in the JAX package the phases are XLA ops and the casts Pallas K5
launches).  The last valid slot's reservoir is the pass's new back
reservoir.

The plain versions are `integrator.trace` with `gbuffer_slots` (K4),
`restir.default_cast`'s `intersect.intersect` (K5) and
`render_sample_split` with both (the pass); the kernels follow their
operations in order, so on the same inputs the two agree bit for bit.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The JAX split path has no VJP, and neither has this one: on CUDA a
gradient through it raises before any launch (on the CPU the plain route is
differentiable).

What bounds them on the H100: K4 is K1 without NEE's shadow rays, bound by
instruction latency and divergence like K1; K5 moves 32 bytes a ray and, in
scenes with SDF meshes, marches, which outweighs its bytes.  K4's paths end
at very different depths, so it runs persistent warps that regenerate
paths: its grid is the blocks that stay resident (`resident_blocks`), and
its lanes draw pixels from a ticket counter (`ticket_counter`) until the
image is done.
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
from raytracer0_tpu_torch.models.scene import TENSOR_FIELDS
from raytracer0_tpu_torch.ops import cuda_build, megakernel, restir, restir_vertex
from raytracer0_tpu_torch.render import integrator
from raytracer0_tpu_torch.render.state import Reservoirs

#: K4 launches since import (or since a caller reset it to 0).
GBUF_LAUNCHES = 0
#: K5 launches since import (or since a caller reset it to 0).
CAST_LAUNCHES = 0

GBUF_SOURCES = ("gbuffer.cu",)
CAST_SOURCES = ("cast.cu",)
#: The most G-buffer slots K4 tracks per lane (MAX_GBUF_SLOTS in gbuffer.cu).
MAX_GBUF_SLOTS = 32
_ITEM = "ROADMAP queue 1 item 11"

_c_void_p, _c_int, _c_ll, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_GBUF_ARGTYPES = megakernel._ARGTYPES[:-1] + (
    _c_void_p, _c_void_p, _c_void_p,  # pos, nl, mask
    _c_void_p, _c_void_p, _c_void_p,  # idx, depth, valid
    _c_int, _c_int, _c_void_p,        # slots, grid, ticket counter
    _c_void_p,                        # stream
)
_CAST_ARGTYPES = (
    _c_void_p, _c_void_p, _c_void_p, _c_int,    # table, mesh, mat, n_mesh
    _c_void_p, _c_int, _c_int,                  # SDF shapes, n_analytic, n_sdf
    _c_int, _c_float, _c_float,                 # marching steps, fudge, t0
    _c_void_p, _c_void_p, _c_void_p, _c_void_p,  # ro, rd, t, idx
    _c_ll, _c_float, _c_float,                  # rays, epsilon, infinity
    _c_void_p,                                  # stream
)


def gbuffer_slots(cfg: RenderConfig) -> int:
    """G-buffer slots: a path has at most this many diffuse vertices
    (raytracer0_tpu/ops/megakernel.py:2816)."""
    return min(cfg.max_diff_bounces, cfg.max_bounces)


def cast_smem_bytes(scene) -> int:
    """Dynamic shared memory of one K5 block: the table, the mesh and
    material codes and the SDF rows' shapes."""
    return 4 * (scene.num_meshes * 36 + 2 * scene.num_meshes + scene.num_sdfs)


def unsupported_gbuffer(scene, cfg: RenderConfig) -> Optional[str]:
    """Why K4 cannot trace (scene, cfg), or None when it can: the JAX
    `supported_restir` (raytracer0_tpu/ops/megakernel.py:545-560), a ReSTIR
    config in the class of `integrator.unsupported` (ReSTIR engaged,
    LIGHT-sphere slots, no photographic cubemap, cosine sampling, static or
    animated, the ad-hoc reprojection or not; SDF rows of every shape and
    blended textures, in the whole-SDF copy where `megakernel.whole_sdf`
    says so), at most MAX_GBUF_SLOTS slots and a table that fits the
    shared memory."""
    if not cfg.use_restir:
        return "not a ReSTIR config (use_restir is off): K1 renders it"
    reason = integrator.unsupported(scene, cfg)
    if reason is None and gbuffer_slots(cfg) > MAX_GBUF_SLOTS:
        reason = f"{gbuffer_slots(cfg)} G-buffer slots, more than K4's {MAX_GBUF_SLOTS}"
    return reason or megakernel.check_smem(megakernel.packed_smem_bytes(scene))


def unsupported_cast(scene) -> Optional[str]:
    """Why K5 cannot cast rays in `scene`, or None when it can: analytic
    SPHERE/PLANE/BOX meshes and BOX/ROUND_BOX SDF rows, untextured and unlit
    (`integrator.outside_box_sdf`), with a table that fits the shared
    memory."""
    return (integrator.unsupported_geometry(scene)
            or integrator.outside_box_sdf(scene, "K5")
            or megakernel.check_smem(cast_smem_bytes(scene)))


def build_gbuffer():
    """Build (or load from `build/kernels/`) the K4 library.
    Returns (ctypes function, cuda_build.BuildInfo)."""
    lib, info = cuda_build.load("gbuffer", GBUF_SOURCES)
    fn = lib.rt0_gbuffer_forward
    fn.argtypes = _GBUF_ARGTYPES
    fn.restype = ctypes.c_int
    return fn, info


# (device, stream) -> int32[2] zeros: K4's ticket counter and finished-block
# count, which every launch leaves zeroed (its last block resets them)
_TICKETS: dict = {}
# (device, copy, shared memory bytes) -> blocks of K4 that stay resident
_RESIDENT: dict = {}


def gbuffer_copy(scene) -> int:
    """The copy of K4 that `scene` runs, as `rt0_gbuffer_forward` picks it:
    bit 0 the SDF march (a scene with SDF rows), bit 1 the whole SDF class
    (`megakernel.whole_sdf`)."""
    return int(scene.num_sdfs > 0) | 2 * int(megakernel.whole_sdf(scene))


def ticket_counter(dev, stream: int):
    """K4's ticket counter for launches on `stream` of device `dev`: one per
    stream, since two launches must not share one while they run."""
    key = (dev, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _TICKETS[key]


def resident_blocks(dev, copy: int, smem: int) -> int:
    """K4's persistent grid on device `dev`: the blocks of 128 threads of
    its copy `copy` (`gbuffer_copy`; True is the SDF march's) that stay
    resident at `smem` bytes of dynamic shared memory
    (`rt0_gbuffer_forward_occupancy`) times the SMs; computed once per
    device, copy and size."""
    key = (dev, int(copy), smem)
    if key not in _RESIDENT:
        occ = cuda_build.occupancy("gbuffer", GBUF_SOURCES, "rt0_gbuffer_forward_occupancy",
                                   128, smem, int(copy))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if occ["blocks"] < 1:
            raise RuntimeError(f"K4 does not fit an SM at {smem} bytes of shared memory: {occ}")
        _RESIDENT[key] = occ["blocks"] * sms
    return _RESIDENT[key]


def build_cast():
    """Build (or load from `build/kernels/`) the K5 library.
    Returns (ctypes function, cuda_build.BuildInfo)."""
    lib, info = cuda_build.load("cast", CAST_SOURCES)
    fn = lib.rt0_cast_rays
    fn.argtypes = _CAST_ARGTYPES
    fn.restype = ctypes.c_int
    return fn, info


def gbuffer_plain(scene, cfg: RenderConfig, ro, rd, pix, pass_idx, sample_idx):
    """The plain version of K4: `integrator.trace` without the direct light
    of diffuse vertices, recording them in `gbuffer_slots(cfg)` slots."""
    return integrator.trace(scene, cfg, ro, rd, pix, pass_idx, sample_idx,
                            gbuffer_slots=gbuffer_slots(cfg))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _no_grad_reason(what):
    return (f"a gradient through {what}: the split ReSTIR path (K4, K6v) has no adjoint, as "
            f"in the JAX package; ReSTIR without the ad-hoc reprojection differentiates "
            f"through K6 and K7: {_ITEM}")


def trace_forward_gbuffer(scene, cfg: RenderConfig, ro, rd, pix, pass_idx, sample_idx):
    """Radiance without diffuse NEE f32[H, W, 3] and the G-buffer: a list of
    `gbuffer_slots(cfg)` dicts, slot k holding each lane's k-th diffuse
    vertex: pos, nl, mask f32[H, W, 3], idx and depth int32[H, W], valid
    bool[H, W] (a slot no vertex wrote reads zeros, mesh 0, depth -1, not
    valid).  CPU tensors take the plain version; CUDA tensors launch K4, or
    raise for what K4 does not cover and for a gradient."""
    if ro.device.type == "cpu":
        return gbuffer_plain(scene, cfg, ro, rd, pix, pass_idx, sample_idx)
    if ro.device.type != "cuda":
        raise ValueError(f"trace_forward_gbuffer: unsupported device {ro.device}")
    reason = unsupported_gbuffer(scene, cfg)
    if reason is not None:
        raise NotImplementedError(f"K4 does not cover this scene: {reason}")
    table = megakernel.scene_table(scene)
    if _needs_grad(table, ro, rd, scene.images, scene.noise, scene.cubemap):
        raise NotImplementedError(_no_grad_reason("K4"))
    return _launch_gbuffer(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx)


def _launch_gbuffer(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx):
    """Check the tensors and launch K4: (radiance, G-buffer slots)."""
    out, bufs = launch_gbuffer(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx)
    return out, [{k: v[i] for k, v in bufs.items()} for i in range(len(bufs["pos"]))]


def launch_gbuffer(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx, out=None,
                   args=None):
    """Check the tensors and launch K4: (radiance, the G-buffer as
    {field: [slots, H, W, ...]}, the layout K6v reads).  `out` and `args`:
    the radiance tensor and K1's launch arguments that point at it, when
    the caller has built them (`launch_two_stage`)."""
    global GBUF_LAUNCHES
    dev = ro.device
    h, w = pix.shape
    megakernel._check("ro", ro, torch.float32, (h, w, 3), dev)
    megakernel._check("rd", rd, torch.float32, (h, w, 3), dev)
    megakernel._check("pix", pix, torch.int64, (h, w), dev)
    if scene.device != dev:
        raise ValueError(f"scene is on {scene.device}, rays on {dev}")
    slots = gbuffer_slots(cfg)
    if args is None:
        out = torch.empty_like(ro)
        args, _keep = megakernel.forward_args(scene, cfg, table, ro, rd, pix, out, pass_idx,
                                              sample_idx)
    bufs = dict(pos=torch.empty((slots, h, w, 3), dtype=torch.float32, device=dev),
                nl=torch.empty((slots, h, w, 3), dtype=torch.float32, device=dev),
                mask=torch.empty((slots, h, w, 3), dtype=torch.float32, device=dev),
                idx=torch.empty((slots, h, w), dtype=torch.int32, device=dev),
                depth=torch.empty((slots, h, w), dtype=torch.int32, device=dev),
                valid=torch.empty((slots, h, w), dtype=torch.bool, device=dev))
    fn, _ = build_gbuffer()
    grid = resident_blocks(dev, gbuffer_copy(scene), megakernel.packed_smem_bytes(scene))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, *[bufs[k].data_ptr() for k in restir_vertex.GBUF_FIELDS], slots, grid,
                ticket_counter(dev, stream).data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {rc}")
    GBUF_LAUNCHES += 1
    return out, bufs


def launch_two_stage(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx, grids, total=None):
    """K4 then K6v on one set of K1 launch arguments, the G-buffer between
    them scratch: K6's pass (`total` None: K6v's fused form) or a sample of
    the split pass (K6v's split form, adding into `total`), as
    `restir_vertex.launch` returns them."""
    rad = torch.empty_like(ro)
    args, _keep = megakernel.forward_args(scene, cfg, table, ro, rd, pix, rad, pass_idx,
                                          sample_idx)
    _, gbuf = launch_gbuffer(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx, rad, args)
    return restir_vertex.launch(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx, grids,
                                gbuf, rad, total=total, args=args)


def cast_rays(scene, cfg: RenderConfig, ro, rd, table=None):
    """Nearest hit of rays f32[..., 3]: (t f32[...], mesh index, missed
    bool[...]), with t = cfg.infinity and index 0 on a miss.  CPU tensors
    take the plain version (an int64 index); CUDA tensors launch K5 (an
    int32 index), or raise for a scene K5 does not cover.  `table`, the
    scene's `megakernel.scene_table`, saves building it per call."""
    if ro.device.type == "cpu":
        return restir.default_cast(scene, cfg)(ro, rd)
    if ro.device.type != "cuda":
        raise ValueError(f"cast_rays: unsupported device {ro.device}")
    reason = unsupported_cast(scene)
    if reason is not None:
        raise NotImplementedError(f"K5 does not cover this scene: {reason}")
    return _launch_cast(scene, cfg, megakernel.scene_table(scene) if table is None else table,
                        ro, rd)


def _launch_cast(scene, cfg, table, ro, rd):
    """Check the tensors and launch K5: (t, idx, missed)."""
    global CAST_LAUNCHES
    dev = ro.device
    batch = tuple(ro.shape[:-1])
    megakernel._check("ro", ro, torch.float32, batch + (3,), dev)
    megakernel._check("rd", rd, torch.float32, batch + (3,), dev)
    megakernel._check("table", table, torch.float32, (scene.num_meshes, 36), dev)
    mesh, mat, _ = megakernel._codes(scene)
    sdf = scene.sdf_shape[scene.num_analytic:].to(torch.int32).contiguous()
    t = torch.empty(batch, dtype=torch.float32, device=dev)
    idx = torch.empty(batch, dtype=torch.int32, device=dev)
    fn, _ = build_cast()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(table.data_ptr(), mesh.data_ptr(), mat.data_ptr(), scene.num_meshes,
                sdf.data_ptr(), scene.num_analytic, scene.num_sdfs, cfg.marching_steps,
                cfg.fudge_factor, float(np.float32(cfg.epsilon * 4.0)),
                ro.data_ptr(), rd.data_ptr(), t.data_ptr(), idx.data_ptr(), t.numel(),
                cfg.epsilon, cfg.infinity, stream)
    if rc != 0:
        raise RuntimeError(f"K5 launch failed: CUDA error {rc}")
    CAST_LAUNCHES += 1
    # the JAX cast_rays' miss (megakernel.py:3389-3390): t at cfg.infinity
    return t, idx, ~(t < cfg.infinity)


def render_sample_split(scene, cfg: RenderConfig, camera, state, height, width, pass_idx,
                        time_s, trace_gbuffer, make_cast):
    """One ReSTIR pass on the split path with the G-buffer tracer
    `trace_gbuffer` (`trace_forward_gbuffer`'s signature) and the shadow-ray
    caster `make_cast(scene, cfg) -> cast_fn(o, d) -> (t, idx, missed)`:
    (mean radiance f32[H, W, 3], new back Reservoirs), the operations of
    the JAX `restir.render_sample_fast` (restir.py:711-748) in order, the
    reservoir phases as PyTorch ops per G-buffer slot.  With the plain
    versions (`gbuffer_plain`, `restir.default_cast`) it is the plain
    version of `render_sample_fast`'s route on the card, K4 and K6v."""
    scene = scene_mod.animate_positions(scene, time_s, int(cfg.render_mode))
    pix = rng.pixel_ids(height, width, device=scene.device)
    back = state.restir_back.fields()
    hist = [state.restir_hist1.fields(), state.restir_hist2.fields()]
    cast_fn = make_cast(scene, cfg)
    total = torch.zeros((height, width, 3), dtype=torch.float32, device=scene.device)
    res_out = None
    for s in range(cfg.samples_per_pass):
        ro, rd = generate_rays(camera, height, width, pass_idx, sample_idx=s)
        rad, gbuf = trace_gbuffer(scene, cfg, ro, rd, pix, pass_idx, s)
        direct = torch.zeros((height, width, 3), dtype=torch.float32, device=scene.device)
        res_cur = restir.empty_reservoir((height, width), scene.device)
        for slot in gbuf:  # ascending diffuse ordinal: the last valid slot wins
            out, res = restir.reservoir_direct(
                scene, cfg, back, hist, slot["pos"], slot["nl"], slot["idx"], pix, pass_idx,
                s, slot["depth"], height=height, width=width, cast_fn=cast_fn)
            v = slot["valid"]
            direct = direct + torch.where(v[..., None], out * slot["mask"],
                                          torch.zeros_like(out))
            res_cur = {k: torch.where(v[..., None] if r.dim() > v.dim() else v, r, res_cur[k])
                       for k, r in res.items()}
        total = total + rad + direct
        res_out = res_cur
    return total / cfg.samples_per_pass, Reservoirs(**res_out)


def check_split(scene, cfg: RenderConfig, camera, state, time_s=0.0):
    """Raise NotImplementedError for a split pass the kernels do not serve
    on the card: a (scene, cfg) outside K4's or K6v's class; a cubemap,
    which no test holds K4 and K6v's split form to yet (K6's gate,
    `restir_kernel.unsupported_restir`, refuses it too); or a gradient (any
    scene leaf, camera field, ring field or the frame time that requires
    grad), which the split path has no adjoint for.  SDF rows of every
    shape and blended textures run in K4's and K6v's whole-SDF copies."""
    reason = unsupported_gbuffer(scene, cfg) or restir_vertex.unsupported(scene, gbuffer_slots(cfg))
    if reason is None and cfg.use_cubemap:
        reason = f"a cubemap and its gather ray under ReSTIR on the split path: {_ITEM}"
    if reason is not None:
        raise NotImplementedError(f"the split ReSTIR path does not cover this scene: {reason}")
    ring = [t for g in (state.restir_back, state.restir_hist1, state.restir_hist2)
            for t in g.fields().values()]
    leaves = [getattr(scene, k) for k in TENSOR_FIELDS] + [
        getattr(camera, k) for k in ("origin", "lookat", "fov", "aperture", "focal_length")]
    if _needs_grad(*leaves, *ring, time_s):
        raise NotImplementedError(_no_grad_reason("ReSTIR with the ad-hoc reprojection"))


def render_sample_fast(scene, cfg: RenderConfig, camera, state, height, width, pass_idx,
                       time_s=0.0):
    """One ReSTIR pass on the split path: (mean radiance f32[H, W, 3], new
    back Reservoirs), as `restir.render_sample` returns them.  On CUDA, per
    sample one K4 and one K6v launch (split form); it raises, before any
    launch, for what K4 or K6v does not cover and for a gradient (any scene
    leaf, camera field or ring field that requires grad).  On the CPU, the
    plain version: `render_sample_split` with `gbuffer_plain` and
    `restir.default_cast`."""
    if scene.device.type != "cuda":
        return render_sample_split(scene, cfg, camera, state, height, width, pass_idx, time_s,
                                   gbuffer_plain, restir.default_cast)
    check_split(scene, cfg, camera, state, time_s)
    return _render_sample_kernels(scene, cfg, camera, state, height, width, pass_idx, time_s)


def _render_sample_kernels(scene, cfg, camera, state, height, width, pass_idx, time_s):
    """`render_sample_fast`'s route on the card, without the device and
    class checks: K4 then K6v (split form) per sample."""
    scene = scene_mod.animate_positions(scene, time_s, int(cfg.render_mode))
    pix = rng.pixel_ids(height, width, device=scene.device)
    table = megakernel.scene_table(scene)
    grids = (state.restir_back, state.restir_hist1, state.restir_hist2)
    total = torch.zeros((height, width, 3), dtype=torch.float32, device=scene.device)
    new = None
    for s in range(cfg.samples_per_pass):
        ro, rd = generate_rays(camera, height, width, pass_idx, sample_idx=s)
        total, new = launch_two_stage(scene, cfg, table, ro, rd, pix, pass_idx, s, grids,
                                      total=total)
    return total / cfg.samples_per_pass, new
