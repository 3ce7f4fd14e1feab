"""The ReSTIR pass K6 and its adjoint K7 (`csrc/restir_bwd.cu`) on Hopper:
their gates, launchers, the `torch.autograd.Function` that pairs them, and
the render pass that uses them.

K6 replaces the Pallas TPU kernel
`raytracer0_tpu/ops/megakernel.py::_fused_restir_kernel_body` (launched by
`_fused_restir_fwd_impl`), which traces every pixel's path and runs the
reservoir pipeline (`restir.reservoir_direct`) at each diffuse vertex in
place of per-light NEE, returning the radiance and the pass's new back
reservoirs.  On Hopper K6 is two launches (`_launch`): the G-buffer kernel
K4 (`ops/restir_split.py`) traces the paths and records their diffuse
vertices, then the reservoir-vertex kernel K6v (`ops/restir_vertex.py`,
its fused form) runs the vertices one thread per pixel and adds K4's
radiance.  `LAUNCHES` counts K6 passes, one per (K4, K6v) pair.  K7
replaces the adjoint `_fused_restir_bwd_kernel_body` (launched by
`_fused_restir_backward`) and serves its per-slot twin
`_fused_restir_bwd_slotted_kernel_body` (K8), being per-slot by design.
`_RestirCore` pairs them as the JAX custom_vjp `_fused_restir_call` does:
forward launches K6, backward launches K7, which replays the paths and the
vertices from the ring, not from K6's G-buffer.  Their plain PyTorch
version is `restir.render_sample` and its autograd; on the same inputs K6
traces the same paths and makes the same reservoir decisions, and K7 gives
the same gradients up to float32 rounding.

What bounds them on the H100: like K1, instruction latency and divergence.
A pixel reads 28 bytes of rays and id, 60 bytes of reservoirs at its own
pixel and up to 160 bytes of spatial taps (mostly from L2, since
neighbouring threads read overlapping taps), and writes 56 bytes; K6's
G-buffer adds 45 bytes per slot written and read; its work is K1's bounce
loop plus, per diffuse vertex, up to 16 candidates, 10 combines and 2
shadow rays with SDF marches.  The design keeps the reservoir in registers,
reads the taps in place (no pre-rolled copy of the grid), and keeps the
light slots in shared memory.  K7 replays each slot from a per-slot stash
and each reservoir vertex from a tape of its decisions, and reduces its
scene cotangents per thread, per block in thread order and across blocks in
block order; its tap cotangents are gathered into the back grid in tap
order, so it is deterministic.

K7 has two copies (`bwd_copy`): the ROUND_BOX copy, its code before the
whole SDF class came, for scenes whose SDF rows are untextured ROUND_BOX
rows and that blend no texture; and the whole-SDF copy
(`csrc/restir_bwd_sdf.cu`, a library of its own) for the scenes K4 and
K6v run their whole-SDF copies on and those that blend a texture, which
replays every SDF shape, the texel blended into a hit's color and
emission and K6v's whole-SDF vertex.  The gradient flows to the
scene table's pos, joker, color, emission and ior columns (in the
whole-SDF copy also aux and the texture columns, `bwd_columns`), to the
rays, and to the ring's m, w and age (a source's weight_sum only gates
its validity: its cotangent is zero).  A light's
position and color·emission in the new reservoirs are gathered from the
scene by `light_index` outside the kernels (`light_data`), so autograd
carries their cotangents to the scene.  K6 and K7 read a light's data from
the slot table where the plain version reads the ring's copy; over a chain
of passes from an empty ring with one scene the two gradients agree.

Under ANIMATED accumulation (`cfg.render_mode`) K6v and K7 fade the
history by a further 0.85 and reject spatial taps older than 2 passes, as
the Pallas K6 does; the scene arrives animated to the pass's time.  Since
the kernels read every reservoir's light data from the slot table, a
spatial tap sees its light where it is in this frame, where the plain
version reads the tap's stored copy from the last frame: at a moving frame
time the two differ (PERF.md), at a constant one they agree bit for bit.
The ad-hoc reprojection runs on the split path (`ops/restir_split.py`).

On a CUDA device nothing here falls back to the plain version: a ReSTIR
config outside K6's class, or a gradient outside K7's, raises before any
launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.config import RenderConfig
from raytracer0_tpu_torch.models import scene as scene_mod
from raytracer0_tpu_torch.models.camera import generate_rays
from raytracer0_tpu_torch.models.materials import SdfShape
from raytracer0_tpu_torch.ops import cuda_build, megakernel, restir, restir_split, restir_vertex
from raytracer0_tpu_torch.ops import textures
from raytracer0_tpu_torch.render import integrator
from raytracer0_tpu_torch.render.state import Reservoirs

#: K6 passes since import (or since a caller reset it to 0): one per K4 and
#: K6v pair `_launch` launches (`restir_split.GBUF_LAUNCHES` and
#: `restir_vertex.VERTEX_LAUNCHES` count the kernels).
LAUNCHES = 0
#: K7 launches since import (or since a caller reset it to 0); one per
#: backward of a K6 pass: the adjoint, the tap gather and the reduction.
BWD_LAUNCHES = 0
#: Those of them that launched K7's whole-SDF copy (`bwd_copy`).
BWD_SDF_LAUNCHES = 0

BWD_SOURCES = ("restir_bwd.cu",)
#: K7's whole-SDF copy, a library of its own (restir_bwd.cu with
#: RT0_K7_WHOLE_SDF set), which nvcc builds beside the ROUND_BOX copy's.
BWD_SDF_SOURCES = ("restir_bwd_sdf.cu",)
#: The ring's float fields, which carry a gradient from pass to pass.
RING_FLOATS = ("weight_sum", "m", "w", "age")
_ITEM = "ROADMAP queue 1 item 11"
# K7 on BOX rows of a scene K4 and K6v march without the whole SDF class
_K7_ITEM = "ROADMAP queue 1 item 8"
# K7: stash depth (MAX_SLOTS in restir_bwd.cu), candidates its tape holds,
# the cotangent columns of its ROUND_BOX copy (table columns 0:14: pos,
# joker, color, emission, ior), the opt-in shared memory of one block, and
# block sizes tried in order until the per-thread accumulators fit
MAX_SLOTS = 16
MAX_CAND = 32
_BWD_NG = 14
_BWD_SMEM_LIMIT = 227 * 1024
_BWD_THREADS = (128, 64, 32)
#: Scene leaves that neither copy of K7 differentiates: the texel arrays
#: (ROADMAP queue 1 item 14).
NO_GRAD_LEAVES = ("images", "noise", "cubemap")
#: Scene leaves whose table columns the ROUND_BOX copy does not keep (its
#: scenes read none of them); a gradient asked of them there is refused,
#: not left zero.
ROUND_BOX_NO_GRAD = ("aux", "tex_params", "tex_cmask", "tex_emask")

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
_BWD_ARGTYPES = megakernel._ARGTYPES[:-1] + (_c_void_p,) + restir_vertex.RESTIR_ARGTYPES + (
    _c_void_p, _c_void_p,             # ct, ct_res[4]
    _c_void_p, _c_void_p,             # d_ro, d_rd
    _c_void_p, _c_void_p,             # partials, d_table
    _c_void_p, _c_void_p, _c_void_p,  # dtap, dhist, dback
    ctypes.c_ulonglong,               # the mask of bwd_columns
    _c_int, _c_void_p,                # threads per block, stream
)


def unsupported_restir(scene, cfg: RenderConfig) -> Optional[str]:
    """Why K6 cannot render (scene, cfg), or None when it can: a ReSTIR
    config in the class of `integrator.unsupported` (the JAX
    `supported_restir_fused`: ReSTIR engaged, LIGHT-sphere slots, no
    photographic cubemap, cosine sampling, static or animated
    accumulation; SDF rows of every shape and textures blended into any
    row, which K4 and K6v run in their whole-SDF copies where
    `megakernel.whole_sdf` says so) with the pixel's own history (the
    ad-hoc reprojection runs on the split path, `ops/restir_split.py`),
    without a cubemap, whose gather ray adds to the radiance between the
    vertices K6v sums, in K4's and K6v's classes."""
    if not cfg.use_restir:
        return "not a ReSTIR config (use_restir is off): K1 renders it"
    if cfg.restir_adhoc_motion:
        return ("ReSTIR's ad-hoc temporal reprojection runs on the split path of K4 and K6v's "
                "split form (ops/restir_split.py, restir_split.render_sample_fast), not the K6 "
                f"pass: {_ITEM}")
    reason = integrator.unsupported(scene, cfg)
    if reason is None and cfg.use_cubemap:
        reason = f"a cubemap and its gather ray under ReSTIR on K6: {_ITEM}"
    # K6v's gate covers K4's beyond `integrator.unsupported` (slots, and a
    # shared memory that holds K4's and the light slots)
    return reason or restir_vertex.unsupported(scene, restir_split.gbuffer_slots(cfg))


def bwd_slots(cfg: RenderConfig) -> int:
    """The most bounce slots a path runs, hence K7's stash depth: each slot
    that does not end the path adds one to one of the three bounce
    counters, and the path stops once one of them reaches its cap (or at
    `max_bounces`)."""
    caps = (cfg.max_diff_bounces, cfg.max_spec_bounces, cfg.max_scattering_events)
    return min(cfg.max_bounces, sum(max(c, 1) - 1 for c in caps) + 1)


def bwd_copy(scene) -> str:
    """The copy of K7 that differentiates `scene`, and so the library
    `_launch_backward` loads: "whole_sdf" where K4 and K6v run their
    whole-SDF copies (`megakernel.whole_sdf`) or a texture is blended into
    some row (`textures.blended`); else "round_box", the copy K7 had
    before (its code, registers and stack), whose SDF rows are ROUND_BOX
    rows (`outside_k7_class` refuses BOX rows there)."""
    whole = megakernel.whole_sdf(scene) or textures.blended(scene)
    return "whole_sdf" if whole else "round_box"


def bwd_columns(scene) -> tuple[int, ...]:
    """The scene-table columns K7 keeps a cotangent for, in table order:
    0:14 (pos, joker, color, emission, ior; the reservoir vertex reads a
    COAT's IOR and every light's joker.x), and in the whole-SDF copy also
    the aux and texture columns K2's wide copy keeps for the scene
    (`megakernel.wide_columns`: the vertices of TRIANGLE and QUAD rows, a
    texture's params, the color and emission masks of blended rows)."""
    cols = set(range(_BWD_NG))
    if bwd_copy(scene) == "whole_sdf":
        cols |= set(megakernel.wide_columns(scene))
    return tuple(sorted(cols))


def bwd_smem_bytes(scene, threads: int) -> int:
    """Dynamic shared memory of one K7 block: K6v's, plus `threads` columns
    of `bwd_columns` cotangent accumulators per mesh and, in the whole-SDF
    copy, the map of those columns (36 ints)."""
    whole = bwd_copy(scene) == "whole_sdf"
    return (restir_vertex.smem_bytes(scene) + 4 * megakernel._NCOLS * whole
            + 4 * scene.num_meshes * len(bwd_columns(scene)) * threads)


def bwd_threads(scene) -> Optional[int]:
    """K7's block size: the largest of 128, 64, 32 whose accumulators fit
    the shared memory of one block; None when none does."""
    for t in _BWD_THREADS:
        if bwd_smem_bytes(scene, t) <= _BWD_SMEM_LIMIT:
            return t
    return None


def outside_k7_class(scene) -> Optional[str]:
    """What of the scene lies outside the class of K7's two copies, or
    None: a light slot on an SDF row (the reservoir vertex samples and
    shades sphere lights), and a BOX row in a scene K4 and K6v march
    without the whole SDF class (`megakernel.whole_sdf` false: the
    ROUND_BOX copy has no BOX adjoint, and the whole-SDF copy marches with
    another scene map than K6 did there, which no test holds).  Every SDF
    shape and textures blended into any row, SDF rows included, are
    otherwise inside: K7 runs its whole-SDF copy there (`bwd_copy`).
    K7's own check, made before K6's gate, so a wider K6 never sends K7 a
    scene it would differentiate wrongly."""
    if any(li >= scene.num_analytic for li in scene.lights_static):
        return f"SDF-bound light slots (K7 samples sphere lights): {_ITEM}"
    if (any(s == int(SdfShape.BOX) for s in scene.sdf_shapes_static)
            and not megakernel.whole_sdf(scene)):
        return ("BOX SDF rows in a scene K4 and K6v march without the whole SDF class (K7's "
                "ROUND_BOX copy has no BOX adjoint, and its whole-SDF copy marches them with "
                f"another scene map): {_K7_ITEM}")
    return None


def unsupported_restir_bwd(scene, cfg: RenderConfig) -> Optional[str]:
    """Why K7 cannot differentiate (scene, cfg), or None when it can: its
    own class first (`outside_k7_class`: no SDF light, no BOX row outside
    the whole SDF class), then K6's class, a
    stash of at most MAX_SLOTS slots, at most MAX_CAND candidates,
    accumulators that fit the shared memory of a block of 32 threads, and
    no gradient asked of a leaf K7 leaves without one (the images, the
    noise LUT, the cubemap; in the ROUND_BOX copy also aux and the texture
    columns, `ROUND_BOX_NO_GRAD`)."""
    reason = outside_k7_class(scene) or unsupported_restir(scene, cfg)
    if reason is not None:
        return reason
    if bwd_slots(cfg) > MAX_SLOTS:
        return f"paths of {bwd_slots(cfg)} slots, more than K7's stash of {MAX_SLOTS}"
    if restir_vertex.restir_args(cfg, scene.num_lights)[0] > MAX_CAND:
        return f"more than {MAX_CAND} ReSTIR candidates (K7's tape): {_ITEM}"
    if bwd_threads(scene) is None:
        return (f"{scene.num_meshes} meshes of {len(bwd_columns(scene))} columns: K7's "
                f"cotangent accumulators do not fit {_BWD_SMEM_LIMIT} bytes of shared memory "
                "at 32 threads a block")
    asked = [k for k in NO_GRAD_LEAVES if getattr(scene, k).requires_grad]
    if asked:
        return (f"a gradient with respect to the texel arrays {', '.join(asked)}, which K7 "
                "does not compute: ROADMAP queue 1 item 14")
    if bwd_copy(scene) == "round_box":
        asked = [k for k in ROUND_BOX_NO_GRAD if getattr(scene, k).requires_grad]
        if asked:
            return (f"a gradient with respect to {', '.join(asked)}, whose columns K7's "
                    "ROUND_BOX copy does not keep: the scene reads none of them (ROUND_BOX "
                    "SDF rows alone, no blended texture), so their gradient is 0")
    return None


def bwd_library(whole: bool = False) -> tuple[str, tuple[str, ...]]:
    """(name, sources) of the K7 library that holds its whole-SDF copy
    (`whole`) or its ROUND_BOX copy."""
    return ("restir_bwd_sdf", BWD_SDF_SOURCES) if whole else ("restir_bwd", BWD_SOURCES)


def build_bwd():
    """Build (or load from `build/kernels/`) the library of K7's ROUND_BOX
    copy.  Returns (ctypes function, cuda_build.BuildInfo)."""
    return _bind_bwd(*cuda_build.load(*bwd_library()))


def build_bwd_sdf():
    """Build (or load from `build/kernels/`) the library of K7's whole-SDF
    copy.  Returns (ctypes function, cuda_build.BuildInfo)."""
    return _bind_bwd(*cuda_build.load(*bwd_library(True)))


def _bind_bwd(lib, info):
    fn = lib.rt0_restir_backward
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn, info


def light_data(scene, light_index):
    """(light_pos, light_color) f32[..., 3] of reservoirs holding the light
    slots `light_index` (-1 for none): the slot's position and
    color·emission, zeros for no slot, as K6 writes them and
    `restir.light_table` gathers them (one multiply), differentiable with
    respect to the scene."""
    slot = torch.clamp(light_index.long(), 0, scene.num_lights - 1)
    li = torch.clamp_min(scene.light_idx.long(), 0)[slot]
    held = ((light_index >= 0) & (light_index < scene.num_lights))[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=scene.device)
    return (torch.where(held, scene.pos[li], zero),
            torch.where(held, scene.color[li] * scene.emission[li], zero))


def _launch(scene, cfg, ro, rd, pix, pass_idx, sample_idx, back, hist1, hist2, table=None):
    """Launch K6, K4 then K6v (`trace_forward_restir_fused` without the
    device and class checks): (radiance, new back Reservoirs).  The
    G-buffer between them is scratch, freed on return."""
    global LAUNCHES
    if table is None:
        table = megakernel.scene_table(scene)
    out = restir_split.launch_two_stage(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx,
                                        (back, hist1, hist2))
    LAUNCHES += 1
    return out


def _launch_backward(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx, grids, ct, ct_res):
    """Launch K7 for the cotangents `ct` of the radiance and `ct_res` of the
    new reservoirs' weight_sum, m, w and age: (d_table, d_ro, d_rd, the
    cotangents of the ring's float fields as a list in `_RestirCore`'s
    order)."""
    global BWD_LAUNCHES, BWD_SDF_LAUNCHES
    reason = unsupported_restir_bwd(scene, cfg)
    if reason is not None:
        raise NotImplementedError(f"K7 does not cover this scene: {reason}")
    h, w = pix.shape
    dev = ro.device
    megakernel._check("ct", ct, torch.float32, (h, w, 3), dev)
    for k, t in zip(RING_FLOATS, ct_res):
        megakernel._check(f"ct {k}", t, torch.float32, (h, w), dev)
    res_in = restir_vertex.check_ring(h, w, dev, *grids)
    threads = bwd_threads(scene)
    cols = bwd_columns(scene)
    blocks = -(-(h * w) // threads)
    d_ro, d_rd = torch.empty_like(ro), torch.empty_like(rd)
    partials = torch.empty((blocks, scene.num_meshes, len(cols)), dtype=torch.float32,
                           device=dev)
    d_table = torch.zeros_like(table)   # K7 writes the columns `cols`
    f32 = dict(dtype=torch.float32, device=dev)
    dtap = torch.zeros((restir.RESTIR_SPATIAL_SAMPLES, 3, h, w), **f32)
    dhist = torch.zeros((2, 3, h, w), **f32)
    dback = torch.empty((3, h, w), **f32)
    args, _keep = megakernel.forward_args(scene, cfg, table, ro, rd, pix, None,
                                          pass_idx, sample_idx)
    ins = (ctypes.c_void_p * 15)(*[t.data_ptr() for t in res_in])
    cts = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in ct_res])
    whole = bwd_copy(scene) == "whole_sdf"
    fn, _ = build_bwd_sdf() if whole else build_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, ins, restir_vertex.TAPS, h, w,
                *restir_vertex.restir_args(cfg, scene.num_lights),
                ct.data_ptr(), cts, d_ro.data_ptr(), d_rd.data_ptr(), partials.data_ptr(),
                d_table.data_ptr(), dtap.data_ptr(), dhist.data_ptr(), dback.data_ptr(),
                megakernel._cols_mask(cols), threads, stream)
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    BWD_SDF_LAUNCHES += int(whole)
    d_ring = []
    for m_w_age in (dback, dhist[0], dhist[1]):
        # a source's weight_sum only gates its validity
        d_ring += [torch.zeros((h, w), **f32), m_w_age[0], m_w_age[1], m_w_age[2]]
    return d_table, d_ro, d_rd, d_ring


def _grids(floats, idx):
    """The ring (back, hist1, hist2) from its 12 float fields and 3 light
    indices, for the launchers (which read no light data)."""
    return [Reservoirs(light_pos=None, light_color=None, light_index=idx[g],
                       **dict(zip(RING_FLOATS, floats[4 * g:4 * g + 4])))
            for g in range(3)]


class _RestirCore(torch.autograd.Function):
    """K6 forward, K7 backward: the counterpart of the JAX custom_vjp
    `_fused_restir_call`.  Differentiable inputs: the scene table (its
    `torch.cat` backward splits the cotangent into the scene's leaves),
    `ro`, `rd`, and the weight_sum, m, w and age of back, hist1 and hist2.
    Outputs: the radiance and the new reservoirs' weight_sum, m, w, age and
    light_index (not differentiable).  Only the inputs are saved: O(H*W)
    memory at any depth."""

    @staticmethod
    def forward(ctx, scene, cfg, pix, pass_idx, sample_idx, idx, table, ro, rd, *floats):
        grids = _grids(floats, idx)
        out, new = _launch(scene, cfg, ro, rd, pix, pass_idx, sample_idx, *grids, table=table)
        ctx.save_for_backward(table, ro, rd, pix, *idx, *floats)
        ctx.trace_args = (scene, cfg, pass_idx, sample_idx)
        ctx.mark_non_differentiable(new.light_index)
        return out, new.weight_sum, new.m, new.w, new.age, new.light_index

    @staticmethod
    def backward(ctx, g_out, *g_res):
        table, ro, rd, pix, *rest = ctx.saved_tensors
        idx, floats = rest[:3], rest[3:]
        scene, cfg, pass_idx, sample_idx = ctx.trace_args
        # an unused output has no cotangent; that of .sum() is an expanded view
        ct = torch.zeros_like(ro) if g_out is None else g_out.contiguous()
        ct_res = [torch.zeros_like(floats[0]) if g is None else g.contiguous()
                  for g in g_res[:4]]
        d_table, d_ro, d_rd, d_ring = _launch_backward(
            scene, cfg, table, ro, rd, pix, pass_idx, sample_idx, _grids(floats, idx), ct,
            ct_res)
        need = ctx.needs_input_grad
        grads = (d_table, d_ro, d_rd, *d_ring)
        return (None,) * 6 + tuple(g if need[6 + i] else None for i, g in enumerate(grads))


def trace_forward_restir_fused(scene, cfg: RenderConfig, ro, rd, pix, pass_idx,
                               sample_idx, back: Reservoirs, hist1: Reservoirs,
                               hist2: Reservoirs):
    """Launch K6: (radiance f32[H, W, 3], new back Reservoirs).

    `ro`, `rd`: f32[H, W, 3] CUDA tensors; `pix`: int64[H, W] pixel ids of
    the [H, W] grid the reservoirs cover; `back`, `hist1`, `hist2`: the
    ring.  When a gradient is needed (the scene's parameters, its images,
    noise LUT or cubemap, the rays or the ring's float fields require grad)
    the launch is recorded as `_RestirCore`, whose backward launches K7,
    and the new reservoirs' light data is gathered from the scene
    (`light_data`).  Raises for what K6 (or, with a gradient, K7) does not
    cover, before any launch."""
    if ro.device.type != "cuda":
        raise ValueError(f"K6 runs on a CUDA device, got {ro.device}")
    return _fused(scene, cfg, ro, rd, pix, pass_idx, sample_idx, back, hist1, hist2)


def _fused(scene, cfg, ro, rd, pix, pass_idx, sample_idx, back, hist1, hist2):
    """`trace_forward_restir_fused` without the device check."""
    reason = unsupported_restir(scene, cfg)
    if reason is not None:
        raise NotImplementedError(f"K6 does not cover this scene: {reason}")
    table = megakernel.scene_table(scene)
    grids = (back, hist1, hist2)
    floats = [getattr(g, k) for g in grids for k in RING_FLOATS]
    inputs = (table, ro, rd, scene.images, scene.noise, scene.cubemap, *floats)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        reason = unsupported_restir_bwd(scene, cfg)
        if reason is not None:
            raise NotImplementedError(f"K7 does not cover this scene: {reason}")
        out, ws, m, w, age, idx = _RestirCore.apply(
            scene, cfg, pix, pass_idx, sample_idx, tuple(g.light_index for g in grids),
            table, ro, rd, *floats)
        pos, col = light_data(scene, idx)
        return out, Reservoirs(light_pos=pos, light_color=col, weight_sum=ws, m=m, w=w,
                               age=age, light_index=idx)
    return _launch(scene, cfg, ro, rd, pix, pass_idx, sample_idx, back, hist1, hist2,
                   table=table)


def render_sample_fused(scene, cfg: RenderConfig, camera, state, height, width,
                        pass_idx, time_s=0.0):
    """One ReSTIR pass on K6 (and, under a gradient, K7): (mean radiance
    f32[H, W, 3], new back Reservoirs), as `restir.render_sample` returns
    them."""
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
