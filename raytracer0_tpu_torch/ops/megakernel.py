"""The megakernel pair on Hopper: K1 (forward, `csrc/megakernel.cu`) and its
adjoint K2 (`csrc/megakernel_bwd.cu`), joined in a `torch.autograd.Function`.

K1 replaces the Pallas TPU kernels
`raytracer0_tpu/ops/megakernel.py::_fwd_kernel_body` (launched by
`_forward`), `_env_kernel_body` (launched by `_env_forward`,
photographic cubemaps), `_imgtex_kernel_body` (launched by
`_imgtex_forward`, image textures) and `_gloss_kernel_body` (launched by
`_gloss_launch`, image textures on a SPEC surface's glossiness): it
fetches the cubemap's and the images' texels itself, where the Pallas
kernels export records that the host resolves; a copy of it built for the
whole SDF class (`whole_sdf`) marches all 14 distances of `_sdf_distance`,
reads the texels of SDF hits and samples SDF-bound lights; its medium
copy (`medium`: hero-wavelength spectral transport and the homogeneous
medium of `_build_bounce`, over K1's whole class) draws the hero
wavelength, disperses negative-IOR glass by Cauchy's IOR, samples the
free path, the in-scatter NEE and the HG direction and fogs sphere-light
shadow rays, and `trace_forward` scales its radiance by the hero
wavelength's RGB weight after the launch, as the JAX `trace_forward`
does; K2 replaces
`_bwd_slotted_kernel_body` (launched by `_backward`) and computes the same
outputs as its whole-trace twin `_bwd_kernel_body`.  `_TraceCore` pairs
them as the JAX `_trace_core` custom_vjp does: forward launches K1,
backward launches K2.  K1 covers the class that `integrator.unsupported`
states without ReSTIR (every surface material, textures of all ten types
on analytic and SDF meshes, sphere, directional and SDF lights, cubemaps,
uniform sampling, SDF meshes of every shape, spectral transport and the
medium: `unsupported`; a ReSTIR pass runs on K6, `ops/restir_kernel.py`);
K2 covers the same class (`unsupported_bwd`) in four copies
(`bwd_copy`): the Cornell copy (analytic DIFF and LIGHT meshes, no
texture, sphere-light slots, no
cubemap, cosine sampling: `cornell_copy`), the whole-SDF copy for the
scenes K1 runs its own whole-SDF copy on (`whole_sdf`: every SDF shape's
distance adjoint, the texel of an SDF hit, SDF-light NEE), the medium
copy for every scene under spectral transport or the medium (`medium`:
the whole-SDF copy with the adjoints of Cauchy's IOR at the hero
wavelength, the medium event with its in-scatter NEE and HG direction and
the fog on sphere-light shadow rays, a library of its own) and the wide
copy for the rest, each with its set of scene-table columns that have a
cotangent (`bwd_columns`).  `trace_forward` scales the radiance by the
hero wavelength's RGB weight outside the kernels on both routes, so K2
receives the cotangent already scaled, as the JAX adjoint does.  Their
plain PyTorch version is `render/integrator.py::trace` (K1) and its
`torch.autograd` backward (K2);
on the same inputs K1 traces the same paths, pixel for pixel, and K2
gives the same gradients up to float32 rounding.

What bounds them on the H100: a pixel reads 28 bytes and writes 12 (K2: 40
and 24), so neither is memory-bound.  They are latency- and
divergence-bound: a long, data-dependent bounce loop per pixel, a scan over
every mesh per ray and one shadow ray per light per bounce, and paths that
end at different depths.  The design keeps one thread per pixel with the
whole bounce loop in registers, lets each thread leave the loop when its
path ends (exact, because the counter RNG keys on depth), and keeps the
scene table, the type codes and the light slots in shared memory, read by
all threads of a warp at once; every ray scans the meshes through packed
float4 records.  K2 stashes the carry entering each slot and the hit its
ray found in local memory and replays the slots newest first through a
hand-derived adjoint (`csrc/adjoint.cuh`: every BSDF's direction, the SDF
distances and the implicit t of an SDF hit, the cubemap fetch, the texels
and their blend), without scanning a slot's ray again; it sums the
scene-table cotangents in shared memory, in a column per thread for a few
meshes and per warp for many (`bwd_layout`: lanes grouped by mesh,
summed over a fixed tree), per block in column order and across blocks in
a second, fixed-order kernel, so its result is deterministic.

The kernels are built with nvcc on first use (`cuda_build`) and launched
through ctypes on PyTorch's current stream.  On CPU tensors
`trace_forward` is the plain version and plain autograd gives the
gradient; on CUDA tensors it launches the kernels or raises, forward and
backward alike.  A gradient on CUDA for a scene outside K2's class, or
w.r.t. a texel array, raises before anything is launched; it never runs
the plain backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.config import RenderConfig
from raytracer0_tpu_torch.models.materials import MatType, SdfShape, TexType
from raytracer0_tpu_torch.ops import cuda_build, lighting, spectral, textures
from raytracer0_tpu_torch.render import integrator

#: K1 launches since import (or since a caller reset it to 0).
LAUNCHES = 0
#: K2 launches since import (or since a caller reset it to 0); one per
#: backward of `trace_forward`, adjoint and partial-sum reduction together.
BWD_LAUNCHES = 0
#: launches of K2's medium copy since import (or since a caller reset it
#: to 0), each counted in BWD_LAUNCHES too.
BWD_MEDIUM_LAUNCHES = 0

SOURCES = ("megakernel.cu",)
BWD_SOURCES = ("megakernel_bwd.cu",)
# K2's whole-SDF copy: the same source built alone (RT0_K2_WHOLE_SDF), a
# library of its own that nvcc compiles beside the other two copies'
BWD_SDF_SOURCES = ("megakernel_bwd_sdf.cu",)
# K2's medium copy: the same source built alone (RT0_K2_MEDIUM), whose
# launcher takes K1's medium arguments
BWD_MEDIUM_SOURCES = ("megakernel_bwd_medium.cu",)
_NCOLS = 36
# dynamic shared memory one block may take without an opt-in attribute
_SMEM_LIMIT = 48 * 1024
# K2: stash depth (MAX_SLOTS in megakernel_bwd.cu) and the block size
MAX_SLOTS = 16
BWD_THREADS = 128

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
    _c_void_p, _c_int, _c_int,                    # cubemap, its height, width
    _c_int, _c_int,                               # use_cubemap, use_biased
    _c_void_p, _c_void_p,                         # tex codes, blend flags
    _c_void_p, _c_int, _c_int,                    # images, their height, width
    _c_void_p, _c_int, _c_int,                    # noise LUT, its size, use_tex
    _c_void_p, _c_int, _c_int,                    # SDF shapes, n_analytic, n_sdf
    _c_int, _c_float, _c_float,                   # marching steps, fudge, t0
    _c_void_p,                                    # stream
)
# K1's own: the shared ones, then the medium copy's flags and constants
_FWD_ARGTYPES = _ARGTYPES[:-1] + (
    _c_int, _c_int,                               # use_spectral, use_volumetrics
    _c_float, _c_float, _c_float,                 # sigma_t, sigma_s / sigma_t, eps * 20
    _c_float, _c_float, _c_float, _c_float,       # g, 1 + g^2, 2 g, 1 - g^2
    _c_void_p,                                    # stream
)
_BWD_ARGTYPES = _ARGTYPES[:-1] + (            # K1's (out unused), then
    _c_void_p, _c_void_p, _c_void_p,              # ct, d_ro, d_rd
    _c_void_p, _c_void_p,                         # partials, d_table
    ctypes.c_ulonglong, _c_int,                   # column mask, wide copy
    _c_int, _c_void_p,                            # threads per block, stream
)
# the medium copy's: the same, then K1's medium arguments before the stream
_BWD_MEDIUM_ARGTYPES = _BWD_ARGTYPES[:-1] + _FWD_ARGTYPES[len(_ARGTYPES) - 1:]


def scene_table(scene):
    """The scene's parameters packed f32[n_mesh, 36], in the columns of the
    JAX `_scene_table`: pos 0:3, joker 3:7, color 7:10, emission 10:13,
    ior 13, aux 14:26, tex_params 26:30, tex_cmask 30:33, tex_emask 33:36."""
    return torch.cat([scene.pos, scene.joker, scene.color, scene.emission,
                      scene.ior[:, None], scene.aux, scene.tex_params,
                      scene.tex_cmask, scene.tex_emask], dim=1).contiguous()


def smem_bytes(scene) -> int:
    """Dynamic shared memory of one K1 block: the table, the mesh and
    material codes, the light slots, the texture codes and blend flags,
    and the SDF rows' shapes (`path.cuh::path_smem_bytes`)."""
    return 4 * (scene.num_meshes * _NCOLS + 4 * scene.num_meshes
                + scene.num_lights + scene.num_sdfs)


def packed_smem_bytes(scene) -> int:
    """Dynamic shared memory of one K1 or K4 block: `smem_bytes`, aligned
    to 16 bytes, then the packed scan's record ends, float4 record and
    table row per mesh and gate radius per SDF row
    (`trace_common.cuh::packed_smem_bytes`)."""
    return -(-smem_bytes(scene) // 16) * 16 + 4 * (4 + 5 * scene.num_meshes + scene.num_sdfs)


def check_smem(nbytes: int) -> Optional[str]:
    if nbytes > _SMEM_LIMIT:
        return (f"the scene table needs {nbytes} bytes of shared memory, more "
                f"than {_SMEM_LIMIT}")
    return None


def unsupported(scene, cfg: RenderConfig) -> Optional[str]:
    """Why K1 cannot render (scene, cfg), or None when it can: the class
    of `integrator.unsupported` without ReSTIR (spectral transport and the
    medium in its medium copy), with a table that fits the shared
    memory."""
    if cfg.use_restir:
        # K1 has no reservoir vertex: it would render per-light NEE
        return ("a ReSTIR pass and its gradient run on K6 and K7 "
                "(ops/restir_kernel.py, ROADMAP queue 1 item 11), not K1")
    return integrator.unsupported(scene, cfg) or check_smem(packed_smem_bytes(scene))


def bwd_slots(scene, cfg: RenderConfig) -> int:
    """The most bounce slots a path runs on (scene, cfg), hence K2's stash
    depth.  On the Cornell copy (`cornell_copy`) every slot that does not
    end the path is a diffuse bounce, and the path stops once
    `max_diff_bounces` of them ran; elsewhere each such slot adds one to
    one of the three bounce counters (diffuse, specular, scattering), and
    the path stops once one of them reaches its cap.  Either way it stops
    at `max_bounces`."""
    if cornell_copy(scene, cfg):
        return min(cfg.max_bounces, max(cfg.max_diff_bounces, 1) + 1)
    caps = (cfg.max_diff_bounces, cfg.max_spec_bounces, cfg.max_scattering_events)
    return min(cfg.max_bounces, sum(max(c, 1) - 1 for c in caps) + 1)


_K2_MATS = (int(MatType.DIFF), int(MatType.LIGHT))
_K2_ITEM = "ROADMAP queue 1 item 14"
# scene-table columns (scene_table): pos 0:3, joker 3:7, color 7:10,
# emission 10:13, ior 13, tex_params 26:30, tex_cmask 30:33, tex_emask 33:36
_CORNELL_COLS = (0, 1, 2, 3, 7, 8, 9, 10, 11, 12)
# texture types whose params reach the texel with a gradient: CHECK and
# RIPPLE (the divisor of their remainder), the noise types (their scale)
_PARAM_TEX = (int(TexType.CHECK), int(TexType.RIPPLE), int(TexType.GRADIENT_NOISE),
              int(TexType.VALUE_NOISE), int(TexType.METAL))
# the joker components (table columns 3 + k) and the count of aux entries
# (columns 14 + k) that each SDF shape's distance reads (ops/sdf.py); a BOX
# keeps joker.w's column too, as the wide copy has since it served BOX and
# ROUND_BOX rows alone (a column no add reaches is 0), so those scenes keep
# their layout
_S = SdfShape
_SDF_JOKER = {int(_S.BOX): (0, 1, 2, 3), int(_S.ROUND_BOX): (0, 1, 2, 3), int(_S.SPHERE): (0,),
              int(_S.TRI_PRISM): (0, 1), int(_S.CONE): (0, 1, 2),
              int(_S.MENGER_SPONGE): (0, 1, 2), int(_S.MANDELBULB): (),
              int(_S.ELLIPSOID): (0, 1, 2), int(_S.CAPSULE): (0, 1, 2, 3),
              int(_S.SNOWBALL): (0,), int(_S.SEA_BOX): (0, 1, 2, 3), int(_S.SIGGRAPH): (),
              int(_S.TRIANGLE): (), int(_S.QUAD): ()}
_SDF_AUX = {**{s: 0 for s in _SDF_JOKER}, int(_S.TRIANGLE): 9, int(_S.QUAD): 12}


def medium(cfg: RenderConfig) -> bool:
    """Whether K1 and K2 run their medium copies: hero-wavelength spectral
    transport or the homogeneous medium is on."""
    return bool(cfg.use_spectral or cfg.use_volumetrics)


def cornell_copy(scene, cfg: RenderConfig) -> bool:
    """Whether K2 runs its Cornell copy on (scene, cfg): analytic DIFF and
    LIGHT meshes, no texture, LIGHT-sphere slots, no cubemap, cosine
    sampling, neither spectral transport nor the medium, 10 cotangent
    columns a mesh.  Anything else in K2's class
    runs the wide copy, which takes 2.6x the Cornell copy's time on Cornell
    (PERF.md §6)."""
    return (not scene.num_sdfs and not medium(cfg)
            and all(m in _K2_MATS for m in scene.mat_types_static)
            and all(li < 0 or lighting.slot_kind(scene, slot) == "sphere"
                    for slot, li in enumerate(scene.lights_static))
            and not cfg.use_cubemap and not scene.tex_types_used
            and cfg.use_biased_sampling)


def bwd_columns(scene, cfg: RenderConfig) -> tuple[int, ...]:
    """The scene-table columns K2 keeps a cotangent for on (scene, cfg),
    in table order: Cornell's 10 (pos, joker.x, color, emission), and in
    the wide copy also the joker and aux columns that the scene's SDF rows
    read (`_SDF_JOKER`, `_SDF_AUX`; an SDF light's sample reads its joker
    0:3), the IOR under refraction, a texture's params (CHECK, RIPPLE and
    the noise types; a shadow ray reads the texel of any mesh it hits),
    and the color and emission masks where a mesh blends its texel into
    its color or emission.  The medium copy keeps the wide copy's columns:
    its in-scatter NEE and fog reach a light sphere's pos, joker.x, color
    and emission, Cauchy's IOR a refractor's column 13.  No other column
    has a gradient in this class."""
    return _CORNELL_COLS if cornell_copy(scene, cfg) else wide_columns(scene)


def wide_columns(scene) -> tuple[int, ...]:
    """The columns of `bwd_columns` beyond the Cornell copy, which depend
    on the scene alone; K7's whole-SDF copy keeps them too
    (`restir_kernel.bwd_columns`)."""
    cols = set(_CORNELL_COLS)
    na = scene.num_analytic
    for shape in scene.sdf_shapes_static:
        cols |= {3 + k for k in _SDF_JOKER[shape]} | {14 + k for k in range(_SDF_AUX[shape])}
    if any(li >= na for li in scene.lights_static):
        cols |= {3, 4, 5}
    if any(m in (int(MatType.REFR_FRESNEL), int(MatType.REFR_SCHLICK))
           for m in scene.mat_types_static):
        cols.add(13)
    blends = [(t, c, e) for t, (c, e, *_) in zip(scene.tex_types_static, scene.opts_static)
              if t != int(TexType.NONE) and (c or e)]
    # a shadow ray reads the texel of the mesh it hits whatever its flags
    if any(t in _PARAM_TEX for t in scene.tex_types_static):
        cols |= {26, 27, 28, 29}
    if any(c for _, c, _ in blends):
        cols |= {30, 31, 32}
    if any(e for _, _, e in blends):
        cols |= {33, 34, 35}
    return tuple(sorted(cols))


def bwd_copy(scene, cfg: RenderConfig) -> str:
    """The copy of K2 that runs (scene, cfg): "medium" (spectral transport
    or the medium, `medium`: the whole-SDF copy with the adjoints of the
    hero wavelength, Cauchy's IOR, the medium event and the fog, over K1's
    whole class, a library of its own), "cornell" (`cornell_copy`),
    "whole_sdf" (K1's whole-SDF class, `whole_sdf`: every SDF shape,
    textured SDF rows, SDF lights) or "wide" (the rest).  The last three
    share two libraries, which pick the copy from their `wide` argument and
    `use_tex` bit 2 (`tex_flags`)."""
    if medium(cfg):
        return "medium"
    if cornell_copy(scene, cfg):
        return "cornell"
    return "whole_sdf" if whole_sdf(scene) else "wide"


def _cols_mask(cols) -> int:
    return sum(1 << c for c in cols)


def bwd_layout(scene, cfg: RenderConfig, threads: int = BWD_THREADS,
               fn=None) -> tuple[bool, int]:
    """How K2's launcher lays out a block of `threads` threads for (scene,
    cfg) on the current device, as the library says
    (`rt0_trace_backward_layout` of `fn`'s library, else of the built one),
    for the copy K2 runs and its columns (`cornell_copy`, `bwd_columns`):
    whether each warp, not each thread, keeps a column of cotangent
    accumulators (where 3 blocks of per-thread columns would not fit an
    SM's shared memory), and the block's dynamic shared memory in bytes."""
    if fn is None:
        lib = cuda_build.load(*bwd_library(bwd_copy(scene, cfg)))[0]
        fn = lib.rt0_trace_backward_layout
    fn.argtypes = (_c_int, _c_int, _c_int, ctypes.c_ulonglong, _c_int, _c_int,
                   ctypes.c_void_p)
    fn.restype = _c_int
    out = (_c_ll * 2)()
    rc = fn(scene.num_meshes, scene.num_lights, scene.num_sdfs,
            _cols_mask(bwd_columns(scene, cfg)), int(not cornell_copy(scene, cfg)), threads, out)
    if rc != 0:
        raise RuntimeError(f"rt0_trace_backward_layout failed: CUDA error {rc}")
    return bool(out[0]), int(out[1])


def _texel_leaves(scene) -> tuple[str, ...]:
    """The texel arrays of the scene (images, the noise LUT, the cubemap)
    that require a gradient."""
    return tuple(k for k in ("images", "noise", "cubemap") if getattr(scene, k).requires_grad)


def unsupported_bwd(scene, cfg: RenderConfig) -> Optional[str]:
    """Why K2 cannot differentiate (scene, cfg), or None when it can: K1's
    whole class (`unsupported`: every surface material, textures on
    analytic and SDF meshes, sphere, directional and SDF lights, cubemaps,
    uniform sampling, SDF meshes of every shape, hero-wavelength spectral
    transport and the homogeneous medium in its medium copy, a table that
    fits the shared memory; ReSTIR runs on K6 and K7, which refuse both
    flags), with a stash of at most MAX_SLOTS slots.  K2 gives the
    cotangents of the scene table and of the rays; a gradient asked of a texel array
    (the images, the noise LUT, the cubemap), which the JAX package also
    computes outside its kernels, is refused.  On many meshes K2 keeps a
    column of cotangent accumulators per warp (`bwd_layout`), so any table
    K1 takes fits."""
    if cfg.use_restir:
        return ("gradients through ReSTIR run on K7 (ops/restir_kernel.py, "
                "ROADMAP queue 1 item 11), not K2")
    reason = unsupported(scene, cfg)
    if reason is None and _texel_leaves(scene):
        reason = (f"a gradient w.r.t. the texel arrays {', '.join(_texel_leaves(scene))} "
                  f"(K2 differentiates the scene table and the rays): {_K2_ITEM}")
    if reason is None and bwd_slots(scene, cfg) > MAX_SLOTS:
        reason = (f"paths of {bwd_slots(scene, cfg)} slots, more than K2's stash of "
                  f"{MAX_SLOTS}")
    return reason


def build():
    """Build (or load from `build/kernels/`) the K1 library.
    Returns (ctypes function, cuda_build.BuildInfo)."""
    lib, info = cuda_build.load("megakernel", SOURCES)
    fn = lib.rt0_trace_forward
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn, info


def bwd_library(copy: str = "wide") -> tuple[str, tuple[str, ...]]:
    """(name, sources) of the K2 library that holds the copy `copy`
    (`bwd_copy`): the whole-SDF copy and the medium copy each have a
    library of their own, the Cornell and wide copies share one."""
    if copy == "whole_sdf":
        return "megakernel_bwd_sdf", BWD_SDF_SOURCES
    if copy == "medium":
        return "megakernel_bwd_medium", BWD_MEDIUM_SOURCES
    return "megakernel_bwd", BWD_SOURCES


def build_bwd():
    """Build (or load from `build/kernels/`) the K2 library of its Cornell
    and wide copies.  Returns (ctypes function, cuda_build.BuildInfo)."""
    return _bind_bwd(*cuda_build.load(*bwd_library()))


def build_bwd_sdf():
    """Build (or load from `build/kernels/`) the K2 library of its
    whole-SDF copy.  Returns (ctypes function, cuda_build.BuildInfo)."""
    return _bind_bwd(*cuda_build.load(*bwd_library("whole_sdf")))


def build_bwd_medium():
    """Build (or load from `build/kernels/`) the K2 library of its medium
    copy.  Returns (ctypes function, cuda_build.BuildInfo)."""
    return _bind_bwd(*cuda_build.load(*bwd_library("medium")), _BWD_MEDIUM_ARGTYPES)


def _bind_bwd(lib, info, argtypes=_BWD_ARGTYPES):
    fn = lib.rt0_trace_backward
    fn.argtypes = argtypes
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


def _tex_args(scene, device):
    """K1's texture arguments: the TexType codes, the blend flags (bit 0
    color, bit 1 emission), the images and the noise LUT, checked."""
    images, lut = scene.images, scene.noise
    _check("images", images, torch.float32, (4,) + tuple(images.shape[1:3]) + (4,), device)
    _check("noise", lut, torch.float32, (lut.shape[0], lut.shape[0], 4), device)
    tex = scene.tex_type.to(torch.int32).contiguous()
    opts = scene.opts.to(torch.int32)
    blend = (opts[:, 0] + 2 * opts[:, 1]).contiguous()
    return (tex, blend, images, lut)


def _cfg_args(cfg: RenderConfig, pass_idx, sample_idx):
    return (int(pass_idx) & 0xFFFFFFFF, int(sample_idx) & 0xFFFFFFFF,
            cfg.max_bounces, cfg.max_diff_bounces, cfg.max_spec_bounces,
            cfg.max_scattering_events, cfg.epsilon, cfg.infinity,
            int(cfg.sample_lights), int(cfg.use_mis), int(cfg.use_procedural_sky))


def whole_sdf(scene) -> bool:
    """Whether K1 runs its copy for the whole SDF class on `scene`: an SDF
    row of a shape other than BOX and ROUND_BOX, with a texture blended
    into its color or emission, or in a light slot
    (`integrator.outside_box_sdf`).  Every other scene runs the copies
    built without them."""
    return integrator.outside_box_sdf(scene, "K1") is not None


def tex_flags(scene) -> int:
    """The kernels' `use_tex`: bit 0 when some mesh blends a texture into
    its color or emission, bit 1 when some LIGHT mesh has a texture, whose
    texel NEE blends into the color of a shadow ray's hit (K1 and K2 run
    a copy without that blend where bit 1 is clear), bit 2 when K1 runs
    its copy for the whole SDF class (`whole_sdf`; the other kernels
    refuse such scenes)."""
    light_tex = any(t != int(TexType.NONE) and m == int(MatType.LIGHT)
                    for t, m in zip(scene.tex_types_static, scene.mat_types_static))
    return int(textures.blended(scene)) | 2 * int(light_tex) | 4 * int(whole_sdf(scene))


def forward_args(scene, cfg, table, ro, rd, pix, out, pass_idx, sample_idx):
    """K1's launch arguments before the stream, checked: (the arguments,
    the tensors they point into, which the caller keeps alive until the
    launch).  K6 and K7 take the same ones first (K7 with `out` None)."""
    h, w = pix.shape
    mesh, mat, lights = _codes(scene)
    cube = scene.cubemap
    _check("cubemap", cube, torch.float32, (6,) + tuple(cube.shape[1:3]) + (3,),
           ro.device)
    tex, blend, images, lut = _tex_args(scene, ro.device)
    sdf = scene.sdf_shape[scene.num_analytic:].to(torch.int32).contiguous()
    args = (table.data_ptr(), mesh.data_ptr(), mat.data_ptr(),
            scene.num_meshes, lights.data_ptr(), scene.num_lights,
            ro.data_ptr(), rd.data_ptr(), pix.data_ptr(),
            None if out is None else out.data_ptr(),
            h * w, *_cfg_args(cfg, pass_idx, sample_idx),
            cube.data_ptr(), cube.shape[1], cube.shape[2],
            int(cfg.use_cubemap), int(cfg.use_biased_sampling),
            tex.data_ptr(), blend.data_ptr(), images.data_ptr(),
            images.shape[1], images.shape[2], lut.data_ptr(), lut.shape[0],
            tex_flags(scene), sdf.data_ptr(), scene.num_analytic,
            scene.num_sdfs, cfg.marching_steps, cfg.fudge_factor,
            float(np.float32(cfg.epsilon * 4.0)))
    return args, (mesh, mat, lights, tex, blend, sdf)


def medium_args(cfg: RenderConfig) -> tuple:
    """K1's medium arguments: the two flags, then σt, σs/σt, the in-scatter
    shadow ray's offset 20 eps, g (which the HG sampler takes in float32),
    and the HG phase's 1 + g², 2g and 1 - g², each formed in double and
    rounded to float32 once, as the plain version forms them."""
    g = cfg.vol_g
    return (int(cfg.use_spectral), int(cfg.use_volumetrics), cfg.vol_sigma_t,
            cfg.vol_sigma_s / cfg.vol_sigma_t, cfg.epsilon * 20.0, g,
            1.0 + g * g, 2.0 * g, 1.0 - g * g)


def _launch_forward(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx):
    """Launch K1: radiance f32[H, W, 3], before the spectral RGB scale."""
    global LAUNCHES
    out = torch.empty_like(ro)
    args, _keep = forward_args(scene, cfg, table, ro, rd, pix, out, pass_idx,
                               sample_idx)
    fn, _ = build()
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        rc = fn(*args, *medium_args(cfg), stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def _launch_backward(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx, ct):
    """Launch K2 for the radiance cotangent `ct`: (d_table, d_ro, d_rd).
    The copy's library (`bwd_copy`, `bwd_library`) holds the kernel; the
    medium copy's launcher takes K1's medium arguments too."""
    global BWD_LAUNCHES, BWD_MEDIUM_LAUNCHES
    reason = unsupported_bwd(scene, cfg)
    if reason is not None:
        raise NotImplementedError(f"K2 does not cover this scene: {reason}")
    h, w = pix.shape
    dev = ro.device
    _check("ct", ct, torch.float32, (h, w, 3), dev)
    threads = BWD_THREADS
    blocks = -(-(h * w) // threads)
    cols = bwd_columns(scene, cfg)
    args, _keep = forward_args(scene, cfg, table, ro, rd, pix, None, pass_idx, sample_idx)
    d_ro, d_rd = torch.empty_like(ro), torch.empty_like(rd)
    partials = torch.empty((blocks, scene.num_meshes, len(cols)),
                           dtype=torch.float32, device=dev)
    d_table = torch.empty_like(table)
    copy = bwd_copy(scene, cfg)
    fn, _ = {"whole_sdf": build_bwd_sdf, "medium": build_bwd_medium}.get(copy, build_bwd)()
    extra = medium_args(cfg) if copy == "medium" else ()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, ct.data_ptr(), d_ro.data_ptr(), d_rd.data_ptr(), partials.data_ptr(),
                d_table.data_ptr(), _cols_mask(cols), int(not cornell_copy(scene, cfg)),
                threads, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    BWD_MEDIUM_LAUNCHES += copy == "medium"
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
    gradient is needed (the scene's parameters, its images, noise LUT or
    cubemap, `ro` or `rd` require grad) the call is recorded as
    `_TraceCore` and its backward launches K2, or it raises when K2 does
    not cover the scene or a texel array requires grad.
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
    inputs = (table, ro, rd, scene.images, scene.noise, scene.cubemap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        reason = unsupported_bwd(scene, cfg)
        if reason is not None:
            raise NotImplementedError(f"K2 does not cover this scene: {reason}")
        out = _TraceCore.apply(table, ro, rd, scene, cfg, pix, pass_idx, sample_idx)
    else:
        out = _launch_forward(scene, cfg, table, ro, rd, pix, pass_idx, sample_idx)
    # outside the kernels on both routes, as the JAX `trace_forward` applies
    # it, so K2 receives the cotangent already scaled (the plain version on
    # the CPU applies it itself)
    return out * spectral_rgb(pix, pass_idx, sample_idx) if cfg.use_spectral else out


def spectral_rgb(pix, pass_idx, sample_idx):
    """The RGB weight f32[H, W, 3] of each pixel's hero wavelength
    (`spectral.wavelength_to_rgb` of the WAVELENGTH draw), a constant of
    the RNG alone, which scales K1's radiance under spectral transport."""
    return spectral.wavelength_to_rgb(spectral.sample_wavelength(
        rng.uniform(pix, pass_idx, sample_idx, rng.Stream.WAVELENGTH)))
