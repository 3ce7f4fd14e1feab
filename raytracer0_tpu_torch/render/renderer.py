"""Progressive renderer: the frame/pass loop (port of render/renderer.py).

Each pass traces `samples_per_pass` radiance samples per pixel.  Under
STATIC accumulation their mean is added into the accumulator; under
ANIMATED (the real-time mode) the accumulator is an exponential moving
average over `cfg.temporal_frames` frames, the scene is animated to the
pass's `time_s` first (`scene.animate_positions`) and the display shows
the average itself.  `_route` decides where a pass runs: on a
CUDA device through the K1 kernel (`ops/megakernel.py`), on the CPU
through the plain integrator.  A CUDA device with a (scene, cfg) the
kernel does not cover raises; it never falls back to the plain version.

`sample_radiance` and `render_pass` are differentiable: the pass is a sum
of `trace_fn` calls, so a loss on the image back-propagates to the scene's
parameters (and to the camera, through the rays).  On the CPU the plain
integrator's autograd serves every class the integrator renders.  On CUDA
K2, the adjoint kernel behind `megakernel.trace_forward`, serves the whole
class K1 renders without ReSTIR (every material, directional lights,
uniform sampling, SDF meshes of every shape, the cubemap, textures,
hero-wavelength spectral transport and the homogeneous medium, the last
two in its medium copy), with respect to the scene table and the rays; a gradient w.r.t. a texel
array (the images, the noise LUT, the cubemap) raises NotImplementedError
before anything is launched (`megakernel.unsupported_bwd`).  A render that
needs no gradient launches K1 alone.

A ReSTIR pass (`cfg.use_restir`) goes through `render_pass` alone, since
it reads and writes the reservoir ring: on a CUDA device through the
ReSTIR pass K6 (`ops/restir_kernel.py`: the G-buffer kernel K4, then the
reservoir-vertex kernel K6v), or, with `cfg.restir_adhoc_motion`, through
the split path (`ops/restir_split.py`: K4, then K6v's split form), as the
JAX package routes it, K4 and K6v each in its whole-SDF copy for SDF rows
beyond BOX and ROUND_BOX or textured (`megakernel.whole_sdf`); on the CPU
through the plain `restir.render_sample`; after which the ring rotates.
It is differentiable too: on CUDA K6's adjoint K7 computes the gradient
(with respect to the scene, the rays and the ring's float fields, so it
flows from pass to pass) over K6's class, in its whole-SDF copy for SDF
rows beyond ROUND_BOX or blended textures (`restir_kernel.bwd_copy`), on
the CPU the plain version's autograd.  On CUDA a ReSTIR
config that K6 does not cover, or a gradient outside K7's class, raises
before any launch; nothing falls back to the plain version.  The split
path has no adjoint (the JAX one has none): a gradient through it raises
on CUDA before any launch.

The kernels mask the ragged edge themselves, so no padding to a block shape
is needed.  `render_scan` (one launch for a chain of passes) waits for a
CUDA graph port.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer0_tpu_torch.config import RenderConfig, RenderMode
from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.models import scene as scene_mod
from raytracer0_tpu_torch.models.camera import Camera, generate_rays
from raytracer0_tpu_torch.ops import megakernel, restir, restir_kernel, restir_split, tonemap
from raytracer0_tpu_torch.render import integrator
from raytracer0_tpu_torch.render.state import RenderState


def _route(device_type: str, scene, cfg: RenderConfig) -> str:
    """"kernel" or "plain": where a pass of (scene, cfg) runs on a device of
    this type.  Raises NotImplementedError for what neither covers on it."""
    if cfg.use_restir:
        # a ReSTIR pass reads and writes the reservoir ring: render_pass
        raise NotImplementedError(
            "sample_radiance renders no ReSTIR pass (render_pass, Renderer and "
            "optimize.render_linear carry the reservoir ring: ROADMAP queue 1 item 11)")
    if device_type == "cuda":
        reason = megakernel.unsupported(scene, cfg)
        if reason is not None:
            raise NotImplementedError(f"no CUDA kernel for this scene: {reason}")
        return "kernel"
    if device_type == "cpu":
        return "plain"
    raise NotImplementedError(f"unsupported device type {device_type!r}")


def sample_radiance(scene, cfg: RenderConfig, camera: Camera,
                    height: int, width: int, pass_idx, time_s=0.0):
    """Trace all samples of one pass; returns mean radiance f32[H, W, 3] on
    the scene's device.  (Bands of a taller image, `row0`/`full_height`,
    come with the tile renderer, ROADMAP queue 1 item 12.)"""
    route = _route(scene.device.type, scene, cfg)
    scene = scene_mod.animate_positions(scene, time_s, int(cfg.render_mode))
    pix = rng.pixel_ids(height, width, device=scene.device)
    trace_fn = megakernel.trace_forward if route == "kernel" else integrator.trace

    total = torch.zeros((height, width, 3), dtype=torch.float32,
                        device=scene.device)
    for s in range(cfg.samples_per_pass):
        ro, rd = generate_rays(camera, height, width, pass_idx, sample_idx=s)
        total = total + trace_fn(scene, cfg, ro, rd, pix, pass_idx, s)
    return total / cfg.samples_per_pass


def render_pass(scene, camera: Camera, cfg: RenderConfig, state: RenderState,
                height: int, width: int, time_s=0.0) -> RenderState:
    """One progressive pass (the reference's per-frame draw): adds one
    pass's radiance into the accumulator, or under ANIMATED mixes it into
    the moving average; a ReSTIR pass also rotates the reservoir ring
    (raytracer0_tpu/render/renderer.py:210-243)."""
    if cfg.use_restir:
        if scene.device.type == "cuda":
            render_fn = (restir_split.render_sample_fast if cfg.restir_adhoc_motion
                         else restir_kernel.render_sample_fused)
        elif scene.device.type == "cpu":
            render_fn = restir.render_sample
        else:
            raise NotImplementedError(f"unsupported device type {scene.device.type!r}")
        radiance, new_back = render_fn(scene, cfg, camera, state, height, width,
                                       state.passes, time_s)
        state = state.rotate_reservoirs(new_back)
    else:
        radiance = sample_radiance(scene, cfg, camera, height, width,
                                   state.passes, time_s)
    if int(cfg.render_mode) == int(RenderMode.ANIMATED):
        accum = state.accum + (radiance - state.accum) * (1.0 / cfg.temporal_frames)
    else:
        accum = state.accum + radiance
    return state.replace(accum=accum, passes=state.passes + 1)


def display_image(state: RenderState, cfg: RenderConfig):
    """Tonemapped [0,1] image from the accumulator (tonemapper.glsl:30-32;
    u_cont = 1/passes, an f32 division as the JAX package computes it, for
    the STATIC sum and 1 for the ANIMATED average, index.js:1083-1089)."""
    if int(cfg.render_mode) == int(RenderMode.ANIMATED):
        cont = np.float32(1.0)
    else:
        cont = np.float32(1.0) / np.float32(max(state.passes, 1))
    return tonemap.display(state.accum, float(cont), cfg)


class Renderer:
    """Owns (scene, camera, config, image size) and the accumulator; the
    scene's device is the render device."""

    def __init__(self, scene, camera: Camera, cfg: RenderConfig,
                 height: int, width: int):
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.height = height
        self.width = width
        self.state = RenderState.create(height, width, device=scene.device)

    def reset(self):
        """The accumulator clear on camera/scene edits."""
        self.state = RenderState.create(self.height, self.width,
                                        device=self.scene.device)

    def step(self, time_s: float = 0.0):
        self.state = render_pass(self.scene, self.camera, self.cfg,
                                 self.state, self.height, self.width, time_s)
        return self.state

    def render(self, passes: int, time_s: float = 0.0):
        """Batch render of `passes` passes; returns the display image."""
        for _ in range(passes):
            self.step(time_s)
        return self.image()

    def image(self):
        return display_image(self.state, self.cfg)
