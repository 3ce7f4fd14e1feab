"""Progressive renderer: the frame/pass loop (port of render/renderer.py).

Each pass traces `samples_per_pass` radiance samples per pixel and adds
their mean into the accumulator.  `_route` decides where a pass runs: on a
CUDA device through the K1 kernel (`ops/megakernel.py`), on the CPU
through the plain integrator.  A CUDA device with a (scene, cfg) the
kernel does not cover raises; it never falls back to the plain version.

`sample_radiance` and `render_pass` are differentiable on both devices:
the pass is a sum of `trace_fn` calls, so a loss on the image
back-propagates to the scene's parameters (and to the camera, through the
rays) by the plain integrator's autograd on the CPU and by K2, the adjoint
kernel behind `megakernel.trace_forward`, on CUDA.  A render that needs
no gradient launches K1 alone.

The kernel masks the ragged edge itself, so no padding to a block shape is
needed.  `render_scan` (one launch for a chain of passes) waits for a CUDA
graph port.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer0_tpu_torch.config import RenderConfig, RenderMode
from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.models import scene as scene_mod
from raytracer0_tpu_torch.models.camera import Camera, generate_rays
from raytracer0_tpu_torch.ops import megakernel, tonemap
from raytracer0_tpu_torch.render import integrator
from raytracer0_tpu_torch.render.state import RenderState


def _route(device_type: str, scene, cfg: RenderConfig) -> str:
    """"kernel" or "plain": where a pass of (scene, cfg) runs on a device of
    this type.  Raises NotImplementedError for what neither covers on it."""
    if int(cfg.render_mode) != int(RenderMode.STATIC):
        raise NotImplementedError(
            "ANIMATED render mode is not ported yet: ROADMAP queue 1 item 12")
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
    pass's radiance into the accumulator."""
    radiance = sample_radiance(scene, cfg, camera, height, width,
                               state.passes, time_s)
    return state.replace(accum=state.accum + radiance, passes=state.passes + 1)


def display_image(state: RenderState, cfg: RenderConfig):
    """Tonemapped [0,1] image from the accumulated sum (tonemapper.glsl:30-32;
    u_cont = 1/passes, an f32 division as the JAX package computes it)."""
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
