"""Scene presets (port of models/presets.py: `_cfg`, `cornell_default` and
`cubemap_demo`).

Each preset returns `(scene, camera, config)`.  The other presets of the
JAX package come with the slices that add their features (ROADMAP queue 1
items 8-11).
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer0_tpu_torch.config import OFFLINE_CONFIG, RenderConfig
from raytracer0_tpu_torch.models.camera import Camera
from raytracer0_tpu_torch.models.dsl import parse_scene


def _cfg(base: RenderConfig = OFFLINE_CONFIG, **kw) -> RenderConfig:
    return base.replace(**kw)


def cornell_default(device="cuda", **cfg_kw):
    """The viewport's built-in Cornell box (index.js:54-95): 5 planes,
    sphere light, two boxes; procedural-sky define on but fully enclosed."""
    scene = parse_scene("""
        MAT_CORNELL_WHITE, PLANE,  vec3( 0.0, 1.0, 0.0), vec4(1.5, 0.0, 0.0, 0.0)
        MAT_CORNELL_WHITE, PLANE,  vec3( 0.0,-1.0, 0.0), vec4(1.5, 0.0, 0.0, 0.0)
        MAT_CORNELL_WHITE, PLANE,  vec3( 0.0, 0.0, 1.0), vec4(2.5, 0.0, 0.0, 0.0)
        MAT_CORNELL_RED,   PLANE,  vec3( 1.0, 0.0, 0.0), vec4(1.5, 0.0, 0.0, 0.0)
        MAT_CORNELL_GREEN, PLANE,  vec3(-1.0, 0.0, 0.0), vec4(1.5, 0.0, 0.0, 0.0)
        MAT_LIGHT_4,       SPHERE, vec3( 0.0, 1.4,-1.2), vec4(0.3, 0.0, 0.0, 0.0)
        MAT_CORNELL_WHITE, BOX,    vec3( 0.5,-1.0,-1.8), vec4(1.0, 0.0, 0.0, 0.0)
        MAT_CORNELL_WHITE, BOX,    vec3(-0.45,-1.15,-1.3), vec4(0.7, 0.0, 0.0, 0.0)
    """, device=device)
    camera = Camera.make(origin=(0.0, 0.0, 2.8), lookat=(0.0, 0.0, -1.0),
                         fov=50.0, aperture=0.0, focal_length=3.5,
                         device=device)
    return scene, camera, _cfg(**cfg_kw)


def synthetic_sky(n: int = 256):
    """The deterministic f32[6, n, n, 3] stand-in for a photographic
    cubemap that the JAX `cubemap_demo` builds: per face a constant red,
    green rising down the rows and blue rising along the columns."""
    g = np.linspace(0.0, 1.0, n, dtype=np.float32)
    faces = np.zeros((6, n, n, 3), np.float32)
    for f in range(6):
        faces[f, :, :, 0] = 0.25 + 0.08 * f
        faces[f, :, :, 1] = 0.4 + 0.5 * g[:, None]
        faces[f, :, :, 2] = 0.6 + 0.4 * g[None, :]
    return faces


def cubemap_demo(cubemap=None, device="cuda", **cfg_kw):
    """An open scene under a photographic cubemap: a floor, a sphere
    light, a diffuse and a mirror sphere (the JAX preset; the reference's
    Tropical Beach environment, index.js:302-331).  `cubemap`:
    f32[6, H, W, 3]; defaults to `synthetic_sky()`."""
    scene = parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_LIGHT_4, SPHERE, vec3(0.8, 1.2, 0.0), vec4(0.1)
        MAT_WHITE, SPHERE, vec3(0.0, -0.4, 0.0), vec4(0.6)
        MAT_MIRROR, SPHERE, vec3(-1.2, -0.4, -0.6), vec4(0.5)
    """, device=device)
    faces = synthetic_sky() if cubemap is None else np.asarray(cubemap, np.float32)
    scene = scene.replace(
        cubemap=torch.as_tensor(faces, device=scene.device),
        cubemap_is_procedural=False)
    camera = Camera.make(origin=(0.0, 0.2, 2.6), lookat=(0.0, -0.2, -1.0),
                         fov=60.0, device=device)
    return scene, camera, _cfg(use_cubemap=True, use_procedural_sky=False, **cfg_kw)
