"""Scene presets (port of models/presets.py: `_cfg` and `cornell_default`).

Each preset returns `(scene, camera, config)`.  The other presets of the
JAX package come with the slices that add their features (ROADMAP queue 1
items 7-11).
"""

from __future__ import annotations

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
