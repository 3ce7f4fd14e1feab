"""Scene presets (port of models/presets.py: `_cfg`, `cornell_default`,
`default_scene`, `cornell_box`, `mandelbulb`, `menger_sponge`, `mis_demo`,
`restir_demo`, `restir_stress`,
`animated_restir`, `spectral_caustics`, `textured_cornell`,
`textured_gloss`, `cubemap_demo` and `textured_emitter`: every preset of
the JAX `PRESETS` table), `animated_untextured`, the variant of
`animated_restir` without its texture that the port's timings keep for
comparison, and three scenes that the port's
tests and timing scripts share: `many_lights` (K2's Cornell copy with many
meshes), `textured_restir_demo` (a ReSTIR scene with a blended texture)
and `config2` (glass, a mirror and coat under MIS).  The whole SDF class
has scenes of its own beside presets 0, 2 and 3 (`SDF_SCENE_VIEWS`,
`sdf_view`): every SDF shape the presets lack, an SDF light, textured SDF
rows and the two polygon shapes, each built alike by either package's
SceneBuilder (so the tests can hold the two packages on the same scene),
and a scene of one SDF row of each shape (`one_row_scene`); ReSTIR views
of the class (`RESTIR_SDF_VIEWS`, `restir_sdf_view`).

Each preset returns `(scene, camera, config)`.  The JAX package's
`PRESETS` table comes with the CLI (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from raytracer0_tpu_torch.config import ANIMATED_CONFIG, OFFLINE_CONFIG, RenderConfig
from raytracer0_tpu_torch.models.camera import Camera
from raytracer0_tpu_torch.models import materials as _materials
from raytracer0_tpu_torch.models.dsl import parse_scene
from raytracer0_tpu_torch.models.materials import TEX_1, Material, MatType, MeshType, SdfShape
from raytracer0_tpu_torch.models.scene import SceneBuilder


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


def default_scene(device="cuda", **cfg_kw):
    """Preset 0 (index.html:752-789): two SDF boxes, the upper one METAL
    (a SPEC surface whose glossiness carries the METAL fBm texture), under
    the cubemap sky."""
    scene = parse_scene("""
        MAT_METAL, SDF, vec3(0.0, -0.49, 0.0), vec4(1.0)
        MAT_WHITE, SDF, vec3(0.0, -1.6, -0.2), vec4(1.5, 0.1, 1.5, 0.0)
    """, sdf_shapes=[SdfShape.BOX, SdfShape.BOX], device=device)
    camera = Camera.make(origin=(0.0, 0.0, 4.0), lookat=(0.0, -math.pi / 18.0, -1.0),
                         fov=45.0, device=device)
    return scene, camera, _cfg(use_cubemap=True, use_procedural_sky=False, **cfg_kw)


def cornell_box(device="cuda", **cfg_kw):
    """Preset 1 (index.html:789-820): closed Cornell box with a textured
    sphere light and an orange glass sphere."""
    scene = parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, -1.0, 0.0), vec4(2.0)
        MAT_GREEN, PLANE, vec3(1.0, 0.0, 0.0), vec4(2.0)
        MAT_RED, PLANE, vec3(-1.0, 0.0, 0.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, 0.0, -1.0), vec4(2.0)
        MAT_LIGHT_4_TEX, SPHERE, vec3(0.0, 1.5, -1.5), vec4(0.5)
        MAT_REFR_CLEAR, SPHERE, vec3(0.0), vec4(0.5)
    """, device=device)
    camera = Camera.make(origin=(0.0, 0.0, 1.99), lookat=(0.0, 0.0, -1.0), fov=60.0,
                         device=device)
    return scene, camera, _cfg(use_procedural_sky=False, **cfg_kw)


def mandelbulb(device="cuda", **cfg_kw):
    """Preset 2 (index.html:821-855): Cornell walls and a Mandelbulb SDF."""
    scene = parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, -1.0, 0.0), vec4(2.0)
        MAT_GREEN, PLANE, vec3(1.0, 0.0, 0.0), vec4(2.0)
        MAT_RED, PLANE, vec3(-1.0, 0.0, 0.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, 0.0, -1.0), vec4(2.0)
        MAT_LIGHT_4, SPHERE, vec3(0.0, 1.5, 1.5), vec4(0.5)
        MAT_WHITE, SDF, vec3(0.0), vec4(0.0)
    """, sdf_shapes=[SdfShape.MANDELBULB], device=device)
    camera = Camera.make(origin=(0.0, 0.0, 1.99), lookat=(0.15, 0.15, -1.0), fov=45.0,
                         device=device)
    return scene, camera, _cfg(use_procedural_sky=False, **cfg_kw)


def menger_sponge(device="cuda", **cfg_kw):
    """Preset 3 (index.html:856-877): a wax (COAT) Menger sponge under the
    cubemap."""
    scene = parse_scene("MAT_COAT_WAX, SDF, vec3(0.0), vec4(1.0)",
                        sdf_shapes=[SdfShape.MENGER_SPONGE], device=device)
    camera = Camera.make(origin=(0.0, 0.0, 2.0), lookat=(0.0, 0.0, -1.0), fov=33.0,
                         device=device)
    return scene, camera, _cfg(use_cubemap=True, use_procedural_sky=False, **cfg_kw)


def mis_demo(device="cuda", **cfg_kw):
    """Preset 4 (index.html:878-908): tiny light occluded by an SDF box —
    the classic NEE/MIS stress case."""
    scene = parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, -1.0, 0.0), vec4(2.0)
        MAT_GREEN, PLANE, vec3(1.0, 0.0, 0.0), vec4(2.0)
        MAT_RED, PLANE, vec3(-1.0, 0.0, 0.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, 0.0, -1.0), vec4(2.0)
        MAT_LIGHT_4, SPHERE, vec3(0.0, 1.8, 0.0), vec4(0.05)
        MAT_WHITE, SDF, vec3(0.0, 1.0, 0.0), vec4(0.8, 0.1, 0.8, 0.0)
    """, sdf_shapes=[SdfShape.BOX], device=device)
    camera = Camera.make(origin=(0.0, 0.0, 1.99), lookat=(0.0, 0.0, -1.0), fov=90.0,
                         device=device)
    return scene, camera, _cfg(use_procedural_sky=False, **cfg_kw)


def config2(device="cuda", **cfg_kw):
    """Config 2 of tests/test_golden_cornell.py:66-79 (no preset in the JAX
    package): REFR_SCHLICK glass, a mirror and a COAT sphere in a closed
    box under a sphere light, with MIS."""
    scene = parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, -1.0, 0.0), vec4(2.0)
        MAT_GREEN, PLANE, vec3(1.0, 0.0, 0.0), vec4(2.0)
        MAT_RED, PLANE, vec3(-1.0, 0.0, 0.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0), vec4(2.0)
        MAT_WHITE, PLANE, vec3(0.0, 0.0, -1.0), vec4(2.0)
        MAT_LIGHT_4, SPHERE, vec3(0.0, 1.5, -1.0), vec4(0.3)
        MAT_REFR_CLEAR_2, SPHERE, vec3(-0.5, -0.6, 0.0), vec4(0.4)
        MAT_MIRROR, SPHERE, vec3(0.6, -0.6, -0.5), vec4(0.4)
        MAT_COAT_PURPLE, SPHERE, vec3(0.0, -1.4, 0.8), vec4(0.35)
    """, device=device)
    camera = Camera.make(origin=(0.0, 0.0, 1.99), lookat=(0.0, 0.0, -1.0), fov=60.0,
                         device=device)
    return scene, camera, _cfg(use_mis=True, use_procedural_sky=False, **cfg_kw)


_RESTIR_9_LIGHTS = """
    MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, -1.0, 0.0), vec4(2.0)
    MAT_GREEN, PLANE, vec3(1.0, 0.0, 0.0), vec4(2.0)
    MAT_RED, PLANE, vec3(-1.0, 0.0, 0.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, 0.0, -1.0), vec4(2.0)
    MAT_LIGHT_4, SPHERE, vec3(-0.8, 1.8, -0.8), vec4(0.03)
    MAT_LIGHT_CANDLE_4, SPHERE, vec3(0.8, 1.8, -0.8), vec4(0.03)
    MAT_LIGHT_HALOGEN_4, SPHERE, vec3(-0.8, 1.8, 0.8), vec4(0.03)
    MAT_LIGHT_4, SPHERE, vec3(0.8, 1.8, 0.8), vec4(0.03)
    MAT_LIGHT_4, SPHERE, vec3(0.0, 1.8, 0.0), vec4(0.02)
    MAT_LIGHT_CANDLE_4, SPHERE, vec3(-0.4, 1.6, -0.4), vec4(0.02)
    MAT_LIGHT_HALOGEN_4, SPHERE, vec3(0.4, 1.6, -0.4), vec4(0.02)
    MAT_LIGHT_4, SPHERE, vec3(-0.4, 1.6, 0.4), vec4(0.02)
    MAT_LIGHT_CANDLE_4, SPHERE, vec3(0.4, 1.6, 0.4), vec4(0.02)
    MAT_REFR_CLEAR, SPHERE, vec3(-0.5, -0.5, 0.0), vec4(0.4)
    MAT_MIRROR, SPHERE, vec3(0.5, -0.5, 0.0), vec4(0.4)
    MAT_WHITE, SDF, vec3(0.0, 0.0, 0.0), vec4(0.3, 0.05, 0.3, 0.0)
"""


def restir_demo(device="cuda", **cfg_kw):
    """Preset 5 (index.html:909-964): 9 small lights + glass/mirror spheres,
    ReSTIR enabled."""
    scene = parse_scene(_RESTIR_9_LIGHTS, sdf_shapes=[SdfShape.ROUND_BOX], device=device)
    camera = Camera.make(origin=(0.0, 0.0, 1.99), lookat=(0.0, 0.0, -1.0), fov=60.0,
                         device=device)
    return scene, camera, _cfg(use_restir=True, use_procedural_sky=False, **cfg_kw)


def _grid_lights():
    """Preset 6's 41 ceiling lights (index.html:965-1014): a 5x5 grid at
    y=1.9 (r=0.02) plus a 4x4 grid at y=1.5 (r=0.015), cycling the three
    light material colors."""
    mats = ["MAT_LIGHT_4", "MAT_LIGHT_CANDLE_4", "MAT_LIGHT_HALOGEN_4"]
    lines = []
    k = 0
    for z in (-1.2, -0.6, 0.0, 0.6, 1.2):
        for x in (-1.2, -0.6, 0.0, 0.6, 1.2):
            lines.append(f"{mats[k % 3]}, SPHERE, vec3({x}, 1.9, {z}), vec4(0.02)")
            k += 1
    # second layer: 4x4 at y=1.5, material cycle restarting at MAT_LIGHT_4
    k = 0
    for z in (-0.9, -0.3, 0.3, 0.9):
        for x in (-0.9, -0.3, 0.3, 0.9):
            lines.append(f"{mats[k % 3]}, SPHERE, vec3({x}, 1.5, {z}), vec4(0.015)")
            k += 1
    return "\n".join(lines)


_STRESS_PLANES = """
    MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(3.0)
    MAT_WHITE, PLANE, vec3(0.0, -1.0, 0.0), vec4(3.0)
    MAT_GREEN, PLANE, vec3(1.0, 0.0, 0.0), vec4(3.0)
    MAT_RED, PLANE, vec3(-1.0, 0.0, 0.0), vec4(3.0)
    MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0), vec4(3.0)
    MAT_WHITE, PLANE, vec3(0.0, 0.0, -1.0), vec4(3.0)
"""


def restir_stress(device="cuda", **cfg_kw):
    """Preset 6 (index.html:965-1014): 41 lights in two ceiling grids —
    the many-light showcase where ReSTIR beats per-light NEE."""
    text = _STRESS_PLANES + _grid_lights() + """
        MAT_REFR_CLEAR, SPHERE, vec3(-0.7, -0.5, 0.0), vec4(0.3)
        MAT_MIRROR, SPHERE, vec3(0.7, -0.5, 0.0), vec4(0.3)
        MAT_WHITE, SDF, vec3(0.0, 0.0, 0.0), vec4(0.4, 0.05, 0.4, 0.0)
    """
    scene = parse_scene(text, sdf_shapes=[SdfShape.ROUND_BOX], device=device)
    camera = Camera.make(origin=(0.0, 0.0, 2.5), lookat=(0.0, 0.0, -1.0), fov=60.0,
                         device=device)
    return scene, camera, _cfg(use_restir=True, use_procedural_sky=False, **cfg_kw)


def many_lights(device="cuda", n_lights=41, **cfg_kw):
    """`restir_stress`'s six planes and the first `n_lights` of its grid
    lights, without its glass, mirror and SDF rows (6 + n_lights meshes:
    47 with every light), with its camera and budgets, ReSTIR off and MIS
    on: K2's class with many meshes."""
    lights = "\n".join(_grid_lights().splitlines()[:n_lights])
    scene = parse_scene(_STRESS_PLANES + lights, device=device)
    _, camera, cfg = restir_stress(device=device, **cfg_kw)
    return scene, camera, cfg.replace(use_restir=False, use_mis=True)


def textured_restir_demo(device="cuda", **cfg_kw):
    """`restir_demo` with a CHECK texture blended into its back wall's
    color: a ReSTIR scene of analytic rows and a ROUND_BOX with a blended
    texture, which K6 and the split path render and K7 differentiates in
    its whole-SDF copy."""
    back_wall = "MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0)"
    text = _RESTIR_9_LIGHTS.replace(back_wall, "MAT_CHECK_WHITE, PLANE, vec3(0.0, 0.0, 1.0)")
    assert text != _RESTIR_9_LIGHTS
    _, camera, cfg = restir_demo(device=device, **cfg_kw)
    return parse_scene(text, sdf_shapes=[SdfShape.ROUND_BOX], device=device), camera, cfg


_ANIMATED_RESTIR = """
    MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, -1.0, 0.0), vec4(2.0)
    MAT_GREEN, PLANE, vec3(1.0, 0.0, 0.0), vec4(2.0)
    MAT_RED, PLANE, vec3(-1.0, 0.0, 0.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0), vec4(2.0)
    MAT_WHITE, PLANE, vec3(0.0, 0.0, -1.0), vec4(2.0)
    MAT_LIGHT_4, SPHERE, vec3(0.0, 1.7, 0.0), vec4(0.04)
    MAT_LIGHT_CANDLE_4, SPHERE, vec3(0.8, 1.5, 0.8), vec4(0.03)
    MAT_LIGHT_HALOGEN_4, SPHERE, vec3(-0.8, 1.5, 0.8), vec4(0.03)
    MAT_LIGHT_4, SPHERE, vec3(0.8, 1.5, -0.8), vec4(0.03)
    MAT_LIGHT_CANDLE_4, SPHERE, vec3(-0.8, 1.5, -0.8), vec4(0.03)
    MAT_LIGHT_HALOGEN_4, SPHERE, vec3(0.0, 1.3, 1.2), vec4(0.025)
    MAT_LIGHT_4, SPHERE, vec3(1.2, 1.3, 0.0), vec4(0.025)
    MAT_LIGHT_CANDLE_4, SPHERE, vec3(0.0, 1.3, -1.2), vec4(0.025)
    MAT_LIGHT_HALOGEN_4, SPHERE, vec3(-1.2, 1.3, 0.0), vec4(0.025)
    MAT_REFR_CLEAR, SPHERE, vec3(-0.4, -0.3, 0.4), vec4(0.35)
    MAT_MIRROR, SPHERE, vec3(0.4, -0.3, -0.4), vec4(0.35)
    MAT_METAL, SDF, vec3(0.0, -0.2, 0.0), vec4(0.3, 0.05, 0.3, 0.0)
"""


def animated_restir(device="cuda", **cfg_kw):
    """Preset 7 (index.html:1015-1092): 9 moving lights, real-time budget
    (ANIMATED_CONFIG: 6 bounces, EMA accumulation, ReSTIR on).  Its rounded
    box is MAT_METAL, a METAL texture blended into an SDF mesh: on the card
    K4 and K6v render it in their whole-SDF copies, and K7 differentiates
    it in its own."""
    scene = parse_scene(_ANIMATED_RESTIR, sdf_shapes=[SdfShape.ROUND_BOX], device=device)
    camera = Camera.make(origin=(0.0, 0.0, 1.99), lookat=(0.0, 0.0, -1.0), fov=60.0,
                         device=device)
    return scene, camera, _cfg(base=ANIMATED_CONFIG, use_procedural_sky=False, **cfg_kw)


def animated_untextured(device="cuda", **cfg_kw):
    """`animated_restir` with its rounded box MAT_WHITE (the variant of
    tests/test_animated.py:73-85): the real-time ReSTIR scene the port
    measured before it rendered the preset as shipped, kept so its times
    stay comparable, and a scene K7 differentiates."""
    scene = parse_scene(_ANIMATED_RESTIR.replace("MAT_METAL, SDF", "MAT_WHITE, SDF"),
                        sdf_shapes=[SdfShape.ROUND_BOX], device=device)
    camera = Camera.make(origin=(0.0, 0.0, 1.99), lookat=(0.0, 0.0, -1.0), fov=60.0,
                         device=device)
    return scene, camera, _cfg(base=ANIMATED_CONFIG, use_procedural_sky=False, **cfg_kw)


def synthetic_texture(blue="wave"):
    """The deterministic f32[4, 64, 64, 4] image stack of the JAX textured
    presets: ones, with IMAGE1's red rising along the columns, green down
    the rows, and blue a sine-cosine wave (`blue="wave"`) or 0.5."""
    g = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    images = np.ones((4, 64, 64, 4), np.float32)
    images[1, ..., 0] = 0.3 + 0.7 * g[None, :]
    images[1, ..., 1] = 0.3 + 0.7 * g[:, None]
    images[1, ..., 2] = (0.5 + 0.5 * np.sin(g[:, None] * 19.0) * np.cos(g[None, :] * 23.0)
                         if blue == "wave" else 0.5)
    return images


def _textured_box(sb, light):
    """The closed box of `textured_cornell` and `textured_emitter`: six
    walls, `light` (a material name or Material) at the ceiling, and the
    IMAGE1-textured diffuse sphere."""
    sb.add("MAT_WHITE", MeshType.PLANE, (0.0, 1.0, 0.0), (2.0,))
    sb.add("MAT_WHITE", MeshType.PLANE, (0.0, -1.0, 0.0), (2.0,))
    sb.add("MAT_GREEN", MeshType.PLANE, (1.0, 0.0, 0.0), (2.0,))
    sb.add("MAT_RED", MeshType.PLANE, (-1.0, 0.0, 0.0), (2.0,))
    sb.add("MAT_WHITE", MeshType.PLANE, (0.0, 0.0, 1.0), (2.0,))
    sb.add("MAT_WHITE", MeshType.PLANE, (0.0, 0.0, -1.0), (2.0,))
    sb.add(light, MeshType.SPHERE, (0.0, 1.6, 0.0), (0.3,))
    sb.add("MAT_TEST", MeshType.SPHERE, (0.0, -0.8, 0.0), (0.7,))
    return sb.images(synthetic_texture())


def textured_cornell(device="cuda", **cfg_kw):
    """The Cornell box with an IMAGE1-textured diffuse sphere (the
    reference's image-texture path, raytracer.glsl:726-772, with the
    spherical UV of 1055-1059), under the synthetic 64² texture."""
    scene = _textured_box(SceneBuilder(), "MAT_LIGHT_4").build(device=device)
    camera = Camera.make(origin=(0.0, 0.0, 1.9), lookat=(0.0, -0.4, -1.0), fov=60.0,
                         device=device)
    return scene, camera, _cfg(use_procedural_sky=False, **cfg_kw)


def textured_gloss(device="cuda", **cfg_kw):
    """A Cornell box with an IMAGE1-textured SPEC sphere whose texel drives
    both its color and its emission-as-glossiness (raytracer.glsl:1812-1813):
    the texel steers the bounce direction."""
    gloss = Material(c=(0.9, 0.9, 0.9), e=(0.35, 0.35, 0.35), t=MatType.SPEC,
                     tex=TEX_1, opts=(True, True, False, False))
    sb = SceneBuilder()
    sb.add("MAT_CORNELL_WHITE", MeshType.PLANE, (0.0, 1.0, 0.0), (1.5,))
    sb.add("MAT_CORNELL_WHITE", MeshType.PLANE, (0.0, -1.0, 0.0), (1.5,))
    sb.add("MAT_CORNELL_WHITE", MeshType.PLANE, (0.0, 0.0, 1.0), (2.5,))
    sb.add("MAT_CORNELL_RED", MeshType.PLANE, (1.0, 0.0, 0.0), (1.5,))
    sb.add("MAT_CORNELL_GREEN", MeshType.PLANE, (-1.0, 0.0, 0.0), (1.5,))
    sb.add("MAT_LIGHT_4", MeshType.SPHERE, (0.0, 1.4, -1.2), (0.3,))
    sb.add(gloss, MeshType.SPHERE, (0.0, -0.7, -1.2), (0.6,))
    scene = sb.images(synthetic_texture(blue="flat")).build(device=device)
    camera = Camera.make(origin=(0.0, 0.0, 2.8), lookat=(0.0, 0.0, -1.0), fov=50.0,
                         device=device)
    return scene, camera, _cfg(use_procedural_sky=False, **cfg_kw)


def textured_emitter(device="cuda", **cfg_kw):
    """`textured_cornell` whose LIGHT sphere carries IMAGE1 on its color and
    its emission (raytracer.glsl:2071-2090)."""
    light = Material(c=(1.0, 1.0, 1.0), e=(8.0, 7.0, 6.0), t=MatType.LIGHT,
                     tex=TEX_1, opts=(True, True, False, False))
    scene = _textured_box(SceneBuilder(), light).build(device=device)
    camera = Camera.make(origin=(0.0, 0.0, 1.9), lookat=(0.0, -0.4, -1.0), fov=60.0,
                         device=device)
    return scene, camera, _cfg(use_procedural_sky=False, **cfg_kw)


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


def spectral_caustics(device="cuda", **cfg_kw):
    """Preset 8 (index.html:1093-1146): a dispersive flint sphere (a
    negative IOR, Cauchy's A), a mirror and fog in a Cornell box open at
    the front, under hero-wavelength spectral transport and the
    homogeneous medium, no sky (vol_cornell_spectral)."""
    scene = parse_scene("""
        MAT_CORNELL_WHITE,  PLANE,  vec3( 0.0, 1.0, 0.0), vec4(1.5, 0.0, 0.0, 0.0)
        MAT_CORNELL_WHITE,  PLANE,  vec3( 0.0,-1.0, 0.0), vec4(1.5, 0.0, 0.0, 0.0)
        MAT_CORNELL_WHITE,  PLANE,  vec3( 0.0, 0.0, 1.0), vec4(2.5, 0.0, 0.0, 0.0)
        MAT_CORNELL_RED,    PLANE,  vec3( 1.0, 0.0, 0.0), vec4(1.5, 0.0, 0.0, 0.0)
        MAT_CORNELL_GREEN,  PLANE,  vec3(-1.0, 0.0, 0.0), vec4(1.5, 0.0, 0.0, 0.0)
        MAT_LIGHT_DEMO,     SPHERE, vec3( 0.0, 1.38,-1.0), vec4(0.14, 0.0, 0.0, 0.0)
        MAT_LIGHT_CANDLE_4, SPHERE, vec3(-0.85, 1.25,-1.8), vec4(0.14, 0.0, 0.0, 0.0)
        MAT_SPECTRAL_FLINT, SPHERE, vec3( 0.05,-0.45,-1.15), vec4(0.55, 0.0, 0.0, 0.0)
        MAT_CORNELL_WHITE,  BOX,    vec3( 0.65,-1.2,-1.7), vec4(0.65, 0.0, 0.0, 0.0)
        MAT_MIRROR,         SPHERE, vec3(-0.9,-1.05,-2.05), vec4(0.45, 0.0, 0.0, 0.0)
    """, device=device)
    camera = Camera.make(origin=(0.0, 0.0, 2.2), lookat=(0.0, -0.15, -1.0), fov=60.0,
                         device=device)
    return scene, camera, _cfg(use_spectral=True, use_volumetrics=True,
                               use_procedural_sky=False, **cfg_kw)


def _builder(builder, m):
    return (builder or SceneBuilder)(), (m or _materials)


def _build(b, device):
    return b.build() if device is None else b.build(device=device)


def sdf_light_scene(device="cuda", builder=None, m=None):
    """The Cornell geometry of the reference's tests/test_megakernel.py:
    700-716 with its light an SDF ROUND_BOX (the only light slot), which
    NEE samples at a point of its bounding ellipsoid.  `builder` and `m`
    (default: this package's SceneBuilder and materials module) may be
    another package's; `device` None builds on that builder's default."""
    b, m = _builder(builder, m)
    b.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, 1.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, -1.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, 0.0, 1.0), (2.5,))
    b.add("MAT_CORNELL_RED", m.MeshType.PLANE, (1.0, 0.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_GREEN", m.MeshType.PLANE, (-1.0, 0.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_WHITE", m.MeshType.BOX, (0.5, -1.0, -1.8), (1.0,))
    b.add("MAT_LIGHT_4", m.MeshType.SDF, (0.0, 1.0, -1.2), (0.3, 0.3, 0.3, 0.05),
          sdf_shape=m.SdfShape.ROUND_BOX)
    return _build(b, device)


def every_shape_scene(device="cuda", builder=None, m=None):
    """The 11 SDF shapes no preset of the reference holds (ROUND_BOX,
    SPHERE, TRI_PRISM, CONE, ELLIPSOID, CAPSULE, SNOWBALL, SEA_BOX,
    SIGGRAPH, TRIANGLE and QUAD), three rows of them in front of the
    camera, in a box of five planes under a sphere light; the quad carries
    a CHECK texture on its color.  The capsule, prism, cone, sea box,
    SIGGRAPH object, triangle and quad have no bounding sphere, so the
    march's gate is off.  `builder`, `m`, `device`: as `sdf_light_scene`."""
    b, m = _builder(builder, m)
    S = m.SdfShape
    check = m.Material(c=(0.7, 0.5, 0.3), t=m.MatType.DIFF,
                       tex=m.Texture(t=m.TexType.CHECK, params=(4.0, 4.0, 2.0, 2.0)),
                       opts=(True, False, False, False))
    b.add("MAT_WHITE", m.MeshType.PLANE, (0.0, 1.0, 0.0), (2.0,))
    b.add("MAT_WHITE", m.MeshType.PLANE, (0.0, -1.0, 0.0), (2.0,))
    b.add("MAT_GREEN", m.MeshType.PLANE, (1.0, 0.0, 0.0), (2.0,))
    b.add("MAT_RED", m.MeshType.PLANE, (-1.0, 0.0, 0.0), (2.0,))
    b.add("MAT_WHITE", m.MeshType.PLANE, (0.0, 0.0, 1.0), (3.0,))
    b.add("MAT_LIGHT_4", m.MeshType.SPHERE, (0.0, 1.6, -0.6), (0.3,))
    sdf = m.MeshType.SDF
    b.add("MAT_WHITE", sdf, (-1.2, 0.8, -1.2), (0.2, 0.15, 0.2, 0.05), sdf_shape=S.ROUND_BOX)
    b.add("MAT_WHITE", sdf, (-0.4, 0.8, -1.2), (0.3,), sdf_shape=S.SPHERE)
    b.add("MAT_WHITE", sdf, (0.4, 0.8, -1.2), (0.4, 0.2), sdf_shape=S.TRI_PRISM)
    b.add("MAT_WHITE", sdf, (1.2, 1.1, -1.2), (0.6, 0.8, 0.4), sdf_shape=S.CONE)
    b.add("MAT_WHITE", sdf, (-1.2, 0.0, -1.2), (0.35, 0.2, 0.25), sdf_shape=S.ELLIPSOID)
    b.add("MAT_WHITE", sdf, (-0.6, -0.15, -1.2), (-0.2, 0.2, -1.1, 0.12),
          sdf_shape=S.CAPSULE)
    b.add("MAT_WHITE", sdf, (0.4, 0.0, -1.2), (0.3,), sdf_shape=S.SNOWBALL)
    b.add("MAT_WHITE", sdf, (1.2, 0.0, -1.2), (0.3, 0.3, 0.3, 0.05), sdf_shape=S.SEA_BOX)
    b.add("MAT_WHITE", sdf, (0.0, -1.0, -2.2), (0.0,), sdf_shape=S.SIGGRAPH)
    b.add("MAT_WHITE", sdf, (-1.2, -1.0, -1.2), (0.0,), sdf_shape=S.TRIANGLE,
          aux=(-0.3, -0.3, 0.0, 0.3, -0.3, 0.0, 0.0, 0.3, 0.1))
    b.add(check, sdf, (1.2, -1.0, -1.2), (0.0,), sdf_shape=S.QUAD,
          aux=(-0.3, -0.3, 0.0, 0.3, -0.3, 0.0, 0.3, 0.3, 0.0, -0.3, 0.3, 0.0))
    return _build(b, device)


def textured_sdf_scene(device="cuda", builder=None, m=None):
    """The textures of SDF rows whose texels carry a gradient into the hit
    point: Cornell walls, an SDF sphere with an image (the textured
    presets' IMAGE1) blended into its color, read at the UV of its row's
    box normal, an SDF ellipsoid, and an SDF ROUND_BOX light (the only
    light slot) with value noise blended into its emission, whose texel
    NEE's shadow rays blend into its color at the hit of the SDF shadow
    march.  `builder`, `m`, `device`: as `sdf_light_scene`."""
    b, m = _builder(builder, m)
    image = m.Material(c=(0.6, 0.6, 0.6), t=m.MatType.DIFF,
                       tex=m.Texture(t=m.TexType.IMAGE1), opts=(True, False, False, False))
    light = m.Material(c=(1.0, 1.0, 1.0), e=(4.0, 4.0, 4.0), t=m.MatType.LIGHT,
                       tex=m.Texture(t=m.TexType.VALUE_NOISE, params=(3.0, 3.0, 3.0, 0.0)),
                       opts=(False, True, False, False))
    b.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, 1.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, -1.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, 0.0, 1.0), (2.5,))
    b.add("MAT_CORNELL_RED", m.MeshType.PLANE, (1.0, 0.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_GREEN", m.MeshType.PLANE, (-1.0, 0.0, 0.0), (1.5,))
    b.add(image, m.MeshType.SDF, (-0.45, -0.8, -1.4), (0.5,), sdf_shape=m.SdfShape.SPHERE)
    b.add("MAT_CORNELL_WHITE", m.MeshType.SDF, (0.55, -1.0, -1.6), (0.35, 0.5, 0.3),
          sdf_shape=m.SdfShape.ELLIPSOID)
    b.add(light, m.MeshType.SDF, (0.0, 1.0, -1.2), (0.3, 0.3, 0.3, 0.05),
          sdf_shape=m.SdfShape.ROUND_BOX)
    b.lights([7])   # a light found by its material's name alone otherwise
    b.images(synthetic_texture())
    return _build(b, device)


def polygon_scene(device="cuda", builder=None, m=None):
    """An SDF triangle and an SDF quad (the shapes that read aux) in a box
    of five planes, lit directly by a sphere light, with no other SDF row:
    the every-shape scene's cone puts its own square root's NaN into the
    JAX package's gradient wherever a path touches it, which reaches every
    leaf of such a path.  `builder`, `m`, `device`: as `sdf_light_scene`."""
    b, m = _builder(builder, m)
    b.add("MAT_WHITE", m.MeshType.PLANE, (0.0, 1.0, 0.0), (2.0,))
    b.add("MAT_WHITE", m.MeshType.PLANE, (0.0, -1.0, 0.0), (2.0,))
    b.add("MAT_GREEN", m.MeshType.PLANE, (1.0, 0.0, 0.0), (2.0,))
    b.add("MAT_RED", m.MeshType.PLANE, (-1.0, 0.0, 0.0), (2.0,))
    b.add("MAT_WHITE", m.MeshType.PLANE, (0.0, 0.0, 1.0), (3.0,))
    b.add("MAT_LIGHT_4", m.MeshType.SPHERE, (0.0, 1.2, -0.2), (0.3,))
    sdf = m.MeshType.SDF
    b.add("MAT_WHITE", sdf, (-0.6, -0.2, -1.4), (0.0,), sdf_shape=m.SdfShape.TRIANGLE,
          aux=(-0.5, -0.5, 0.1, 0.5, -0.4, 0.0, 0.0, 0.5, -0.1))
    b.add("MAT_CORNELL_WHITE", sdf, (0.6, -0.2, -1.4), (0.0,), sdf_shape=m.SdfShape.QUAD,
          aux=(-0.4, -0.4, 0.0, 0.4, -0.45, 0.1, 0.45, 0.4, 0.0, -0.4, 0.4, -0.1))
    return _build(b, device)


#: the whole SDF class's scenes beside the presets: name -> (scene
#: function, (camera origin, lookat, fov), config overrides)
SDF_SCENE_VIEWS = {
    "sdf_light": (sdf_light_scene, ((0.0, 0.0, 2.8), (0.0, 0.0, -1.0), 50.0),
                  dict(max_bounces=2)),
    "every_shape": (every_shape_scene, ((0.0, 0.0, 1.6), (0.0, -0.05, -1.0), 75.0),
                    dict(max_bounces=2)),
    "textured_sdf": (textured_sdf_scene, ((0.0, 0.9, 2.6), (0.0, -0.5, -1.2), 50.0),
                     dict(max_bounces=2)),
    "polygons": (polygon_scene, ((0.0, 0.0, 1.6), (0.0, -0.15, -1.0), 60.0),
                 dict(max_bounces=2)),
}


def sdf_view(name, device="cuda", **cfg_kw):
    """(scene, camera, config) of the scene `name` of SDF_SCENE_VIEWS."""
    make, (origin, lookat, fov), kw = SDF_SCENE_VIEWS[name]
    camera = Camera.make(origin=origin, lookat=lookat, fov=fov, device=device)
    return make(device=device), camera, _cfg(**{**kw, **cfg_kw})


@functools.cache
def shape_rows():
    """{shape: (pos, joker, aux)} of one SDF row of each shape: the
    every-shape scene's, `default_scene`'s BOX, `menger_sponge`'s and
    `mandelbulb`'s."""
    rows = {}
    scenes = [every_shape_scene(device="cpu")] + [
        f(device="cpu")[0] for f in (default_scene, menger_sponge, mandelbulb)]
    for s in scenes:
        for k, shape in enumerate(s.sdf_shapes_static):
            i = s.num_analytic + k
            rows.setdefault(shape, tuple(getattr(s, f)[i].tolist() for f in ("pos", "joker", "aux")))
    return rows


def one_row_scene(shape, device="cuda", builder=None):
    """A scene of the one SDF row of `shape` (an SdfShape code) of
    `shape_rows`, lit by the procedural sky; `builder` (default this
    package's SceneBuilder) may be another package's, with `device` None."""
    pos, joker, aux = shape_rows()[shape]
    b = (builder or SceneBuilder)().add("MAT_WHITE", MeshType.SDF, pos, joker, sdf_shape=shape,
                                         aux=aux)
    return _build(b, device)


#: ReSTIR views of the whole SDF class, one sphere light each, so ReSTIR
#: engages with MIS off (the JAX `supported_restir`): name -> the scene's
#: (scene, camera, config) function, with `device` and config overrides
RESTIR_SDF_VIEWS = {
    "mandelbulb": mandelbulb,
    "every_shape": functools.partial(sdf_view, "every_shape"),
    "polygons": functools.partial(sdf_view, "polygons"),
}


def restir_sdf_view(name, device="cuda", **cfg_kw):
    """(scene, camera, config) of the ReSTIR view `name` of
    RESTIR_SDF_VIEWS: the scene's own view with ReSTIR on and MIS off."""
    kw = dict(dict(use_restir=True, use_mis=False), **cfg_kw)
    return RESTIR_SDF_VIEWS[name](device=device, **kw)
