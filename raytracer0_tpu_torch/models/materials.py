"""Material, texture, and mesh type system + the named material library
(the port's copy of raytracer0_tpu/models/materials.py, same names, codes
and values; tests/test_torch_grad.py holds them equal).

Reproduces the reference's material model (raytracer.glsl:147-224): seven
material types, emission doubling as glossiness for SPEC, negative IOR
signalling a spectral (Cauchy) glass, per-material texture assignment with
color/emission masks and generator params, and a bvec4 of options
(color-tex, emission-tex, bump, backface-cull).

Everything here is host-side build data; `models.scene` packs it into SoA
device arrays.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class MatType(enum.IntEnum):
    """Material types (raytracer.glsl:148-154)."""

    LIGHT = 0
    DIR_LIGHT = 1
    DIFF = 2
    SPEC = 3
    REFR_FRESNEL = 4
    REFR_SCHLICK = 5
    COAT = 6


class TexType(enum.IntEnum):
    """Texture types (raytracer.glsl:112-121); NONE replaces GLSL NULL=-1."""

    NONE = -1
    IMAGE0 = 0
    IMAGE1 = 1
    IMAGE2 = 2
    IMAGE3 = 3
    VORONOI = 4
    GRADIENT_NOISE = 5
    VALUE_NOISE = 6
    CHECK = 7
    RIPPLE = 8
    METAL = 9


class MeshType(enum.IntEnum):
    """Geometric primitive types (raytracer.glsl:231-236)."""

    SPHERE = 0
    PLANE = 1
    BOX = 2
    SDF = 3
    GRID_SDF = 4
    TRIANGLE = 5


class SdfShape(enum.IntEnum):
    """SDF shape selector per SDF mesh entry.

    Codes 0-6 follow the reference UI dropdown order (index.html:838-846);
    7+ expose the rest of the reference's SDF library (raytracer.glsl:
    496-640) as framework extras.
    """

    BOX = 0
    ROUND_BOX = 1
    SPHERE = 2
    TRI_PRISM = 3
    CONE = 4
    MENGER_SPONGE = 5
    MANDELBULB = 6
    ELLIPSOID = 7
    CAPSULE = 8
    SNOWBALL = 9
    SEA_BOX = 10
    SIGGRAPH = 11
    # udTriangle / udQuad (raytracer.glsl:537-576): vertices live in the
    # scene's `aux` row (relative to `pos`), 3 or 4 consecutive vec3s.
    TRIANGLE = 12
    QUAD = 13


# Index of refraction table (raytracer.glsl:51-58).
IOR_VACUUM = 1.0
IOR_AIR = 1.00029
IOR_ICE = 1.31
IOR_WATER = 1.33
IOR_COAT = 1.4
IOR_GLASS = 1.53
IOR_SAPPHIRE = 1.77
IOR_DIAMOND = 2.417


@dataclasses.dataclass(frozen=True)
class Texture:
    """Texture assignment (raytracer.glsl:124-128)."""

    c_mask: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    e_mask: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    params: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    t: TexType = TexType.NONE


@dataclasses.dataclass(frozen=True)
class Material:
    """Material record (raytracer.glsl:157-163)."""

    c: Tuple[float, float, float] = (0.0, 0.0, 0.0)   # color
    e: Tuple[float, float, float] = (0.0, 0.0, 0.0)   # emission / glossiness
    nt: float = 0.0                                   # IOR; negative = Cauchy A
    t: MatType = MatType.DIFF
    tex: Texture = Texture()
    # color tex, emission/gloss tex, bump tex, backface culling
    opts: Tuple[bool, bool, bool, bool] = (False, False, False, False)


NULL_TEX = Texture()

# Named textures (raytracer.glsl:133-141).
TEX_0 = Texture(params=(0.0, 0.0, 0.0, 1.0), t=TexType.IMAGE0)
TEX_1 = Texture(params=(0.0, 0.0, 0.0, 1.0), t=TexType.IMAGE1)
TEX_2 = Texture(params=(0.0, 0.0, 0.0, 1.0), t=TexType.IMAGE2)
TEX_3 = Texture(params=(0.0, 0.0, 0.0, 1.0), t=TexType.IMAGE3)
TEX_VALUE_NOISE = Texture(params=(16.0, 16.0, 16.0, 16.0), t=TexType.VALUE_NOISE)
TEX_CHECK = Texture(e_mask=(0.0, 0.0, 0.0), params=(5.0, 5.0, 2.0, 0.0), t=TexType.CHECK)
TEX_METAL = Texture(
    c_mask=(0.7, 0.25, 0.055), e_mask=(0.6, 0.2, 0.6),
    params=(16.0, 10.0, 16.0, 0.0), t=TexType.METAL,
)

# ---------------------------------------------------------------------------
# Named material library (raytracer.glsl:165-224).  Keys are the DSL names.
# ---------------------------------------------------------------------------

MATERIALS: dict[str, Material] = {
    "NULL_MAT": Material(),
    # glass
    "MAT_REFR_CLEAR": Material(c=(1.0, 0.5, 0.0), nt=IOR_GLASS, t=MatType.REFR_FRESNEL),
    "MAT_REFR_CLEAR_2": Material(c=(1.0, 1.0, 1.0), nt=IOR_GLASS, t=MatType.REFR_SCHLICK),
    "MAT_REFR_SAPPHIRE": Material(c=(1.0, 1.0, 1.0), nt=IOR_SAPPHIRE, t=MatType.REFR_FRESNEL),
    "MAT_REFR_WATER": Material(c=(0.25, 0.64, 0.88), nt=IOR_WATER, t=MatType.REFR_FRESNEL),
    "MAT_REFR_TEST": Material(c=(1.0, 1.0, 1.0), nt=IOR_GLASS, t=MatType.REFR_FRESNEL,
                              tex=TEX_1, opts=(True, False, False, False)),
    # lights
    "MAT_LIGHT_4": Material(c=(1.0, 1.0, 1.0), e=(4.0, 4.0, 4.0), t=MatType.LIGHT),
    "MAT_LIGHT_CANDLE_4": Material(c=(1.0, 0.57647058823, 0.16078431372),
                                   e=(4.0, 4.0, 4.0), t=MatType.LIGHT),
    "MAT_LIGHT_HALOGEN_4": Material(c=(1.0, 0.94509803921, 0.87843137254),
                                    e=(4.0, 4.0, 4.0), t=MatType.LIGHT),
    "MAT_LIGHT_DEMO": Material(c=(1.0, 1.0, 1.0), e=(10.0, 10.0, 10.0), t=MatType.LIGHT),
    "MAT_LIGHT_4_TEX": Material(c=(1.0, 1.0, 1.0), e=(1.0, 1.0, 1.0), t=MatType.LIGHT,
                                tex=TEX_1, opts=(True, False, False, False)),
    # directional "sky" lights
    "MAT_CLEAR_SKY": Material(c=(0.25098039215, 0.61176470588, 1.0),
                              e=(1.0, 1.0, 1.0), t=MatType.DIR_LIGHT),
    "MAT_OVERCAST_SKY": Material(c=(0.78823529411, 0.8862745098, 1.0),
                                 e=(1.0, 1.0, 1.0), t=MatType.DIR_LIGHT),
    "MAT_DIRECT_SUNLIGHT": Material(c=(1.0, 1.0, 1.0), e=(1.0, 1.0, 1.0),
                                    t=MatType.DIR_LIGHT),
    # specular
    "MAT_MIRROR": Material(c=(1.0, 1.0, 1.0), t=MatType.SPEC),
    "MAT_METAL": Material(c=(0.6, 0.6, 0.6), t=MatType.SPEC, tex=TEX_METAL,
                          opts=(False, True, False, False)),
    # diffuse
    "MAT_BLACK": Material(c=(0.0, 0.0, 0.0)),
    "MAT_WHITE": Material(c=(1.0, 1.0, 1.0)),
    "MAT_RED": Material(c=(1.0, 0.0, 0.0)),
    "MAT_GREEN": Material(c=(0.0, 1.0, 0.0)),
    "MAT_BLUE": Material(c=(0.0, 0.0, 1.0)),
    "MAT_CORNELL_WHITE": Material(c=(1.0, 1.0, 1.0)),
    "MAT_CORNELL_RED": Material(c=(0.7, 0.12, 0.05)),
    "MAT_CORNELL_GREEN": Material(c=(0.2, 0.4, 0.36)),
    "MAT_YELLOW": Material(c=(1.0, 1.0, 0.0)),
    "MAT_PURPLE": Material(c=(0.50196078431, 0.0, 0.50196078431)),
    # checkered
    "MAT_CHECK_WHITE": Material(c=(0.0, 0.0, 0.0), tex=TEX_CHECK,
                                opts=(True, False, False, False)),
    # coat
    "MAT_COAT_NAVY": Material(c=(0.0, 0.0, 0.50196078431), e=(1.0, 1.0, 1.0),
                              nt=IOR_COAT, t=MatType.COAT),
    "MAT_COAT_PURPLE": Material(c=(0.50196078431, 0.0, 0.50196078431),
                                nt=IOR_COAT, t=MatType.COAT),
    "MAT_COAT_WAX": Material(c=(0.9333, 0.6666, 0.6), e=(0.005, 0.005, 0.005),
                             nt=IOR_COAT, t=MatType.COAT),
    # test
    "MAT_TEST": Material(c=(1.0, 1.0, 1.0), tex=TEX_1, opts=(True, False, False, False)),
    # spectral glass: |nt| = Cauchy A coefficient (raytracer.glsl:220-224)
    "MAT_SPECTRAL_FLINT": Material(c=(1.0, 1.0, 1.0), nt=-1.7167, t=MatType.REFR_FRESNEL),
    "MAT_SPECTRAL_DIAMOND": Material(c=(1.0, 1.0, 1.0), nt=-2.3991, t=MatType.REFR_FRESNEL),
}
