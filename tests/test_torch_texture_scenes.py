"""Textured scenes shared by the port's texture tests (CPU, host build and
card), built alike with either package's SceneBuilder and materials
module, and a check that both packages build the same scene.

This module imports neither JAX nor the JAX package at its top, so the
card's tests (tests/test_torch_cuda.py, run without JAX) can use it.
"""

import pytest


def tex_material(m, t, params, c=(0.4, 0.4, 0.4), opts=(True, False, False, False)):
    """A DIFF material of materials module `m` with a texture of type `t`."""
    return m.Material(c=c, t=m.MatType.DIFF, tex=m.Texture(params=params, t=t), opts=opts)


def procedural_scene(builder, m, device=None):
    """tests/test_megakernel.py:168-202: CHECK (plane), METAL fBm (box,
    on its glossiness), VORONOI (box), VALUE_NOISE and RIPPLE (planes)."""
    b = builder()
    b.add("MAT_CHECK_WHITE", m.MeshType.PLANE, (0.0, 1.0, 0.0), (2.0,))
    b.add("MAT_METAL", m.MeshType.BOX, (0.6, -1.4, -0.5), (1.2,))
    b.add(tex_material(m, m.TexType.VORONOI, (2.0, 2.0, 2.0, 0.0)),
          m.MeshType.BOX, (-1.2, -1.4, 0.2), (1.0,))
    b.add("MAT_WHITE", m.MeshType.PLANE, (0.0, 0.0, 1.0), (2.0,))
    b.add(tex_material(m, m.TexType.VALUE_NOISE, (16.0, 16.0, 16.0, 0.0), c=(0.2, 0.5, 0.3)),
          m.MeshType.PLANE, (1.0, 0.0, 0.0), (2.0,))
    b.add(tex_material(m, m.TexType.RIPPLE, (0.0, 0.0, 8.0, 2.0), c=(0.6, 0.6, 0.1)),
          m.MeshType.PLANE, (-1.0, 0.0, 0.0), (2.0,))
    b.add("MAT_LIGHT_4", m.MeshType.SPHERE, (0.0, 1.5, 0.0), (0.4,))
    return b.build() if device is None else b.build(device=device)


def gradient_noise_scene(builder, m, device=None):
    """tests/test_megakernel.py:247-266: a GRADIENT_NOISE floor."""
    b = builder()
    b.add(tex_material(m, m.TexType.GRADIENT_NOISE, (3.0, 3.0, 3.0, 0.0), c=(0.5, 0.3, 0.2)),
          m.MeshType.PLANE, (0.0, 1.0, 0.0), (2.0,))
    b.add("MAT_LIGHT_4", m.MeshType.SPHERE, (0.0, 1.5, 0.0), (0.4,))
    return b.build() if device is None else b.build(device=device)


def check_sphere_scene(builder, m, device=None):
    """tests/test_megakernel.py:795-806: a CHECK-textured sphere, whose UV
    is spherical (asin/atan2 of the world hit position)."""
    mat = m.Material(c=(0.8, 0.6, 0.4), t=m.MatType.DIFF,
                     tex=m.Texture(t=m.TexType.CHECK, c_mask=(1.0, 1.0, 1.0),
                                   params=(8.0, 8.0, 2.0, 2.0)),
                     opts=(True, False, False, False))
    b = builder()
    b.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, 1.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, 0.0, 1.0), (2.5,))
    b.add("MAT_LIGHT_4", m.MeshType.SPHERE, (0.0, 1.4, -1.2), (0.3,))
    b.add(mat, m.MeshType.SPHERE, (0.0, -0.6, -1.2), (0.6,))
    return b.build() if device is None else b.build(device=device)


# (camera origin, lookat, fov) and config of the scenes above
SCENE_VIEWS = {
    "procedural": (procedural_scene, ((0.0, 0.0, 1.9), (0.0, -0.4, -1.0), 60.0),
                   dict(max_bounces=3, use_procedural_sky=True)),
    "gradient_noise": (gradient_noise_scene, ((0.0, 0.5, 1.9), (0.0, -0.5, -1.0), 60.0),
                       dict(max_bounces=2, use_procedural_sky=True)),
    "check_sphere": (check_sphere_scene, ((0.0, -0.5, 0.0), (0.0, -0.6, -1.2), 8.0),
                     dict(max_bounces=3)),
}


@pytest.mark.parametrize("name", list(SCENE_VIEWS))
def test_scenes_match_jax(name):
    """Both packages build the same scene from these builders."""
    import numpy as np
    from raytracer0_tpu.models import materials as jmat
    from raytracer0_tpu.models.scene import SceneBuilder as JBuilder
    from raytracer0_tpu_torch.models import materials as tmat
    from raytracer0_tpu_torch.models.scene import STATIC_FIELDS, TENSOR_FIELDS
    from raytracer0_tpu_torch.models.scene import SceneBuilder as TBuilder

    make = SCENE_VIEWS[name][0]
    js, ts = make(JBuilder, jmat), make(TBuilder, tmat, device="cpu")
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), k)
    for k in STATIC_FIELDS:
        assert getattr(ts, k) == getattr(js, k), k
    assert ts.tex_types_used
