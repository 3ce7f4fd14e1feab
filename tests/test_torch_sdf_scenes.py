"""SDF scenes shared by the port's SDF tests (CPU, host build and card),
built alike with either package's SceneBuilder and materials module, and a
check that both packages build the same scene.

`sdf_light_scene` is the Cornell geometry of tests/test_megakernel.py:700-716
with its light an SDF rounded box, which NEE samples at a point of its
bounding ellipsoid.  `every_shape_scene` holds every SDF shape that the
reference's presets do not (ROUND_BOX, SPHERE, TRI_PRISM, CONE, ELLIPSOID,
CAPSULE, SNOWBALL, SEA_BOX, SIGGRAPH, TRIANGLE and QUAD) in a closed box
under a sphere light, a CHECK texture blended into the quad's color; its
capsule, prism, cone, sea box, SIGGRAPH object, triangle and quad have no
bounding sphere, so the march's gate is off.

This module imports neither JAX nor the JAX package at its top, so the
card's tests (tests/test_torch_cuda.py, run without JAX) can use it.
"""

import pytest


def sdf_light_scene(builder, m, device=None):
    """tests/test_megakernel.py:700-716: Cornell walls, a box and an SDF
    ROUND_BOX light (the only light slot)."""
    b = builder()
    b.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, 1.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, -1.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, 0.0, 1.0), (2.5,))
    b.add("MAT_CORNELL_RED", m.MeshType.PLANE, (1.0, 0.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_GREEN", m.MeshType.PLANE, (-1.0, 0.0, 0.0), (1.5,))
    b.add("MAT_CORNELL_WHITE", m.MeshType.BOX, (0.5, -1.0, -1.8), (1.0,))
    b.add("MAT_LIGHT_4", m.MeshType.SDF, (0.0, 1.0, -1.2), (0.3, 0.3, 0.3, 0.05),
          sdf_shape=m.SdfShape.ROUND_BOX)
    return b.build() if device is None else b.build(device=device)


def every_shape_scene(builder, m, device=None):
    """The 11 SDF shapes no preset of the reference holds, three rows of
    them in front of the camera, in a box of five planes under a sphere
    light; the quad carries a CHECK texture on its color."""
    S = m.SdfShape
    check = m.Material(c=(0.7, 0.5, 0.3), t=m.MatType.DIFF,
                       tex=m.Texture(t=m.TexType.CHECK, params=(4.0, 4.0, 2.0, 2.0)),
                       opts=(True, False, False, False))
    b = builder()
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
    return b.build() if device is None else b.build(device=device)


# (camera origin, lookat, fov) and config of the scenes above
SCENE_VIEWS = {
    "sdf_light": (sdf_light_scene, ((0.0, 0.0, 2.8), (0.0, 0.0, -1.0), 50.0),
                  dict(max_bounces=2)),
    "every_shape": (every_shape_scene, ((0.0, 0.0, 1.6), (0.0, -0.05, -1.0), 75.0),
                    dict(max_bounces=2)),
}


#: the three classes K1 renders and no other kernel models
NEW_CLASSES = ("mandelbulb", "textured_box", "sdf_light")
#: the gates that refuse them, each a kernel or route
GATES = ("K2", "K4", "K5", "K6", "split", "K7", "restir")


def new_class_case(where, device):
    """(scene, camera, cfg) of a class only K1 and the plain version
    render: a Mandelbulb (`presets.mandelbulb`), a textured BOX SDF
    (`presets.default_scene`'s METAL box), an SDF light (`sdf_light_scene`)."""
    from raytracer0_tpu_torch.config import OFFLINE_CONFIG
    from raytracer0_tpu_torch.models import materials, presets
    from raytracer0_tpu_torch.models.camera import Camera
    from raytracer0_tpu_torch.models.scene import SceneBuilder

    if where == "mandelbulb":
        return presets.mandelbulb(device=device)
    if where == "textured_box":
        return presets.default_scene(device=device)
    make, (origin, lookat, fov), kw = SCENE_VIEWS["sdf_light"]
    return (make(SceneBuilder, materials, device=device),
            Camera.make(origin=origin, lookat=lookat, fov=fov, device=device),
            OFFLINE_CONFIG.replace(**kw))


def gate_reason(gate, scene, cam, cfg):
    """Why `gate` refuses (scene, cfg as a ReSTIR config where the gate
    takes one), or None: the gate's own function; the split path's raises,
    and its message is returned."""
    from raytracer0_tpu_torch.ops import megakernel, restir_kernel, restir_split
    from raytracer0_tpu_torch.render import integrator
    from raytracer0_tpu_torch.render.state import RenderState

    rcfg = cfg.replace(use_restir=True, use_mis=False)
    if gate == "K2":
        return megakernel.unsupported_bwd(scene, cfg)
    if gate == "K4":
        return restir_split.unsupported_gbuffer(scene, rcfg)
    if gate == "K5":
        return restir_split.unsupported_cast(scene)
    if gate == "K6":
        return restir_kernel.unsupported_restir(scene, rcfg)
    if gate == "K7":
        return restir_kernel.unsupported_restir_bwd(scene, rcfg)
    if gate == "restir":
        return integrator.unsupported(scene, rcfg)
    try:
        restir_split.check_split(scene, rcfg.replace(restir_adhoc_motion=True), cam,
                                 RenderState.create(4, 4, device=scene.device))
    except NotImplementedError as exc:
        return str(exc)
    return None


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
    assert ts.num_sdfs in (1, 11)
