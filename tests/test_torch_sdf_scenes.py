"""Three classes of the whole SDF class, the gates that take them or
refuse them, shared by the port's SDF tests (CPU, host build and card),
and a check that both packages build the whole SDF class's scenes
(`presets.SDF_SCENE_VIEWS`) alike.

This module imports neither JAX nor the JAX package at its top, so the
card's tests (tests/test_torch_cuda.py, run without JAX) can use it.
"""

import pytest

from raytracer0_tpu_torch.models import presets


#: three classes of the whole SDF class: K1, K2 and the plain version
#: render them, K4 and K6v in their whole-SDF copies under ReSTIR
NEW_CLASSES = ("mandelbulb", "textured_box", "sdf_light")
#: the gates of the other kernels and routes (K2 admits them: it
#: differentiates K1's whole class)
GATES = ("K4", "K5", "K6", "split", "K7", "restir")
#: the gate that models BOX and ROUND_BOX rows alone (K5), which refuses
#: all three naming item 8; K7 differentiates the whole SDF class in its
#: whole-SDF copy
BOX_ONLY_GATES = ("K5",)


def new_class_case(where, device):
    """(scene, camera, cfg) of a class only K1 and the plain version
    render: a Mandelbulb (`presets.mandelbulb`), a textured BOX SDF
    (`presets.default_scene`'s METAL box), an SDF light
    (`presets.sdf_light_scene`)."""
    if where == "mandelbulb":
        return presets.mandelbulb(device=device)
    if where == "textured_box":
        return presets.default_scene(device=device)
    return presets.sdf_view("sdf_light", device=device)


def expected_verdict(gate, where):
    """The ROADMAP item `gate` names when it refuses the class `where`
    (as a ReSTIR config with MIS off), or None when it admits it: K5
    refuses all three (item 8); the ReSTIR gates, K7's among them, admit
    the Mandelbulb (K4's, K6v's and K7's whole-SDF copies) and refuse
    `default_scene`, which has no light for ReSTIR, and the SDF light,
    whose slot is not a LIGHT sphere, as the JAX `supported_restir` does
    (item 11)."""
    if gate in BOX_ONLY_GATES:
        return "ROADMAP queue 1 item 8"
    return None if where == "mandelbulb" else "ROADMAP queue 1 item 11"


def gate_reason(gate, scene, cam, cfg):
    """Why `gate` refuses (scene, cfg as a ReSTIR config where the gate
    takes one), or None: the gate's own function; the split path's raises,
    and its message is returned."""
    from raytracer0_tpu_torch.ops import restir_kernel, restir_split
    from raytracer0_tpu_torch.render import integrator
    from raytracer0_tpu_torch.render.state import RenderState

    rcfg = cfg.replace(use_restir=True, use_mis=False)
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


@pytest.mark.parametrize("name", list(presets.SDF_SCENE_VIEWS))
def test_scenes_match_jax(name):
    """Both packages build the same scene from the builders of
    `presets.SDF_SCENE_VIEWS`."""
    import numpy as np
    from raytracer0_tpu.models import materials as jmat
    from raytracer0_tpu.models.scene import SceneBuilder as JBuilder
    from raytracer0_tpu_torch.models import materials as tmat
    from raytracer0_tpu_torch.models.scene import STATIC_FIELDS, TENSOR_FIELDS
    from raytracer0_tpu_torch.models.scene import SceneBuilder as TBuilder

    make = presets.SDF_SCENE_VIEWS[name][0]
    js = make(device=None, builder=JBuilder, m=jmat)
    ts = make(device="cpu", builder=TBuilder, m=tmat)
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), k)
    for k in STATIC_FIELDS:
        assert getattr(ts, k) == getattr(js, k), k
    assert ts.num_sdfs in (1, 2, 3, 11)
