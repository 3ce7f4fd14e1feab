"""Port models (scene, DSL, camera, presets) against the JAX package.

Scenes are built from the same Python data, so every tensor and static
field must be equal exactly.  Rays go through float32 math that rounds
per operation in both frameworks (sqrt, tan, sin, cos may differ by one
ULP), so they are compared within 1e-6, about 8 ULP at unit length.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer0_tpu.models import camera as jcam
from raytracer0_tpu.models import dsl as jdsl
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.models.materials import SdfShape
from raytracer0_tpu_torch.models import camera as tcam
from raytracer0_tpu_torch.models import dsl as tdsl
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models.scene import STATIC_FIELDS, TENSOR_FIELDS, Scene

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RAY_TOL = 1e-6


def _scene_arrays(js):
    return {k: np.asarray(getattr(js, k)) for k in TENSOR_FIELDS}


def _scene_static(js):
    return {k: getattr(js, k) for k in STATIC_FIELDS}


def assert_scene_equal(ts, js):
    for k in TENSOR_FIELDS:
        a, b = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in STATIC_FIELDS:
        assert getattr(ts, k) == getattr(js, k), k
    assert ts.num_meshes == js.num_meshes
    assert ts.num_lights == js.num_lights


def test_cornell_default_matches_jax():
    ts, tc, tcfg = tpresets.cornell_default(device="cpu", use_mis=True)
    js, jc, jcfg = jpresets.cornell_default(use_mis=True)
    assert_scene_equal(ts, js)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for k in ("origin", "lookat", "fov", "aperture", "focal_length"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)))


def test_parse_scene_matches_jax():
    text = """
        // comment line
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_LIGHT_4, SPHERE, vec3(0.0, 1.5, -1.0), vec4(0.3)
        MAT_MIRROR, BOX, vec3(0.6, -0.6, -0.5), vec4(0.4, 0.1)
        MAT_METAL, SDF, vec3(0.0, -0.49, 0.0), vec4(1.0)
        MAT_WHITE, SDF, vec3(0.0, -1.6, -0.2), vec4(1.5, 0.1, 1.5, 0.0)
    """
    shapes = [SdfShape.SPHERE, SdfShape.BOX]
    ts = tdsl.parse_scene(text, sdf_shapes=shapes, lights=[1, 0], device="cpu")
    js = jdsl.parse_scene(text, sdf_shapes=shapes, lights=[1, 0])
    assert_scene_equal(ts, js)
    with pytest.raises(ValueError):
        tdsl.parse_scene("MAT_WHITE, CONE, vec3(0.0), vec4(1.0)", device="cpu")


def test_from_arrays_matches_jax():
    js, jc, _ = jpresets.cornell_default()
    ts = Scene.from_arrays(_scene_arrays(js), _scene_static(js), "cpu")
    assert_scene_equal(ts, js)
    arrays = {k: np.asarray(getattr(jc, k))
              for k in ("origin", "lookat", "fov", "aperture", "focal_length")}
    tc = tcam.Camera.from_arrays(arrays, "cpu")
    for k, v in arrays.items():
        np.testing.assert_array_equal(getattr(tc, k).numpy(), v)


@pytest.mark.parametrize("name", ["cornell_box", "textured_cornell", "textured_gloss",
                                  "textured_emitter"])
def test_textured_presets_match_jax(name):
    """The textured presets build the JAX package's scene (images, noise
    LUT, texture codes, params, masks and options), and `from_arrays`
    carries the JAX scene across unchanged."""
    js, jc, jcfg = getattr(jpresets, name)()
    ts, tc, tcfg = getattr(tpresets, name)(device="cpu")
    assert_scene_equal(ts, js)
    assert_scene_equal(Scene.from_arrays(_scene_arrays(js), _scene_static(js), "cpu"), js)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    np.testing.assert_allclose(tc.origin.numpy(), np.asarray(jc.origin), rtol=0, atol=0)
    assert ts.tex_types_used and any(c or e for c, e in ts.opts_static)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(row0=8, full_height=48),
    dict(aperture=0.1, pass_idx=3),
], ids=["pinhole", "band", "thin_lens"])
def test_generate_rays_matches_jax(kw):
    kw = dict(kw)
    aperture = kw.pop("aperture", 0.0)
    pass_idx = kw.pop("pass_idx", 0)
    cam_kw = dict(origin=(0.1, 0.2, 2.8), lookat=(0.05, -0.1, -1.0), fov=50.0,
                  aperture=aperture, focal_length=3.5)
    h = w = 24
    jro, jrd = jcam.generate_rays(jcam.Camera.make(**cam_kw), h, w, pass_idx,
                                  sample_idx=1, **kw)
    tro, trd = tcam.generate_rays(tcam.Camera.make(**cam_kw, device="cpu"), h, w, pass_idx,
                                  sample_idx=1, **kw)
    assert tro.shape == (h, w, 3) and tro.dtype == torch.float32
    np.testing.assert_allclose(tro.numpy(), np.asarray(jro), rtol=0, atol=RAY_TOL)
    np.testing.assert_allclose(trd.numpy(), np.asarray(jrd), rtol=0, atol=RAY_TOL)


def test_camera_basis_and_tent_match_jax():
    jc = jcam.Camera.make(lookat=(0.3, -0.2, -1.0))
    tc = tcam.Camera.make(lookat=(0.3, -0.2, -1.0), device="cpu")
    for a, b in zip(tc.basis(), jc.basis()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
    r = np.random.default_rng(0).random(1000, dtype=np.float32)
    np.testing.assert_allclose(tcam.tent_jitter(torch.from_numpy(r)).numpy(),
                               np.asarray(jcam.tent_jitter(jnp.asarray(r))),
                               rtol=0, atol=1e-7)
