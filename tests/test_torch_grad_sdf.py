"""Gradients of the port's 14 SDF distances against `jax.grad`.

The hand-written adjoint K2 differentiates every SDF shape through
`csrc/adjoint.cuh::sdf_entry_bwd`, the reverse-mode twin of
`csrc/trace_common.cuh::sdf_entry_all`, which repeats `ops/sdf.py`
operation for operation.  Its plain version is `torch.autograd` through
`ops/sdf.py`; here that autograd is held against `jax.grad` of the JAX
package's `_entry_distance` (raytracer0_tpu/ops/sdf.py:254) on a one-row
scene of each shape, at 300 seeded points about the row (half of them near
its surface), w.r.t. the points, the row's pos, joker and aux (read by
TRIANGLE and QUAD alone), per leaf within GRAD_TOL = 1e-4 relative:
max|a - b| / max|b|.

Where jax.grad is NaN by design the points are counted, so a new one
fails: where `vecmath.length` or `jnp.sqrt(jnp.maximum(x, 0))` meets 0 (a
point inside a box, a sponge or a sea box, in a rounded box's core,
inside a cone; the port's `length` and `safe_sqrt` give 0 there), and
where a Mandelbulb lane that is done keeps iterating to an overflow whose
NaN the `where` multiplies by a zero cotangent (the port's done lanes
iterate on w = 0, `ops/sdf.mandelbulb`).  The leaves are then compared on
every point where the reference is finite once its `vecmath.length` has
the port's zero gradient at 0 (`safe_jax_length`, the same forward
values): the points inside a box, a sponge or a sea box, whose length is
0 however the point moves, are compared there, and the NaNs of the
cone's, the triangle's and the quad's own square roots and of the
Mandelbulb are counted again.  The Mandelbulb's points include a shell of
radius 2-2.5 about it, inside its bounding sphere, where the march
evaluates it and a lane is done after one iteration.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu.models.scene import SceneBuilder as JBuilder
from raytracer0_tpu.ops import sdf as jsdf
from raytracer0_tpu.ops import vecmath as jvm
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.models.materials import SdfShape
from raytracer0_tpu_torch.ops import sdf as tsdf

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GRAD_TOL = 1e-4
LEAVES = ("p", "pos", "joker", "aux")
# the points where jax.grad gives NaN, per shape, with the reference's own
# vecmath.length and with `safe_jax_length` (module docstring)
NAN_POINTS = {"BOX": 242, "ROUND_BOX": 20, "CONE": 32, "MENGER_SPONGE": 236, "SEA_BOX": 91,
              "MANDELBULB": 42}
NAN_POINTS_SAFE = {"CONE": 32, "MANDELBULB": 42}


def safe_jax_length(monkeypatch):
    """Give the JAX package's `vecmath.length`, sqrt(max(a.a, 0)), the port's
    zero gradient at 0, with the same forward values (a double `where`)."""
    def length(a):
        s = jvm.vdot(a, a)
        pos = s > 0.0
        return jnp.where(pos, jnp.sqrt(jnp.where(pos, s, 1.0)), 0.0)
    monkeypatch.setattr(jvm, "length", length)


def _points(shape):
    """300 seeded points about the row of `shape`, half of them near it."""
    pos, joker, _ = (np.asarray(v, np.float32) for v in tpresets.shape_rows()[shape])
    center = (pos + joker[:3]) / 2 if shape == SdfShape.CAPSULE else pos
    r = np.random.default_rng(100 + shape)
    p = [r.uniform(-1.2, 1.2, (150, 3)), r.uniform(-0.35, 0.35, (150, 3))]
    if shape == SdfShape.MANDELBULB:
        u = r.normal(size=(60, 3))
        p.append(u / np.linalg.norm(u, axis=-1, keepdims=True) * r.uniform(2.0, 2.5, (60, 1)))
    return (center + np.concatenate(p)).astype(np.float32)


def distance_grads(shape, p, wt):
    """(port, JAX) gradients of sum(wt * distance(p)) of a one-row scene of
    `shape` w.r.t. LEAVES, each {leaf: array}."""
    ts = tpresets.one_row_scene(shape, device="cpu")
    js = tpresets.one_row_scene(shape, device=None, builder=JBuilder)
    t_leaves = {"p": torch.from_numpy(p.copy())}
    t_leaves.update({k: getattr(ts, k).detach().clone() for k in LEAVES[1:]})
    for v in t_leaves.values():
        v.requires_grad_(True)
    s = ts.replace(**{k: t_leaves[k] for k in LEAVES[1:]})
    d = tsdf._entry_distance(s, 0, t_leaves["p"])
    got = torch.autograd.grad((d * torch.from_numpy(wt)).sum(), list(t_leaves.values()),
                              allow_unused=True)
    got = {k: (torch.zeros_like(t_leaves[k]) if g is None else g).numpy()
           for k, g in zip(LEAVES, got)}

    def jdist(pp, pos, joker, aux):
        return jnp.sum(jnp.asarray(wt) * jsdf._entry_distance(
            js.replace(pos=pos, joker=joker, aux=aux), 0, pp))

    want = jax.grad(jdist, argnums=(0, 1, 2, 3))(jnp.asarray(p), js.pos, js.joker, js.aux)
    return got, {k: np.asarray(v) for k, v in zip(LEAVES, want)}


@pytest.mark.parametrize("shape", [s.name for s in SdfShape])
def test_distance_grad_matches_jax(shape, monkeypatch):
    """d distance / d(p, pos, joker, aux) of each shape: the port's plain
    autograd against jax.grad of `_entry_distance`, per leaf within 1e-4
    relative, JAX's NaN entries counted."""
    code = int(SdfShape[shape])
    p = _points(code)
    wt = np.random.default_rng(7).uniform(0.5, 1.5, len(p)).astype(np.float32)
    got, want = distance_grads(code, p, wt)
    assert all(np.isfinite(v).all() for v in got.values())
    nan_pts = ~np.isfinite(want["p"]).all(-1)
    safe_jax_length(monkeypatch)
    got, want = distance_grads(code, p, wt)
    nan_safe = ~np.isfinite(want["p"]).all(-1)
    print(f"{shape}: jax.grad NaN at {int(nan_pts.sum())} of {len(p)} points, "
          f"{int(nan_safe.sum())} with a safe length")
    assert int(nan_pts.sum()) == NAN_POINTS.get(shape, 0)
    assert int(nan_safe.sum()) == NAN_POINTS_SAFE.get(shape, 0)
    if nan_safe.any():   # the other points, where both are finite
        got, want = distance_grads(code, p[~nan_safe], wt[~nan_safe])
    for k, b in want.items():
        a = got[k]
        assert a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all(), k
        scale = max(np.abs(b).max(), 1e-12)
        assert np.abs(a - b).max() / scale < GRAD_TOL, (k, np.abs(a - b).max(), scale)
    assert np.abs(want["p"]).max() > 0.0 and np.abs(want["pos"]).max() > 0.0
    reads_joker = code not in (SdfShape.MANDELBULB, SdfShape.SIGGRAPH, SdfShape.TRIANGLE,
                               SdfShape.QUAD)
    assert (np.abs(want["joker"]).max() > 0.0) == reads_joker
    reads_aux = code in (SdfShape.TRIANGLE, SdfShape.QUAD)
    assert (np.abs(want["aux"]).max() > 0.0) == reads_aux
    assert (np.abs(got["aux"]).max() > 0.0) == reads_aux


@pytest.mark.parametrize("name", ["every_shape", "mandelbulb"])
def test_plain_grad_matches_jax_scene(name, monkeypatch):
    """The port's plain gradient of `integrator.trace` against jax.grad on
    the scene that holds every shape the presets do not and on
    `mandelbulb` (tests/test_torch_grad_sdf_scenes.py::check_plain_grad,
    which runs the other scenes)."""
    from test_torch_grad_sdf_scenes import check_plain_grad

    check_plain_grad(name, monkeypatch)
