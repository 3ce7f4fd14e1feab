"""Signed-distance fields: the BOX and ROUND_BOX primitives, the scene map,
the tetrahedral normal and the sphere-tracing marcher (port of the parts of
ops/sdf.py that the SDF presets use; raytracer.glsl:496-511, 700-722,
974-993).

`march` is the plain version of K1's per-thread march
(`csrc/trace_common.cuh::sdf_march`): the same bounding-sphere gate, step
rule, fudge factor, final re-evaluation and 4-tap normal, operation for
operation.  Here every lane steps until all lanes are done; the kernel
lets each thread stop on its own, which gives the same `t`, since a lane
that is done no longer moves.

Gradients flow through the implicit function theorem, as in the JAX
package: the march runs without autograd, and the hit `t` is reattached as
`t* - (f(x*, θ) - sg(f)) / sg(∂f/∂t)`, whose forward value is `t*` and
whose derivative is `-f_θ / f_t` at the surface.

The other shapes of the JAX library (sphere, prisms, fractals, triangles
and the rest) come with ROADMAP queue 1 item 8; `integrator.unsupported`
refuses them.
"""

from __future__ import annotations

import torch

from raytracer0_tpu_torch.models.materials import SdfShape
from raytracer0_tpu_torch.ops import vecmath as vm

#: The shapes this module evaluates.
SHAPES = (int(SdfShape.BOX), int(SdfShape.ROUND_BOX))

# calcNormal's tetrahedron taps (raytracer.glsl:714-722)
_TAPS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))


def sd_box(p, b):
    """Signed distance to a box of half-extents `b` (raytracer.glsl:496-500)."""
    d = torch.abs(p) - b
    outside = vm.length(torch.clamp_min(d, 0.0))
    inside = torch.clamp_max(torch.amax(d, dim=-1), 0.0)
    return outside + inside


def ud_round_box(p, b, r):
    """Unsigned distance to a box of half-extents `b` rounded by `r`
    (raytracer.glsl:502-505)."""
    return vm.length(torch.clamp_min(torch.abs(p) - b, 0.0)) - r


def _entry_distance(scene, k, p):
    """Distance of SDF entry `k` (its ordinal among the SDF rows) at `p`."""
    i = scene.num_analytic + k
    shape = scene.sdf_shapes_static[k]
    q = p - scene.pos[i]
    jk = scene.joker[i]
    if shape == SdfShape.BOX:
        return sd_box(q, jk[:3])
    if shape == SdfShape.ROUND_BOX:
        return ud_round_box(q, jk[:3], jk[3])
    raise NotImplementedError(
        f"SDF shape {SdfShape(shape).name}: ROADMAP queue 1 item 8")


def scene_map(scene, p):
    """min over the SDF entries: (distance [...], SDF ordinal int64 [...]);
    the first entry wins a tie (raytracer.glsl:700-712)."""
    best_d = _entry_distance(scene, 0, p)
    best_i = torch.zeros(best_d.shape, dtype=torch.int64, device=p.device)
    for k in range(1, scene.num_sdfs):
        d = _entry_distance(scene, k, p)
        best_i = torch.where(d < best_d, torch.full_like(best_i, k), best_i)
        best_d = torch.minimum(d, best_d)
    return best_d, best_i


def calc_normal(scene, p, eps):
    """Tetrahedral 4-tap finite-difference normal (raytracer.glsl:714-722)."""
    n = torch.zeros_like(p)
    for tap in _TAPS:
        k = torch.tensor(tap, dtype=p.dtype, device=p.device)
        n = n + k * scene_map(scene, p + k * eps)[0][..., None]
    return vm.normalize(n)


def bound_radius(scene, k):
    """Radius of a sphere about entry `k`'s center that holds the whole
    shape (rotation-invariant, with a margin)."""
    jk = scene.joker[scene.num_analytic + k]
    norm3 = torch.sqrt(jk[0] * jk[0] + jk[1] * jk[1] + jk[2] * jk[2])
    if scene.sdf_shapes_static[k] == SdfShape.ROUND_BOX:
        return norm3 * 1.05 + torch.abs(jk[3]) + 0.05
    return norm3 * 1.05 + 0.05


@torch.no_grad()
def march_loop(scene, ro, rd, tmin, cfg):
    """The raw sphere trace (raytracer.glsl:974-993), without autograd:
    (t, SDF ordinal, valid, steps).  A lane whose ray does not enter any
    entry's bounding sphere within [0, tmin] cannot converge there, so it is
    done from the start and invalid.  `steps` counts each lane's loop
    iterations, the work the kernel's per-thread march does."""
    t = torch.full(ro.shape[:-1], cfg.epsilon * 4.0, dtype=torch.float32,
                   device=ro.device)
    d0, _ = scene_map(scene, ro + rd * t[..., None])
    done = torch.abs(d0) < cfg.epsilon

    can_hit = torch.zeros_like(done)
    for k in range(scene.num_sdfs):
        rb = bound_radius(scene, k)
        oc = ro - scene.pos[scene.num_analytic + k]
        b = vm.vdot(oc, rd)
        cq = vm.vdot(oc, oc) - rb * rb
        disc = b * b - cq
        sq = vm.safe_sqrt(disc)
        can_hit = can_hit | ((disc > 0.0) & (-b + sq > 0.0) & (-b - sq < tmin))
    done = done | ~can_hit

    step = 0
    steps = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    while step < cfg.marching_steps - 1 and not bool(done.all()):
        steps += (~done).to(torch.int32)
        dist, _ = scene_map(scene, ro + rd * t[..., None])
        h = torch.abs(dist)
        stop = done | (h < cfg.epsilon) | (t > tmin)
        t = torch.where(stop, t, t + h * cfg.fudge_factor)
        done = stop
        step += 1
    # the final evaluation at the settled t picks the winning entry
    _, res_i = scene_map(scene, ro + rd * t[..., None])
    return t, res_i, (t <= tmin) & can_hit, steps


def march(scene, ro, rd, tmin, cfg):
    """SDF intersection up to `tmin`: (t, mesh index int64, normal, valid).

    `t` carries the implicit-function gradient w.r.t. the scene, `ro` and
    `rd` (module docstring); the march itself is not differentiated."""
    t_star, res_i, valid, _ = march_loop(scene, ro, rd, tmin, cfg)
    # invalid lanes are evaluated at the ray origin (the caller drops them)
    t_safe = torch.where(valid, t_star, torch.zeros_like(t_star))
    x_star = ro + rd * t_safe[..., None]
    f_val, _ = scene_map(scene, x_star)
    with torch.no_grad():
        h = cfg.epsilon
        f_fwd, _ = scene_map(scene, x_star + rd * h)
        f_bwd, _ = scene_map(scene, x_star - rd * h)
        dfdt = (f_fwd - f_bwd) / torch.full_like(f_fwd, 2.0 * h)
        floor = torch.where(dfdt < 0.0, torch.full_like(dfdt, -0.05),
                            torch.full_like(dfdt, 0.05))
        dfdt = torch.where(torch.abs(dfdt) < 0.05, floor, dfdt)
    t = torch.where(valid, t_star - (f_val - f_val.detach()) / dfdt, t_star)
    idx = scene.num_analytic + res_i
    x = ro + rd * torch.where(valid, t, torch.zeros_like(t))[..., None]
    return t, idx, calc_normal(scene, x, cfg.epsilon), valid
