"""Signed-distance fields: the 14 primitives and fractals of the JAX
package, the scene map, the tetrahedral normal and the sphere-tracing
marcher (port of ops/sdf.py; raytracer.glsl:496-722, 974-993).

`march` is the plain version of K1's per-thread march
(`csrc/trace_common.cuh::sdf_march`): the same bounding-sphere gate, step
rule, fudge factor, final re-evaluation and 4-tap normal, operation for
operation.  Here every lane steps until all lanes are done; the kernel
lets each thread stop on its own, which gives the same `t`, since a lane
that is done no longer moves.  The gate holds where every entry has a
bound (`bound_radius`); one entry without one switches it off for the
whole scene, as in the JAX package (the kernels give such an entry an
infinite radius, which admits every ray).

Each distance is written so that the kernel can repeat it operation for
operation: integer powers as the products JAX's `integer_pow` multiplies
(`k3 ** 7` = (k3 * k3²) * k3⁴), `jnp.mod` as `torch.remainder` (the
floored remainder), `1/sqrt` as a reciprocal of a square root, cross
products from separate products and differences (PyTorch's fused cross
kernel may contract them into FMAs on the card), and every division by a
constant as a division by a tensor (PyTorch on the card multiplies by the
reciprocal of a Python float).  A NaN distance (a Mandelbulb evaluated far
out, where its polynomial overflows) wins the scene map's minimum, as
`jnp.minimum` and `torch.minimum` let it.

Gradients flow through the implicit function theorem, as in the JAX
package: the march runs without autograd, and the hit `t` is reattached as
`t* - (f(x*, θ) - sg(f)) / sg(∂f/∂t)`, whose forward value is `t*` and
whose derivative is `-f_θ / f_t` at the surface.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer0_tpu_torch.models.materials import SdfShape
from raytracer0_tpu_torch.ops import noise as nz
from raytracer0_tpu_torch.ops import vecmath as vm

#: The shapes this module evaluates: every SdfShape code.
SHAPES = tuple(int(s) for s in SdfShape)
#: The shapes of the SDF class that K5 and the copies of K2, K4 and K6v
#: built without the whole SDF class serve (K7's ROUND_BOX copy serves the
#: ROUND_BOX alone).
BOX_SHAPES = (int(SdfShape.BOX), int(SdfShape.ROUND_BOX))

# calcNormal's tetrahedron taps (raytracer.glsl:714-722)
_TAPS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
# siggraph_obj's axis, jnp.asarray([-2, 2, 1]) / 3 rounded once in float32
_SIG_AX = tuple(float(v) for v in np.float32([-2.0, 2.0, 1.0]) / np.float32(3.0))
_SIG_CE = (0.0, -0.2, -0.2)


def _const(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


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


def sd_sphere(p, s):
    return vm.length(p) - s


def sd_cone(p, c):
    """Cone of (sin, cos, height) `c` about the y axis (raytracer.glsl:512-520)."""
    qx = vm.safe_sqrt(p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2])
    qy = p[..., 1]
    d1 = -qy - c[..., 2]
    d2 = torch.maximum(qx * c[..., 0] + qy * c[..., 1], qy)
    m1, m2 = torch.clamp_min(d1, 0.0), torch.clamp_min(d2, 0.0)
    outside = vm.safe_sqrt(m1 * m1 + m2 * m2)
    return outside + torch.clamp_max(torch.maximum(d1, d2), 0.0)


def sd_tri_prism(p, h):
    q = torch.abs(p)
    return torch.maximum(
        q[..., 2] - h[..., 1],
        torch.maximum(q[..., 0] * 0.866025 + p[..., 1] * 0.5, -p[..., 1]) - h[..., 0] * 0.5)


def sd_ellipsoid(p, r):
    return (vm.safe_length(p / r) - 1.0) * torch.amin(r, dim=-1)


def sd_capsule(p, a, b, r):
    """Capsule from `a` to `b` of radius `r`; `p` and `a` in world space."""
    pa = p - a
    ba = b - a
    h = torch.clamp(vm.vdot(pa, ba) / torch.clamp_min(vm.vdot(ba, ba), 1e-12), 0.0, 1.0)
    return vm.length(pa - ba * h[..., None]) - r


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _edge_dist2(edge, pv):
    """Squared distance from pv to the segment 0→edge (udTriangle/udQuad)."""
    h = torch.clamp(vm.vdot(edge, pv) / torch.clamp_min(vm.vdot(edge, edge), 1e-12), 0.0, 1.0)
    v = edge * h[..., None] - pv
    return vm.vdot(v, v)


def _face_or_edge(nor, pa, edge_region, d_edge):
    dn = vm.vdot(nor, pa)
    d_face = dn * dn / torch.clamp_min(vm.vdot(nor, nor), 1e-12)
    return vm.safe_sqrt(torch.where(edge_region, d_edge, d_face))


def ud_triangle(p, a, b, c):
    """Unsigned distance to triangle abc (raytracer.glsl:537-554)."""
    ba, pa = b - a, p - a
    cb, pb = c - b, p - b
    ac, pc = a - c, p - c
    nor = _cross(ba, ac)
    edge_region = (torch.sign(vm.vdot(_cross(ba, nor), pa))
                   + torch.sign(vm.vdot(_cross(cb, nor), pb))
                   + torch.sign(vm.vdot(_cross(ac, nor), pc))) < 2.0
    d_edge = torch.minimum(torch.minimum(_edge_dist2(ba, pa), _edge_dist2(cb, pb)),
                           _edge_dist2(ac, pc))
    return _face_or_edge(nor, pa, edge_region, d_edge)


def ud_quad(p, a, b, c, d):
    """Unsigned distance to quad abcd (raytracer.glsl:556-576)."""
    ba, pa = b - a, p - a
    cb, pb = c - b, p - b
    dc, pc = d - c, p - c
    ad, pd = a - d, p - d
    nor = _cross(ba, ad)
    edge_region = (torch.sign(vm.vdot(_cross(ba, nor), pa))
                   + torch.sign(vm.vdot(_cross(cb, nor), pb))
                   + torch.sign(vm.vdot(_cross(dc, nor), pc))
                   + torch.sign(vm.vdot(_cross(ad, nor), pd))) < 3.0
    d_edge = torch.minimum(torch.minimum(_edge_dist2(ba, pa), _edge_dist2(cb, pb)),
                           torch.minimum(_edge_dist2(dc, pc), _edge_dist2(ad, pd)))
    return _face_or_edge(nor, pa, edge_region, d_edge)


def disp(p, phase, power):
    """The sea's displacement (raytracer.glsl:626-630); torch.pow copies its
    base for `power` 1, the only one used."""
    return torch.pow(0.5 + 0.5 * torch.cos(p[..., 0] + 1.5 * phase)
                     * torch.sin(p[..., 1] + 2.0 * phase)
                     * torch.sin(p[..., 2] + 1.0 * phase), power)


def snowball(lut, p, s):
    return sd_sphere(p, s) - nz.value_noise(lut, p * 8.0) * 0.04


def sd_sea_box(p, b, level):
    """A box cut by a displaced sea plane at height `level` (op_subtract)."""
    n = _const([0.0, -1.0, 0.0], p)
    sea = (vm.vdot(p, n) + level) - disp(10.0 * p, 2.5, 1.0) * 0.07 \
        - disp(15.0 * p, 4.5, 1.0) * 0.03
    return torch.maximum(-sea, sd_box(p, b))


def siggraph_obj(p):
    ax = _const(_SIG_AX, p)
    d1 = vm.vdot(p, ax) - 0.1
    d2 = vm.length(p) - 1.0
    pc = p - _const(_SIG_CE, p)
    d3 = vm.length(pc - ax * vm.vdot(pc, ax)[..., None]) - 1.0
    return torch.maximum(torch.maximum(d1, d2), -d3)


def menger_sponge(p, scale):
    """4-iteration Menger sponge carved from a box of half-extents `scale`."""
    d = sd_box(p, scale)
    s = 1.0
    for _ in range(4):
        a = torch.remainder(p * s, 2.0) - 1.0
        s = s * 3.0
        r = torch.abs(1.0 - 3.0 * torch.abs(a))
        da = torch.maximum(r[..., 0], r[..., 1])
        db = torch.maximum(r[..., 1], r[..., 2])
        dc = torch.maximum(r[..., 2], r[..., 0])
        c = torch.minimum(da, torch.minimum(db, dc)) - 1.0
        c = c / torch.full_like(c, s)   # a tensor divisor (module docstring)
        d = torch.maximum(c, d)
    return d


def mandelbulb(p):
    """Power-8 Mandelbulb, 3 iterations, DE = 0.25·log(m)·√m/dz; the GLSL
    early break at |w|² > 4 is a done-mask.

    A lane that is done iterates on w = 0 and m = 0, whose result the
    `where` drops: iterated on its own large w, its polynomial overflows
    (k3⁷ to inf, the products to inf · 0 = NaN), and autograd would carry
    that NaN through the dropped branch as NaN · 0 (the double-`where` of
    `vecmath.length`).  The forward value is the same either way; K2's
    adjoint (`csrc/adjoint.cuh::mandelbulb_bwd`) skips the dead
    iterations."""
    w = p
    m = vm.vdot(w, w)
    dz = torch.ones_like(m)
    done = torch.zeros_like(m, dtype=torch.bool)
    for _ in range(3):
        w_live = vm.where3(done, torch.zeros_like(w), w)
        m_live = torch.where(done, torch.zeros_like(m), m)
        m2 = m_live * m_live
        m4 = m2 * m2
        dz_new = 8.0 * torch.sqrt(torch.clamp_min(m4 * m2 * m_live, 1e-20)) * dz + 1.0

        x, y, z = w_live[..., 0], w_live[..., 1], w_live[..., 2]
        x2, y2, z2 = x * x, y * y, z * z
        x4, y4, z4 = x2 * x2, y2 * y2, z2 * z2
        k3 = x2 + z2
        k3_2 = k3 * k3
        k3_7 = (k3 * k3_2) * (k3_2 * k3_2)    # jnp's integer_pow(k3, 7)
        k2 = torch.reciprocal(torch.sqrt(torch.clamp_min(k3_7, 1e-20)))
        k1 = x4 + y4 + z4 - 6.0 * y2 * z2 - 6.0 * x2 * y2 + 2.0 * z2 * x2
        k4 = x2 - y2 + z2

        wx = p[..., 0] + 64.0 * x * y * z * (x2 - z2) * k4 * (x4 - 6.0 * x2 * z2 + z4) * k1 * k2
        wy = p[..., 1] + -16.0 * y2 * k3 * k4 * k4 + k1 * k1
        wz = p[..., 2] + -8.0 * y * k4 * (x4 * x4 - 28.0 * x4 * x2 * z2 + 70.0 * x4 * z4
                                          - 28.0 * x2 * z2 * z4 + z4 * z4) * k1 * k2
        w_new = torch.stack([wx, wy, wz], dim=-1)
        m_new = vm.vdot(w_new, w_new)

        w = vm.where3(done, w, w_new)
        dz = torch.where(done, dz, dz_new)
        m = torch.where(done, m, m_new)
        done = done | (m > 4.0)
    m_safe = torch.clamp_min(m, 1e-12)
    return 0.25 * torch.log(m_safe) * torch.sqrt(m_safe) / dz


def _entry_distance(scene, k, p):
    """Distance of SDF entry `k` (its ordinal among the SDF rows) at `p`,
    by its static shape (the JAX package's `_entry_distance`)."""
    i = scene.num_analytic + k
    shape = scene.sdf_shapes_static[k]
    q = p - scene.pos[i]
    jk = scene.joker[i]
    if shape == SdfShape.BOX:
        return sd_box(q, jk[:3])
    if shape == SdfShape.ROUND_BOX:
        return ud_round_box(q, jk[:3], jk[3])
    if shape == SdfShape.SPHERE:
        return sd_sphere(q, jk[0])
    if shape == SdfShape.TRI_PRISM:
        return sd_tri_prism(q, jk[:2])
    if shape == SdfShape.CONE:
        return sd_cone(q, jk[:3])
    if shape == SdfShape.MENGER_SPONGE:
        return menger_sponge(q, jk[:3])
    if shape == SdfShape.MANDELBULB:
        return mandelbulb(q)
    if shape == SdfShape.ELLIPSOID:
        return sd_ellipsoid(q, jk[:3])
    if shape == SdfShape.CAPSULE:
        return sd_capsule(p, scene.pos[i], jk[:3], jk[3])
    if shape == SdfShape.SNOWBALL:
        return snowball(scene.noise, q, jk[0])
    if shape == SdfShape.SEA_BOX:
        return sd_sea_box(q, jk[:3], jk[3])
    if shape == SdfShape.SIGGRAPH:
        return siggraph_obj(q)
    ax = scene.aux[i]
    if shape == SdfShape.TRIANGLE:
        return ud_triangle(q, ax[0:3], ax[3:6], ax[6:9])
    if shape == SdfShape.QUAD:
        return ud_quad(q, ax[0:3], ax[3:6], ax[6:9], ax[9:12])
    raise ValueError(f"unknown SDF shape {shape}")


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
    shape (rotation-invariant, with a margin), or None for the shapes
    without a cheap bound (capsule, prism, cone, sea box, SIGGRAPH,
    triangle, quad)."""
    s = scene.sdf_shapes_static[k]
    jk = scene.joker[scene.num_analytic + k]
    norm3 = torch.sqrt(jk[0] * jk[0] + jk[1] * jk[1] + jk[2] * jk[2])
    if s in (SdfShape.BOX, SdfShape.MENGER_SPONGE):
        return norm3 * 1.05 + 0.05
    if s == SdfShape.ROUND_BOX:
        return norm3 * 1.05 + torch.abs(jk[3]) + 0.05
    if s == SdfShape.SPHERE:
        return torch.abs(jk[0]) + 0.05
    if s == SdfShape.SNOWBALL:
        return torch.abs(jk[0]) + 0.15
    if s == SdfShape.MANDELBULB:
        return torch.tensor(2.5, dtype=torch.float32, device=jk.device)
    if s == SdfShape.ELLIPSOID:
        return torch.abs(jk[0]) + torch.abs(jk[1]) + torch.abs(jk[2]) + 0.05
    return None


@torch.no_grad()
def march_loop(scene, ro, rd, tmin, cfg):
    """The raw sphere trace (raytracer.glsl:974-993), without autograd:
    (t, SDF ordinal, valid, steps).  A lane whose ray does not enter any
    entry's bounding sphere within [0, tmin] cannot converge there, so it is
    done from the start and invalid (where every entry has a bound).
    `steps` counts each lane's loop
    iterations, the work the kernel's per-thread march does."""
    t = torch.full(ro.shape[:-1], cfg.epsilon * 4.0, dtype=torch.float32,
                   device=ro.device)
    d0, _ = scene_map(scene, ro + rd * t[..., None])
    done = torch.abs(d0) < cfg.epsilon

    bounds = [bound_radius(scene, k) for k in range(scene.num_sdfs)]
    if all(rb is not None for rb in bounds):
        can_hit = torch.zeros_like(done)
        for k, rb in enumerate(bounds):
            oc = ro - scene.pos[scene.num_analytic + k]
            b = vm.vdot(oc, rd)
            cq = vm.vdot(oc, oc) - rb * rb
            disc = b * b - cq
            sq = vm.safe_sqrt(disc)
            can_hit = can_hit | ((disc > 0.0) & (-b + sq > 0.0) & (-b - sq < tmin))
    else:   # an entry without a bound: no gate
        can_hit = torch.ones_like(done)
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
