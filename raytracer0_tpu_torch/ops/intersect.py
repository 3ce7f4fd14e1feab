"""Analytic ray-primitive intersection (port of the analytic part of
ops/intersect.py).

Every ray is tested against every mesh in one broadcast computation over a
trailing [..., N] mesh axis; the winner is an argmin, which picks the first
of equal distances exactly like the reference's sequential accept-if-closer
loop (raytracer.glsl:997-1082).  SDF marching comes with ROADMAP queue 1
item 8 and UV parsing (textures) with item 9.

Hit `t` stays differentiable w.r.t. scene geometry; only the winner index
is discrete.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer0_tpu_torch.models.materials import MeshType
from raytracer0_tpu_torch.ops import vecmath as vm


@dataclasses.dataclass(frozen=True)
class Hit:
    """SoA hit record (the reference `Hit` struct, raytracer.glsl:99-105)."""

    t: torch.Tensor       # f32[...] distance (infinity on miss)
    idx: torch.Tensor     # i64[...] winning mesh index (0 on miss)
    pos: torch.Tensor     # f32[..., 3]
    n: torch.Tensor       # f32[..., 3] geometric normal (0 on miss)
    missed: torch.Tensor  # bool[...]


def _sphere_t(oc, rd, radius, eps):
    """Closest valid sphere root (raytracer.glsl:818-833)."""
    b = vm.vdot(oc, rd)
    c = vm.vdot(oc, oc) - radius * radius
    disc = b * b - c
    # where-guard keeps sqrt's backward finite on the miss branch
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, torch.ones_like(disc)))
    sq = torch.where(pos, sq, torch.zeros_like(sq))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > eps, t0, t1)
    return t, pos & (t > eps)


def _plane_t(n, w, ro, rd, eps):
    """Plane n·x + w = 0 (raytracer.glsl:812-815): mesh.pos is the
    (unnormalized) normal, joker.x the offset."""
    denom = vm.vdot(n, rd)
    t = vm.safe_div(-w - vm.vdot(n, ro), denom)
    return t, (t > eps) & (torch.abs(denom) > 1e-12)


def _box_t(center, size, ro, rd, eps):
    """Axis-aligned cube of edge `size` centered at `center`
    (raytracer.glsl:836-851)."""
    m = vm.safe_div(torch.ones_like(rd), rd)
    n_vec = m * (center - ro)
    k = torch.abs(m) * (size * 0.5)[..., None]
    t_near = torch.amax(n_vec - k, dim=-1)
    t_far = torch.amin(n_vec + k, dim=-1)
    t = torch.where(t_near > 0.0, t_near, t_far)
    return t, (t_near <= t_far) & (t_far >= 0.0) & (t > eps)


def _box_normal(center, size, hit_pos):
    """Slab-test normal from the dominant penetration axis
    (raytracer.glsl:853-856)."""
    hp = hit_pos - center
    d = torch.abs(hp) - (size * 0.5)[..., None]
    dy = torch.roll(d, -1, dims=-1)  # d.yzx
    dz = torch.roll(d, -2, dims=-1)  # d.zxy
    step = ((d >= dy) & (d >= dz)).to(d.dtype)
    return vm.normalize(torch.sign(hp) * step)


def analytic_min(scene, ro, rd, eps):
    """Closest analytic hit across all meshes: (tmin, idx, hit_any).

    All formulas run over the full [..., N] mesh axis and are selected by
    type masks; formulas for types absent from the scene are skipped.
    """
    pos = scene.pos               # [N, 3]
    joker0 = scene.joker[:, 0]    # [N]
    mesh_type = scene.mesh_type

    ro_b = ro[..., None, :]
    rd_b = rd[..., None, :]

    t = torch.full(ro.shape[:-1] + (pos.shape[0],), float("inf"),
                   dtype=torch.float32, device=ro.device)
    if scene.use_sphere:
        t_s, v_s = _sphere_t(ro_b - pos, rd_b, joker0, eps)
        t = torch.where((mesh_type == MeshType.SPHERE) & v_s, t_s, t)
    if scene.use_plane:
        t_p, v_p = _plane_t(pos, joker0, ro_b, rd_b, eps)
        t = torch.where((mesh_type == MeshType.PLANE) & v_p, t_p, t)
    if scene.use_box:
        t_b, v_b = _box_t(pos, joker0, ro_b, rd_b, eps)
        t = torch.where((mesh_type == MeshType.BOX) & v_b, t_b, t)

    # degenerate-mesh skip: joker.x == 0 placeholders (raytracer.glsl:1009)
    t = torch.where(joker0 == 0.0, torch.full_like(t, float("inf")), t)

    idx = torch.argmin(t, dim=-1)   # first index of the minimum
    tmin = torch.gather(t, -1, idx[..., None])[..., 0]
    return tmin, idx, torch.isfinite(tmin)


def parse_hit(scene, ro, rd, tmin, idx, missed, infinity, need_normal=True):
    """Fill the hit record for the winning mesh (raytracer.glsl:1048-1079).
    `need_normal=False` (shadow rays) skips the normal."""
    t_eff = torch.where(missed, torch.full_like(tmin, infinity), tmin)
    hit_pos = ro + rd * t_eff[..., None]
    zero3 = torch.zeros_like(hit_pos)

    if need_normal:
        w_type = scene.mesh_type[idx]
        w_pos = scene.pos[idx]
        n_sph = vm.normalize(hit_pos - w_pos)
        n_pln = vm.normalize(w_pos)
        n_box = _box_normal(w_pos, scene.joker[idx][..., 0], hit_pos)
        n = vm.where3(w_type == MeshType.SPHERE, n_sph,
                      vm.where3(w_type == MeshType.PLANE, n_pln, n_box))
        n = vm.where3(missed, zero3, n)
    else:
        n = zero3

    return Hit(t=t_eff, idx=torch.where(missed, torch.zeros_like(idx), idx),
               pos=vm.where3(missed, zero3, hit_pos), n=n, missed=missed)


def intersect(scene, ro, rd, cfg, need_normal=True):
    """Top-level analytic intersection (raytracer.glsl:997-1082)."""
    if scene.num_sdfs:
        raise NotImplementedError(
            "SDF intersection is not ported yet: ROADMAP queue 1 item 8")
    tmin, idx, hit_any = analytic_min(scene, ro, rd, cfg.epsilon)
    missed = ~hit_any | ~(tmin < cfg.infinity)
    tmin = torch.where(missed, torch.full_like(tmin, cfg.infinity), tmin)
    return parse_hit(scene, ro, rd, tmin, idx, missed, cfg.infinity,
                     need_normal=need_normal)
