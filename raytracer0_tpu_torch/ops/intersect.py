"""Ray-scene intersection (port of ops/intersect.py): analytic primitives,
and the SDF march where the scene has SDF meshes.

Every ray is tested against every analytic mesh in one broadcast
computation over a trailing [..., N] mesh axis; the winner is an argmin,
which picks the first of equal distances exactly like the reference's
sequential accept-if-closer loop (raytracer.glsl:997-1082).  SDF meshes are
marched up to the nearest analytic hit (`ops/sdf.march`) and win where they
are strictly nearer (raytracer.glsl:1040-1046).

Hit `t` stays differentiable w.r.t. scene geometry; only the winner index
is discrete.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer0_tpu_torch.models.materials import MeshType
from raytracer0_tpu_torch.ops import sdf
from raytracer0_tpu_torch.ops import vecmath as vm
from raytracer0_tpu_torch.ops.sampling import PI, TWO_PI


@dataclasses.dataclass(frozen=True)
class Hit:
    """SoA hit record (the reference `Hit` struct, raytracer.glsl:99-105)."""

    t: torch.Tensor       # f32[...] distance (infinity on miss)
    idx: torch.Tensor     # i64[...] winning mesh index (0 on miss)
    pos: torch.Tensor     # f32[..., 3]
    n: torch.Tensor       # f32[..., 3] geometric normal (0 on miss)
    uv: torch.Tensor      # f32[..., 2] texture coordinates (-1 on miss)
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


def parse_hit(scene, ro, rd, tmin, idx, missed, infinity, need_normal=True,
              need_uv=True):
    """Fill the hit record for the winning mesh (raytracer.glsl:1048-1079).
    `need_normal=False` (shadow rays) skips the normal and `need_uv=False`
    (texture-free scenes, shadow rays) the UV, which is then -1."""
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

    minus1 = torch.full(hit_pos.shape[:-1] + (2,), -1.0, dtype=torch.float32,
                        device=hit_pos.device)
    if need_uv:
        # spherical UV of spheres from the *world* hit position, the
        # reference's quirk (raytracer.glsl:1055-1059)
        rho = vm.safe_length(hit_pos)
        phi = torch.asin(torch.clamp(hit_pos[..., 1] / rho, -1.0 + 1e-6, 1.0 - 1e-6))
        theta = torch.atan2(hit_pos[..., 2], hit_pos[..., 0])
        uv_sph = torch.stack([phi / torch.full_like(phi, PI),
                              theta / torch.full_like(theta, TWO_PI)], dim=-1)
        # dominant-normal-axis planar UV of the other meshes (1070-1076)
        na = torch.abs(n)
        x_dom = (na[..., 0] > na[..., 1]) & (na[..., 0] > na[..., 2])
        y_dom = (na[..., 1] > na[..., 0]) & (na[..., 1] > na[..., 2])
        px, py, pz = hit_pos[..., 0], hit_pos[..., 1], hit_pos[..., 2]
        uv_x = torch.stack([-pz, -py], dim=-1)
        uv_y = torch.stack([px, pz], dim=-1)
        uv_z = torch.stack([px, -py], dim=-1)
        uv = vm.where3(x_dom, uv_x, vm.where3(y_dom, uv_y, uv_z))
        uv = vm.where3(scene.mesh_type[idx] == MeshType.SPHERE, uv_sph, uv)
        uv = vm.where3(missed, minus1, uv)
    else:
        uv = minus1

    return Hit(t=t_eff, idx=torch.where(missed, torch.zeros_like(idx), idx),
               pos=vm.where3(missed, zero3, hit_pos), n=n, uv=uv, missed=missed)


def intersect(scene, ro, rd, cfg, need_normal=True, need_uv=None):
    """Top-level intersection (raytracer.glsl:997-1082).  The UV is
    computed when `need_uv`, by default when the scene has textures; an
    SDF hit's UV takes parse_hit's normal of its row, as in the JAX
    package, and its shading normal is `sdf.calc_normal`'s."""
    if need_uv is None:
        need_uv = bool(scene.tex_types_used)
    tmin, idx, hit_any = analytic_min(scene, ro, rd, cfg.epsilon)
    missed = ~hit_any | ~(tmin < cfg.infinity)
    tmin = torch.where(missed, torch.full_like(tmin, cfg.infinity), tmin)
    if not scene.num_sdfs:
        return parse_hit(scene, ro, rd, tmin, idx, missed, cfg.infinity,
                         need_normal=need_normal, need_uv=need_uv)
    t_sdf, idx_sdf, n_sdf, sdf_valid = sdf.march(scene, ro, rd, tmin, cfg)
    wins = sdf_valid & (t_sdf < tmin)
    hit = parse_hit(scene, ro, rd, torch.where(wins, t_sdf, tmin),
                    torch.where(wins, idx_sdf, idx), missed & ~wins,
                    cfg.infinity, need_normal=need_normal, need_uv=need_uv)
    if need_normal:
        hit = dataclasses.replace(hit, n=vm.where3(wins, n_sdf, hit.n))
    return hit
