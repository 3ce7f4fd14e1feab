"""Next-event estimation with sphere, SDF and directional lights (port of
ops/lighting.py; raytracer.glsl:1174-1262, 1947-1975).

A sphere-light slot is sampled with a uniform cone toward the sphere and
verified by a shadow re-trace, whose hit's texel (in a scene with textures)
blends into the hit's color by its alpha; an SDF light slot (a LIGHT SDF
row) by a shadow ray toward a uniform point of its bounding ellipsoid
(pos + direction * joker.xyz, raytracer.glsl:1205-1217), unweighted; a
directional slot (DIR_LIGHT material, its `pos` is the direction) is lit
where an occlusion ray toward it escapes.  Under MIS each sample is
weighted by the power heuristic against the cosine BSDF pdf: a sphere
light's pdf is its cone's, an SDF light's the uniform sphere's 1/4π, a
directional light's 0, so under MIS it contributes nothing, as in the JAX
package.  A slot of any other kind contributes nothing.  In the
homogeneous medium (`cfg.use_volumetrics`) a sphere light's shadow ray
is attenuated by Beer-Lambert fog, exp(-σt t) over its hit's distance
(raytracer.glsl:1198-1202); SDF and directional lights stay unfogged, as
in the JAX package.
"""

from __future__ import annotations

import torch

from raytracer0_tpu_torch.models.materials import MatType, MeshType
from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.ops import intersect as isect
from raytracer0_tpu_torch.ops import sampling as smp
from raytracer0_tpu_torch.ops import textures as tex
from raytracer0_tpu_torch.ops import vecmath as vm


def slot_kind(scene, slot):
    """"sphere", "sdf", "dir" or None: how light slot `slot` is sampled."""
    li = scene.lights_static[slot]
    if li < 0:
        return None
    mat = scene.mat_types_static[li]
    if mat == int(MatType.DIR_LIGHT):
        return "dir"
    if mat == int(MatType.LIGHT) and scene.mesh_types_static[li] == int(MeshType.SPHERE):
        return "sphere"
    if mat == int(MatType.LIGHT) and scene.mesh_types_static[li] == int(MeshType.SDF):
        return "sdf"
    return None


def direct_light_slot(scene, cfg, slot, x, nl, pix, pass_idx, sample_idx, depth):
    """Direct lighting from light slot `slot` (a sphere, SDF or
    directional light) at shading points `x` with oriented normals `nl`.

    Returns (contribution f32[..., 3], light_dir f32[..., 3] toward the
    light's position).  `light_dir` feeds the MIS pdfs, which use the
    *center* direction, not the sampled cone direction.
    """
    li = scene.lights_static[slot]
    l_pos = scene.pos[li]
    kind = slot_kind(scene, slot)
    if kind == "dir":
        # mesh.pos *is* the direction (raytracer.glsl:1220-1225); lit where
        # the occlusion ray escapes to infinity
        sr_dir = vm.normalize(l_pos.expand_as(x))
        hit = isect.intersect(scene, x + nl * cfg.epsilon, sr_dir, cfg,
                              need_normal=False, need_uv=False)
        cos_term = torch.clamp_min(vm.vdot(l_pos, nl), 0.001)
        contrib = scene.color[li] * scene.emission[li] * cos_term[..., None]
        contrib = vm.where3(hit.missed, contrib, torch.zeros_like(contrib))
        return contrib, vm.normalize(l_pos - x)

    sw = l_pos - x
    if kind == "sdf":
        # a uniform point on the bounding ellipsoid (raytracer.glsl:1205-1208)
        su1, su2 = rng.uniform2(pix, pass_idx, sample_idx, depth, slot,
                                rng.Stream.NEE_SDF_POINT)
        ld = l_pos + smp.random_sphere_direction(su1, su2) * scene.joker[li, :3]
        sr_dir = vm.normalize(ld - x)
    else:
        r = scene.joker[li, 0]
        u1, u2 = rng.uniform2(pix, pass_idx, sample_idx, depth, slot,
                              rng.Stream.NEE_CONE)
        # uniform cone toward the center (raytracer.glsl:1182-1190)
        d2 = vm.vdot(sw, sw)
        cos_a_max = vm.safe_sqrt(1.0 - torch.clamp(vm.safe_div(r * r, d2), 0.0, 1.0))
        sr_dir = smp.sample_cone(vm.normalize(sw), 1.0 - cos_a_max, u1, u2)

    # shadow re-trace (raytracer.glsl:1193); the contribution uses sr_dir
    hit = isect.intersect(scene, x + nl * cfg.epsilon, sr_dir, cfg, need_normal=False)
    hit_is_light = (scene.mat_type[hit.idx] == MatType.LIGHT) & ~hit.missed
    hit_c = scene.color[hit.idx]
    if scene.tex_types_used:
        # the reference blends the hit mesh's texel into its color by the
        # texel's alpha, unconditionally (raytracer.glsl:1203), as the JAX
        # package does; the UV of a hit without a normal is the (x, -y) plane's
        texel = tex.get_texel(scene, hit.idx, hit.uv, hit.pos)
        hit_c = vm.mix(hit_c, texel[..., :3], texel[..., 3:4])
    lit_c = torch.clamp_min(hit_c, 0.001)
    cos_term = torch.clamp_min(vm.vdot(sr_dir, nl), 0.001)
    if kind == "sdf":
        contrib = lit_c * scene.emission[hit.idx] * cos_term[..., None]
    else:
        weight = 2.0 * (1.0 - cos_a_max) * cos_term
        if cfg.use_volumetrics:   # Beer-Lambert fog on the shadow ray
            weight = weight * torch.exp(-cfg.vol_sigma_t * hit.t)
        contrib = lit_c * scene.emission[hit.idx] * weight[..., None]
    contrib = vm.where3(hit_is_light, contrib, torch.zeros_like(contrib))
    return contrib, vm.normalize(sw)


def light_pdf_slot(scene, slot, x):
    """Light-sampling pdf of slot `slot` for MIS (raytracer.glsl:1246-1262):
    the cone pdf of a sphere light, the uniform sphere's 1/4π for an SDF
    light, 0 for a directional one."""
    li = scene.lights_static[slot]
    if slot_kind(scene, slot) == "dir":
        return torch.zeros_like(x[..., 0])
    if slot_kind(scene, slot) == "sdf":
        return torch.full_like(x[..., 0], 1.0 / smp.FOUR_PI)
    return smp.sphere_light_pdf(scene.pos[li], scene.joker[li, 0], x)


def sample_lights_nee(scene, cfg, x, nl, mask, pix, pass_idx, sample_idx, depth):
    """The reference's non-ReSTIR NEE block inside `brdf`
    (raytracer.glsl:1947-1975): per-light contributions, with power-
    heuristic MIS against the cosine BSDF pdf when `use_mis`.

    Returns the radiance to add to the accumulator (already multiplied by
    the path throughput `mask`)."""
    total = torch.zeros_like(x)
    for slot in range(scene.num_lights):
        if slot_kind(scene, slot) is None:
            continue  # sentinel or non-light slot: no contribution
        contrib, light_dir = direct_light_slot(
            scene, cfg, slot, x, nl, pix, pass_idx, sample_idx, depth)
        if cfg.use_mis:
            # weight applied only when the sample carries energy (1958)
            has_energy = vm.vdot(contrib, contrib) > 1e-6
            w = smp.power_heuristic(1.0, light_pdf_slot(scene, slot, x),
                                    1.0, smp.cosine_hemisphere_pdf(light_dir, nl))
            contrib = vm.where3(has_energy, contrib * w[..., None],
                                torch.zeros_like(contrib))
        total = total + contrib
    return total * mask
