"""Next-event estimation with sphere lights (port of the sphere-cone
branch of ops/lighting.py; raytracer.glsl:1174-1262, 1947-1975).

Each light slot is sampled with a uniform cone toward the sphere and
verified by a shadow re-trace; under MIS the sample is weighted by the
power heuristic against the cosine BSDF pdf.  SDF-bound and directional
lights come with ROADMAP queue 1 item 7; `integrator.unsupported` keeps
scenes with such slots off this path.
"""

from __future__ import annotations

import torch

from raytracer0_tpu_torch.models.materials import MatType
from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.ops import intersect as isect
from raytracer0_tpu_torch.ops import sampling as smp
from raytracer0_tpu_torch.ops import vecmath as vm


def direct_light_slot(scene, cfg, slot, x, nl, pix, pass_idx, sample_idx, depth):
    """Direct lighting from sphere-light slot `slot` at shading points `x`
    with oriented normals `nl`.

    Returns (contribution f32[..., 3], light_dir f32[..., 3] toward the
    light center).  `light_dir` feeds the MIS pdfs, which use the *center*
    direction, not the sampled cone direction.
    """
    li = scene.lights_static[slot]
    l_pos = scene.pos[li]
    r = scene.joker[li, 0]

    u1, u2 = rng.uniform2(pix, pass_idx, sample_idx, depth, slot,
                          rng.Stream.NEE_CONE)

    # uniform cone toward the center (raytracer.glsl:1182-1190)
    sw = l_pos - x
    d2 = vm.vdot(sw, sw)
    cos_a_max = vm.safe_sqrt(1.0 - torch.clamp(vm.safe_div(r * r, d2), 0.0, 1.0))
    sr_dir = smp.sample_cone(vm.normalize(sw), 1.0 - cos_a_max, u1, u2)

    # shadow re-trace (raytracer.glsl:1193); the contribution uses sr_dir
    hit = isect.intersect(scene, x + nl * cfg.epsilon, sr_dir, cfg,
                          need_normal=False)
    hit_is_light = (scene.mat_type[hit.idx] == MatType.LIGHT) & ~hit.missed
    lit_c = torch.clamp_min(scene.color[hit.idx], 0.001)
    cos_term = torch.clamp_min(vm.vdot(sr_dir, nl), 0.001)
    weight = 2.0 * (1.0 - cos_a_max)
    contrib = lit_c * scene.emission[hit.idx] * (weight * cos_term)[..., None]
    contrib = vm.where3(hit_is_light, contrib, torch.zeros_like(contrib))
    return contrib, vm.normalize(sw)


def light_pdf_slot(scene, slot, x):
    """Light-sampling pdf of sphere slot `slot` for MIS
    (raytracer.glsl:1246-1262)."""
    li = scene.lights_static[slot]
    return smp.sphere_light_pdf(scene.pos[li], scene.joker[li, 0], x)


def sample_lights_nee(scene, cfg, x, nl, mask, pix, pass_idx, sample_idx, depth):
    """The reference's non-ReSTIR NEE block inside `brdf`
    (raytracer.glsl:1947-1975): per-light contributions, with power-
    heuristic MIS against the cosine BSDF pdf when `use_mis`.

    Returns the radiance to add to the accumulator (already multiplied by
    the path throughput `mask`)."""
    total = torch.zeros_like(x)
    for slot, li in enumerate(scene.lights_static):
        if li < 0:
            continue  # sentinel slot: no light
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
