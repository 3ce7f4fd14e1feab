"""Wavefront path-tracing integrator: the plain PyTorch version of the
forward megakernel K1 (port of render/integrator.py, Cornell class).

The reference's `radiance()` loop (raytracer.glsl:1986-2105) as a Python
loop over bounce depth with per-lane active masks over [H, W] tensors.
It keeps the JAX integrator's mask order and RNG coordinates, so it traces
the same paths as `raytracer0_tpu.render.integrator.trace` and as the CUDA
kernel (`ops/megakernel.py`), pixel for pixel:

  * miss → procedural sky, suppressed for non-specular paths under NEE
  * emissive termination with the BSDF-side MIS weight from `prev_nl`
  * DIFF bounce, sphere-light NEE with optional power-heuristic MIS
  * luminance cutoff and per-type bounce caps

Differentiability: discrete events (winner index, light validity) are
boolean masks whose continuous integrands carry gradients; `torch.where`
zeroes gradients on untaken branches, the detached-decision estimator of
the JAX package.

The class it covers is stated by `unsupported`; anything else raises
NotImplementedError naming the ROADMAP item that adds it.
"""

from __future__ import annotations

from typing import Optional

import torch

from raytracer0_tpu_torch.config import RenderConfig, RenderMode
from raytracer0_tpu_torch.models.materials import MatType, MeshType
from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.ops import bsdf as bsdf_ops
from raytracer0_tpu_torch.ops import intersect as isect
from raytracer0_tpu_torch.ops import lighting
from raytracer0_tpu_torch.ops import sampling as smp
from raytracer0_tpu_torch.ops import sky
from raytracer0_tpu_torch.ops import vecmath as vm

_ANALYTIC = (int(MeshType.SPHERE), int(MeshType.PLANE), int(MeshType.BOX))
_MATS = (int(MatType.DIFF), int(MatType.LIGHT))


def unsupported(scene, cfg: RenderConfig) -> Optional[str]:
    """Why (scene, cfg) is outside the ported class, or None when inside.

    The class: analytic SPHERE/PLANE/BOX meshes, DIFF and LIGHT materials,
    no textures, light slots that are LIGHT spheres, cosine-weighted
    sampling, procedural sky or none, static accumulation.
    """
    if cfg.use_restir:
        return "ReSTIR: ROADMAP queue 1 item 11"
    if cfg.use_spectral or cfg.use_volumetrics:
        return "spectral transport and media: ROADMAP queue 1 item 10"
    if cfg.use_cubemap:
        return "cubemap environments: ROADMAP queue 1 item 9"
    if not cfg.use_biased_sampling:
        return "uniform hemisphere sampling: ROADMAP queue 1 item 7"
    if int(cfg.render_mode) != int(RenderMode.STATIC):
        return "ANIMATED render mode: ROADMAP queue 1 item 12"
    if scene.num_sdfs or any(t not in _ANALYTIC for t in scene.mesh_types_static):
        return "SDF meshes: ROADMAP queue 1 item 8"
    if scene.tex_types_used:
        return "textures: ROADMAP queue 1 item 9"
    if any(m not in _MATS for m in scene.mat_types_static):
        return "SPEC/REFR/COAT/DIR_LIGHT materials: ROADMAP queue 1 item 7"
    for li in scene.lights_static:
        if li >= 0 and (li >= scene.num_meshes
                        or scene.mesh_types_static[li] != int(MeshType.SPHERE)
                        or scene.mat_types_static[li] != int(MatType.LIGHT)):
            return "non-sphere light slots: ROADMAP queue 1 item 7"
    return None


def _light_pdf_mesh(scene, idx, x):
    """Light-sampling pdf of the *hit* mesh, for BSDF-side MIS
    (raytracer.glsl:2083-2086 → lightSamplingPdf 1246-1262)."""
    is_sphere = scene.mesh_type[idx] == MeshType.SPHERE
    pdf_sphere = smp.sphere_light_pdf(scene.pos[idx], scene.joker[idx][..., 0], x)
    return torch.where(is_sphere, pdf_sphere,
                       torch.full_like(pdf_sphere, 1.0 / smp.FOUR_PI))


def trace(scene, cfg: RenderConfig, ro, rd, pix, pass_idx, sample_idx):
    """Trace one radiance sample per lane.

    `ro`/`rd`: f32[..., 3] primary rays; `pix`: int64 pixel ids (uint32
    values) matching the batch shape.  Returns radiance f32[..., 3].
    """
    reason = unsupported(scene, cfg)
    if reason is not None:
        raise NotImplementedError(f"not ported yet: {reason}")

    batch = ro.shape[:-1]
    dev = ro.device
    f3 = lambda v: torch.full(batch + (3,), v, dtype=torch.float32, device=dev)
    false = torch.zeros(batch, dtype=torch.bool, device=dev)

    o, d = ro, rd
    mask, acc = f3(1.0), f3(0.0)
    active = ~false
    specular = ~false                  # primary rays count as specular
    prev_nl = torch.zeros(batch + (3,), dtype=torch.float32, device=dev)
    prev_nl[..., 1] = 1.0
    n_diff = torch.zeros(batch, dtype=torch.int32, device=dev)
    n_spec = torch.zeros_like(n_diff)
    n_scat = torch.zeros_like(n_diff)

    for depth in range(cfg.max_bounces):
        hit = isect.intersect(scene, o, d, cfg)
        surface = active

        # ---- miss: environment or NEE-suppressed break (2055-2066) ----
        missed = surface & hit.missed
        # non-specular env hits double-count NEE
        env_allowed = specular if cfg.sample_lights else ~false
        if cfg.use_procedural_sky:
            acc = acc + vm.where3(missed & env_allowed,
                                  mask * sky.procedural_sky(d),
                                  torch.zeros_like(acc))
        active = active & ~missed
        surface = surface & ~hit.missed

        # ---- color / emission (2071, 2077): no textures in this class ----
        c = torch.clamp_min(scene.color[hit.idx], 0.001)
        e = torch.clamp_min(scene.emission[hit.idx], 0.001)

        inside = -torch.sign(vm.vdot(d, hit.n))
        inside = torch.where(inside == 0.0, torch.ones_like(inside), inside)

        # ---- emissive hit: MIS-weighted accumulate + terminate (2079-2090) ----
        is_light = surface & (scene.mat_type[hit.idx] == MatType.LIGHT)
        contrib = mask * c * e
        if cfg.use_mis and cfg.sample_lights and depth > 0:
            # depth-0 and specular-path hits keep weight 1
            light_dir = vm.normalize(hit.pos - o)
            l_pdf = _light_pdf_mesh(scene, hit.idx, o)
            b_pdf = smp.cosine_hemisphere_pdf(light_dir, prev_nl)
            mis_w = smp.power_heuristic(1.0, b_pdf, 1.0, l_pdf)
            mis_w = torch.where(specular, torch.ones_like(mis_w), mis_w)
            contrib = contrib * mis_w[..., None]
        acc = acc + vm.where3(is_light, contrib, torch.zeros_like(acc))
        active = active & ~is_light
        surface = surface & ~is_light

        # ---- BSDF sample (brdf, 1804-1884): DIFF ----
        u1, u2 = rng.uniform2(pix, pass_idx, sample_idx, depth, rng.Stream.BSDF_DIR)
        bs = bsdf_ops.sample(cfg, hit, c, inside, u1, u2)
        new_prev_nl = hit.n * inside[..., None]
        mask_after = mask * bs.mask_mult
        diffuse_lane = surface & ~bs.specular

        # ---- NEE on diffuse bounces (1899-1976) ----
        if cfg.sample_lights:
            nee = lighting.sample_lights_nee(
                scene, cfg, hit.pos, new_prev_nl, mask_after,
                pix, pass_idx, sample_idx, depth)
            acc = acc + vm.where3(diffuse_lane, nee, torch.zeros_like(acc))

        # ---- commit per-lane ray state ----
        o = vm.where3(surface, bs.o, o)
        d = vm.where3(surface, bs.d, d)
        mask = vm.where3(surface, mask_after, mask)
        specular = torch.where(surface, bs.specular, specular)
        prev_nl = vm.where3(surface, new_prev_nl, prev_nl)
        zero_i = torch.zeros_like(n_diff)
        n_diff = n_diff + torch.where(surface, bs.diff_inc, zero_i)
        n_spec = n_spec + torch.where(surface, bs.spec_inc, zero_i)
        n_scat = n_scat + torch.where(surface, bs.scatter_inc, zero_i)

        # ---- cutoff + per-type caps (2097-2101) ----
        cutoff = surface & (vm.max3(mask) < 0.01)
        capped = surface & ((n_diff >= cfg.max_diff_bounces)
                            | (n_spec >= cfg.max_spec_bounces)
                            | (n_scat >= cfg.max_scattering_events))
        active = active & ~(cutoff | capped)

    return acc
