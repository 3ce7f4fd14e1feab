"""Wavefront path-tracing integrator: the plain PyTorch version of the
forward megakernel K1 (port of render/integrator.py).

The reference's `radiance()` loop (raytracer.glsl:1986-2105) as a Python
loop over bounce depth with per-lane active masks over [H, W] tensors.
It keeps the JAX integrator's mask order and RNG coordinates, so it traces
the same paths as `raytracer0_tpu.render.integrator.trace` and as the CUDA
kernel (`ops/megakernel.py`), pixel for pixel:

  * miss → environment (cubemap or procedural sky), suppressed for
    non-specular paths under NEE
  * the texel of the hit (image, UV-pattern and noise textures) blended
    into its color and emission
  * emissive termination with the BSDF-side MIS weight from `prev_nl`;
    DIR_LIGHT surfaces end the path
  * the BSDF dispatch (DIFF, SPEC, REFR_FRESNEL, REFR_SCHLICK, COAT)
  * the cubemap gather ray and sphere/directional-light NEE on diffuse
    bounces, with optional power-heuristic MIS
  * luminance cutoff and per-type bounce caps
  * with a `restir_sampler` (ops/restir.py), the reservoir pipeline in
    place of per-light NEE on diffuse bounces, whose reservoir the last
    diffuse bounce of each path leaves behind
  * SDF meshes of every shape marched in every intersection (ops/sdf.py),
    their texels read at the UV of their row's box normal, as in the JAX
    package, and SDF-bound lights sampled at a point of their bounding
    ellipsoid (ops/lighting.py)

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

from raytracer0_tpu_torch.config import RenderConfig
from raytracer0_tpu_torch.models.materials import MatType, MeshType, SdfShape
from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.ops import bsdf as bsdf_ops
from raytracer0_tpu_torch.ops import intersect as isect
from raytracer0_tpu_torch.ops import lighting
from raytracer0_tpu_torch.ops import restir
from raytracer0_tpu_torch.ops import sampling as smp
from raytracer0_tpu_torch.ops import sdf
from raytracer0_tpu_torch.ops import sky
from raytracer0_tpu_torch.ops import textures as tex
from raytracer0_tpu_torch.ops import vecmath as vm

_ANALYTIC = (int(MeshType.SPHERE), int(MeshType.PLANE), int(MeshType.BOX))
_SDF_ITEM = "ROADMAP queue 1 item 8"
_RESTIR_ITEM = "ROADMAP queue 1 item 11"


def restir_engaged(scene, cfg: RenderConfig) -> bool:
    """Whether ReSTIR replaces per-light NEE at every diffuse vertex: with
    MIS and at most 8 lights the reference keeps per-light NEE
    (raytracer.glsl:1906-1911)."""
    n_lights = sum(1 for li in scene.lights_static if li >= 0)
    return bool(cfg.use_restir and cfg.sample_lights and n_lights > 0
                and (not cfg.use_mis or n_lights > 8))


def outside_box_sdf(scene, who: str) -> Optional[str]:
    """What of the scene's SDF rows lies outside the SDF class of the
    kernels built without the whole SDF class, or None: BOX and ROUND_BOX
    shapes, no texture blended into an SDF row's color or emission, no
    light slot on an SDF row.  `who` names the kernel or route in the
    message.  K5 models no more; K1 and K2, K4, K6v and K7 run a copy of
    their own for the rest (`megakernel.whole_sdf`), and the plain
    version renders the whole class (`unsupported`)."""
    na = scene.num_analytic
    other = sorted({SdfShape(s).name if s in sdf.SHAPES else str(s)
                    for s in scene.sdf_shapes_static if s not in sdf.BOX_SHAPES})
    if other:
        what = f"SDF shapes other than BOX and ROUND_BOX ({', '.join(other)})"
    elif any(t >= 0 and (o[0] or o[1]) for t, o in
             zip(scene.tex_types_static[na:], scene.opts_static[na:])):
        what = "textures on SDF meshes"
    elif any(li >= na for li in scene.lights_static):
        what = "SDF-bound light slots"
    else:
        return None
    return f"{what}, outside {who}'s class: {_SDF_ITEM}"


def _outside_restir_class(scene, cfg: RenderConfig) -> Optional[str]:
    """What of a ReSTIR (scene, cfg) the port does not render: the class of
    the JAX `supported_restir` (raytracer0_tpu/ops/megakernel.py:545-560):
    ReSTIR engaged, LIGHT spheres in every light slot (so no SDF-bound
    light), no photographic cubemap, cosine sampling; the pixel's own
    history or the ad-hoc reprojection, static or animated; SDF meshes of
    every shape, textures blended into any row, SDF rows included (image
    textures too, which the JAX package renders on its XLA route)."""
    if not restir_engaged(scene, cfg):
        return ("ReSTIR that keeps per-light NEE (no light, sample_lights "
                f"off, or MIS with at most 8 lights): {_RESTIR_ITEM}")
    for li in scene.lights_static:
        if li >= 0 and not (li < scene.num_analytic
                            and scene.mesh_types_static[li] == int(MeshType.SPHERE)
                            and scene.mat_types_static[li] == int(MatType.LIGHT)):
            return f"ReSTIR with light slots that are not LIGHT spheres: {_RESTIR_ITEM}"
    if cfg.use_cubemap and not scene.cubemap_is_procedural:
        return f"ReSTIR under a photographic cubemap: {_RESTIR_ITEM}"
    if not cfg.use_biased_sampling:
        return f"ReSTIR with uniform hemisphere sampling: {_RESTIR_ITEM}"
    return None


def unsupported_geometry(scene) -> Optional[str]:
    """What of the scene's geometry the port does not intersect, or None:
    analytic SPHERE/PLANE/BOX meshes and SDF meshes of every shape."""
    na = scene.num_analytic
    if any(t not in _ANALYTIC for t in scene.mesh_types_static[:na]) \
            or any(t != int(MeshType.SDF) for t in scene.mesh_types_static[na:]):
        return f"mesh types other than SPHERE/PLANE/BOX/SDF: {_SDF_ITEM}"
    if any(s not in sdf.SHAPES for s in scene.sdf_shapes_static):
        return f"unknown SDF shape codes: {_SDF_ITEM}"
    return None


def unsupported(scene, cfg: RenderConfig) -> Optional[str]:
    """Why (scene, cfg) is outside the ported class, or None when inside.

    The class: analytic SPHERE/PLANE/BOX meshes and SDF meshes of all 14
    shapes, every surface material (the IOR taken as |ior|), textures of
    all ten types on analytic and SDF meshes, sphere, directional and
    SDF-bound light slots, cosine-weighted or uniform sampling, a
    cubemap, the procedural sky or no environment, static or animated
    accumulation; and ReSTIR in the class of `_outside_restir_class`.
    """
    if cfg.use_spectral or cfg.use_volumetrics:
        return "spectral transport and media: ROADMAP queue 1 item 10"
    reason = unsupported_geometry(scene)
    if reason is not None:
        return reason
    if any(li >= scene.num_meshes for li in scene.lights_static):
        return "a light slot names no mesh of the scene"
    if cfg.use_restir:
        return _outside_restir_class(scene, cfg)
    return None


def _light_pdf_mesh(scene, idx, x):
    """Light-sampling pdf of the *hit* mesh, for BSDF-side MIS
    (raytracer.glsl:2083-2086 → lightSamplingPdf 1246-1262)."""
    is_sphere = scene.mesh_type[idx] == MeshType.SPHERE
    pdf_sphere = smp.sphere_light_pdf(scene.pos[idx], scene.joker[idx][..., 0], x)
    return torch.where(is_sphere, pdf_sphere,
                       torch.full_like(pdf_sphere, 1.0 / smp.FOUR_PI))


def hit_color_emission(scene, hit):
    """The hit mesh's color and emission, its texel blended in where the
    mesh's options ask for it, floored at 0.001 (raytracer.glsl:2071, 2077)."""
    mat_c = scene.color[hit.idx]
    mat_e = scene.emission[hit.idx]
    if not scene.tex_types_used:
        return torch.clamp_min(mat_c, 0.001), torch.clamp_min(mat_e, 0.001)
    texel = tex.get_texel(scene, hit.idx, hit.uv, hit.pos)
    opts = scene.opts[hit.idx]
    blend_c = opts[..., 0].to(torch.float32) * texel[..., 3]
    blend_e = opts[..., 1].to(torch.float32) * texel[..., 3]
    c = vm.mix(mat_c, texel[..., :3] * scene.tex_cmask[hit.idx], blend_c[..., None])
    e = vm.mix(mat_e, texel[..., :3] * scene.tex_emask[hit.idx], blend_e[..., None])
    return torch.clamp_min(c, 0.001), torch.clamp_min(e, 0.001)


def trace(scene, cfg: RenderConfig, ro, rd, pix, pass_idx, sample_idx,
          restir_sampler=None, gbuffer_slots=0):
    """Trace one radiance sample per lane.

    `ro`/`rd`: f32[..., 3] primary rays; `pix`: int64 pixel ids (uint32
    values) matching the batch shape.  Returns radiance f32[..., 3].

    `restir_sampler` (`restir.make_sampler`), called as `sampler(scene,
    cfg, hit, nl, mask, pix, pass, sample, depth)` and returning
    `(direct radiance, reservoir dict)`, replaces per-light NEE on diffuse
    bounces where ReSTIR is engaged (raytracer.glsl:1899-1946); trace then
    returns `(radiance, reservoir dict)`, the reservoir of each lane's last
    diffuse bounce (the reference's g_final_reservoir overwrite,
    raytracer.glsl:1616, 1757).

    `gbuffer_slots` > 0 is the plain version of the G-buffer kernel K4
    (`ops/restir_split.py`): no direct light on diffuse bounces, and the
    k-th diffuse vertex of each lane (k < gbuffer_slots) recorded in slot k
    (hit position, oriented normal, throughput after the bounce, mesh
    index, bounce depth, valid); trace then returns `(radiance, slots)`.
    """
    reason = unsupported(scene, cfg)
    if reason is not None:
        raise NotImplementedError(f"not ported yet: {reason}")
    use_restir = restir_sampler is not None and restir_engaged(scene, cfg)

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
    if restir_sampler is not None:
        reservoir = restir.empty_reservoir(batch, dev)
    gbuf = [_empty_slot(batch, dev) for _ in range(gbuffer_slots)]

    for depth in range(cfg.max_bounces):
        hit = isect.intersect(scene, o, d, cfg)
        surface = active

        # ---- miss: environment or NEE-suppressed break (2055-2066) ----
        missed = surface & hit.missed
        # non-specular env hits double-count NEE
        env_allowed = specular if cfg.sample_lights else ~false
        acc = acc + vm.where3(missed & env_allowed,
                              mask * sky.environment(scene, d, cfg),
                              torch.zeros_like(acc))
        active = active & ~missed
        surface = surface & ~hit.missed

        c, e = hit_color_emission(scene, hit)

        inside = -torch.sign(vm.vdot(d, hit.n))
        inside = torch.where(inside == 0.0, torch.ones_like(inside), inside)

        # ---- emissive hit: MIS-weighted accumulate + terminate (2079-2090) ----
        mat_type = scene.mat_type[hit.idx]
        is_light = surface & (mat_type == MatType.LIGHT)
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

        # DIR_LIGHT surfaces have no brdf case (the reference's dispatch
        # falls through, 1826-1884): the path ends
        is_dirlight = surface & (mat_type == MatType.DIR_LIGHT)
        active = active & ~is_dirlight
        surface = surface & ~is_dirlight

        # ---- BSDF sample (brdf, 1804-1884) ----
        new_prev_nl = hit.n * inside[..., None]
        u1, u2 = rng.uniform2(pix, pass_idx, sample_idx, depth, rng.Stream.BSDF_DIR)
        uc = rng.uniform(pix, pass_idx, sample_idx, depth, rng.Stream.BSDF_CHOICE)
        bs = bsdf_ops.sample(scene, cfg, hit, c, e, inside, d, u1, u2, uc)
        mask_after = mask * bs.mask_mult
        diffuse_lane = surface & ~bs.specular

        # ---- cubemap gather on diffuse bounces (1888-1897) ----
        if cfg.use_cubemap:
            eu1, eu2 = rng.uniform2(pix, pass_idx, sample_idx, depth,
                                    rng.Stream.ENV_DIR)
            env_dir = smp.random_direction(new_prev_nl, eu1, eu2,
                                           cfg.use_biased_sampling)
            env_hit = isect.intersect(scene, hit.pos + new_prev_nl * cfg.epsilon,
                                      env_dir, cfg, need_normal=False, need_uv=False)
            env_rad = sky.sample_cubemap(scene.cubemap, env_dir)
            acc = acc + vm.where3(diffuse_lane & env_hit.missed,
                                  mask_after * env_rad, torch.zeros_like(acc))

        # ---- NEE on diffuse bounces (1899-1976) ----
        # NEE reads the light row's emission untextured and blends the
        # shadow hit's texel into its color by the texel's alpha alone, as
        # the JAX integrator does (lighting.direct_light_slot)
        if gbuffer_slots:
            for k, rec in enumerate(gbuf):
                sel = diffuse_lane & (n_diff == k)
                gbuf[k] = _record(rec, sel, hit.pos, new_prev_nl, mask_after, hit.idx, depth)
        elif use_restir:
            nee, res = restir_sampler(scene, cfg, hit, new_prev_nl, mask_after,
                                      pix, pass_idx, sample_idx, depth)
            # the last diffuse bounce wins
            reservoir = {k: torch.where(diffuse_lane[..., None] if v.dim() > diffuse_lane.dim()
                                        else diffuse_lane, res[k], v)
                         for k, v in reservoir.items()}
        elif cfg.sample_lights:
            nee = lighting.sample_lights_nee(
                scene, cfg, hit.pos, new_prev_nl, mask_after,
                pix, pass_idx, sample_idx, depth)
        if cfg.sample_lights and not gbuffer_slots:
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

    if restir_sampler is not None:
        return acc, reservoir
    if gbuffer_slots:
        return acc, gbuf
    return acc


def _empty_slot(batch, dev):
    """A G-buffer slot no vertex wrote: zeros, mesh 0, depth -1, not valid."""
    z3 = torch.zeros(batch + (3,), dtype=torch.float32, device=dev)
    return dict(pos=z3, nl=z3, mask=z3,
                idx=torch.zeros(batch, dtype=torch.int32, device=dev),
                depth=torch.full(batch, -1, dtype=torch.int32, device=dev),
                valid=torch.zeros(batch, dtype=torch.bool, device=dev))


def _record(rec, sel, pos, nl, mask, idx, depth):
    """G-buffer slot `rec` with the lanes of `sel` set to this vertex."""
    return dict(pos=vm.where3(sel, pos, rec["pos"]), nl=vm.where3(sel, nl, rec["nl"]),
                mask=vm.where3(sel, mask, rec["mask"]),
                idx=torch.where(sel, idx.to(torch.int32), rec["idx"]),
                depth=torch.where(sel, torch.full_like(rec["depth"], depth), rec["depth"]),
                valid=rec["valid"] | sel)
