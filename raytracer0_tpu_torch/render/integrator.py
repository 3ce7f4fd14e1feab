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
  * hero-wavelength spectral transport (`cfg.use_spectral`): one
    wavelength per sample from the WAVELENGTH stream, Cauchy dispersion
    of negative-IOR glass (ops/bsdf.py), the radiance scaled to RGB at
    the end (ops/spectral.py)
  * the homogeneous medium (`cfg.use_volumetrics`): a free-path distance
    per bounce, drawn before the miss test, so a ray that misses can
    scatter; a scattered path's throughput takes σs/σt, it gathers
    in-scatter NEE from LIGHT spheres alone and goes on along a
    Henyey-Greenstein direction; Beer-Lambert fog on sphere-light shadow
    rays (ops/lighting.py)

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
from raytracer0_tpu_torch.ops import spectral
from raytracer0_tpu_torch.ops import textures as tex
from raytracer0_tpu_torch.ops import vecmath as vm

_ANALYTIC = (int(MeshType.SPHERE), int(MeshType.PLANE), int(MeshType.BOX))
_SDF_ITEM = "ROADMAP queue 1 item 8"
_RESTIR_ITEM = "ROADMAP queue 1 item 11"
_MEDIUM_ITEM = "ROADMAP queue 1 item 10"


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
    textures too, which the JAX package renders on its XLA route); no
    spectral transport and no medium, which the ReSTIR kernels (K4, K6v,
    K7) and the plain ReSTIR pass do not model yet.  Every ReSTIR route
    chains through here."""
    if cfg.use_spectral or cfg.use_volumetrics:
        return f"ReSTIR with spectral transport or a medium: {_MEDIUM_ITEM}"
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
    shapes, every surface material (a negative IOR dispersive under
    spectral transport, else taken as |ior|), textures of all ten types on
    analytic and SDF meshes, sphere, directional and SDF-bound light
    slots, cosine-weighted or uniform sampling, a cubemap, the procedural
    sky or no environment, static or animated accumulation,
    hero-wavelength spectral transport and the homogeneous medium; and
    ReSTIR in the class of `_outside_restir_class`, which refuses the
    last two.
    """
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


def _volumetric_nee(scene, cfg, scatter_pos, rd, mask, pix, pass_idx, sample_idx, depth):
    """In-scatter NEE at a medium event (raytracer.glsl:2011-2044): per
    LIGHT-sphere slot, a uniform cone sample toward the sphere from the
    VOL_NEE stream, a shadow ray from 20 eps along it that counts only if
    it hits that light, weighted by the HG phase, the fog over its length,
    pi and the cone's solid angle; times the throughput `mask`."""
    total = torch.zeros_like(scatter_pos)
    for slot in range(scene.num_lights):
        if lighting.slot_kind(scene, slot) != "sphere":
            continue
        li = scene.lights_static[slot]
        dl = scene.pos[li] - scatter_pos
        dist = vm.safe_length(dl)
        r2 = scene.joker[li, 0] * scene.joker[li, 0]
        cos_a_max = vm.safe_sqrt(
            1.0 - torch.clamp(r2 / torch.clamp_min(dist * dist, 1e-12), 0.0, 1.0))
        u1, u2 = rng.uniform2(pix, pass_idx, sample_idx, depth, slot, rng.Stream.VOL_NEE)
        dir_l = smp.sample_cone(dl / dist[..., None], 1.0 - cos_a_max, u1, u2)
        sh = isect.intersect(scene, scatter_pos + dir_l * (cfg.epsilon * 20.0), dir_l, cfg,
                             need_normal=False, need_uv=False)
        reached = (sh.idx == li) & ~sh.missed   # must hit this light (2028)
        omega = 2.0 * (1.0 - cos_a_max)
        phase = smp.hg_phase(vm.vdot(rd, dir_l), cfg.vol_g)
        t_fog = torch.exp(-cfg.vol_sigma_t * sh.t)
        contrib = (scene.color[li] * scene.emission[li]
                   * (phase * t_fog * smp.PI * omega)[..., None])
        total = total + vm.where3(reached, contrib, torch.zeros_like(contrib))
    return mask * total


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
    # the hero wavelength: the WAVELENGTH stream keys on no depth
    hero_wl = (spectral.sample_wavelength(
        rng.uniform(pix, pass_idx, sample_idx, rng.Stream.WAVELENGTH))
        if cfg.use_spectral else None)
    if cfg.use_volumetrics:   # σt as a tensor: a division by a number is a reciprocal multiply
        sigma_t = torch.full(batch, cfg.vol_sigma_t, dtype=torch.float32, device=dev)

    for depth in range(cfg.max_bounces):
        hit = isect.intersect(scene, o, d, cfg)

        # ---- medium event, before the miss test (raytracer.glsl:1999-2053) ----
        if cfg.use_volumetrics:
            u_fp = rng.uniform(pix, pass_idx, sample_idx, depth, rng.Stream.VOL_FREEPATH)
            scatter_d = -torch.log(torch.clamp_min(u_fp, 1e-6)) / sigma_t
            scatters = active & (scatter_d < torch.clamp_max(hit.t, cfg.infinity))
            scatter_pos = o + scatter_d[..., None] * d
            mask = vm.where3(scatters, mask * (cfg.vol_sigma_s / cfg.vol_sigma_t), mask)
            if cfg.sample_lights and scene.num_lights > 0:
                vol_light = _volumetric_nee(scene, cfg, scatter_pos, d, mask, pix, pass_idx,
                                            sample_idx, depth)
                acc = acc + vm.where3(scatters, vol_light, torch.zeros_like(acc))
            hg1, hg2 = rng.uniform2(pix, pass_idx, sample_idx, depth, rng.Stream.VOL_PHASE)
            hg_dir = smp.sample_hg(d, cfg.vol_g, hg1, hg2)
            n_scat = n_scat + scatters.to(torch.int32)
            # the stale prev_nl stays: the next light hit's MIS weight reads it
            specular = specular & ~scatters
            vol_done = scatters & ((n_scat >= cfg.max_scattering_events)
                                   | (vm.max3(mask) < 0.01))
            active = active & ~vol_done
            surface = active & ~scatters
        else:
            scatters = None
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
        bs = bsdf_ops.sample(scene, cfg, hit, c, e, inside, d, u1, u2, uc, hero_wl)
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

        # scattered lanes go on along their HG direction
        if scatters is not None:
            o = vm.where3(scatters, scatter_pos, o)
            d = vm.where3(scatters, hg_dir, d)

    if cfg.use_spectral:
        acc = acc * spectral.wavelength_to_rgb(hero_wl)
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
