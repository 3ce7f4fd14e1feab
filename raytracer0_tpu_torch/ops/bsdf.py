"""BSDF sampling: the reference's `brdf` dispatch (port of ops/bsdf.py;
raytracer.glsl:1804-1884).

Five surface behaviors selected per ray by material type, evaluated
branch-free over the whole wavefront:

* DIFF — cosine-weighted (or uniform) bounce, throughput *= albedo
  (1826-1831)
* SPEC — mirror with roughness perturbation from emission-as-glossiness
  (`_roughness = e * randomDir`, 1812-1813, 1832-1836)
* REFR_FRESNEL / REFR_SCHLICK — refraction with TIR fallback and a
  stochastic reflect/transmit choice by reflectance (1837-1868)
* COAT — stochastic specular-vs-diffuse by Schlick (1869-1884)

Under spectral transport a negative IOR marks dispersive glass: its
refraction and its Schlick or Fresnel reflectance (COAT's too) take
Cauchy's IOR at the path's hero wavelength, with |ior| as Cauchy's A
(1820-1824); without it, and for a positive IOR, the IOR is |ior|.  As in
the reference, transmission increments SCATTERING_EVENTS, not
TRANS_BOUNCES (435-438, 1866).
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer0_tpu_torch.models.materials import MatType
from raytracer0_tpu_torch.ops import sampling as smp
from raytracer0_tpu_torch.ops import spectral as spec
from raytracer0_tpu_torch.ops import vecmath as vm

IOR_AIR = 1.00029  # nc in brdf (raytracer.glsl:1815)


@dataclasses.dataclass(frozen=True)
class BsdfSample:
    o: torch.Tensor            # f32[..., 3] next ray origin
    d: torch.Tensor            # f32[..., 3] next ray direction
    mask_mult: torch.Tensor    # f32[..., 3] throughput multiplier
    specular: torch.Tensor     # bool[...] bounce is specular (NEE gating)
    diff_inc: torch.Tensor     # i32[...] DIFF_BOUNCES increment
    spec_inc: torch.Tensor     # i32[...] SPEC_BOUNCES increment
    scatter_inc: torch.Tensor  # i32[...] SCATTERING_EVENTS increment


def sample(scene, cfg, hit, c, e, inside, rd, u_dir1, u_dir2, u_choice, hero_wl=None):
    """Sample the next ray of every lane of the wavefront.

    `c`, `e`: clamped color and emission of the hit; `inside`: +1 entering
    / -1 exiting; `rd`: the incoming direction; `u_dir1`, `u_dir2`: the
    BSDF_DIR draws; `u_choice`: the BSDF_CHOICE draw; `hero_wl`: the
    lanes' hero wavelength in nm, read under `cfg.use_spectral`.
    """
    x = hit.pos
    nl = hit.n * inside[..., None]
    mat_type = scene.mat_type[hit.idx]

    rand_dir = smp.random_direction(nl, u_dir1, u_dir2, cfg.use_biased_sampling)
    # Emission doubles as glossiness (1812-1813).  Its magnitude is detached:
    # it only bends the sampled direction, as in the JAX package.
    roughness = e.detach() * rand_dir

    nc = IOR_AIR
    nt = scene.ior[hit.idx]
    if cfg.use_spectral:
        nt = torch.where(nt < 0.0, spec.cauchy_ior(hero_wl, torch.abs(nt)), nt)
    else:
        nt = torch.abs(nt)   # the reference's non-spectral handling (1823)
    nt = torch.clamp_min(nt, 1e-3)   # guard the NULL/light materials (nt = 0)

    o_out = x + nl * cfg.epsilon
    o_in = x - nl * cfg.epsilon
    refl_dir = vm.normalize(roughness + vm.reflect(rd, nl))

    # ---- refraction, computed for all lanes and selected below ----
    # Divisions by a Python float are reciprocal-then-multiply in torch
    # (scalar / tensor everywhere, tensor / scalar on CUDA): dividing by a
    # tensor keeps each one correctly rounded division, as in JAX and K1.
    nc_t = torch.full_like(nt, nc)
    nnt = torch.where(inside > 0.0, nc_t / nt, nt / nc_t)
    tdir_raw, tir = vm.refract(rd, nl, nnt)
    tdir = vm.normalize(roughness + tdir_raw)
    re_schlick = smp.schlick(rd, nl, nc, nt)
    re_fresnel = smp.fresnel(rd, nl, nc, nt, tdir)
    re = torch.where(mat_type == MatType.REFR_FRESNEL, re_fresnel, re_schlick)

    is_diff = mat_type == MatType.DIFF
    is_spec = mat_type == MatType.SPEC
    is_refr = (mat_type == MatType.REFR_FRESNEL) | (mat_type == MatType.REFR_SCHLICK)
    is_coat = mat_type == MatType.COAT
    refr_reflects = tir | (u_choice < re)
    coat_spec = u_choice < re_schlick

    d = vm.where3(is_diff, rand_dir,
        vm.where3(is_spec, refl_dir,
        vm.where3(is_refr, vm.where3(refr_reflects, refl_dir, tdir),
        vm.where3(coat_spec, refl_dir, rand_dir))))
    o = vm.where3(is_refr & ~refr_reflects, o_in, o_out)

    attenuates = is_diff | is_spec | (is_refr & ~refr_reflects) | (is_coat & ~coat_spec)
    mask_mult = vm.where3(attenuates, c, torch.ones_like(c))
    specular = is_spec | is_refr | (is_coat & coat_spec)
    i32 = torch.int32
    return BsdfSample(
        o=o, d=d, mask_mult=mask_mult, specular=specular,
        diff_inc=(is_diff | (is_coat & ~coat_spec)).to(i32),
        spec_inc=(is_spec | (is_refr & refr_reflects) | (is_coat & coat_spec)).to(i32),
        scatter_inc=(is_refr & ~refr_reflects).to(i32))
