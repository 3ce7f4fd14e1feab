"""Direction sampling, the Fresnel models and MIS weights (port of
ops/sampling.py; raytracer.glsl:480-492, 1109-1141, 1233-1262).

Cosine-weighted and uniform hemisphere and uniform cone sampling consume
explicit uniforms from `rng` streams, the uniform sphere direction
picks the point of an SDF light, and the Henyey-Greenstein phase function
scatters a path in the homogeneous medium.  Integer powers are written out
as products in the order JAX's `integer_pow` multiplies, which the CUDA
kernel follows too.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer0_tpu_torch.ops import vecmath as vm

PI = 3.14159265
TWO_PI = 6.28318531
ONE_OVER_PI = 0.31830989
FOUR_PI = 12.5663706


def _around(w, u, v, ang, om, r_y):
    """(cos(ang)*om)*u + (sin(ang)*om)*v + r_y*w, normalized."""
    d = ((torch.cos(ang) * om)[..., None] * u
         + (torch.sin(ang) * om)[..., None] * v
         + r_y[..., None] * w)
    return vm.normalize(d)


def sample_biased(w, power, u1, u2):
    """Cosine-power-weighted direction about `w` (raytracer.glsl:1109-1120).
    power=1 gives cosine-weighted hemisphere sampling (pdf = cosθ/π)."""
    u, v = vm.onb(w)
    ang = u1 * TWO_PI
    # torch.pow with exponent 0.5 is sqrt; the CUDA kernel calls sqrtf
    r_y = torch.pow(torch.clamp_min(u2, 1e-12), 1.0 / (power + 1.0))
    oneminus = vm.safe_sqrt(1.0 - r_y * r_y)
    return _around(w, u, v, ang, oneminus, r_y)


def sample_cone(w, extent, u1, u2):
    """Uniform direction in a cone of `extent = 1 - cosθ_max` about `w`
    (raytracer.glsl:1122-1133); extent=1 is the uniform hemisphere."""
    u, v = vm.onb(w)
    ang = u1 * TWO_PI
    r_y = 1.0 - u2 * extent
    oneminus = vm.safe_sqrt(1.0 - r_y * r_y)
    return _around(w, u, v, ang, oneminus, r_y)


def random_direction(n, u1, u2, biased: bool):
    """Bounce direction about normal `n` (raytracer.glsl:1135-1141):
    cosine-weighted when USE_BIASED_SAMPLING, else uniform hemisphere."""
    if biased:
        return sample_biased(n, 1.0, u1, u2)
    return sample_cone(n, 1.0, u1, u2)


def random_sphere_direction(u1, u2):
    """Uniform direction on the sphere: z = 1 - 2u1, φ = 2πu2 (the JAX
    package's mapping, not the reference's sin/cos products)."""
    z = 1.0 - 2.0 * u1
    r = vm.safe_sqrt(1.0 - z * z)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sample_hg(w, g, u1, u2):
    """Henyey-Greenstein importance sampling about the direction `w`
    (raytracer.glsl:1157-1171).  `g` is a config constant; as in the JAX
    package it enters as a float32 value and the arithmetic on it is
    float32, the near-isotropic |g| < 1e-3 as the uniform sphere."""
    g = np.float32(g)
    if np.abs(g) < np.float32(1e-3):
        cos_t = 1.0 - 2.0 * u1
    else:
        # float32 constants as Python floats (exact), and tensor divisors:
        # a division by a number is a reciprocal multiply
        one_m_g2, one_p_g2 = float(1 - g * g), float(1 + g * g)
        sqr = torch.full_like(u1, one_m_g2) / (float(1 - g) + float(2 * g) * u1)
        cos_t = (one_p_g2 - sqr * sqr) / torch.full_like(u1, float(2 * g))
    sin_t = vm.safe_sqrt(1.0 - cos_t * cos_t)
    t_vec, b_vec = vm.onb(w)
    return _around(w, t_vec, b_vec, TWO_PI * u2, sin_t, cos_t)


def hg_phase(cos_theta, g):
    """HG phase function value (raytracer.glsl:2032-2037).  `g` is a
    Python float, so g², 1 + g², 2g and 1 - g² are formed in double and
    rounded to float32 once, as JAX folds them."""
    g = float(g)
    g2 = g * g
    denom = torch.clamp_min((1.0 + g2) - (2.0 * g) * cos_theta, 1e-6)
    return torch.full_like(denom, 1.0 - g2) / (FOUR_PI * denom * torch.sqrt(denom))


def schlick(d, n, nc, nt):
    """Schlick reflectance (raytracer.glsl:480-483); `d` the incident
    direction, `n` the oriented normal.  r0 = q**2 and c**5 as products."""
    q = (nc - nt) / (nc + nt)
    r0 = q * q
    c = torch.clamp(1.0 + vm.vdot(n, d), 0.0, 1.0)
    c2 = c * c
    return r0 + (1.0 - r0) * (c * (c2 * c2))


def fresnel(d, n, nc, nt, refr):
    """Full unpolarized Fresnel (Rs+Rp)/2 (raytracer.glsl:485-492)."""
    cos_i = vm.vdot(d, n)
    cos_t = vm.vdot(n, refr)
    rs = vm.safe_div(nc * cos_i - nt * cos_t, nc * cos_i + nt * cos_t)
    rp = vm.safe_div(nc * cos_t - nt * cos_i, nc * cos_t + nt * cos_i)
    return torch.clamp((rs * rs + rp * rp) * 0.5, 0.0, 1.0)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Veach power heuristic, β=2 (raytracer.glsl:1233-1238)."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    # floor^2 >= f32 min-normal keeps the division's backward finite
    return torch.where(denom > 0.0,
                       torch.clamp_min(f * f, 0.0) / torch.clamp_min(denom, 1e-12),
                       torch.zeros_like(denom))


def cosine_hemisphere_pdf(wi, n):
    """pdf = cosθ/π for cosine-weighted sampling (raytracer.glsl:1241-1243)."""
    return torch.clamp_min(vm.vdot(wi, n), 0.0) * ONE_OVER_PI


def sphere_light_pdf(light_pos, light_r, x):
    """Solid-angle pdf of cone-sampling a sphere light from x
    (raytracer.glsl:1246-1262), with inside-sphere and tiny-angle guards."""
    d = light_pos - x
    d2 = vm.vdot(d, d)
    r2 = light_r * light_r
    inside = d2 <= r2
    cos_max = vm.safe_sqrt(1.0 - vm.safe_div(r2, d2))
    denom = 1.0 - cos_max
    degenerate = denom < 1e-6
    pdf = 1.0 / torch.clamp_min(TWO_PI * denom, 1e-12)
    return torch.where(inside | degenerate, torch.zeros_like(pdf), pdf)
