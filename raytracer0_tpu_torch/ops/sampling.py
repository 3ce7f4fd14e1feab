"""Direction sampling and MIS weights (port of the ops/sampling.py
functions the Cornell class uses).

Cosine-weighted hemisphere and uniform cone sampling consume explicit
uniforms from `rng` streams.  Uniform-hemisphere, Henyey-Greenstein and
the Fresnel models come with ROADMAP queue 1 items 7 and 10.
"""

from __future__ import annotations

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
