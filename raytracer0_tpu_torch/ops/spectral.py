"""Hero-wavelength spectral transport (port of ops/spectral.py;
raytracer.glsl:320-359, 2122-2155).

One wavelength per pixel sample, drawn uniformly from [380, 720] nm from
the WAVELENGTH stream; the path's radiance is converted to RGB by the CIE
1931 XYZ color matching functions (the multi-Gaussian analytic fit of
Wyman, Sloan & Shirley 2013) and the D65 XYZ -> linear sRGB matrix,
normalized by the reference's white constants.  Dispersive materials
(a negative IOR, whose magnitude is Cauchy's A) refract with Cauchy's
n(λ) = A + B/λ² with B = 0.04 μm².

The constants and the order of every operation are the JAX package's.
Divisions are tensor by tensor: torch turns a division by a Python float
into a reciprocal multiply.  K1 draws the hero wavelength and applies
Cauchy's IOR itself (`csrc/path.cuh`); the RGB scale is applied outside
it (`ops/megakernel.trace_forward`), as the JAX `trace_forward` does.
"""

from __future__ import annotations

import torch

LAMBDA_MIN = 380.0
LAMBDA_SPAN = 340.0
#: the reference's white normalization of the linear sRGB weight
WHITE_NORM = (0.378, 0.298, 0.285)


def sample_wavelength(u):
    """λ = u*340 + 380 nm (raytracer.glsl:2123)."""
    return u * LAMBDA_SPAN + LAMBDA_MIN


def _gauss(l, mu, s_lo, s_hi):
    t = (l - mu) * torch.where(l < mu, s_lo, s_hi)
    return torch.exp(-0.5 * t * t)


def cmf_x(l):
    return (0.362 * _gauss(l, 442.0, 0.0624, 0.0374)
            + 1.056 * _gauss(l, 599.8, 0.0264, 0.0323)
            - 0.065 * _gauss(l, 501.1, 0.0490, 0.0382))


def cmf_y(l):
    return (0.821 * _gauss(l, 568.8, 0.0213, 0.0247)
            + 0.286 * _gauss(l, 530.9, 0.0613, 0.0322))


def cmf_z(l):
    return (1.217 * _gauss(l, 437.0, 0.0845, 0.0278)
            + 0.681 * _gauss(l, 459.0, 0.0385, 0.0725))


def xyz_to_linear_srgb(xyz):
    """D65 XYZ -> linear sRGB (raytracer.glsl:342-348)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return torch.stack([
        3.2404542 * x - 1.5371385 * y - 0.4985314 * z,
        -0.9692660 * x + 1.8760108 * y + 0.0415560 * z,
        0.0556434 * x - 0.2040259 * y + 1.0572252 * z,
    ], dim=-1)


def wavelength_to_rgb(l):
    """λ (nm) [...] -> normalized linear sRGB weight [..., 3]
    (raytracer.glsl:350-353)."""
    xyz = torch.stack([cmf_x(l), cmf_y(l), cmf_z(l)], dim=-1)
    norm = torch.tensor(WHITE_NORM, dtype=torch.float32, device=l.device)
    return torch.clamp_min(xyz_to_linear_srgb(xyz), 0.0) / norm


def cauchy_ior(lambda_nm, cauchy_a):
    """n(λ) = A + 0.04/λ_μm² (raytracer.glsl:355-358)."""
    lu = lambda_nm * 0.001
    return cauchy_a + torch.full_like(lu, 0.04) / torch.clamp_min(lu * lu, 1e-6)
