"""Procedural noise: gradient noise, LUT value noise, Voronoi, fBm (port of
ops/noise.py; raytracer.glsl:363-433).

Vectorized over any batch shape on any device.  The LUT is the scene's
`noise` field, f32[256, 256, 4], built by `rng.noise_lut` from the counter
hash, so it is the JAX package's LUT bit for bit.  Every function keeps the
JAX package's operation order (the `.yx` channel swizzle of value noise, the
z-fold texel addressing of Voronoi), which is also the order the forward
kernel K1 (`csrc/trace_common.cuh`) evaluates them in.
"""

from __future__ import annotations

import torch

from raytracer0_tpu_torch.ops import vecmath as vm


def _gradient_hash(p):
    """iq's sin-based gradient hash in [-1, 1]^3 (raytracer.glsl:363-368)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d = torch.stack([
        x * 127.1 + y * 311.7 + z * 74.7,
        x * 269.5 + y * 183.3 + z * 246.1,
        x * 113.5 + y * 271.9 + z * 124.6,
    ], dim=-1)
    s = torch.sin(d) * 43758.5453
    return -1.0 + 2.0 * (s - torch.floor(s))


def gradient_noise(p):
    """3D gradient (Perlin-style) noise (raytracer.glsl:371-385)."""
    i = torch.floor(p)
    f = p - i
    u = f * f * (3.0 - 2.0 * f)

    def g(ox, oy, oz):
        off = torch.tensor([ox, oy, oz], dtype=p.dtype, device=p.device)
        return vm.vdot(_gradient_hash(i + off), f - off)

    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    lerp = lambda a, b, t: a + (b - a) * t
    return lerp(
        lerp(lerp(g(0, 0, 0), g(1, 0, 0), ux), lerp(g(0, 1, 0), g(1, 1, 0), ux), uy),
        lerp(lerp(g(0, 0, 1), g(1, 0, 1), ux), lerp(g(0, 1, 1), g(1, 1, 1), ux), uy),
        uz,
    )


def _lut_bilinear(lut, x, y, ch0, ch1):
    """Bilinear fetch of two channels from the [256, 256, 4] LUT with REPEAT
    wrapping (`texture(u_rnd_tex, (uv + 0.5) / 256)`, LINEAR)."""
    size = lut.shape[0]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    x0 = torch.remainder(x0, size)
    y0 = torch.remainder(y0, size)
    x1 = torch.remainder(x0 + 1, size)
    y1 = torch.remainder(y0 + 1, size)

    def fetch(ch):
        c00 = lut[y0, x0, ch]
        c01 = lut[y0, x1, ch]
        c10 = lut[y1, x0, ch]
        c11 = lut[y1, x1, ch]
        return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy

    return fetch(ch0), fetch(ch1)


def value_noise(lut, x):
    """LUT-backed 3D value noise (raytracer.glsl:393-401): two channels
    fetched at z-sheared 2D coordinates, lerped along z."""
    p = torch.floor(x)
    f = x - p
    f = f * f * (3.0 - 2.0 * f)
    u = (p[..., 0] + 37.0 * p[..., 2]) + f[..., 0]
    v = (p[..., 1] + 17.0 * p[..., 2]) + f[..., 1]
    # .yx swizzle: rg = tex.yx -> mix(g, r, f.z)
    g_ch, r_ch = _lut_bilinear(lut, u, v, 1, 0)
    return g_ch + (r_ch - g_ch) * f[..., 2]


def voronoi(lut, x):
    """3D Voronoi over the 3x3x3 neighbourhood (raytracer.glsl:404-433):
    [..., 3] = (sqrt(F1), sqrt(F2), |cell id|).  Cell jitter is the LUT
    texel at the integer cell, z folded as (x + 3z, y + z)."""
    p = torch.floor(x)
    f = x - p
    size = lut.shape[0]
    f1 = torch.full(x.shape[:-1], 100.0, dtype=x.dtype, device=x.device)
    f2 = f1.clone()
    cid = torch.zeros_like(f1)
    for k in (-1, 0, 1):
        for j in (-1, 0, 1):
            for i in (-1, 0, 1):
                b = torch.tensor([i, j, k], dtype=x.dtype, device=x.device)
                hx = p + b
                tx = torch.remainder(torch.floor(hx[..., 0] + 3.0 * hx[..., 2])
                                     .to(torch.int64), size)
                ty = torch.remainder(torch.floor(hx[..., 1] + 1.0 * hx[..., 2])
                                     .to(torch.int64), size)
                r = b - f + lut[ty, tx, :3]
                d = vm.vdot(r, r)
                new_id = torch.abs(hx[..., 0] + hx[..., 1] * 57.0 + hx[..., 2] * 113.0)
                closer = d < f1
                f2 = torch.where(closer, f1, torch.where(d < f2, d, f2))
                cid = torch.where(closer, new_id, cid)
                f1 = torch.where(closer, d, f1)
    return torch.stack([torch.sqrt(f1), torch.sqrt(f2), cid], dim=-1)


def metal_fbm(lut, q):
    """3-octave anisotropic fBm of TEX_METAL (raytracer.glsl:762-768)."""
    m = torch.tensor([-1.2, 1.99, -1.6], dtype=q.dtype, device=q.device)
    f = 0.5 * value_noise(lut, q)
    q = m * q * 2.01
    f = f + 0.25 * value_noise(lut, q)
    q = m * q * 2.02
    f = f + 0.125 * value_noise(lut, q)
    return f
