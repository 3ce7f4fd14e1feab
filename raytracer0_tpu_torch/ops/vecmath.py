"""Vector math over stacked `[..., 3]` tensors (port of ops/vecmath.py).

Elementwise over arbitrarily batched tensors.  Divisions and square roots
are guarded exactly as in the JAX package (`EPS` floors, `safe_*`), so
results and gradients stay finite; `length` also keeps its gradient finite
at 0, where the JAX package's is NaN.  Dot products are written out as
x*x' + y*y' + z*z', left to right, which is the order the CUDA kernel
uses; a reduction over the last axis may sum in another order.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def vdot(a, b):
    """Batched dot product: [..., 3] x [..., 3] -> [...]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(a):
    """Euclidean length, sqrt(max(a·a, 0)), with a zero gradient at a = 0,
    where sqrt's would be 0 * inf = NaN (the JAX package's is; an SDF
    distance evaluated exactly on a box's core reaches it)."""
    return safe_sqrt(vdot(a, a))


def safe_length(a, eps=EPS):
    """Length with a floor so the gradient at 0 is finite."""
    return torch.sqrt(torch.clamp_min(vdot(a, a), eps))


def normalize(a, eps=EPS):
    """Unit vector; returns a finite vector even for (near-)zero input."""
    return a * torch.reciprocal(safe_length(a, eps))[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def reflect(d, n):
    """GLSL reflect: d - 2*dot(d,n)*n (d incident, n unit normal)."""
    return d - (2.0 * vdot(d, n))[..., None] * n


def refract(d, n, eta):
    """GLSL refract semantics (raytracer.glsl:1839): (t, tir) with the
    refracted direction, zero where total internal reflection occurred
    (`tir` True).  `eta` [...] is n_incident / n_transmitted."""
    cos_i = vdot(d, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    t = eta[..., None] * d - (eta * cos_i + safe_sqrt(k))[..., None] * n
    return torch.where(tir[..., None], torch.zeros_like(t), t), tir


def mix(a, b, t):
    """GLSL mix/lerp; t may be scalar, [...] or [..., k]."""
    return a + (b - a) * t


def luminance(c):
    """ITU-R BT.709 luma (raytracer.glsl:1372)."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def max3(c):
    """max(r, g, b) — the mask-cutoff test."""
    return torch.amax(c, dim=-1)


def safe_sqrt(x):
    """sqrt(max(x, 0)) with a finite backward at and below 0: exact in the
    forward pass and zero gradient for x <= 0."""
    pos = x > 0.0
    r = torch.sqrt(torch.where(pos, x, torch.ones_like(x)))
    return torch.where(pos, r, torch.zeros_like(x))


def safe_div(a, b, eps=EPS):
    """a / b with sign-preserving denominator floor (finite gradients)."""
    mag = torch.clamp_min(torch.abs(b), eps)
    return a / torch.where(b < 0, -mag, mag)


def onb(n):
    """Branch-free orthonormal basis from a unit normal (Duff et al.,
    JCGT 2017), with the degenerate |n.z|≈1 guard of vecmath.onb.
    Returns (u, v) with (u, v, n) spanning the tangent frame."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    one = torch.ones_like(nz)
    sig = torch.where(nz < 0.0, -one, one)
    den = sig + nz
    a = -1.0 / torch.where(torch.abs(den) < EPS, torch.full_like(den, EPS), den)
    b = nx * ny * a
    u = torch.stack([1.0 + sig * nx * nx * a, sig * b, -sig * nx], dim=-1)
    v = torch.stack([b, sig + ny * ny * a, -ny], dim=-1)
    # Degenerate pole: n ≈ (0, 0, ±1)
    degen = (torch.abs(nz) > 0.99999)[..., None]
    zero = torch.zeros_like(nz)
    u = torch.where(degen, torch.stack([one, zero, zero], dim=-1), u)
    v = torch.where(degen, torch.stack([zero, sig, zero], dim=-1), v)
    return u, v


def where3(mask, a, b):
    """Select [..., 3] vectors by a [...] boolean mask."""
    return torch.where(mask[..., None], a, b)
