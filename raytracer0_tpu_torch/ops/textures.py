"""Texture evaluation, the reference's `getTexel` (raytracer.glsl:726-772;
port of ops/textures.py).

Ten texture types: four image samplers (differentiable bilinear gathers
from the scene's `images`), the CHECK and RIPPLE UV patterns, and four
position-based types (VORONOI, GRADIENT_NOISE, VALUE_NOISE, METAL fBm).
Only the types present in the scene are evaluated (`scene.tex_types_used`,
static).  This is the plain version of the texel fetch in the forward
kernel K1 (`csrc/trace_common.cuh::get_texel`), which follows these
operations in the same order.  Divisions by a constant divide by a tensor:
PyTorch on CUDA turns a division by a Python float into a multiplication
by its reciprocal, which rounds differently.
"""

from __future__ import annotations

import torch

from raytracer0_tpu_torch.models.materials import TexType
from raytracer0_tpu_torch.ops import noise as nz


def bilinear_wrap(img, uv):
    """Differentiable bilinear sample of [H, W, C] at `uv` under GL REPEAT
    wrapping, mip level 0."""
    h, w = img.shape[0], img.shape[1]
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = torch.remainder(x0f.to(torch.int64), w)
    y0 = torch.remainder(y0f.to(torch.int64), h)
    x1 = torch.remainder(x0 + 1, w)
    y1 = torch.remainder(y0 + 1, h)
    flat = img.reshape(h * w, img.shape[2])
    c00 = flat[y0 * w + x0]
    c01 = flat[y0 * w + x1]
    c10 = flat[y1 * w + x0]
    c11 = flat[y1 * w + x1]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def used_tex_types(scene) -> set[int]:
    """The texture types present in the scene (static)."""
    return set(scene.tex_types_used)


def blended(scene) -> bool:
    """Whether any mesh blends a texture into its color or emission (a
    texture without either option, or a blend option without a texture,
    changes nothing)."""
    return any(t != int(TexType.NONE) and (c or e)
               for t, (c, e) in zip(scene.tex_types_static, scene.opts_static))


def get_texel(scene, idx, uv, pos):
    """The winning mesh's texel, f32[..., 4].

    `idx` int[...] mesh index, `uv` f32[..., 2], `pos` f32[..., 3] hit
    position (for the 3D types).  Meshes without a texture give zeros,
    whose alpha of 0 makes every blend a no-op, as the reference's NULL
    texel does."""
    present = used_tex_types(scene)
    out = torch.zeros(uv.shape[:-1] + (4,), dtype=torch.float32, device=uv.device)
    if not present:
        return out
    ttype = scene.tex_type[idx]
    params = scene.tex_params[idx]

    def put(t, tex):
        return torch.where((ttype == int(t))[..., None], tex, out)

    for k in range(4):
        if int(TexType.IMAGE0) + k in present:
            out = put(int(TexType.IMAGE0) + k, bilinear_wrap(scene.images[k], uv))

    if int(TexType.CHECK) in present:
        val = torch.remainder(torch.floor(params[..., 0] * uv[..., 0])
                              + torch.floor(params[..., 1] * uv[..., 1]),
                              torch.clamp_min(params[..., 2], 1e-6))
        out = put(TexType.CHECK, val[..., None])

    if int(TexType.RIPPLE) in present:
        du = uv[..., 0] - params[..., 0]
        dv = uv[..., 1] - params[..., 1]
        dist = torch.sqrt(du * du + dv * dv)
        val = torch.remainder(torch.ceil(dist * params[..., 2]),
                              torch.clamp_min(params[..., 3], 1e-6))
        out = put(TexType.RIPPLE, val[..., None])

    # the 3D types share scaled = params.xyz * hit_pos (raytracer.glsl:747)
    scaled = params[..., :3] * pos

    if int(TexType.VORONOI) in present:
        v3 = nz.voronoi(scene.noise, scaled)
        out = put(TexType.VORONOI, torch.cat([v3, torch.zeros_like(v3[..., :1])], dim=-1))

    if int(TexType.GRADIENT_NOISE) in present:
        f = nz.gradient_noise(scaled)
        t = torch.clamp((f + 0.7) / torch.full_like(f, 1.4), 0.0, 1.0)
        val = t * t * (3.0 - 2.0 * t)   # smoothstep(-0.7, 0.7, f)
        out = put(TexType.GRADIENT_NOISE, val[..., None])

    if int(TexType.VALUE_NOISE) in present:
        val = nz.value_noise(scene.noise, scaled)
        out = put(TexType.VALUE_NOISE, val[..., None])

    if int(TexType.METAL) in present:
        val = nz.metal_fbm(scene.noise, scaled)
        out = put(TexType.METAL, val[..., None])

    return out
