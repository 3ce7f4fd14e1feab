"""Environment: procedural sky and cubemap sampling (port of ops/sky.py).

The cosine-palette sky of the reference (raytracer.glsl:2062), the
procedural fallback cubemap that `SceneBuilder.build` bakes from it, and
`sample_cubemap`, which replaces GLSL `texture(u_cubemap, dir)` with a
face select and a bilinear fetch over an f32[6, H, W, 3] tensor.  The
CUDA kernel K1 (`csrc/trace_common.cuh::sample_cubemap`) fetches the
texels with the same operations in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 6.28318531

_SKY_PHASE = (0.525, 0.408, 0.409)
_SKY_FREQ = (0.9, 0.97, 0.8)


def procedural_sky(rd):
    """Cosine-palette sky from ray direction [..., 3] -> [..., 3]."""
    h = torch.clamp(rd[..., 1] * 0.6 + 0.5, 0.3, 1.0)[..., None]
    phase = torch.tensor(_SKY_PHASE, dtype=torch.float32, device=rd.device)
    freq = torch.tensor(_SKY_FREQ, dtype=torch.float32, device=rd.device)
    return 0.5 + 0.5 * torch.cos(TWO_PI * (phase + freq * h))


def default_cubemap(size: int = 64):
    """Procedural fallback cubemap: the cosine-palette sky baked onto 6
    faces, f32[6, size, size, 3] numpy (the same values as
    raytracer0_tpu.ops.sky.default_cubemap)."""
    ax = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    t, s = np.meshgrid(ax, ax, indexing="ij")  # t = v (down), s = u
    one = np.ones_like(s)
    # direction per face from the GL (s, t) cubemap conventions
    dirs = {
        0: (one, -t, -s),   # +x
        1: (-one, -t, s),   # -x
        2: (s, one, t),     # +y
        3: (s, -one, -t),   # -y
        4: (s, -t, one),    # +z
        5: (-s, -t, -one),  # -z
    }
    phase = np.asarray(_SKY_PHASE, np.float32)
    freq = np.asarray(_SKY_FREQ, np.float32)
    faces = []
    for f in range(6):
        d = np.stack(dirs[f], axis=-1)
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        h = np.clip(d[..., 1] * 0.6 + 0.5, 0.3, 1.0)
        faces.append(0.5 + 0.5 * np.cos(TWO_PI * (phase + freq * h[..., None])))
    return np.stack(faces).astype(np.float32)


def sample_cubemap(cubemap, rd):
    """Sample an f32[6, H, W, 3] cubemap by direction rd [..., 3] (GL face
    order +x, -x, +y, -y, +z, -z; the ties of the JAX `sample_cubemap`)."""
    x, y, z = rd[..., 0], rd[..., 1], rd[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    x_major = (ax >= ay) & (ax >= az)
    y_major = (ay > ax) & (ay >= az)

    def pick(a, b, c):
        return torch.where(x_major, a, torch.where(y_major, b, c))

    face = pick(torch.where(x > 0, 0, 1), torch.where(y > 0, 2, 3),
                torch.where(z > 0, 4, 5))
    ma = torch.clamp_min(pick(ax, ay, az), 1e-9)
    # GL cubemap (s, t) conventions per face
    sc = pick(torch.where(x > 0, -z, z), x, torch.where(z > 0, x, -x))
    tc = pick(-y, torch.where(y > 0, z, -z), -y)
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)

    h, w = cubemap.shape[1], cubemap.shape[2]
    xpix = torch.clamp(u * w - 0.5, 0.0, w - 1.0)
    ypix = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(xpix).to(torch.int64)
    y0 = torch.floor(ypix).to(torch.int64)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = (xpix - x0)[..., None]
    fy = (ypix - y0)[..., None]
    flat = cubemap.reshape(6 * h * w, 3)
    base = face * (h * w)
    c00 = flat[base + y0 * w + x0]
    c01 = flat[base + y0 * w + x1]
    c10 = flat[base + y1 * w + x0]
    c11 = flat[base + y1 * w + x1]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def environment(scene, rd, cfg):
    """Environment radiance of escaped rays (raytracer.glsl:2059-2063)."""
    if cfg.use_cubemap:
        return sample_cubemap(scene.cubemap, rd)
    if cfg.use_procedural_sky:
        return procedural_sky(rd)
    return torch.zeros_like(rd)
