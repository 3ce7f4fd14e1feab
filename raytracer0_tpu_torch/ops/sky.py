"""Environment: procedural sky (port of ops/sky.py:20-56).

The cosine-palette sky of the reference (raytracer.glsl:2062), and the
procedural fallback cubemap that `SceneBuilder.build` bakes from it.
Photographic cubemap sampling comes with ROADMAP queue 1 item 9.
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
