"""Display transform: exposure scaling + tone operator + gamma
(port of ops/tonemap.py; tonemapper.glsl:17-32)."""

from __future__ import annotations

import torch

from raytracer0_tpu.config import RenderConfig, TonemapOp


def reinhard(x):
    return x / (1.0 + x)


def aces_film(x):
    """Narkowicz ACES filmic fit (tonemapper.glsl:17-26)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def display(accum, cont, cfg: RenderConfig):
    """Map an accumulated HDR buffer to display-referred sRGB in [0, 1].

    `accum`: f32[..., 3] accumulated radiance sum; `cont`: contribution
    scale (1/passes for static accumulation, 1.0 for animated EMA).
    """
    col = torch.clamp_min(accum * cont, 0.0)
    if cfg.tonemap == TonemapOp.REINHARD:
        col = reinhard(col)
    elif cfg.tonemap == TonemapOp.ACES:
        col = aces_film(col)
    return torch.clamp(torch.pow(torch.clamp_min(col, 1e-12), 1.0 / cfg.gamma),
                       0.0, 1.0)
