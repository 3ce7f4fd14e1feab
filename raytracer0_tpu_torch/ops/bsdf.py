"""BSDF sampling: the DIFF branch of the reference's `brdf` dispatch
(port of ops/bsdf.py; raytracer.glsl:1826-1831).

SPEC, REFR_FRESNEL, REFR_SCHLICK and COAT come with ROADMAP queue 1 item 7;
`integrator.unsupported` keeps scenes that use them off this path.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer0_tpu_torch.ops import sampling as smp


@dataclasses.dataclass(frozen=True)
class BsdfSample:
    o: torch.Tensor            # f32[..., 3] next ray origin
    d: torch.Tensor            # f32[..., 3] next ray direction
    mask_mult: torch.Tensor    # f32[..., 3] throughput multiplier
    specular: torch.Tensor     # bool[...] bounce is specular (NEE gating)
    diff_inc: torch.Tensor     # i32[...] DIFF_BOUNCES increment
    spec_inc: torch.Tensor     # i32[...] SPEC_BOUNCES increment
    scatter_inc: torch.Tensor  # i32[...] SCATTERING_EVENTS increment


def sample(cfg, hit, c, inside, u_dir1, u_dir2):
    """Sample the next ray of every lane on a DIFF surface: a
    cosine-weighted bounce about the oriented normal, throughput *= albedo
    `c` (raytracer.glsl:1826-1831).  `inside`: +1 entering / -1 exiting."""
    nl = hit.n * inside[..., None]
    d = smp.sample_biased(nl, 1.0, u_dir1, u_dir2)
    batch = inside.shape
    dev = inside.device
    one = torch.ones(batch, dtype=torch.int32, device=dev)
    zero = torch.zeros(batch, dtype=torch.int32, device=dev)
    return BsdfSample(o=hit.pos + nl * cfg.epsilon, d=d, mask_mult=c,
                      specular=torch.zeros(batch, dtype=torch.bool, device=dev),
                      diff_inc=one, spec_inc=zero, scatter_inc=zero)
