"""Camera model and primary-ray generation (port of models/camera.py).

The reference camera (raytracer.glsl:2126-2148): look-direction basis
with +Y up, vertical-FOV screen extents, tent-filter antialiasing jitter,
and thin-lens depth of field.  Camera parameters are 0-d/[3] f32 tensors
on the render device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.ops import vecmath as vm

TWO_PI = 6.28318531
RAD = 0.01745329

_FIELDS = ("origin", "lookat", "fov", "aperture", "focal_length")


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera parameters (reference defaults: index.js:89-95)."""

    origin: torch.Tensor        # f32[3]
    lookat: torch.Tensor        # f32[3] — a *direction*, as in the reference
    fov: torch.Tensor           # f32[] vertical field of view, degrees
    aperture: torch.Tensor      # f32[] lens radius (0 = pinhole)
    focal_length: torch.Tensor  # f32[] focus distance

    @classmethod
    def make(cls, origin=(0.0, 0.0, 2.8), lookat=(0.0, 0.0, -1.0), fov=50.0,
             aperture=0.0, focal_length=3.5, device="cuda"):
        vals = dict(origin=origin, lookat=lookat, fov=fov, aperture=aperture,
                    focal_length=focal_length)
        return cls.from_arrays({k: np.asarray(v, np.float32)
                                for k, v in vals.items()}, device)

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, np.ndarray], device) -> "Camera":
        """Build a Camera from numpy arrays — the JAX Camera's fields
        carried across (`np.asarray` of each)."""
        return cls(**{k: torch.as_tensor(np.array(arrays[k]),
                                         dtype=torch.float32, device=device)
                      for k in _FIELDS})

    def basis(self):
        """(u, v, w): right, up, forward — raytracer.glsl:2131-2133."""
        w = vm.normalize(self.lookat)
        up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                          device=w.device)
        u = vm.normalize(vm.cross(w, up))
        v = vm.cross(u, w)
        return u, v, w


def tent_jitter(r):
    """Tent-filter inverse-CDF mapping a uniform in [0,1) to [-1, 1]
    (raytracer.glsl:2135-2138)."""
    flip = r >= 0.5
    h = torch.where(flip, 1.0 - r, r)
    d = torch.sqrt(torch.clamp_min(2.0 * h, 0.0)) - 1.0
    return torch.where(flip, -d, d)


def generate_rays(camera: Camera, height: int, width: int, pass_idx,
                  sample_idx=0, row0=0, full_height=None):
    """Primary rays for every pixel: (origin, direction), f32[H, W, 3] each,
    on the camera's device.

    Pixel convention matches gl_FragCoord: x right, y **up** (row 0 is the
    bottom of the image).  `row0`/`full_height` render rows
    [row0, row0+height) of a `full_height`-tall image with exactly the rays
    the full render would use.
    """
    dev = camera.origin.device
    full_height = height if full_height is None else full_height
    pix = rng.pixel_ids(height, width, row0=row0, device=dev)
    r_aa_x = rng.uniform(pix, pass_idx, sample_idx, rng.Stream.AA)
    r_aa_y = rng.uniform(pix, pass_idx, sample_idx, rng.Stream.AA + 16)
    r_ap_ang, r_ap_rad = rng.uniform2(pix, pass_idx, sample_idx,
                                      rng.Stream.APERTURE)

    # Normalized screen coords in [-1, 1], pixel centers (gl_FragCoord = idx+0.5).
    rows = torch.arange(height, dtype=torch.float32, device=dev) + row0
    ys = (2.0 * (rows + 0.5) / full_height - 1.0)[:, None]
    xs = (2.0 * (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
          / width - 1.0)[None, :]
    aspect = width / full_height

    theta = camera.fov * RAD
    v_len = torch.tan(theta * 0.5)
    u_len = aspect * v_len

    u, v, w = camera.basis()

    dx = xs + tent_jitter(r_aa_x) / (width * 0.5)
    dy = ys + tent_jitter(r_aa_y) / (full_height * 0.5)

    # Focal point along the jittered direction (raytracer.glsl:2140).
    d = vm.normalize(dx[..., None] * u * u_len + dy[..., None] * v * v_len + w)
    focal_point = d * camera.focal_length

    # Random point on the aperture disk (raytracer.glsl:2143-2145).
    ang = r_ap_ang * TWO_PI
    rad = r_ap_rad * camera.aperture
    aperture_pos = ((torch.cos(ang)[..., None] * u
                     + torch.sin(ang)[..., None] * v) * rad[..., None])

    origin = camera.origin + aperture_pos
    direction = vm.normalize(focal_point - aperture_pos)
    return origin, direction
