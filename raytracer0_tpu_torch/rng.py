"""Counter-based stateless RNG on int64 tensors (port of raytracer0_tpu/rng.py).

Every random draw is a pure function of integer coordinates
`(pixel_id, pass, depth, stream)` through the PCG output hash (Jarzynski &
Olano, JCGT 2020), so the port draws the same bits as the JAX package and
as the CUDA kernel, pixel for pixel.  Nothing here uses torch's generators.

torch has no uint32 `+` or `>>` on the CPU, so the uint32 words are held in
int64 tensors and masked to 32 bits after every `*` and `+`.  A product of
two full 32-bit words would overflow int64; `_mul32` splits the word into
16-bit halves so every intermediate stays below 2**49.

Functions take tensors or Python ints as coordinates (broadcast together);
at least one coordinate of `fold` should be a tensor, which fixes the
device and the batch shape.
"""

from __future__ import annotations

import enum

import torch

_MASK = 0xFFFFFFFF
_M1 = 747796405
_A1 = 2891336453
_M2 = 277803737
# Multipliers for combining coordinates into one counter (odd constants
# from Weyl-sequence / splitmix-style stream separation).
_CK = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1)
_SEED0 = 0x5BD1E995

_INV_2_24 = 1.0 / (1 << 24)


def _as_u32(c):
    """A coordinate as a uint32 value: int64 tensor or Python int."""
    if isinstance(c, torch.Tensor):
        return c.to(torch.int64) & _MASK
    return int(c) & _MASK


def _mul32(x, k: int):
    """(x * k) mod 2**32 for a uint32 value `x` and a constant `k` < 2**32,
    without overflowing int64."""
    return ((((x >> 16) * k) & _MASK) << 16) + (x & 0xFFFF) * k & _MASK


def pcg(x):
    """PCG-RXS-M-XS output hash on uint32 values (Jarzynski & Olano 2020)."""
    x = (x * _M1 + _A1) & _MASK
    x = (((x >> ((x >> 28) + 4)) ^ x) * _M2) & _MASK
    return (x >> 22) ^ x


def fold(*coords):
    """Mix integer coordinates into one well-distributed uint32 state.

    Each coordinate is weighted by a distinct odd constant and the running
    state is re-hashed, so permuted/equal coordinates do not collide.
    """
    h = _SEED0
    for i, c in enumerate(coords):
        h = pcg((h + _mul32(_as_u32(c), _CK[i % len(_CK)]) + i) & _MASK)
    if not isinstance(h, torch.Tensor):
        h = torch.tensor(h, dtype=torch.int64)
    return h


def uniform_from_bits(bits):
    """uint32 → f32 uniform in [0, 1) with exactly-representable mantissas."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def uniform(*coords):
    """One f32 uniform in [0,1) per broadcast element of the coordinates."""
    return uniform_from_bits(fold(*coords))


def uniform2(*coords):
    """Two independent uniforms (returned as a tuple, not stacked)."""
    h = fold(*coords)
    return uniform_from_bits(h), uniform_from_bits(pcg(h))


def uniform3(*coords):
    h = fold(*coords)
    h2 = pcg(h)
    h3 = pcg(h2)
    return uniform_from_bits(h), uniform_from_bits(h2), uniform_from_bits(h3)


class Stream(enum.IntEnum):
    """Named decorrelated streams (the same values as raytracer0_tpu.rng)."""

    AA = 0                 # tent-filter jitter
    APERTURE = 1           # thin-lens disk sample
    WAVELENGTH = 2         # hero wavelength
    BSDF_DIR = 3           # hemisphere/cone direction in brdf
    BSDF_CHOICE = 4        # reflect-vs-refract / coat choice
    NEE_CONE = 5           # light cone sample
    NEE_SDF_POINT = 6      # point on SDF light bound
    ENV_DIR = 7            # cubemap gather direction
    VOL_FREEPATH = 8       # free-path distance
    VOL_PHASE = 9          # HG phase direction
    VOL_NEE = 10           # per-light cone sample at scatter point
    RESTIR_CANDIDATE = 11  # candidate light picks
    RESTIR_TEMPORAL = 12   # temporal combine rand + jitter
    RESTIR_SPATIAL = 13    # spatial combine rand
    LIGHT_INDEX = 14       # stratified light selection
    RR = 15                # (reserved) russian roulette


def pixel_ids(height: int, width: int, row0: int = 0, device=None):
    """Pixel counter grid [H, W] (row-major): int64 holding uint32 values.

    `row0` offsets the row index, so a band owning rows [row0, row0+H)
    draws the same numbers it would in a full-frame render.
    """
    r = (torch.arange(height, dtype=torch.int64, device=device)[:, None]
         + row0) & _MASK
    c = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    return (_mul32(r, width) + c) & _MASK


def noise_lut(size: int = 256, channels: int = 4, seed: int = 7):
    """The [size, size, channels] f32 value-noise LUT, built from the same
    counter hash as raytracer0_tpu.rng.noise_lut (CPU tensor)."""
    r = torch.arange(size, dtype=torch.int64)[:, None, None]
    c = torch.arange(size, dtype=torch.int64)[None, :, None]
    k = torch.arange(channels, dtype=torch.int64)[None, None, :]
    return uniform(r, c, k, seed)
