"""Render state: the progressive accumulator and the ReSTIR reservoir ring
(port of render/state.py).

The reservoirs are unpacked per-pixel fields, as in the JAX package (the
reference packs them lossily into RGBA textures, raytracer.glsl:1417-1468).
The ring back → hist1 → hist2 mirrors the reference's buffer rotation
(index.js:795-820); `rotate_reservoirs` moves references, it copies
nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

#: Reservoir fields in declaration order, with their dtypes.
RESERVOIR_FIELDS = {
    "light_pos": torch.float32,    # [H, W, 3]
    "light_color": torch.float32,  # [H, W, 3]
    "weight_sum": torch.float32,   # [H, W]
    "m": torch.float32,            # [H, W]
    "w": torch.float32,            # [H, W]
    "age": torch.float32,          # [H, W]
    "light_index": torch.int32,    # [H, W] slot into scene.light_idx, -1 = none
}


@dataclasses.dataclass(frozen=True)
class Reservoirs:
    """Per-pixel ReSTIR reservoirs (the reference struct at
    raytracer.glsl:1275-1283)."""

    light_pos: torch.Tensor
    light_color: torch.Tensor
    weight_sum: torch.Tensor
    m: torch.Tensor
    w: torch.Tensor
    age: torch.Tensor
    light_index: torch.Tensor

    @classmethod
    def empty(cls, *shape: int, device="cuda") -> "Reservoirs":
        """Reservoirs that hold no light, over a grid of `shape`."""
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        z3 = torch.zeros(shape + (3,), dtype=torch.float32, device=device)
        return cls(light_pos=z3, light_color=z3, weight_sum=z, m=z, w=z, age=z,
                   light_index=torch.full(shape, -1, dtype=torch.int32, device=device))

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, np.ndarray], device) -> "Reservoirs":
        """Reservoirs from numpy arrays by field name: a JAX `Reservoirs`
        carried across (`np.asarray` of each field)."""
        return cls(**{k: torch.as_tensor(np.array(arrays[k]), dtype=dt, device=device)
                      for k, dt in RESERVOIR_FIELDS.items()})

    def fields(self) -> dict:
        return {k: getattr(self, k) for k in RESERVOIR_FIELDS}


@dataclasses.dataclass(frozen=True)
class RenderState:
    accum: torch.Tensor           # f32[H, W, 3] radiance sum
    passes: int = 0               # completed passes
    restir_back: Reservoirs = None    # previous pass (spatial-reuse source)
    restir_hist1: Reservoirs = None   # one pass back (temporal level 0)
    restir_hist2: Reservoirs = None   # two passes back (temporal level 1)

    @classmethod
    def create(cls, height: int, width: int, device="cuda"):
        return cls(accum=torch.zeros((height, width, 3), dtype=torch.float32,
                                     device=device),
                   restir_back=Reservoirs.empty(height, width, device=device),
                   restir_hist1=Reservoirs.empty(height, width, device=device),
                   restir_hist2=Reservoirs.empty(height, width, device=device))

    def replace(self, **kw) -> "RenderState":
        return dataclasses.replace(self, **kw)

    def rotate_reservoirs(self, new_back: Reservoirs) -> "RenderState":
        """The per-pass rotation back → hist1 → hist2 (index.js:795-820)."""
        return self.replace(restir_back=new_back, restir_hist1=self.restir_back,
                            restir_hist2=self.restir_hist1)
