"""Render state: the progressive accumulator (port of render/state.py).

Holds the radiance sum and the pass count.  The ReSTIR reservoir ring of
the JAX RenderState comes with ReSTIR (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RenderState:
    accum: torch.Tensor   # f32[H, W, 3] radiance sum
    passes: int = 0       # completed passes

    @classmethod
    def create(cls, height: int, width: int, device="cuda"):
        return cls(accum=torch.zeros((height, width, 3), dtype=torch.float32,
                                     device=device))

    def replace(self, **kw) -> "RenderState":
        return dataclasses.replace(self, **kw)
