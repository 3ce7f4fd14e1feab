"""raytracer0_tpu_torch — the path tracer on PyTorch and CUDA (NVIDIA H100).

A port of `raytracer0_tpu` (JAX, XLA and Pallas) that keeps its layout and
names, so each module here has its counterpart at the same path there.
Plain tensor code is PyTorch; the Pallas megakernel becomes a CUDA C++
kernel written for Hopper (`csrc/megakernel.cu`), built with `nvcc` on
first use and bound with `ctypes`.

The JAX package stays the reference.  Two of its modules are pure Python
and are shared, so both packages read one set of flags and codes:
`raytracer0_tpu.config` and `raytracer0_tpu.models.materials`.  Nothing
else of it is imported here, and nothing here imports `jax`.

Layout:
  rng.py       — the counter RNG on int64 tensors (bit-identical draws)
  models/      — scene dataclass, DSL, camera, presets
  ops/         — vecmath, intersect, sampling, bsdf, lighting, sky,
                 tonemap, megakernel (wrapper of the CUDA kernel)
  render/      — integrator (plain bounce loop), renderer, state
  csrc/        — CUDA C++ sources of the kernels

Slice 1 covers the forward render of the Cornell class (analytic
primitives, DIFF and LIGHT materials, sphere-light NEE with optional MIS,
procedural sky); other features raise NotImplementedError.
"""

from raytracer0_tpu.config import (  # noqa: F401  (shared, pure Python)
    ANIMATED_CONFIG, OFFLINE_CONFIG, RenderConfig, RenderMode, TonemapOp,
)

__version__ = "0.1.0"
__all__ = ["RenderConfig", "RenderMode", "TonemapOp", "OFFLINE_CONFIG",
           "ANIMATED_CONFIG", "__version__"]
