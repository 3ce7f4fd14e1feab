"""raytracer0_tpu_torch — the path tracer on PyTorch and CUDA (NVIDIA H100).

A port of `raytracer0_tpu` (JAX, XLA and Pallas) that keeps its layout and
names, so each module here has its counterpart at the same path there.
Plain tensor code is PyTorch; the Pallas megakernels become CUDA C++
kernels written for Hopper, the forward K1 (`csrc/megakernel.cu`) and its
adjoint K2 (`csrc/megakernel_bwd.cu`), built with `nvcc` on first use and
bound with `ctypes`.

The JAX package stays the reference.  Nothing here imports it or `jax`:
the port keeps its own copies of the two pure-Python modules it needs,
`config.py` (the render flags and budgets) and `models/materials.py` (the
type codes and the material library), with the JAX package's names and
values.  Entry points put their tensors on the CUDA device unless the
caller passes `device="cpu"`.

Layout:
  config.py    — RenderConfig and the two budget sets
  rng.py       — the counter RNG on int64 tensors (bit-identical draws)
  models/      — scene dataclass, DSL, camera, presets
  ops/         — vecmath, intersect, sampling, bsdf, lighting, sky,
                 tonemap, megakernel (the autograd pairing of the CUDA
                 forward kernel K1 and its adjoint K2)
  render/      — integrator (plain bounce loop), renderer, state
  optimize.py  — inverse rendering: fit scene parameters with Adam
  csrc/        — CUDA C++ sources of the kernels

The port covers the Cornell class (analytic primitives, DIFF and LIGHT
materials, sphere-light NEE with optional MIS, procedural sky), forward
and gradient; other features raise NotImplementedError.
"""

from raytracer0_tpu_torch.config import (  # noqa: F401
    ANIMATED_CONFIG, OFFLINE_CONFIG, RenderConfig, RenderMode, TonemapOp,
)

__version__ = "0.1.0"
__all__ = ["RenderConfig", "RenderMode", "TonemapOp", "OFFLINE_CONFIG",
           "ANIMATED_CONFIG", "__version__"]
