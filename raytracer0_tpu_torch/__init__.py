"""raytracer0_tpu_torch — the path tracer on PyTorch and CUDA (NVIDIA H100).

A port of `raytracer0_tpu` (JAX, XLA and Pallas) that keeps its layout and
names, so each module here has its counterpart at the same path there.
Plain tensor code is PyTorch; the Pallas megakernels become CUDA C++
kernels written for Hopper, the forward K1 (`csrc/megakernel.cu`), its
adjoint K2 (`csrc/megakernel_bwd.cu`), the ReSTIR pass K6 as two
kernels, the G-buffer kernel K4 (`csrc/gbuffer.cu`, sharing K1's bounce
loop in `csrc/path.cuh`) and the reservoir-vertex kernel K6v
(`csrc/restir_vertex.cu`, which also runs the real-time split pass's
reservoir phases), its adjoint K7 (`csrc/restir_bwd.cu`), and the ray-cast
kernel K5 (`csrc/cast.cu`), built with `nvcc` on first use and bound with
`ctypes`.

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
  ops/         — vecmath, intersect, sdf, sampling, bsdf, lighting, sky,
                 textures, noise, spectral, tonemap, restir (the reservoir pipeline),
                 megakernel (the autograd pairing of the CUDA forward
                 kernel K1 and its adjoint K2), restir_kernel (the K6
                 pass and K7), restir_vertex (K6v), restir_split (K4, K5,
                 K4 then K6v, and the real-time pass)
  render/      — integrator (plain bounce loop), renderer, state
  optimize.py  — inverse rendering: fit scene parameters with Adam
  csrc/        — CUDA C++ sources of the kernels

The forward pass (K1) covers analytic primitives and SDF meshes of all 14
shapes with every surface material (DIFF, SPEC, REFR_FRESNEL,
REFR_SCHLICK, COAT), textures of all ten types on analytic and SDF
meshes, sphere, directional and SDF-bound lights with optional MIS,
cosine or uniform sampling, a cubemap or the procedural sky, and
hero-wavelength spectral transport (Cauchy dispersion of negative-IOR
glass) and the homogeneous medium (free paths, in-scatter NEE from sphere
lights, Henyey-Greenstein scattering, fogged shadow rays) in its medium
copy.  ReSTIR (K4 and K6v) covers sphere lights over every SDF shape and
textures blended into any row, without a cubemap on the card, under
STATIC or ANIMATED (real-time) accumulation, with the pixel's own history
or the ad-hoc reprojection, and without spectral transport or the medium
on any route.  Gradients cover all of it on the CPU (plain autograd).  On
CUDA, K2 differentiates K1's whole class, spectral transport and the
medium in its medium copy, and K7 the ReSTIR
pass without the ad-hoc reprojection over its whole class
(`restir_kernel.outside_k7_class`: every SDF shape, textures blended into
any row, but no BOX row in a scene K4 and K6v march without the whole SDF
class; at most 32 candidates), each with respect to the scene table
(aux and the texture columns included) and the rays, K7 also to the
ring's float fields.  Neither differentiates a texel array (the images,
the noise LUT, the cubemap), and the split path has no adjoint.  What is
outside these classes raises NotImplementedError naming the ROADMAP item
that adds it.
"""

from raytracer0_tpu_torch.config import (  # noqa: F401
    ANIMATED_CONFIG, OFFLINE_CONFIG, RenderConfig, RenderMode, TonemapOp,
)

__version__ = "0.1.0"
__all__ = ["RenderConfig", "RenderMode", "TonemapOp", "OFFLINE_CONFIG",
           "ANIMATED_CONFIG", "__version__"]
