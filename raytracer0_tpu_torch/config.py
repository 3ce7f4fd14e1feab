"""Static render configuration (the port's copy of raytracer0_tpu/config.py).

The reference drives all feature selection through compile-time GLSL text
splicing: 7 `#define USE_*` toggles plus 13 `const` declarations
(reference: index.js:11-52, tools.js:22-61).  Here it is a frozen
(hashable) dataclass: the integrator, the kernel wrappers and the renderer
read its fields by name, so a config of the JAX package with the same
fields works too.  Names, fields and defaults equal the JAX package's
(tests/test_torch_grad.py holds them equal); the fields that only steer
the JAX package's execution (`remat_bounces`, `scan_unroll`,
`use_megakernel`, `megakernel_unroll_below`) are kept for that reason and
read by nothing here.
"""

from __future__ import annotations

import dataclasses
import enum


class TonemapOp(enum.IntEnum):
    """Display operator.

    The reference ships exposure-scale + gamma (tonemapper.glsl:30-32),
    defines an unused ACESFilm curve (tonemapper.glsl:17-26), and its README
    names Reinhard; all three are selectable here.
    """

    GAMMA = 0
    REINHARD = 1
    ACES = 2


class RenderMode(enum.IntEnum):
    """Accumulation mode (reference constant RENDER_MODE, index.js:34, 52)."""

    STATIC = 0   # progressive sum accumulation (raytracer.glsl:2168)
    ANIMATED = 1  # temporal EMA over `temporal_frames` (raytracer.glsl:2159-2165)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All compile-time feature flags and work budgets.

    Defaults mirror the reference's offline `constants` set
    (index.js:21-35) and default `defines` (index.js:11-19).
    """

    # ---- bounce budgets (index.js:21-26) ----
    max_bounces: int = 12
    max_diff_bounces: int = 4
    max_spec_bounces: int = 4
    max_trans_bounces: int = 12
    max_scattering_events: int = 12

    # ---- SDF sphere tracing (index.js:27-28, raytracer.glsl:974-993) ----
    marching_steps: int = 128
    fudge_factor: float = 0.9

    # ---- light sampling strategy (index.js:29-32) ----
    sample_lights: bool = True
    use_mis: bool = False
    use_restir: bool = False
    light_path_length: int = 2
    restir_samples: int = 16
    # Temporal-reuse reprojection.  The reference offsets the history
    # lookup by an ad-hoc camera-relative "motion vector" plus jitter
    # (raytracer.glsl:1486-1496 — its own comment admits the camera term
    # is a placeholder; the camera is static during accumulation, every
    # move clears the buffers, index.html:475-482).  Default False reads
    # the pixel's own history (exact for a static camera); True
    # reproduces the reference's ad-hoc offset.
    restir_adhoc_motion: bool = False

    # ---- accumulation mode (index.js:34) ----
    render_mode: RenderMode = RenderMode.STATIC
    temporal_frames: int = 5  # EMA window for ANIMATED mode (index.js:236)

    # ---- feature defines (index.js:11-19) ----
    use_cubemap: bool = False
    use_procedural_sky: bool = True
    use_biased_sampling: bool = True   # cosine-weighted hemisphere vs uniform
    use_spectral: bool = False
    use_volumetrics: bool = False

    # ---- participating media (raytracer.glsl:61-65) ----
    vol_sigma_t: float = 0.15
    vol_sigma_s: float = 0.13
    vol_g: float = 0.5

    # ---- display (tonemapper.glsl) ----
    tonemap: TonemapOp = TonemapOp.GAMMA
    gamma: float = 2.2

    # ---- numerics (raytracer.glsl:47-48) ----
    epsilon: float = 1e-3
    infinity: float = 1e4

    # ---- wavefront execution ----
    # Samples traced per pixel per render pass (the reference always traces
    # 1 spp per frame, index.js:230); >1 batches the sample axis on device.
    samples_per_pass: int = 1
    # Execution knobs of the JAX package (remat of the bounce scan, scan
    # unroll, megakernel dispatch and unroll bound), kept so the two
    # configs have the same fields; the port reads none of them.
    remat_bounces: bool = True
    scan_unroll: int = 1
    use_megakernel: bool = True
    megakernel_unroll_below: int = 7

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if self.max_bounces < 1:
            raise ValueError("max_bounces must be >= 1")
        if self.marching_steps < 1:
            raise ValueError("marching_steps must be >= 1")
        if self.use_cubemap and self.use_procedural_sky:
            # mutual exclusion enforced by the reference UI (index.html:547-563)
            raise ValueError("use_cubemap and use_procedural_sky are mutually exclusive")


# The reference's two built-in budget sets.

#: Offline/batch quality budget (reference `constants`, index.js:21-35).
OFFLINE_CONFIG = RenderConfig()

#: Real-time budget for animated scenes (reference `animatedConstants`,
#: index.js:38-52): 6 bounces, 2/2/4/4 caps, 64 march steps, ReSTIR on, EMA.
ANIMATED_CONFIG = RenderConfig(
    max_bounces=6,
    max_diff_bounces=2,
    max_spec_bounces=2,
    max_trans_bounces=4,
    max_scattering_events=4,
    marching_steps=64,
    use_restir=True,
    light_path_length=1,
    restir_samples=8,
    render_mode=RenderMode.ANIMATED,
)
