#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases (each prints readable lines, and a line with the seconds since the
script started at its start and at the steps of the long ones; any failure
raises and exits non-zero):

1. requires a CUDA device; prints `nvidia-smi`'s name and power limit;
2. builds the forward megakernel K1, its adjoint K2, the reservoir-vertex
   kernel K6v and the ReSTIR adjoint K7, the G-buffer kernel K4 and the
   ray-cast kernel K5 from `raytracer0_tpu_torch/csrc/` with nvcc, all at
   once (K2 in three libraries, its whole-SDF copy and its medium copy each
   a library of its own; K7 in two), or loads them from `build/kernels/`,
   and prints the build times
   and ptxas' register, stack and spill lines; prints each kernel's blocks
   and warps per SM from `cudaOccupancyMaxActiveBlocksPerMultiprocessor`
   with the shared memory, registers and local memory they were computed
   for (its main path's scene; K1's whole-SDF copy on `mandelbulb`; K6v in
   both forms; K2's copies on each
   scene class, `k2_cases`: its Cornell copy on Cornell and the 47-mesh
   scene of `presets.many_lights`, its wide copy on config 2, `mis_demo`,
   `textured_cornell`, `cubemap_demo` and the 47-mesh scene under uniform
   sampling, its whole-SDF copy on `default_scene`, `mandelbulb`,
   `menger_sponge` and the scene of every shape the presets lack, its medium
   copy on `spectral_caustics`, with its
   layout, columns and spills, and fails if a column per thread leaves it
   fewer than 3 blocks per SM); prints K2's ptxas line per copy (by the
   template instance of its kernel) and fails unless its Cornell and wide
   copies keep their registers and local memory (128 and 928 B on
   Cornell; 128 and 2,160 B, per warp 64 and 2,464 B on the wide copy);
   prints K7's ptxas line per copy and checks that its ROUND_BOX copy,
   which shares K6v's vertex code, keeps its 168 registers and 1,328-byte
   stack (neither the vertex's split form nor K7's whole-SDF copy, a
   template instance beside it, may move its code); prints the occupancy
   of K7's whole-SDF copy on the scenes of `k7_sdf_scenes`;
   prints K4's and K6v's ptxas lines per copy and the occupancy of their
   whole-SDF copies (on `mandelbulb`, and K6v's split form on
   `animated_restir`), and fails unless their old copies keep their
   registers and local memory (K4 80 and 56 B; K6v 64 and 32 B, split 72
   and 32 B); prints K1's ptxas line per copy and fails unless its copies
   other than the medium copy keep the lines they had before it came
   (`K1_PTXAS`), and prints the medium copy's occupancy on
   `spectral_caustics`;
3. holds K1 against its plain PyTorch version (`render/integrator.trace`)
   on the card, on `cornell_default(use_mis=True)`: at 16x128 with 3
   bounces under the parity contract (>= 99 % of pixels within 1e-5,
   median < 1e-4), and at 512x512 with 12 bounces under the golden
   contract (median < 1e-4, >= 99 % of pixels within 2e-3);
4. drives the render main path, `Renderer(...).render(16)` at 512x512, and
   checks that it launched K1 16 times and K2 never, and that the image is
   finite, not black and shows the red and green walls;
5. times one `sample_radiance` pass at 512x512 with 12 bounces through K1
   and through the plain version (CUDA events, median of 7 after warm-up);
6. holds K2 against the plain version's autograd on the card,
   d(color, emission, pos, joker, ro, rd): per leaf max|a-b| / max|b| < 1e-4
   at 16x128 with 3 bounces in four configurations, < 1e-3 at 512x512 with
   12 bounces (sums over 262,144 pixels in another order); one K2 launch
   per backward; < 1e-4 on the 47-mesh scene (six planes, 41 sphere
   lights) at 64x128 with 12 bounces; and two K2 launches on the same
   inputs give the same d_table, d_ro and d_rd bits, on Cornell and the
   47-mesh scene at 512x512; then K2's wide copy at 512x512 with 12
   bounces on config 2 (glass, mirror, coat), `mis_demo` (a BOX SDF),
   `cornell_box`, `textured_gloss`, `cubemap_demo`, `textured_cornell`,
   `textured_emitter`, the sun scene and Cornell with uniform sampling:
   every scene-table leaf and the rays within 1e-4 relative of the plain
   autograd (an entry that misses it arbitrated by the plain autograd in
   float64 on the pixels whose float32 and float64 radiances agree, on at
   most 0.1 % of a leaf's entries, and every entry within 1e-3 unarbitrated,
   `arbitrated_errors`), K2 alone timed (CUDA events, profiler)
   beside its bound;
7. holds K2 against central differences of two K1 renders: d sum /
   d emission[light] and d sum / d color[red wall] within 5 % at 128x128,
   12 bounces; then K2's wide copy, d sum / d config 2's glass IOR within
   5 % of K1's central difference on the pixels where K1's radiance is
   linear in it (no discrete decision flips between the renders), and so
   `mis_demo`'s SDF box height;
8. drives the gradient main path, d sum(sample_radiance) / d(color,
   emission, pos, joker) at 512x512, 12 bounces (the step of bench.py's
   headline), checks that each step launched K1 and K2 once, times it
   through K1+K2 and through the plain version's autograd (CUDA events,
   median and quartiles of 9 after warm-up, of 3 for the plain version),
   prints rays/s, the kernels' device time from torch.profiler and each
   route's peak memory; then runs
   `optimize.fit` of the light's emission at 128x128 for 20 steps and
   checks that the loss falls and K2 ran once per step; then a 10-step
   fit of config 2's light emission through K2's wide copy, which lowers
   the loss with no call of the plain version;
9. holds the widened K1 against its plain version on the card: on
   `cubemap_demo` and the config-2 scene (REFR_SCHLICK, a mirror and COAT
   under MIS, tests/test_golden_cornell.py:66-79) at 16x128 with 3 bounces
   (parity contract) and at 512x512 with 12 bounces (golden contract); on
   the directional-sun scene of tests/test_megakernel.py:685-698 with and
   without MIS, and on `cornell_default` with uniform hemisphere sampling,
   at both sizes; checks that the cubemap shows: pixels whose primary ray
   escapes, or escapes after the mirror, equal the cubemap's texels in
   that direction, in K1 and in the plain version alike; times K1 (CUDA
   events, and device time from torch.profiler) and the plain version on
   config 2 and `cubemap_demo`, and prints their path events and K1's
   bound;
10. drives the cubemap main path, `Renderer(cubemap_demo).render(16)` at
   512x512, and checks that it launched K1 16 times and K2 never and that
   the image is finite and not black; times one `sample_radiance` pass
   through K1 and through the plain version, and prints K1's device time
   within a pass from torch.profiler;
11. asks for a gradient w.r.t. `cubemap_demo`'s cubemap texels on the card
   and checks that it raises NotImplementedError naming ROADMAP item 14
   and launches neither kernel;
12. holds K1 against its plain version on the card on the textured scenes:
   `textured_cornell`, `textured_emitter`, `textured_gloss`, `cornell_box`,
   the procedural scene of tests/test_megakernel.py:168-202 (CHECK, METAL,
   VORONOI, VALUE_NOISE, RIPPLE), a GRADIENT_NOISE floor and a CHECK
   sphere, at 16x128 with 3 bounces (parity contract) and at 512x512 with
   12 bounces (golden contract), printing the max abs error and the count
   of differing pixels; the scenes whose textures involve no libm call
   (no sin, asin or atan2) must agree bit for bit; then asks for a gradient
   w.r.t. `textured_cornell`'s images and noise LUT and checks that it
   raises NotImplementedError and launches neither kernel, and that the
   color's gradient runs through one K1 and one K2 launch;
13. drives the texture main path, `Renderer(textured_cornell).render(16)`
   at 512x512, and checks 16 K1 launches, no K2, and a finite, non-black
   image whose textured-sphere pixels vary; then `textured_gloss` (the
   texel steers the SPEC bounce) for 16 passes, one K1 launch each;
14. times K1 and the plain version on `textured_cornell` and
   `textured_gloss` at 512x512 with 12 bounces (CUDA events, and K1's
   device time from torch.profiler), and prints their path events and
   K1's bound;
15. holds K1 with the SDF march against its plain version on the card, on
   `mis_demo` and on `restir_demo`'s geometry with per-light NEE, at 16x128
   with 3 bounces (parity contract) and at 512x512 with 12 bounces and 128
   marching steps (golden contract), printing the differing pixels (0
   expected) and the max error; prints Cornell's and `mis_demo`'s K1
   device time (`k1_device_time.py`), times K1 and the plain version on
   `mis_demo` and prints its path events and K1's bound; checks that a
   gradient through a mesh type K1 does not render (`mis_demo`'s box made
   a GRID_SDF) raises before any launch, naming item 8;
16. holds the ReSTIR pass K6 (K4, then K6v's fused form) against the
   plain `restir.render_sample` on the card, on `restir_demo`,
   `restir_stress` and `restir_demo` with MIS, each threading its own
   reservoir ring: passes 0-11 at 16x128 with 3 bounces and passes 0-3 at
   512x512 with 12 bounces, one K4 and one K6v launch per pass; bit for
   bit at every pass (radiance and every reservoir field), which implies
   JAX's fused-versus-wavefront contract (tests/test_restir.py:312-352),
   also checked and printed with the differing pixels; checks that the new
   reservoirs' light data gathered from the scene
   (`restir_kernel.light_data`, the gradient path's) equals K6v's bit for
   bit;
17. drives the ReSTIR main path, `Renderer(*restir_demo()).render(16)` at
   512x512: 16 K6 passes (16 K4 and 16 K6v launches) and no K1 or K2
   launch, populated reservoirs (max M > 0, max W <= 12, the share of
   pixels holding a light), a finite image whose mean lies within 1/9..2x
   of the per-light-NEE render's (tests/test_restir.py:94-129); times a
   pass (CUDA events), a K6 pass and its two kernels alone (CUDA events
   and profiler) and the plain version's pass; prints K6's path events and
   the bounds of the pass, of K4 and of K6v; checks that a gradient K7
   does not compute (the aux leaf) through `restir_demo` raises before
   any launch;
18. holds K7 against the plain `restir.trace_sample`'s autograd on the
   card: over passes 0-3 from an empty ring at 16x128 with 3 bounces on
   `restir_demo` and `restir_stress` (d emission, color, pos, joker, ior
   and every pass's rays, per leaf max|a-b| / max|b| < 1e-4), and at
   512x512 with 12 bounces on `restir_demo` over as many passes (up to 4)
   as the plain autograd fits in the card's memory; two K7 runs give the
   same bits; prints the peak memory of each route;
19. checks K7 against K6's finite differences: d sum(render_linear) / ds
   for every light's emission scaled by s at 128x128, 12 bounces, 4 passes
   equals K6's central difference and sum(render_linear) at s = 1 (the
   radiance is linear in s, tests/test_restir.py:183-216); prints one
   light's position gradient beside K6's central difference (phase 7's
   method), a measurement that the tiny, directly seen lights make
   discontinuous;
20. drives the ReSTIR gradient main path: `optimize.fit` of the lights'
   emission on `restir_demo` at 128x128 with passes=4 for 20 steps, which
   lowers the loss through 4 K6 passes and 4 K7 launches per step and no
   K1 or K2 launch; times the fwd+bwd step of `render_linear(passes=4)` at
   512x512 with 12 bounces through K6+K7 (median and quartiles), K7 per
   launch (CUDA events and profiler) and the plain autograd step at
   128x128; prints the peak memory of each, K7's path events and bound,
   the share of it K7's device time reaches and K7's occupancy;
21. holds K5 against the plain `intersect.intersect` bit for bit at
   512x512 on `restir_demo`, `mis_demo` and the real-time scene
   (`animated_untextured`) at a frame time: the primary rays, and rays
   from the primary hits and from every G-buffer vertex toward the lights;
22. holds K4 against its plain version bit for bit (the radiance and every
   G-buffer field of every slot) at 16x128 and 512x512 on `restir_demo`
   and the real-time scene;
23. holds K6 under ANIMATED accumulation against the plain
   `restir.render_sample` at every pass of a 4-pass chain at 512x512, bit
   for bit at a constant frame time and at a moving one with the plain
   ring's light data refreshed to the frame's, and prints the share of
   pixels where the two differ at a moving time unrefreshed; holds K7
   under ANIMATED against plain autograd at 16x128 over passes 0-3
   (identical bits twice); differentiates `render_linear` under ANIMATED
   through 4 K6 and 4 K7 launches;
24. drives the real-time main path, 16 frames of
   `Renderer.step(time_s=k/30)` on the real-time scene at 512x512 with
   the ad-hoc reprojection: 16 K4 and 16 K6v launches (split form), no K5
   and no other kernel of the port; holds the last frame bit for bit
   against the same frame through `render_sample_split` with the plain
   G-buffer and caster on the card and against the plain `render_sample`
   under JAX's fast-versus-wavefront contract
   (tests/test_restir.py:284-310); times the frame (median and quartiles
   of 9 after warm-up), K4 and K6v per launch (CUDA events and profiler)
   and ray generation, counts the device launches of a frame (profiler),
   and prints K4's and K6v's events and bounds; times K5 on the shadow
   rays the plain split pass casts (its bound beside it); times the
   ANIMATED frame through K6 (no ad-hoc motion) and through K1 (ReSTIR
   off, held bit for bit against the plain version);
25. checks that a gradient through the split path and `restir_demo` on
   the split path with a cubemap (item 11) raise NotImplementedError
   before any launch; that K6 and K7 admit the scenes of `k7_sdf_scenes`
   (`animated_restir` as shipped, STATIC too, the `mandelbulb`,
   `every_shape` and `polygons` ReSTIR views, `textured_restir_demo` and
   `textured_cornell` with ReSTIR), K7 in its whole-SDF copy, and that a
   ReSTIR gradient w.r.t. the noise LUT of each raises before any launch
   naming item 14, and one on `restir_demo` with its rounded box a BOX
   (a BOX row outside the whole SDF class) naming item 8; and that K2 admits a Mandelbulb, a textured BOX SDF
   (`default_scene`) and an SDF light, K5 refuses them naming item 8, the
   ReSTIR gates (K4, K6, K6v, K7, ReSTIR) admit the Mandelbulb and refuse
   the other two naming item 11 (no light for ReSTIR; an SDF light slot),
   and the routes behind a refusing gate (a ReSTIR pass, the split path, a
   ReSTIR gradient, K5's cast) raise before any launch;
26. drives the whole SDF class on K1, the reference's presets
   `default_scene` (a METAL-textured BOX SDF under the cubemap),
   `mandelbulb` and `menger_sponge` (a COAT Menger sponge under the
   cubemap), each through `Renderer(...).render(2)` at 512x512 with 12
   bounces and 128 marching steps: K1 launched twice, K2 and the plain
   version never, a finite image that is not black; holds K1's image bit
   for bit against the plain version on the card (the count of differing
   pixels printed); times a `sample_radiance` pass (CUDA events) and K1's
   device time (`k1_device_time.py`), prints the path events (march
   steps, the march's lane use) and K1's bound with the float operations
   of each distance;
27. differentiates the whole SDF class on K2 (its whole-SDF copy, a
   library of its own): holds its adjoint of each of the 14 distances in
   the scene that holds the shape (the scene of every shape the presets
   lack, presets 0, 2 and 3) at 64x64, 2 bounces, 64 marching steps, on
   the cotangents of that shape's rows and of the rays whose first hit is
   one of them; holds its gradient w.r.t. every scene-table leaf (aux
   among them) and the rays on the scene of every shape, the SDF light
   with and without MIS and the textured SDF scene at 64x64, and on the
   presets 0, 2 and 3 at 128x128, 4 bounces and 64 marching steps, one K1
   and one K2 launch each and K1's radiance the plain version's bit for
   bit; each against the plain autograd, arbitrated as phase 6 does
   (`arbitrated_errors`: `menger_sponge` on the pixels where float32 and
   float64 take the same decisions, `default_scene`'s pos, joker and rays
   held against the float64 plain autograd, whose misses are printed);
   holds d sum / d the SDF light's pos.y and joker scale and the textured
   SDF sphere's pos.y against K1's central differences on the pixels
   linear in them (and prints those of `menger_sponge`'s joker scale and
   `default_scene`'s upper box pos.y, which a central difference cannot
   hold: PERF.md §7); runs 10-step `optimize.fit`s at 64x64 of
   `mandelbulb`'s emission and color, `menger_sponge`'s color and joker
   and the SDF light's position, each lowering its loss through 10 K1 and
   10 K2 launches and no call of the plain version; times K2 on the three
   presets at 512x512, 12 bounces, 128 marching steps (CUDA events;
   device time from `k1_device_time.py`) beside its bound (the winning
   distance's reverse counted at each SDF hit, from phase 26's path events
   of the same rays), the plain forward and backward of its hold above
   (128x128, 4 bounces), its registers, local memory, blocks per SM and
   ptxas line;
28. ReSTIR over the whole SDF class and blended textures
   (`restir_sdf_phase`): holds K4 against `gbuffer_plain` and the K6 pass
   (K4, then K6v's fused form, each in its whole-SDF copy where
   `megakernel.whole_sdf` says so) against the plain `restir.render_sample`
   bit for bit at every pass of a 3-pass ring, on `animated_restir` as
   shipped (MAT_METAL on its ROUND_BOX, at a constant frame time) and
   `textured_cornell` with ReSTIR and MIS off at 128x128, of a 2-pass ring
   on the `polygons` ReSTIR view at 128x128, and at 64x64 over 1 pass on
   the `mandelbulb` view (its K4 held through the K6 pass alone) and the
   `every_shape` view, each scene at its own depth, one K4 and one K6v
   launch per pass; holds the split path (`render_sample_fast`) against
   `render_sample_split` with the plain G-buffer and caster bit for bit
   over 5 ANIMATED frames of `animated_restir` as shipped at t = (k+1)/30;
   drives the real-time main path of `animated_restir` as shipped
   (16 frames of `Renderer.step`, ad-hoc motion, 512x512: 16 K4 and 16
   K6v launches, no other) and phase 24's `animated_untextured` beside
   it, timing each (median and quartiles of 9), their device launches per
   frame and K4's and K6v's device time (profiler), and the preset as
   shipped through the K6 pass; drives `Renderer.render(2)` of the
   `mandelbulb` ReSTIR view at 512x512 (2 K4, 2 K6v, no other launch) and
   times a K6 pass, K4 and K6v alone (CUDA events, profiler) beside
   `bound` and `vertex_bound`, with the march's lane use;
29. ReSTIR gradients over the whole SDF class and blended textures
   (`restir_grad_sdf_phase`): prints the occupancy of K7's whole-SDF copy
   on each scene of `k7_sdf_scenes`; holds it against the plain autograd
   on each at its own depth (the preset's 6 bounces, the `mandelbulb`
   view's 12 bounces and 128 marching steps), over passes 0-3 of the
   preset as shipped, 0-1 of its STATIC twin, the `polygons` view and
   `textured_cornell`, and pass 0 alone on the `mandelbulb` and
   `every_shape` views and `textured_restir_demo`, whose plain passes take
   4-35 s each, from an empty ring at 32x32:
   every scene-table leaf and ray within 1e-4 of the leaf, the same bits on two launches, one K6 and one launch of
   the copy per pass; runs a ReSTIR fwd+bwd step (`render_linear`, 2
   passes, d(emission, color)) at 512x512 of `animated_restir` as shipped
   and of the `mandelbulb` view (12 bounces, 128 marching steps), its
   launches counted from 0, timed (median and quartiles of 5), with K7's
   whole-SDF copy alone per launch (CUDA events, profiler) beside `bound`
   (`sdf_adjoint`; the `mandelbulb` view's path events are phase 28's of
   the same pass); runs a 6-step `optimize.fit` of the preset at
   128x128 (the lights' emission and the METAL box's color) through K6 and
   K7's whole-SDF copy alone, lowering its loss;
30. hero-wavelength spectral transport and the homogeneous medium on K1's
   medium copy (`medium_phase`): holds it against the plain version bit
   for bit at 64x64 at each scene's own depth on the reference's preset 8
   (`spectral_caustics`) as shipped, with spectral transport alone and
   with the medium alone, and with both on `mis_demo` (an SDF box under
   MIS) and `cubemap_demo` (`MEDIUM_HOLDS`), one launch each; drives
   `Renderer(*spectral_caustics()).render(2)` at 512x512 with 12 bounces
   (2 K1 launches, no other kernel, no call of the plain version, a finite
   image that is not black); times a `sample_radiance` pass (median and
   quartiles of 7) and K1 through `trace_forward` (CUDA events), K1's device
   time in a fresh process (`k1_device_time.k1_device_ms`) and the plain
   version (median of 3), and prints the path events (free paths, scatter
   events, in-scatter shadow rays, fogged shadow rays, dispersive hits) and
   `bound` beside the copy's occupancy; checks that a gradient w.r.t. the
   preset's noise LUT (K2, item 14) and a ReSTIR pass, the split path with
   the medium or spectral transport (item 10) raise NotImplementedError
   naming their ROADMAP item before any launch;
31. the adjoint of spectral transport and the medium on K2's medium copy
   (`medium_grad_phase`, `csrc/megakernel_bwd_medium.cu`): holds it against
   the plain autograd at 64x64, each scene of `MEDIUM_HOLDS` at its own
   depth (preset 8: 12 bounces, where the flint's IOR carries a gradient),
   every scene-table leaf and the rays within 1e-4 of the leaf arbitrated
   as phase 6 does, one K1 and one launch of the copy each, K1's radiance
   the plain version's bit for bit, the same bits on two launches; drives
   the main path, a 10-step `optimize.fit` of preset 8's two lights'
   emission at 64x64 (10 K1 and 10 K2 launches of the medium copies, no
   call of the plain version, the loss falls); times a fwd+bwd step
   d sum(`sample_radiance`) / d(color, emission, pos, joker, ior) at
   512x512, 12 bounces (median and quartiles of 5, one K1 and one K2
   launch), the kernels' device time per step (profiler), K2's medium copy
   alone (CUDA events; device time from `k1_device_time.py`, key
   `k2_spectral_caustics`) beside `bound` (the forward once and its
   adjoint, from phase 30's path events) and its occupancy; checks that a
   ReSTIR gradient with the medium is refused before any launch (item 10).

The line before the last is a JSON object describing the kernels; the last
line is `{"ok": true, "device": {...}}`.  Without a CUDA device, or outside
the repository, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import statistics
import subprocess
import sys
import time

_START = time.perf_counter()


def stamp(what):
    """Print the seconds since the script started beside `what`: each
    phase's start and the steps of the long ones."""
    print(f"chip_smoke: at {time.perf_counter() - _START:.1f} s: {what}", flush=True)

PARITY_TOL, PARITY_FRAC = 1e-5, 0.99     # tests/test_megakernel.py:94
GOLDEN_TOL, GOLDEN_FRAC = 2e-3, 0.99     # tests/test_golden_cornell.py:26
MEDIAN_TOL = 1e-4                        # tests/test_golden_cornell.py:35
GRAD_TOL = 1e-4                          # tests/test_megakernel.py:128-129
GRAD_TOL_FULL = 1e-3                     # 512x512: sums in another order
ILL_CONDITIONED_LEFT_OUT = 0.15          # tests/test_torch_kernel_host.py
F64_LEAF_TOL = 5e-2                      # tests/test_torch_kernel_host.py
FD_TOL = 0.05                            # tests/test_golden_cornell.py:112
H = W = 512
PASSES = 16
GRAD_STEPS = 3
LEAVES = ("color", "emission", "pos", "joker")
RESTIR_LEAVES = ("emission", "color", "pos", "joker", "ior")
ADJ_CONFIGS = [                          # tests/test_torch_cuda.py
    (16, 128, dict(max_bounces=3)),
    (13, 77, dict(max_bounces=5)),
    (16, 128, dict(max_bounces=4, use_mis=False)),
    (16, 128, dict(max_bounces=4, sample_lights=False)),
]

# ptxas' line of each of K1's copies as it was before the medium copy came
# (PERF.md §6), which phase 2 holds
_K1_LINE = ("{0} bytes stack frame, {1} bytes spill stores, {2} bytes spill loads; Used 64 "
            "registers, used 1 barriers, {0} bytes cumulative stack size")
K1_PTXAS = {"analytic": _K1_LINE.format(88, 148, 188), "SDF": _K1_LINE.format(152, 346, 696),
            "textured light": _K1_LINE.format(128, 294, 500),
            "SDF, textured light": _K1_LINE.format(184, 446, 976),
            "whole-SDF": _K1_LINE.format(256, 566, 1428),
            "whole-SDF, textured light": _K1_LINE.format(256, 562, 1436)}

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and float32 outside
# the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# Float operations per event of K1, counted from csrc/megakernel.cu and
# trace_common.cuh: each add, sub, mul, compare, min, max, abs, floor, sqrt,
# division, sin and cos counts one (so the count, and the bound, are lower
# bounds); the integer RNG hashing and the texel index arithmetic are not
# counted.
OPS_MESH = {0: 26, 1: 22, 2: 44}  # one ray against one sphere, plane, box
OPS_HIT = 29        # x = o + d t, normal, the two clamps, `inside`
OPS_DIFFUSE = 76    # draws, nl, cosine sample about nl, mask, o', cutoff
OPS_REFLECT = 29    # non-DIFF hits: e * rand_dir, reflect, normalize
OPS_REFRACT = 42    # REFR hits: IOR ratio, refract, roughened normalize
OPS_SCHLICK = 17    # REFR_SCHLICK and COAT hits: the Schlick reflectance
OPS_FRESNEL = 36    # REFR_FRESNEL hits: the full Fresnel reflectance
OPS_GATHER = 67     # gather ray on a diffuse vertex: draws, direction, origin
OPS_FETCH = 67      # cubemap fetch: face select, bilinear weights and lerp, acc
OPS_NEE = 108       # per sphere light: cone toward the light, shadow-ray setup, contribution
OPS_NEE_MIS = 43    # per sphere light under MIS: energy gate, both pdfs, heuristic
OPS_NEE_DIR = 32    # per directional light without MIS: direction, origin, contribution
OPS_NEE_SDF = 52    # per SDF light: the sphere point, direction, origin, contribution
OPS_NEE_SDF_MIS = 37  # per SDF light under MIS: energy gate, the BSDF pdf, heuristic
# K1's medium copy (csrc/path.cuh, trace_common.cuh::medium_nee): the free
# path of each ray (max, log, negation, division, min, compare); a scatter
# event (its point, the throughput, the cutoff tests, acc += mask * in-scatter)
# with its HG direction (the sample, an orthonormal basis, sin and cos, the
# normalized sum); per LIGHT sphere at a scatter event the in-scatter shadow
# ray's setup (distance, cone, direction, origin) and weight (HG phase, fog,
# solid angle; its mesh scan counted apart); Beer-Lambert fog on a sphere
# light's NEE shadow ray; the hero wavelength and Cauchy's IOR at a hit on a
# dispersive (negative-IOR) mesh
OPS_FREEPATH = 6
OPS_SCATTER = 87
OPS_VOL_NEE = 115
OPS_FOG = 3
OPS_CAUCHY = 10
OPS_LIGHT = 12      # emissive hit: acc += mask c e w
OPS_LIGHT_MIS = 48  # its BSDF-side MIS weight
OPS_MISS = 28       # procedural sky and acc
OPS_BLEND = 24      # textured hit: c and e mixed toward texel * mask by alpha
# UV of a sphere (asin, atan2), a plane, a box, an SDF row (its row's box
# normal, then the planar UV)
OPS_UV = {0: 14, 1: 9, 2: 9, 3: 29}
# one texel by TexType code: bilinear image, CHECK, RIPPLE, VORONOI (27
# cells), GRADIENT_NOISE (8 hashed corners, 3 sin each), VALUE_NOISE (two
# bilinear LUT channels), METAL (3 octaves of value noise)
OPS_TEXEL = {0: 50, 1: 50, 2: 50, 3: 50, 4: 737, 5: 399, 6: 51, 7: 9, 8: 13, 9: 170}
TEX_UV = (0, 1, 2, 3, 7, 8)   # the image and pattern types read a UV
TEX_LUT = (4, 6, 9)           # Voronoi, value noise and metal read the LUT
# SDF march, per SDF entry and per ray: one distance evaluation, the
# bounding-sphere gate; per step besides the evaluation; per marched ray the
# first and the final evaluation's point; the 4-tap normal of an SDF hit
OPS_SDF_EVAL = 20
# one distance by SdfShape code, counted from trace_common.cuh::sdf_entry_all
# (q = p - pos included): BOX, ROUND_BOX, SPHERE, TRI_PRISM, CONE, MENGER (4
# iterations), MANDELBULB (3 iterations, log and sqrt), ELLIPSOID, CAPSULE,
# SNOWBALL (one value-noise fetch), SEA_BOX (two displacements, 6 sin/cos),
# SIGGRAPH, TRIANGLE, QUAD
OPS_SDF_SHAPE = {0: OPS_SDF_EVAL, 1: OPS_SDF_EVAL, 2: 11, 3: 14, 4: 24, 5: 164, 6: 260, 7: 17,
                 8: 34, 9: 67, 10: 58, 11: 42, 12: 171, 13: 219}
OPS_SDF_GATE = 33
OPS_MARCH_STEP = 11
OPS_MARCH_RAY = 12
OPS_SDF_NORMAL = 139
# K6's reservoir vertex (csrc/restir.cu): the material's BRDF weight, one
# candidate (draws, slot, target function, update), one temporal and one
# spatial combine (validity, target function, merge; the tap's gates),
# visibility (direction, origin; its shadow ray counted apart), finalize,
# and the shading of the selected light (its shadow ray counted apart)
OPS_RESTIR_BRDF = 19
OPS_CANDIDATE = 50
OPS_TEMPORAL = 87
OPS_SPATIAL = 97
OPS_VISIBILITY = 19
OPS_FINALIZE = 64
OPS_SHADE = 120
# extra operations of a BSDF sample by material code, on top of OPS_DIFFUSE
OPS_BSDF = {2: 0, 3: OPS_REFLECT, 4: OPS_REFLECT + OPS_REFRACT + OPS_FRESNEL,
            5: OPS_REFLECT + OPS_REFRACT + OPS_SCHLICK, 6: OPS_REFLECT + OPS_SCHLICK}



def compare(name, out, ref, tol, frac, phase=3):
    """Max-over-RGB abs error per pixel; raise unless the contract holds."""
    err = (out - ref).abs().amax(dim=-1)
    mx, med = err.max().item(), err.median().item()
    share_ok = (err < tol).float().mean().item()
    print(f"phase {phase}: {name}: max abs err {mx:.3e}, median {med:.3e}, "
          f"share of pixels beyond {tol:g}: {1.0 - share_ok:.5f}")
    if not (med < MEDIAN_TOL and share_ok >= frac):
        raise AssertionError(f"{name}: K1 disagrees with the plain version "
                             f"(median {med:.3e}, share within {share_ok:.5f})")
    return mx


def time_stats(torch, fn, runs=7, warmup=2):
    """(median, q1, q3) milliseconds of `fn()` over `runs` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    q1, med, q3 = statistics.quantiles(times, n=4)
    return statistics.median(times), q1, q3


def time_ms(torch, fn, runs=7, warmup=2):
    """Median milliseconds of `fn()` over `runs` calls, CUDA events."""
    return time_stats(torch, fn, runs, warmup)[0]


def grads(torch, trace, scene, cfg, ro, rd, pix, pass_idx=2):
    """d sum(trace(...)) / d(scene leaves, ro, rd), as a dict."""
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in LEAVES}
    o = ro.detach().clone().requires_grad_(True)
    d = rd.detach().clone().requires_grad_(True)
    out = trace(scene.replace(**leaves), cfg, o, d, pix, pass_idx, 0)
    got = torch.autograd.grad(out.sum(), list(leaves.values()) + [o, d])
    return dict(zip(LEAVES + ("ro", "rd"), got))


def grad_errors(got, want):
    """Per leaf (max|a - b| / max|b|, max|a - b|)."""
    errs = {}
    for k, b in want.items():
        a = got[k]
        if not bool(a.isfinite().all()):
            raise AssertionError(f"the kernel's gradient of {k} is not finite")
        diff = (a - b).abs().max().item()
        errs[k] = (diff / max(b.abs().max().item(), 1e-12), diff)
    return errs


TABLE_LEAVES = LEAVES + ("ior", "aux", "tex_params", "tex_cmask", "tex_emask")


def table_grads(torch, trace, scene, cfg, ro, rd, pix, pass_idx=2, dtype=None, mask=None):
    """(radiance, d sum(trace(...) * w) / d(every scene-table leaf, ro, rd))
    for seeded weights w kept on the (H, W) `mask`, the gradients as a dict
    (zeros for a leaf the trace does not read); with `dtype`, the scene's
    float tensors, the rays and w in it."""
    dtype = dtype or torch.float32
    assets = {k: getattr(scene, k).to(dtype) for k in ("images", "noise", "cubemap")}
    leaves = {k: getattr(scene, k).detach().to(dtype).requires_grad_(True) for k in TABLE_LEAVES}
    o, d = (v.detach().to(dtype).requires_grad_(True) for v in (ro, rd))
    out = trace(scene.replace(**leaves, **assets), cfg, o, d, pix, pass_idx, 0)
    w = torch.rand(out.shape, generator=torch.Generator(out.device).manual_seed(5),
                   device=out.device).to(dtype) + 0.5
    if mask is not None:
        w = w * mask[..., None]
    vals = [*leaves.values(), o, d]
    got = torch.autograd.grad((out * w).sum(), vals, allow_unused=True)
    return out.detach(), {k: torch.zeros_like(v) if g is None else g
                          for k, v, g in zip((*TABLE_LEAVES, "ro", "rd"), vals, got)}


def cached_grads(torch, sc, c, r, d, p, timed=None):
    """grads_of(kind, mask) of K2 ("kernel", through `trace_forward`) and
    the plain autograd ("plain", "plain64") on (sc, c) and pass 0's rays,
    for arbitrated_errors, each kind and mask computed once; the
    milliseconds of the unmasked plain autograd (forward and backward, CUDA
    events) go into timed["plain"]."""
    from raytracer0_tpu_torch.ops import megakernel
    from raytracer0_tpu_torch.render import integrator

    cache = {}

    def grads_of(kind, mask):
        key = (kind, None if mask is None else mask.cpu().numpy().tobytes())
        if key not in cache:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            cache[key] = table_grads(
                torch, megakernel.trace_forward if kind == "kernel" else integrator.trace,
                sc, c, r, d, p, 0, torch.float64 if kind == "plain64" else None, mask)
            e1.record()
            torch.cuda.synchronize()
            if timed is not None and kind == "plain" and mask is None:
                timed["plain"] = e0.elapsed_time(e1)
        return cache[key]

    return grads_of


def agreeing_pixels(grads_of):
    """(H, W) bool: the pixels where the float32 and float64 plain radiances
    agree within 1e-3 (tests/test_torch_kernel_host.py::_agreeing_pixels)."""
    out32, out64 = grads_of("plain", None)[0], grads_of("plain64", None)[0]
    return (out32.double() - out64).abs().amax(-1) <= 1e-3 * out64.abs().amax(-1) + 1e-7


def arbitrated_errors(got, want, grads_of, ill_conditioned=False, f64_leaves=()):
    """({leaf: (max|a - b| / max|b|, the same after arbitration)}, pixels
    left out, entries arbitrated, {leaf of `f64_leaves`: (the float32 plain
    autograd's miss, K2's miss) of the float64 one}) of K2's gradient `got`
    against the plain float32 one `want`, under tests/
    test_torch_kernel_host.py::assert_grads_close_f64.  Every entry stays
    within GRAD_TOL_FULL of its leaf.  Where one misses GRAD_TOL, all three
    gradients are taken again (`grads_of(kind, mask)` -> (radiance,
    gradients), kind "kernel", "plain" or "plain64") with the weights kept
    on the pixels where the float32 and float64 plain radiances agree
    within 1e-3 (`agreeing_pixels`; at the others float64 may take another
    discrete decision), at most 0.1 % of them (or 4) left out; there an
    entry that misses counts only what K2 misses the float64 value by
    beyond the float32 plain version's own miss (a float32 cancellation at
    a grazing hit or a high-frequency texel, where either float32 program
    may be the nearer), on at most 0.1 % of a leaf's entries (or a mesh's
    3).  `ill_conditioned` (`menger_sponge`): every gradient is taken on
    the agreeing pixels, at most ILL_CONDITIONED_LEFT_OUT of them left out.
    `f64_leaves` (`default_scene`'s pos, joker and rays): held against the
    float64 plain autograd on the agreeing pixels, K2 within F64_LEAF_TOL
    of the leaf and within GRAD_TOL_FULL or the float32 plain version's own
    miss plus GRAD_TOL (the flat faces' normal taps cancel: the plain
    version sums each tap over the batch first, K2 per pixel)."""
    errs, scales, held = {}, {}, {}
    left0 = 0
    if ill_conditioned:
        agree0 = agreeing_pixels(grads_of)
        left0 = int((~agree0).sum().item())
        if left0 > ILL_CONDITIONED_LEFT_OUT * agree0.numel():
            raise AssertionError(f"{left0} pixels' float32 and float64 radiances disagree")
        grads_all = grads_of
        grads_of = lambda kind, mask: grads_all(kind, agree0 if mask is None else mask & agree0)
        got, want = grads_of("kernel", None)[1], grads_of("plain", None)[1]
    if f64_leaves:
        agree = agreeing_pixels(grads_of)
        if int((~agree).sum().item()) > max(4, 0.001 * agree.numel()) + left0:
            raise AssertionError(f"{int((~agree).sum().item())} pixels' float32 and float64 "
                                 "radiances disagree")
        (_, a_m), (_, b_m), (_, c_m) = (grads_of(kind, agree)
                                        for kind in ("kernel", "plain", "plain64"))
        for k in f64_leaves:
            if not bool(a_m[k].isfinite().all()):
                raise AssertionError(f"the kernel's gradient of {k} is not finite")
            c = c_m[k]
            scale = max(c.abs().max().item(), 1e-12)
            e32 = (b_m[k].double() - c).abs().max().item() / scale
            e_k2 = (a_m[k].double() - c).abs().max().item() / scale
            held[k] = (e32, e_k2)
            if not (e_k2 < F64_LEAF_TOL and (e_k2 <= e32 + GRAD_TOL or e_k2 < GRAD_TOL_FULL)):
                raise AssertionError(f"K2's gradient of {k} misses the float64 plain one by "
                                     f"{e_k2:.3e}, the float32 plain by {e32:.3e}")
        want = {k: v for k, v in want.items() if k not in f64_leaves}
    for k, b in want.items():
        a = got[k]
        if not bool(a.isfinite().all()):
            raise AssertionError(f"the kernel's gradient of {k} is not finite")
        scales[k] = max(b.abs().max().item(), 1e-12)
        errs[k] = ((a - b).abs().max().item() / scales[k],) * 2
        if errs[k][0] >= GRAD_TOL_FULL:
            raise AssertionError(f"K2's gradient of {k} misses the plain one by "
                                 f"{errs[k][0]:.3e} of the leaf")
    if all(errs[k][0] < GRAD_TOL for k in want):
        return errs, left0, 0, held
    agree = agreeing_pixels(grads_of)
    left_out = int((~agree).sum().item())
    if left_out > max(4, 0.001 * agree.numel()) + left0:
        raise AssertionError(f"{left_out} pixels' float32 and float64 radiances disagree")
    (_, a_m), (_, b_m), (_, c_m) = (grads_of(kind, agree) for kind in ("kernel", "plain", "plain64"))
    arbitrated = 0
    for k in want:
        a, b, c = a_m[k], b_m[k], c_m[k]
        miss = (a - b).abs() >= GRAD_TOL * scales[k]
        n = int(miss.sum().item())
        if n > max(3, 0.001 * miss.numel()):
            raise AssertionError(f"{n} entries of {k} miss the plain gradient")
        arbitrated += n
        slack = ((a.double() - c).abs() - (b.double() - c).abs()).max().item() / scales[k]
        errs[k] = (errs[k][0], (a - b).abs().max().item() / scales[k] if n == 0
                   else max(slack, 0.0))
        if errs[k][1] >= GRAD_TOL:
            raise AssertionError(f"K2's gradient of {k} misses the float64 one by "
                                 f"{errs[k][1]:.3e} beyond the float32 plain one's miss")
    return errs, left_out, arbitrated, held


def textured_scenes(dev):
    """{name: (scene, camera, cfg)} of phase 12: the four textured presets
    and the scenes of tests/test_torch_texture_scenes.py (the procedural
    types of tests/test_megakernel.py:168-202, its GRADIENT_NOISE floor of
    :247-266 and its CHECK sphere of :795-806)."""
    from raytracer0_tpu_torch.config import OFFLINE_CONFIG
    from raytracer0_tpu_torch.models import materials as m
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.models.camera import Camera
    from raytracer0_tpu_torch.models.scene import SceneBuilder

    def tex(t, params, c=(0.4, 0.4, 0.4)):
        return m.Material(c=c, t=m.MatType.DIFF, tex=m.Texture(params=params, t=t),
                          opts=(True, False, False, False))

    procedural = SceneBuilder()
    procedural.add("MAT_CHECK_WHITE", m.MeshType.PLANE, (0.0, 1.0, 0.0), (2.0,))
    procedural.add("MAT_METAL", m.MeshType.BOX, (0.6, -1.4, -0.5), (1.2,))
    procedural.add(tex(m.TexType.VORONOI, (2.0, 2.0, 2.0, 0.0)),
                   m.MeshType.BOX, (-1.2, -1.4, 0.2), (1.0,))
    procedural.add("MAT_WHITE", m.MeshType.PLANE, (0.0, 0.0, 1.0), (2.0,))
    procedural.add(tex(m.TexType.VALUE_NOISE, (16.0, 16.0, 16.0, 0.0), c=(0.2, 0.5, 0.3)),
                   m.MeshType.PLANE, (1.0, 0.0, 0.0), (2.0,))
    procedural.add(tex(m.TexType.RIPPLE, (0.0, 0.0, 8.0, 2.0), c=(0.6, 0.6, 0.1)),
                   m.MeshType.PLANE, (-1.0, 0.0, 0.0), (2.0,))
    procedural.add("MAT_LIGHT_4", m.MeshType.SPHERE, (0.0, 1.5, 0.0), (0.4,))
    noise = SceneBuilder()
    noise.add(tex(m.TexType.GRADIENT_NOISE, (3.0, 3.0, 3.0, 0.0), c=(0.5, 0.3, 0.2)),
              m.MeshType.PLANE, (0.0, 1.0, 0.0), (2.0,))
    noise.add("MAT_LIGHT_4", m.MeshType.SPHERE, (0.0, 1.5, 0.0), (0.4,))
    check = SceneBuilder()
    check.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, 1.0, 0.0), (1.5,))
    check.add("MAT_CORNELL_WHITE", m.MeshType.PLANE, (0.0, 0.0, 1.0), (2.5,))
    check.add("MAT_LIGHT_4", m.MeshType.SPHERE, (0.0, 1.4, -1.2), (0.3,))
    check.add(m.Material(c=(0.8, 0.6, 0.4), t=m.MatType.DIFF,
                         tex=m.Texture(t=m.TexType.CHECK, params=(8.0, 8.0, 2.0, 2.0)),
                         opts=(True, False, False, False)),
              m.MeshType.SPHERE, (0.0, -0.6, -1.2), (0.6,))
    sky = OFFLINE_CONFIG.replace(use_procedural_sky=True)
    cases = {name: getattr(presets, name)(device=dev) for name in
             ("textured_cornell", "textured_emitter", "textured_gloss", "cornell_box")}
    cases["procedural"] = (procedural.build(device=dev), Camera.make(
        origin=(0.0, 0.0, 1.9), lookat=(0.0, -0.4, -1.0), fov=60.0, device=dev), sky)
    cases["gradient_noise"] = (noise.build(device=dev), Camera.make(
        origin=(0.0, 0.5, 1.9), lookat=(0.0, -0.5, -1.0), fov=60.0, device=dev), sky)
    cases["check_sphere"] = (check.build(device=dev), Camera.make(
        origin=(0.0, -0.5, 0.0), lookat=(0.0, -0.6, -1.2), fov=8.0, device=dev), OFFLINE_CONFIG)
    return cases


def warp_lane_use(torch, counts):
    """Lane use of a loop whose lanes run `counts` iterations each, 32
    pixels a warp in image order, one pixel per thread: lane-iterations /
    (32 x the sum of each warp's longest)."""
    c = counts.flatten().to(torch.int64)
    c = torch.cat([c, c.new_zeros((-c.numel()) % 32)]).view(-1, 32)
    longest = int(c.amax(1).sum())
    return int(c.sum()) / (32 * longest) if longest else 1.0


def regenerated_lane_use(counts, warps, refill_min=16):
    """Lane use of the same loop under path regeneration (K4's schedule),
    simulated: `warps` resident warps of 32 lanes; at every tick the idle
    lanes of each warp with at least `refill_min` of them (or no live one;
    `gbuffer.cu`'s REFILL_MIN) take the next pixels of a launch-wide
    counter (warps in order), then every warp with a live lane issues one
    iteration and each live lane runs it.  Returns (lane use, ticks,
    warp-iterations issued)."""
    import numpy as np

    c = counts.flatten().cpu().numpy().astype(np.int64)
    rem = np.zeros(warps * 32, np.int64)
    nxt = issued = busy = ticks = 0
    while True:
        if nxt < c.size:
            idle = (rem == 0).reshape(warps, 32)
            ready = (idle.sum(1) >= refill_min) | idle.all(1)
            free = np.flatnonzero((idle & ready[:, None]).ravel())[: c.size - nxt]
            rem[free] = c[nxt: nxt + free.size]
            nxt += free.size
        live = (rem > 0).reshape(warps, 32)
        if not live.any():
            return busy / (32 * max(issued, 1)), ticks, issued
        issued += int(live.any(1).sum())
        busy += int(live.sum())
        ticks += 1
        rem -= live.ravel()


def path_events(torch, scene, cfg, ro, rd, pix, pass_idx, sample_idx, ring=None,
                gbuffer=False, resident_warps=None):
    """Events of every pixel's path, counted over the image: rays by mesh
    scan, BSDF samples by material and by outcome (diffuse, specular,
    transmitted), shadow rays to sphere, SDF and directional lights, gather
    rays, cubemap fetches, emissive hits (and those with a MIS weight),
    procedural-sky misses, texels by texture type and UVs by mesh type
    (at hits on meshes that blend a texture), and in scenes with SDF meshes
    the rays that test the SDF bounds (`gated`), the marched rays and
    their steps, and the SDF hits.  With `ring` (the RenderState of a
    ReSTIR pass, as K6 runs it) a diffuse vertex runs the reservoir
    pipeline (`vertices`, each with two shadow rays, whose march work is
    also counted apart as `v_gated`, `v_marched`, `v_march_steps`) in
    place of NEE; with
    `gbuffer` (K4) a diffuse vertex runs neither and is recorded.  Under
    the homogeneous medium it counts each ray's free path (`freepath`),
    the scatter events (`scatter`), their in-scatter shadow rays
    (`vol_shadow`, one per LIGHT sphere, whose march work counts with the
    rest) and the fogged NEE shadow rays (`fog`); under spectral
    transport the hits on dispersive meshes (`cauchy`).
    Replays the kernels' decisions with the plain version's functions
    (`bsdf.sample`, `integrator.hit_color_emission`, `sdf.march_loop`,
    `restir.reservoir_direct` among them), which make the same ones bit
    for bit.  `lane_use` is the bounce loop's warp lane use one pixel per
    thread (`warp_lane_use` of each pixel's bounces) and `march_lane_use`
    that of the bounces' SDF marches (lane steps over 32 x each warp's
    longest march, bounce by bounce); with `resident_warps`,
    `lane_use_regenerated` simulates the bounce loop under K4's path
    regeneration on that many warps (`regenerated_lane_use`)."""
    from raytracer0_tpu_torch import rng
    from raytracer0_tpu_torch.ops import (bsdf, intersect, lighting, restir, sampling,
                                          sdf, spectral, vecmath)
    from raytracer0_tpu_torch.render import integrator

    n = ro.shape[:-1].numel()
    kinds = [lighting.slot_kind(scene, i) for i in range(scene.num_lights)]
    n_sphere, n_dir, n_sdf_light = kinds.count("sphere"), kinds.count("dir"), kinds.count("sdf")
    ev = dict(rays=0, diffuse=0, specular=0, transmit=0, shadow=0, shadow_dir=0, shadow_sdf=0,
              gather=0, fetch=0, light=0, light_mis=0, dir_hit=0, miss=0, sky=0,
              gated=0, marched=0, march_steps=0, sdf_hits=0, vertices=0,
              v_gated=0, v_marched=0, v_march_steps=0, bsdf={}, texel={}, uv={},
              freepath=0, scatter=0, vol_shadow=0, fog=0, cauchy=0)
    marches, march_loop = [], sdf.march_loop

    def counted(*args):
        out = march_loop(*args)
        marches.append(out[3])
        return out

    def march_work(sel, vertex=False):
        """Count the march work of the rays traced since the last call, in
        the lanes of `sel` (and apart, for the reservoir vertex's)."""
        for steps in marches:
            work = (int(sel.sum()), int((sel & (steps > 0)).sum()), int(steps[sel].sum()))
            for prefix in ("", "v_") if vertex else ("",):
                for k, n in zip(("gated", "marched", "march_steps"), work):
                    ev[prefix + k] += n
        marches.clear()

    blends = scene.tex_type.ne(-1) & (scene.opts[:, 0] | scene.opts[:, 1])
    o, d = ro, rd
    shape = ro.shape[:-1]
    mask = torch.ones_like(ro)
    active = torch.ones(shape, dtype=torch.bool, device=ro.device)
    specular = active.clone()
    counts = [torch.zeros(shape, dtype=torch.int32, device=ro.device) for _ in range(3)]
    bounces = torch.zeros(shape, dtype=torch.int64, device=ro.device)
    march_steps, march_longest = 0, 0
    hero_wl = (spectral.sample_wavelength(rng.uniform(pix, pass_idx, sample_idx,
                                                      rng.Stream.WAVELENGTH))
               if cfg.use_spectral else None)
    sdf.march_loop = counted
    try:
        for depth in range(cfg.max_bounces):
            hit = intersect.intersect(scene, o, d, cfg)
            bounces = bounces + active.long()
            if marches:   # the bounce's own march, lane by lane
                steps = torch.where(active, marches[0], 0).flatten().long()
                steps = torch.cat([steps, steps.new_zeros((-steps.numel()) % 32)]).view(-1, 32)
                march_steps += int(steps.sum())
                march_longest += int(steps.amax(1).sum())
            march_work(active)
            scat = torch.zeros_like(active)
            if cfg.use_volumetrics:   # the medium event, as integrator.trace runs it
                u_fp = rng.uniform(pix, pass_idx, sample_idx, depth, rng.Stream.VOL_FREEPATH)
                s_d = -torch.log(torch.clamp_min(u_fp, 1e-6)) / torch.full_like(
                    u_fp, cfg.vol_sigma_t)
                scat = active & (s_d < torch.clamp_max(hit.t, cfg.infinity))
                s_pos = o + s_d[..., None] * d
                mask = torch.where(scat[..., None],
                                   mask * (cfg.vol_sigma_s / cfg.vol_sigma_t), mask)
                ev["freepath"] += int(active.sum())
                ev["scatter"] += int(scat.sum())
                ev["rays"] += int(scat.sum())   # scanned, then scattered
                if cfg.sample_lights and n_sphere:
                    if scene.num_sdfs:   # the in-scatter shadow rays' march work
                        integrator._volumetric_nee(scene, cfg, s_pos, d, mask, pix, pass_idx,
                                                   sample_idx, depth)
                        march_work(scat)
                    ev["vol_shadow"] += int(scat.sum()) * n_sphere
                h1, h2 = rng.uniform2(pix, pass_idx, sample_idx, depth, rng.Stream.VOL_PHASE)
                hg_dir = sampling.sample_hg(d, cfg.vol_g, h1, h2)
                counts[2] = counts[2] + scat.to(torch.int32)
                specular = specular & ~scat
                vol_on = scat & ~((counts[2] >= cfg.max_scattering_events)
                                  | (mask.amax(-1) < 0.01))
                active = active & ~scat
            mat = scene.mat_type[hit.idx]
            missed = active & hit.missed
            is_light = active & ~hit.missed & (mat == 0)
            is_dir = active & ~hit.missed & (mat == 1)
            surf = active & ~hit.missed & ~is_light & ~is_dir
            ev["rays"] += int(active.sum())
            ev["miss"] += int(missed.sum())
            ev["sdf_hits"] += int((active & ~hit.missed & (hit.idx >= scene.num_analytic)).sum())
            env = int((missed & (specular | (not cfg.sample_lights))).sum())
            if cfg.use_cubemap:
                ev["fetch"] += env
            elif cfg.use_procedural_sky:
                ev["sky"] += env
            ev["light"] += int(is_light.sum())
            ev["dir_hit"] += int(is_dir.sum())
            if cfg.use_mis and cfg.sample_lights and depth > 0:
                ev["light_mis"] += int((is_light & ~specular).sum())
            for code in torch.unique(mat[surf]).tolist():
                ev["bsdf"][code] = ev["bsdf"].get(code, 0) + int((surf & (mat == code)).sum())
            textured = active & ~hit.missed & blends[hit.idx]
            ttype, mtype = scene.tex_type[hit.idx], scene.mesh_type[hit.idx]
            for code in torch.unique(ttype[textured]).tolist():
                sel = textured & (ttype == code)
                ev["texel"][code] = ev["texel"].get(code, 0) + int(sel.sum())
                if code in TEX_UV:
                    for m in torch.unique(mtype[sel]).tolist():
                        ev["uv"][m] = ev["uv"].get(m, 0) + int((sel & (mtype == m)).sum())
            c, e = integrator.hit_color_emission(scene, hit)
            inside = torch.where(vecmath.vdot(d, hit.n) > 0.0, -1.0, 1.0)
            nl = hit.n * inside[..., None]
            u1, u2 = rng.uniform2(pix, pass_idx, sample_idx, depth, rng.Stream.BSDF_DIR)
            uc = rng.uniform(pix, pass_idx, sample_idx, depth, rng.Stream.BSDF_CHOICE)
            bs = bsdf.sample(scene, cfg, hit, c, e, inside, d, u1, u2, uc, hero_wl)
            if cfg.use_spectral:
                refr = (mat == 4) | (mat == 5) | (mat == 6)
                ev["cauchy"] += int((surf & refr & (scene.ior[hit.idx] < 0.0)).sum())
            diffuse = surf & ~bs.specular
            transmit = surf & (bs.scatter_inc > 0)
            ev["diffuse"] += int(diffuse.sum())
            ev["transmit"] += int(transmit.sum())
            ev["specular"] += int((surf & bs.specular & ~transmit).sum())
            n_diffuse = int(diffuse.sum())
            if cfg.use_cubemap:
                eu1, eu2 = rng.uniform2(pix, pass_idx, sample_idx, depth, rng.Stream.ENV_DIR)
                env_dir = sampling.random_direction(nl, eu1, eu2, cfg.use_biased_sampling)
                env_hit = intersect.intersect(scene, hit.pos + nl * cfg.epsilon, env_dir, cfg,
                                              need_normal=False)
                march_work(diffuse)
                ev["gather"] += n_diffuse
                ev["fetch"] += int((diffuse & env_hit.missed).sum())
            if ring is not None:
                restir.reservoir_direct(
                    scene, cfg, ring.restir_back.fields(),
                    [ring.restir_hist1.fields(), ring.restir_hist2.fields()], hit.pos, nl,
                    hit.idx, pix, pass_idx, sample_idx, depth, height=shape[0], width=shape[1])
                march_work(diffuse, vertex=True)
                ev["vertices"] += n_diffuse
            elif cfg.sample_lights and not gbuffer:
                if scene.num_sdfs:   # the shadow rays' march work
                    lighting.sample_lights_nee(scene, cfg, hit.pos, nl, mask, pix, pass_idx,
                                               sample_idx, depth)
                    march_work(diffuse)
                ev["shadow"] += n_diffuse * n_sphere
                ev["fog"] += n_diffuse * n_sphere if cfg.use_volumetrics else 0
                ev["shadow_sdf"] += n_diffuse * n_sdf_light
                if not cfg.use_mis:
                    ev["shadow_dir"] += n_diffuse * n_dir
            sel = surf[..., None]
            o = torch.where(sel, bs.o, o)
            d = torch.where(sel, bs.d, d)
            mask = torch.where(sel, mask * bs.mask_mult, mask)
            specular = torch.where(surf, bs.specular, specular)
            for k, inc in enumerate((bs.diff_inc, bs.spec_inc, bs.scatter_inc)):
                counts[k] = counts[k] + torch.where(surf, inc, 0)
            capped = ((counts[0] >= cfg.max_diff_bounces) | (counts[1] >= cfg.max_spec_bounces)
                      | (counts[2] >= cfg.max_scattering_events))
            active = surf & ~(mask.amax(-1) < 0.01) & ~capped
            if cfg.use_volumetrics:   # scattered lanes go on along their HG direction
                o = torch.where(scat[..., None], s_pos, o)
                d = torch.where(scat[..., None], hg_dir, d)
                active = active | vol_on
            if not bool(active.any()):
                break
    finally:
        sdf.march_loop = march_loop
    ev["pixels"] = n
    ev["lane_use"] = warp_lane_use(torch, bounces)
    if march_longest:
        ev["march_lane_use"] = march_steps / (32 * march_longest)
    if resident_warps:
        ev["lane_use_regenerated"] = regenerated_lane_use(bounces, resident_warps)[0]
    return ev


def bound(ev, scene, cfg, adjoint, restir=False, gbuffer_slots=0, sdf_adjoint=False):
    """(bound_ms, bound_by) of K1 (or K2 when `adjoint`, K6 when `restir`,
    K7 when both) for these events: the larger of the bytes over the HBM
    rate and the float operations over the float32 rate.  The bytes are
    each input read once (rays, pixel ids, the scene table and, where this
    run reads them, the whole cubemap, the images and the noise LUT; K6's
    three reservoir grids) and each output written once (K6's new
    reservoirs too).  An adjoint takes at least the operations of the
    forward it differentiates less its mesh scans and marches, whose
    adjoint reads the winning mesh alone.  K2 runs a forward sweep
    without NEE that scans each slot's ray, then replays each slot with
    the hit it stashed (its NEE shadow rays scanned again) and runs its
    adjoint.  K6 runs K1's sweep with the reservoir vertex and its two
    shadow rays in place of NEE; K7 needs K6's forward once and its
    adjoint (the ROUND_BOX copy scans each slot's ray again in its reverse
    sweep, a cost of its design that the bound leaves out; the whole-SDF
    copy stashes each hit and scans nothing again).  K4 (`gbuffer_slots` > 0)
    runs K1's sweep without NEE and writes the G-buffer: per slot and pixel
    45 bytes (position, normal, throughput, mesh, depth, valid).
    `sdf_adjoint` (K2's whole-SDF copy) adds, at each SDF hit, the reverse
    of the winning distance at the 5 points where the replay evaluated the
    scene map (the implicit t's point and the normal's 4 taps, counted in
    the forward): at least the operations of the scene's cheapest shape's
    distance each.  Under the medium (K2's medium copy) the forward's
    medium events count once in the replay and once in the adjoint, whose
    in-scatter shadow rays read the light they hit alone."""
    types = [int(t) for t in scene.mesh_types_static[:scene.num_analytic]]
    per_ray = sum(OPS_MESH.get(t, 0) + 2 for t in types)
    n_sdf = scene.num_sdfs
    # one scene map: each entry's distance by its shape
    smap = sum(OPS_SDF_SHAPE[int(s)] for s in scene.sdf_shapes_static)
    march = (ev["gated"] * n_sdf * OPS_SDF_GATE
             + ev["marched"] * (2 * (OPS_MARCH_RAY + smap))
             + ev["march_steps"] * (OPS_MARCH_STEP + smap)
             + ev["sdf_hits"] * (n_sdf * (OPS_SDF_NORMAL - 4 * OPS_SDF_EVAL) + 4 * smap))
    nee = OPS_NEE + (OPS_NEE_MIS if cfg.use_mis else 0)
    samples = sum(ev["bsdf"].values())
    hits = samples + ev["light"] + ev["dir_hit"]
    sweep = (ev["rays"] * per_ray + hits * OPS_HIT + samples * OPS_DIFFUSE
             + sum(k * OPS_BSDF.get(code, 0) for code, k in ev["bsdf"].items()))
    nee_sdf = OPS_NEE_SDF + (OPS_NEE_SDF_MIS if cfg.use_mis else 0)
    medium = (ev.get("freepath", 0) * OPS_FREEPATH + ev.get("scatter", 0) * OPS_SCATTER
              + ev.get("vol_shadow", 0) * (per_ray + OPS_VOL_NEE) + ev.get("fog", 0) * OPS_FOG
              + ev.get("cauchy", 0) * OPS_CAUCHY)
    fwd = (sweep + medium + ev["shadow"] * (per_ray + nee)
           + ev["shadow_dir"] * (per_ray + OPS_NEE_DIR)
           + ev["shadow_sdf"] * (per_ray + nee_sdf)
           + ev["gather"] * (per_ray + OPS_GATHER) + ev["fetch"] * OPS_FETCH
           + ev["light"] * OPS_LIGHT + ev["light_mis"] * OPS_LIGHT_MIS + ev["sky"] * OPS_MISS
           + sum(k * (OPS_TEXEL[code] + OPS_BLEND) for code, k in ev["texel"].items())
           + sum(k * OPS_UV[m] for m, k in ev["uv"].items()) + march)
    if restir:
        fwd += vertex_ops(ev, scene, cfg, per_ray)
    scans = (ev["rays"] + ev["shadow"] + ev["shadow_dir"] + ev["shadow_sdf"] + ev["gather"]
             + ev.get("vol_shadow", 0) + (2 * ev["vertices"] if restir else 0)) * per_ray + march
    adjoint_ops = fwd - scans
    if sdf_adjoint and n_sdf:
        adjoint_ops += ev["sdf_hits"] * 5 * min(OPS_SDF_SHAPE[int(s)]
                                                for s in scene.sdf_shapes_static)
    table = 4 * scene.num_meshes * 36
    assets = 4 * scene.cubemap.numel() if cfg.use_cubemap else 0
    assets += 4 * scene.images.numel() if any(t <= 3 for t in ev["texel"]) else 0
    assets += 4 * scene.noise.numel() if any(t in TEX_LUT for t in ev["texel"]) else 0
    px = ev["pixels"]
    if restir and adjoint:   # K6's inputs, ct and the 4 ring cotangents in;
        # d_ro, d_rd, per-tap and history cotangents, d back, d_table out
        ops = fwd + adjoint_ops
        nbytes = px * (12 + 12 + 8 + 3 * 20 + 12 + 16 + 24 + 8 * 12 + 2 * 12 + 12) + 2 * table
    elif gbuffer_slots:   # ro, rd, pix, table in; radiance and the G-buffer out
        ops, nbytes = fwd, px * (12 + 12 + 8 + 12 + 45 * gbuffer_slots) + table
    elif restir:  # ro, rd, pix, three reservoir grids in; radiance, reservoirs out
        ops, nbytes = fwd, px * (12 + 12 + 8 + 3 * 20 + 12 + 44) + table
    elif adjoint:   # ro, rd, pix, ct in; d_ro, d_rd, d_table out
        ops = sweep + (fwd - ev["rays"] * per_ray) + adjoint_ops
        nbytes = px * (12 + 12 + 8 + 12 + 24) + 2 * table
    else:         # ro, rd, pix, table, cubemap, images, LUT in; radiance out
        ops, nbytes = fwd, px * (12 + 12 + 8 + 12) + table + assets
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def vertex_ops(ev, scene, cfg, per_ray):
    """Float operations of the reservoir vertices of `ev` (`path_events`
    with a ring), their shadow rays' mesh scans (`per_ray` each) included,
    their marches not."""
    n_lights = scene.num_lights
    n_cand = min(cfg.restir_samples, max(4, n_lights))
    n_spatial = 8 if n_lights <= 10 else 4
    return ev["vertices"] * (OPS_RESTIR_BRDF + n_cand * OPS_CANDIDATE + 2 * OPS_TEMPORAL
                             + n_spatial * OPS_SPATIAL + OPS_VISIBILITY + OPS_FINALIZE
                             + OPS_SHADE + 2 * per_ray)


def vertex_bound(ev, scene, cfg, slots, split=False):
    """(bound_ms, bound_by) of K6v for these events (`path_events` with the
    ring it reads): the operations of the reservoir vertices and of their
    shadow rays' scans and marches (`v_*`), as `bound` counts them inside
    K6 (each scene map the sum of its rows' distances by shape, as
    `bound`'s); the bytes of pixel ids, the G-buffer (45 per slot and pixel), K4's
    radiance and the three reservoir grids read (20 bytes a cell, 44 in the
    split form, which reads the light data and its running sum too), and
    the radiance and the new reservoirs written."""
    types = [int(t) for t in scene.mesh_types_static[:scene.num_analytic]]
    per_ray = sum(OPS_MESH.get(t, 0) + 2 for t in types)
    n_sdf = scene.num_sdfs
    smap = sum(OPS_SDF_SHAPE[int(s)] for s in scene.sdf_shapes_static)   # one scene map
    march = (ev["v_gated"] * n_sdf * OPS_SDF_GATE
             + ev["v_marched"] * (2 * (OPS_MARCH_RAY + smap))
             + ev["v_march_steps"] * (OPS_MARCH_STEP + smap))
    ops = vertex_ops(ev, scene, cfg, per_ray) + march
    grid = 44 if split else 20
    nbytes = (ev["pixels"] * (8 + 45 * slots + 12 + 3 * grid + (24 if split else 12) + 44)
              + 4 * scene.num_meshes * 36)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cast_bound(torch, scene, cfg, o, d):
    """(bound_ms, bound_by, events) of K5 on the rays (o, d): each ray reads
    24 bytes and writes 8 (the table once); its operations are a scan over
    the analytic meshes and, in scenes with SDF meshes, the march of
    `bound`'s count (the gate, the steps, the final evaluation), replayed
    with the plain `sdf.march_loop`."""
    from raytracer0_tpu_torch.ops import intersect, sdf

    steps_seen, march_loop = [], sdf.march_loop

    def counted(*args):
        out = march_loop(*args)
        steps_seen.append(out[3])
        return out

    sdf.march_loop = counted
    try:
        intersect.intersect(scene, o, d, cfg, need_normal=False, need_uv=False)
    finally:
        sdf.march_loop = march_loop
    n = o.shape[:-1].numel()
    ev = dict(rays=n, gated=0, marched=0, march_steps=0)
    for steps in steps_seen:
        ev["gated"] += n
        ev["marched"] += int((steps > 0).sum())
        ev["march_steps"] += int(steps.sum())
    types = [int(t) for t in scene.mesh_types_static[:scene.num_analytic]]
    n_sdf = scene.num_sdfs
    ops = (n * sum(OPS_MESH.get(t, 0) + 2 for t in types)
           + ev["gated"] * n_sdf * OPS_SDF_GATE
           + ev["marched"] * (2 * (OPS_MARCH_RAY + n_sdf * OPS_SDF_EVAL))
           + ev["march_steps"] * (OPS_MARCH_STEP + n_sdf * OPS_SDF_EVAL))
    nbytes = n * (24 + 8) + 4 * scene.num_meshes * 36
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return by[0], by[1], ev


def kernel_occupancy(dev):
    """{(kernel, scene): cuda_build.occupancy(...)} of the six kernels at
    the block size and shared memory of their main paths' scenes: K1 and
    K2 on Cornell, K1's whole-SDF copy on `mandelbulb`, K1's medium copy on
    `spectral_caustics`, K4 and K5 on the
    real-time scene (the SDF copies), K6v (fused form) and K7 on
    `restir_demo`, K7 on `restir_stress` too, K6v's split form on the
    real-time scene, K4's and K6v's whole-SDF copies on `mandelbulb`
    and on `animated_restir` as shipped (the split form), and K7's
    whole-SDF copy on the scenes of `k7_sdf_scenes`."""
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.ops import (cuda_build, megakernel, restir_kernel, restir_split,
                                          restir_vertex)

    cornell = presets.cornell_default(device=dev, use_mis=True)[0]
    realtime = presets.animated_untextured(device=dev)[0]
    demo, stress = presets.restir_demo(device=dev)[0], presets.restir_stress(device=dev)[0]
    k7_threads = restir_kernel.bwd_threads
    bulb = presets.mandelbulb(device=dev)[0]
    shipped = presets.animated_restir(device=dev)[0]
    caustics = presets.spectral_caustics(device=dev)[0]
    rows = [
        ("K1", "cornell_default", "megakernel", megakernel.SOURCES, "rt0_trace_forward",
         128, megakernel.packed_smem_bytes(cornell), False),
        ("K1 whole-SDF", "mandelbulb", "megakernel", megakernel.SOURCES, "rt0_trace_forward",
         128, megakernel.packed_smem_bytes(bulb), 5),
        ("K1 medium", "spectral_caustics", "megakernel", megakernel.SOURCES,
         "rt0_trace_forward", 128, megakernel.packed_smem_bytes(caustics), 8),
        ("K4", "animated_untextured", "gbuffer", restir_split.GBUF_SOURCES,
         "rt0_gbuffer_forward", 128, megakernel.packed_smem_bytes(realtime), True),
        ("K4", "restir_demo", "gbuffer", restir_split.GBUF_SOURCES,
         "rt0_gbuffer_forward", 128, megakernel.packed_smem_bytes(demo), True),
        ("K5", "animated_untextured", "cast", restir_split.CAST_SOURCES, "rt0_cast_rays", 128,
         restir_split.cast_smem_bytes(realtime), True),
        ("K6v", "restir_demo", "restir_vertex", restir_vertex.SOURCES, "rt0_restir_vertex", 128,
         restir_vertex.smem_bytes(demo), False),
        ("K6v split", "animated_untextured", "restir_vertex", restir_vertex.SOURCES,
         "rt0_restir_vertex", 128, restir_vertex.smem_bytes(realtime), True),
        ("K4 whole-SDF", "mandelbulb", "gbuffer", restir_split.GBUF_SOURCES,
         "rt0_gbuffer_forward", 128, megakernel.packed_smem_bytes(bulb),
         restir_split.gbuffer_copy(bulb)),
        ("K4 whole-SDF", "animated_restir", "gbuffer", restir_split.GBUF_SOURCES,
         "rt0_gbuffer_forward", 128, megakernel.packed_smem_bytes(shipped),
         restir_split.gbuffer_copy(shipped)),
        ("K6v whole-SDF", "mandelbulb", "restir_vertex", restir_vertex.SOURCES,
         "rt0_restir_vertex", 128, restir_vertex.smem_bytes(bulb),
         restir_vertex.vertex_copy(bulb, False)),
        ("K6v split whole-SDF", "animated_restir", "restir_vertex", restir_vertex.SOURCES,
         "rt0_restir_vertex", 128, restir_vertex.smem_bytes(shipped),
         restir_vertex.vertex_copy(shipped, True)),
        ("K7", "restir_demo", "restir_bwd", restir_kernel.BWD_SOURCES, "rt0_restir_backward",
         k7_threads(demo), restir_kernel.bwd_smem_bytes(demo, k7_threads(demo)), True),
        ("K7", "restir_stress", "restir_bwd", restir_kernel.BWD_SOURCES, "rt0_restir_backward",
         k7_threads(stress), restir_kernel.bwd_smem_bytes(stress, k7_threads(stress)), True),
    ]
    for where, (sc, _, _) in k7_sdf_scenes(dev).items():
        rows.append(("K7 whole-SDF", where, *restir_kernel.bwd_library(True),
                     "rt0_restir_backward", k7_threads(sc),
                     restir_kernel.bwd_smem_bytes(sc, k7_threads(sc)), 2))
    for where, (sc, c) in k2_cases(dev).items():
        warp, smem = megakernel.bwd_layout(sc, c)
        copy = megakernel.bwd_copy(sc, c)
        flag = (int(warp) | 2 * int(copy in ("wide", "medium")) | 4 * int(copy == "whole_sdf")
                | 8 * int(copy == "medium"))
        rows.append(("K2", where, *megakernel.bwd_library(copy),
                     "rt0_trace_backward", megakernel.BWD_THREADS, smem, flag))
    # the flag is K1's copy (bit 0 the SDF march, bit 2 the whole SDF class,
    # bit 3 the medium copy),
    # K4's (bit 0 the SDF march, bit 1 the whole SDF class), K5's SDF copy,
    # K6v's (bit 0 the split form, bit 1 the whole SDF class) or K2's copy
    # (bit 0 a column per warp, bit 1 the wide copy, bit 2 the whole-SDF copy,
    # bit 3 the medium copy)
    # or K7's (unused: each of its libraries holds one copy)
    return {(k, where): cuda_build.occupancy(lib, src, sym + "_occupancy", threads, smem, flag)
            for k, where, lib, src, sym, threads, smem, flag in rows}


def k7_sdf_scenes(dev):
    """{name: (scene, camera, cfg)} of the scenes K7 runs its whole-SDF
    copy on: `animated_restir` as shipped (ANIMATED) and under STATIC
    accumulation, the three ReSTIR views, `textured_restir_demo` and
    `textured_cornell` under ReSTIR."""
    from raytracer0_tpu_torch.models import presets

    out = {"animated_restir": presets.animated_restir(device=dev),
           "animated_restir_static": presets.animated_restir(device=dev, render_mode=0)}
    out.update({name: presets.restir_sdf_view(name, device=dev)
                for name in presets.RESTIR_SDF_VIEWS})
    out["textured_restir_demo"] = presets.textured_restir_demo(device=dev)
    out["textured_cornell"] = presets.textured_cornell(device=dev, use_restir=True, use_mis=False)
    return out


def sun_scene(dev):
    """(scene, camera) of tests/test_megakernel.py:685-698: finite geometry
    under a directional sun whose mesh.pos is the direction."""
    from raytracer0_tpu_torch.models.camera import Camera
    from raytracer0_tpu_torch.models.materials import MeshType
    from raytracer0_tpu_torch.models.scene import SceneBuilder

    sb = SceneBuilder()
    sb.add("MAT_CORNELL_WHITE", MeshType.BOX, (0.0, -2.2, -1.0), (2.0,))
    sb.add("MAT_CORNELL_RED", MeshType.BOX, (-0.8, -0.8, -1.4), (0.8,))
    sb.add("MAT_MIRROR", MeshType.SPHERE, (0.6, -0.7, -1.0), (0.5,))
    sb.add("MAT_DIRECT_SUNLIGHT", MeshType.SPHERE, (0.5, 0.8, 0.3), (0.01,))
    sb.lights([3])
    cam = Camera.make(origin=(0.0, 0.3, 2.0), lookat=(0.0, -0.6, -1.0), device=dev)
    return sb.build(device=dev), cam


def k2_cases(dev):
    """{name: (scene, cfg)} of K2's scene classes in phase 2: Cornell and
    the 47-mesh scene on its Cornell copy (a column per thread, per warp),
    and on its wide copy config 2 (glass, mirror, coat), `mis_demo` (a BOX
    SDF), `textured_cornell` and `cubemap_demo` (a column per thread) and
    the 47-mesh scene under uniform sampling (a column per warp), on its
    whole-SDF copy the presets `default_scene`, `mandelbulb` and
    `menger_sponge` and the scene of every shape the presets lack, and on
    its medium copy the reference's preset 8, `spectral_caustics`."""
    from raytracer0_tpu_torch.models import presets

    cases = {"cornell_default": presets.cornell_default(device=dev, use_mis=True),
             "many_meshes": presets.many_lights(device=dev)}
    for name in ("config2", "mis_demo", "textured_cornell", "cubemap_demo", "default_scene",
                 "mandelbulb", "menger_sponge", "spectral_caustics"):
        cases[name] = getattr(presets, name)(device=dev)
    scene, cam, cfg = cases["many_meshes"]
    cases["many_meshes_uniform"] = (scene, cam, cfg.replace(use_biased_sampling=False))
    cases["every_shape"] = presets.sdf_view("every_shape", device=dev)
    return {k: (v[0], v[2]) for k, v in cases.items()}


def device_times_ms(prof, names, per_launch=False):
    """Device milliseconds per profiled kernel whose name contains each of
    `names` (per launch the profile recorded, with `per_launch`), and the
    device total of all kernels; None where the profiler shows no device
    time."""
    evts = prof.key_averages()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return v
        return 0.0

    def launches(n):
        return max(sum(e.count for e in evts if n in e.key), 1) if per_launch else 1

    out = {n: sum(dev_us(e) for e in evts if n in e.key) / 1e3 / launches(n) for n in names}
    total = sum(dev_us(e) for e in evts) / 1e3
    if total <= 0.0:
        return {n: None for n in names}, None
    return out, total


def device_launches(prof):
    """Launches of device work (kernels, copies, fills) the profile saw;
    None where the profiler shows no device time."""
    evts = [e for e in prof.key_averages()
            if (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0.0)) > 0]
    return sum(e.count for e in evts) or None


def restir_sdf_phase(torch, dev, card, occ):
    """Phase 28: ReSTIR over the whole SDF class and blended textures, on
    K4's and K6v's whole-SDF copies.  Returns the figures of the kernels'
    JSON line and raises after printing every failed comparison."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer0_tpu_torch import rng
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.models import scene as scene_mod
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.ops import (megakernel, restir, restir_kernel, restir_split,
                                          restir_vertex)
    from raytracer0_tpu_torch.render.renderer import Renderer
    from raytracer0_tpu_torch.render.state import RESERVOIR_FIELDS, RenderState

    def counts():
        return (restir_kernel.LAUNCHES, restir_split.GBUF_LAUNCHES,
                restir_vertex.VERTEX_LAUNCHES, restir_split.CAST_LAUNCHES, megakernel.LAUNCHES,
                megakernel.BWD_LAUNCHES, restir_kernel.BWD_LAUNCHES)

    def zero_counts():
        restir_kernel.LAUNCHES = restir_kernel.BWD_LAUNCHES = 0
        restir_split.GBUF_LAUNCHES = restir_split.CAST_LAUNCHES = 0
        restir_vertex.VERTEX_LAUNCHES = megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = 0

    def same_ring(a, b):
        return all(torch.equal(getattr(a, k), getattr(b, k)) for k in RESERVOIR_FIELDS)

    def plain_timed(fn):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        return out, ev0.elapsed_time(ev1)

    failed, out28 = [], {"held": {}}
    # the holds' size and passes, which the plain version finishes in
    # seconds: 128x128 over a 3-pass ring (`polygons` over 2); the two views
    # whose plain passes are the slowest (the `mandelbulb` view's 22-25 s
    # each at 128x128 and at 64x64 alike: the plain version's time is its
    # launches, per bounce and marching step) at 64x64 over 1 pass, each at
    # its own depth; the `mandelbulb` view's K4 is held through the K6 pass
    # alone (K6v reads its G-buffer), K4's whole-SDF copy on its own on the
    # other four scenes
    hs_of = {"mandelbulb": 64, "every_shape": 64}
    passes_of = {"mandelbulb": 1, "every_shape": 1, "polygons": 2}
    k4_alone = ("every_shape", "polygons", "animated_restir", "textured_cornell")

    # the K6 pass (K4, then K6v's fused form) and K4 alone against the plain
    # version, bit for bit, at every pass of the ring
    scenes = {name: presets.restir_sdf_view(name, device=dev)
              for name in presets.RESTIR_SDF_VIEWS}
    scenes["animated_restir"] = presets.animated_restir(device=dev)
    scenes["textured_cornell"] = presets.textured_cornell(device=dev, use_restir=True,
                                                          use_mis=False)
    for name, (sc, cam, cfg) in scenes.items():
        reason = restir_kernel.unsupported_restir(sc, cfg)
        if reason is not None:
            raise AssertionError(f"phase 28: K6 refuses {name}: {reason}")
        t = 0.5 if int(cfg.render_mode) else 0.0   # a constant frame time under ANIMATED
        fr = scene_mod.animate_positions(sc, t, int(cfg.render_mode))
        copy4 = restir_split.gbuffer_copy(fr)
        hs, n_pass = hs_of.get(name, 128), passes_of.get(name, 3)
        ro, rd = generate_rays(cam, hs, hs, 0)
        pix = rng.pixel_ids(hs, hs, device=dev)
        before = counts()
        k4_same, plain4_ms = None, None
        if name in k4_alone:
            rad4, gb4 = restir_split.trace_forward_gbuffer(fr, cfg, ro, rd, pix, 0, 0)
            (ref4, rgb4), plain4_ms = plain_timed(
                lambda: restir_split.gbuffer_plain(fr, cfg, ro, rd, pix, 0, 0))
            k4_same = torch.equal(rad4, ref4) and all(
                torch.equal(a[f], b[f]) for a, b in zip(gb4, rgb4) for f in a)
        kring = pring = RenderState.create(hs, hs, device=dev)
        diffs, errs, plain_ms = [], [], []
        for p in range(n_pass):
            out, new = restir_kernel.render_sample_fused(sc, cfg, cam, kring, hs, hs, p, t)
            (ref, new_ref), ms = plain_timed(
                lambda: restir.render_sample(sc, cfg, cam, pring, hs, hs, p, t))
            diffs.append(int((out != ref).any(-1).sum()) + int(not same_ring(new, new_ref)))
            errs.append((out - ref).abs().max().item())
            plain_ms.append(ms)
            if not bool(torch.isfinite(out).all()):
                diffs[-1] += 1
            kring, pring = kring.rotate_reservoirs(new), pring.rotate_reservoirs(new_ref)
        got = tuple(c - b for c, b in zip(counts(), before))
        held_light = (new.light_index >= 0).float().mean().item()
        k4_text = ("held through the K6 pass" if k4_same is None
                   else "identical bits" if k4_same else "DIFFER")
        print(f"phase 28: {name} (K4 copy {copy4}, K6v copy "
              f"{restir_vertex.vertex_copy(fr, False)}, {cfg.max_bounces} bounces, "
              f"{cfg.marching_steps} marching steps) at {hs}x{hs}: K4 against gbuffer_plain "
              f"{k4_text}; the K6 pass against "
              f"restir.render_sample at passes 0-{n_pass - 1}: pixels or fields differing "
              f"{diffs}, max abs "
              f"err {[f'{e:.3e}' for e in errs]}; launches (K6, K4, K6v, K5, K1, K2, K7) {got}; "
              f"image mean {ref.mean().item():.6f}, share holding a light {held_light:.4f}; "
              + ("" if plain4_ms is None else f"plain K4 {plain4_ms:.1f} ms, ")
              + f"plain pass {[round(m, 1) for m in plain_ms]} ms")
        n_k4 = n_pass + (k4_same is not None)
        if k4_same is False or any(diffs) or got != (n_pass, n_k4, n_pass, 0, 0, 0, 0) \
                or not ref.mean().item() > 0.0:
            failed.append(f"the K6 pass or K4 on {name}")
        out28["held"][name] = {"k4_copy": copy4, "k4_identical": k4_same,
                               "k6_pixels_differing": diffs, "max_abs_err": max(errs),
                               "plain_ms_k4": plain4_ms, "plain_ms_pass": plain_ms,
                               "size": hs}
        stamp(f"phase 28: K4 and the K6 pass held on {name}")

    # the split path against its plain version over ANIMATED frames at t != 0
    sc, cam, cfg = scenes["animated_restir"]
    adhoc = cfg.replace(restir_adhoc_motion=True)
    hs = 128
    kring = pring = RenderState.create(hs, hs, device=dev)
    split_diff, split_err = [], []
    before = counts()
    for p in range(5):
        t = (p + 1) / 30
        out, new = restir_split.render_sample_fast(sc, adhoc, cam, kring, hs, hs, p, t)
        ref, new_ref = restir_split.render_sample_split(
            sc, adhoc, cam, pring, hs, hs, p, t, restir_split.gbuffer_plain, restir.default_cast)
        split_diff.append(int((out != ref).any(-1).sum()) + int(not same_ring(new, new_ref)))
        split_err.append((out - ref).abs().max().item())
        kring, pring = kring.rotate_reservoirs(new), pring.rotate_reservoirs(new_ref)
    got = tuple(c - b for c, b in zip(counts(), before))
    print(f"phase 28: animated_restir as shipped, the split path (render_sample_fast) against "
          f"render_sample_split with the plain G-buffer and caster at {hs}x{hs} over 5 ANIMATED "
          f"frames at t = (k+1)/30: pixels or fields differing {split_diff}, max abs err "
          f"{[f'{e:.3e}' for e in split_err]}; launches (K6, K4, K6v, K5, K1, K2, K7) {got}")
    if any(split_diff) or got != (0, 5, 5, 0, 0, 0, 0):
        failed.append("the split path on animated_restir")
    out28["split_pixels_differing"] = split_diff
    out28["split_max_abs_err"] = max(split_err)
    stamp("phase 28: the split path held")

    # the real-time frame of the preset as shipped, and of phase 24's variant
    frames = 16
    frame_stats, frame_dev = {}, {}
    for label, (s_, c_, g_) in (("animated_restir", scenes["animated_restir"]),
                                ("animated_untextured", presets.animated_untextured(device=dev))):
        a_ = g_.replace(restir_adhoc_motion=True)
        zero_counts()   # the main path: counts from 0 just before, read just after
        rt = Renderer(s_, c_, a_, H, W)
        for k in range(frames):
            rt.step(time_s=k / 30)
        torch.cuda.synchronize()
        got = counts()
        img = rt.image()
        print(f"phase 28: Renderer({label}, ANIMATED_CONFIG with restir_adhoc_motion, {H}, {W})"
              f".step(time_s=k/30) for k < {frames}: launches (K6, K4, K6v, K5, K1, K2, K7) "
              f"{got}; image mean {img.mean().item():.6f}")
        if got != (0, frames, frames, 0, 0, 0, 0) or not bool(torch.isfinite(img).all()) \
                or not img.mean().item() > 0.0:
            failed.append(f"the real-time main path of {label}")
        if label == "animated_restir":
            out28["launches_k4"], out28["launches_k6v_split"] = got[1], got[2]
        frame_stats[label] = time_stats(torch, lambda: rt.step(time_s=0.5), runs=9)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                rt.step(time_s=0.5)
            torch.cuda.synchronize()
        d_, tot_ = device_times_ms(prof, ("gbuf_kernel", "restir_vertex_kernel"))
        n_ = device_launches(prof)
        frame_dev[label] = {k: (None if v is None else v / 3) for k, v in d_.items()}
        frame_dev[label]["launches"] = None if n_ is None else n_ / 3
        frame_dev[label]["total"] = None if tot_ is None else tot_ / 3
        fs, fd = frame_stats[label], frame_dev[label]
        txt = lambda v: "not measured" if v is None else f"{v:.4f}"
        print(f"phase 28: {card}: {label} real-time frame at {H}x{W}: {fs[0]:.3f} ms (q1 "
              f"{fs[1]:.3f}, q3 {fs[2]:.3f}; median and quartiles of 9, CUDA events), "
              f"{txt(fd['launches'])} device launches per frame, device time per frame (profiler)"
              f": K4 {txt(fd['gbuf_kernel'])} ms, K6v {txt(fd['restir_vertex_kernel'])} ms, all "
              f"kernels {txt(fd['total'])} ms")
    # the same frame of the preset as shipped through the K6 pass
    zero_counts()
    rk6 = Renderer(sc, cam, cfg, H, W)
    for k in range(frames):
        rk6.step(time_s=k / 30)
    torch.cuda.synchronize()
    got = counts()
    k6_frame = time_stats(torch, lambda: rk6.step(time_s=0.5), runs=9)
    print(f"phase 28: {card}: animated_restir as shipped at {H}x{W} through the K6 pass (no "
          f"ad-hoc motion): launches (K6, K4, K6v, K5, K1, K2, K7) {got}; {k6_frame[0]:.3f} ms "
          f"(q1 {k6_frame[1]:.3f}, q3 {k6_frame[2]:.3f})")
    if got != (frames, frames, frames, 0, 0, 0, 0):
        failed.append("animated_restir through the K6 pass")
    out28["frame_ms"] = {k: v[0] for k, v in frame_stats.items()}
    out28["frame_quartiles"] = {k: v[1:] for k, v in frame_stats.items()}
    out28["frame_device"] = frame_dev
    out28["frame_ms_k6"] = k6_frame[0]

    # the mandelbulb ReSTIR view at full size: the main path, a K6 pass timed
    stamp("phase 28: the real-time frames timed")
    sc, cam, cfg = scenes["mandelbulb"]
    zero_counts()
    rb = Renderer(sc, cam, cfg, H, W)
    img = rb.render(2)
    torch.cuda.synchronize()
    got = counts()
    print(f"phase 28: Renderer(mandelbulb ReSTIR view, {H}, {W}).render(2), "
          f"{cfg.max_bounces} bounces, {cfg.marching_steps} marching steps: launches (K6, K4, "
          f"K6v, K5, K1, K2, K7) {got}; image mean {img.mean().item():.6f}")
    if got != (2, 2, 2, 0, 0, 0, 0) or not bool(torch.isfinite(img).all()) \
            or not img.mean().item() > 0.01:
        failed.append("the mandelbulb ReSTIR main path")
    out28["launches_k6_mandelbulb"] = got[0]
    st = rb.state
    ro, rd = generate_rays(cam, H, W, 2)
    pix = rng.pixel_ids(H, W, device=dev)
    k6_call = lambda: restir_kernel.trace_forward_restir_fused(
        sc, cfg, ro, rd, pix, 2, 0, st.restir_back, st.restir_hist1, st.restir_hist2)
    ms_k6 = time_ms(torch, k6_call)
    table = megakernel.scene_table(sc)
    grids = (st.restir_back, st.restir_hist1, st.restir_hist2)
    rad4, gb4 = restir_split.launch_gbuffer(sc, cfg, table, ro, rd, pix, 2, 0)
    ms_k4 = time_ms(torch, lambda: restir_split.launch_gbuffer(sc, cfg, table, ro, rd, pix, 2, 0))
    ms_k6v = time_ms(torch, lambda: restir_vertex.launch(sc, cfg, table, ro, rd, pix, 2, 0, grids,
                                                         gb4, rad4))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            k6_call()
        torch.cuda.synchronize()
    d28, _ = device_times_ms(prof, ("gbuf_kernel", "restir_vertex_kernel"), per_launch=True)
    # the events of pass 2 on the ring two passes leave, which phase 29's
    # bound of K7 on the same pass reads too
    ev = out28["mandelbulb_events"] = path_events(torch, sc, cfg, ro, rd, pix, 2, 0, ring=st)
    stamp("phase 28: the mandelbulb view's path events counted")
    slots = restir_split.gbuffer_slots(cfg)
    b_pass = bound(ev, sc, cfg, adjoint=False, restir=True)
    ev4 = dict(ev)   # K4 marches no reservoir vertex's shadow ray
    for k in ("gated", "marched", "march_steps"):
        ev4[k] -= ev["v_" + k]
    b4 = bound(ev4, sc, cfg, adjoint=False, gbuffer_slots=slots)
    b6v = vertex_bound(ev, sc, cfg, slots)
    o4 = occ[("K4 whole-SDF", "mandelbulb")]
    o6 = occ[("K6v whole-SDF", "mandelbulb")]
    grid = restir_split.resident_blocks(dev, restir_split.gbuffer_copy(sc),
                                        megakernel.packed_smem_bytes(sc))
    txt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    print(f"phase 28: path events of a mandelbulb ReSTIR pass at {H}x{W}: {json.dumps(ev)}")
    print(f"phase 28: {card}: mandelbulb ReSTIR view at {H}x{W}: the K6 pass {ms_k6:.3f} ms "
          f"(CUDA events), bound {b_pass[0]:.6f} ms ({b_pass[1]}); K4's whole-SDF copy "
          f"{ms_k4:.3f} ms alone, device {txt(d28['gbuf_kernel'])} (profiler), bound "
          f"{b4[0]:.6f} ms ({b4[1]}), {o4['blocks']} blocks per SM at {o4['registers']} "
          f"registers and {o4['local_bytes']} bytes of local memory, a persistent grid of {grid} "
          f"blocks; K6v's whole-SDF copy {ms_k6v:.3f} ms alone, device "
          f"{txt(d28['restir_vertex_kernel'])}, vertex_bound {b6v[0]:.6f} ms ({b6v[1]}), "
          f"{o6['blocks']} blocks per SM at {o6['registers']} registers and "
          f"{o6['local_bytes']} bytes of local memory; the march's lane use "
          f"{ev.get('march_lane_use', 1.0):.4f}")
    out28["mandelbulb"] = {
        "ms_k6": ms_k6, "bound_ms_k6": b_pass[0], "bound_by_k6": b_pass[1],
        "ms_k4": ms_k4, "device_ms_k4": d28["gbuf_kernel"], "bound_ms_k4": b4[0],
        "bound_by_k4": b4[1], "ms_k6v": ms_k6v, "device_ms_k6v": d28["restir_vertex_kernel"],
        "bound_ms_k6v": b6v[0], "bound_by_k6v": b6v[1],
        "march_lane_use": ev.get("march_lane_use", 1.0)}
    del rad4, gb4, rb, st
    if failed:
        raise AssertionError(f"phase 28 failed: {'; '.join(failed)}")
    return out28


#: K1's medium copy's holds in phase 30: {name: (preset, config changes)},
#: each at 64x64 and at its own depth: the reference's preset 8 as shipped
#: (spectral transport and the medium), spectral alone and the medium alone,
#: and both on an SDF box under MIS and under a photographic cubemap
MEDIUM_HOLDS = {
    "spectral_caustics": ("spectral_caustics", {}),
    "spectral_only": ("spectral_caustics", dict(use_volumetrics=False)),
    "media_only": ("spectral_caustics", dict(use_spectral=False)),
    "mis_demo": ("mis_demo", dict(use_mis=True, use_spectral=True, use_volumetrics=True)),
    "cubemap_demo": ("cubemap_demo", dict(use_spectral=True, use_volumetrics=True)),
}


def medium_phase(torch, dev, card, occ):
    """Phase 30: hero-wavelength spectral transport and the homogeneous
    medium on K1's medium copy.  Returns the figures of the kernels' JSON
    line and raises after printing every failed check."""
    from raytracer0_tpu_torch import rng
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.ops import megakernel, restir_kernel, restir_split, restir_vertex
    from raytracer0_tpu_torch.render import integrator
    from raytracer0_tpu_torch.render.renderer import Renderer, sample_radiance

    counters = ((megakernel, "LAUNCHES"), (megakernel, "BWD_LAUNCHES"),
                (restir_kernel, "LAUNCHES"), (restir_kernel, "BWD_LAUNCHES"),
                (restir_split, "GBUF_LAUNCHES"), (restir_split, "CAST_LAUNCHES"),
                (restir_vertex, "VERTEX_LAUNCHES"))
    plain_trace, plain_calls = integrator.trace, [0]

    def counted_plain(*args, **kw):
        plain_calls[0] += 1
        return plain_trace(*args, **kw)

    def counts():
        return tuple(getattr(m, a) for m, a in counters) + (plain_calls[0],)

    def plain_timed(fn):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        return out, ev0.elapsed_time(ev1)

    failed, out30 = [], {"held": {}}
    # K1's medium copy against the plain version, bit for bit
    for name, (where, kw) in MEDIUM_HOLDS.items():
        sc, cam, cfg = getattr(presets, where)(device=dev)
        cfg = cfg.replace(**kw)
        if megakernel.unsupported(sc, cfg) is not None:
            failed.append(f"{name}: not in K1's class")
            continue
        ro, rd = generate_rays(cam, 64, 64, 0)
        pix = rng.pixel_ids(64, 64, device=dev)
        before = megakernel.LAUNCHES
        got = megakernel.trace_forward(sc, cfg, ro, rd, pix, 0, 0)
        ref, plain_ms = plain_timed(lambda: integrator.trace(sc, cfg, ro, rd, pix, 0, 0))
        n_diff = int((got != ref).any(dim=-1).sum())
        err = (got - ref).abs().max().item()
        launched = megakernel.LAUNCHES - before
        print(f"phase 30: {name} at 64x64, {cfg.max_bounces} bounces (use_spectral "
              f"{cfg.use_spectral}, use_volumetrics {cfg.use_volumetrics}): K1's medium copy "
              f"against the plain version: {n_diff} of 4096 pixels differ, max abs err "
              f"{err:.3e}, {launched} K1 launch; means {got.mean().item():.6f} and "
              f"{ref.mean().item():.6f}; plain version {plain_ms:.1f} ms")
        out30["held"][name] = {"pixels_differing": n_diff, "max_abs_err": err,
                               "plain_ms_64": plain_ms}
        if n_diff or launched != 1 or not bool(torch.isfinite(got).all()) \
                or not ref.max().item() > 0.02:
            failed.append(f"{name}: {n_diff} pixels differ, {launched} launches")

    # the main path, its counts set to 0 just before and read just after
    sc, cam, cfg = presets.spectral_caustics(device=dev)
    for m, a in counters:
        setattr(m, a, 0)
    plain_calls[0] = 0
    integrator.trace = counted_plain
    try:
        img = Renderer(sc, cam, cfg, H, W).render(2)
        torch.cuda.synchronize()
    finally:
        integrator.trace = plain_trace
    launches = counts()
    print(f"phase 30: spectral_caustics: Renderer.render(2) at {H}x{W}, {cfg.max_bounces} "
          f"bounces: launches (K1, K2, K6 passes, K7, K4, K5, K6v, plain calls) {launches}; "
          f"image mean {img.mean().item():.6f}")
    if launches != (2, 0, 0, 0, 0, 0, 0, 0) or not bool(torch.isfinite(img).all()) \
            or not img.mean().item() > 0.01:
        failed.append(f"the main path ran {launches}, or its image is not finite or black")
    out30["launches"] = launches[0]

    # timings at 512x512: the pass, K1 through its wrapper, K1's device time
    # in a fresh process, the plain version; the bound from the path events
    ro, rd = generate_rays(cam, H, W, 0)
    pix = rng.pixel_ids(H, W, device=dev)
    pass30 = time_stats(torch, lambda: sample_radiance(sc, cfg, cam, H, W, 0))
    kept = {}

    def keep(key, fn):
        kept[key] = fn()

    k1_30 = time_stats(torch, lambda: keep("k1", lambda: megakernel.trace_forward(
        sc, cfg, ro, rd, pix, 0, 0)))
    plain30 = statistics.median(
        plain_timed(lambda: keep("plain", lambda: integrator.trace(sc, cfg, ro, rd, pix, 0, 0)))[1]
        for _ in range(3))
    # the main path's shapes held: the last outputs of both timing runs
    got, ref = kept.pop("k1"), kept.pop("plain")
    n_diff = int((got != ref).any(dim=-1).sum())
    err = (got - ref).abs().max().item()
    print(f"phase 30: spectral_caustics at {H}x{W}, {cfg.max_bounces} bounces: K1's medium copy "
          f"against the plain version: {n_diff} of {H * W} pixels differ, max abs err "
          f"{err:.3e}; means {got.mean().item():.6f} and {ref.mean().item():.6f}")
    out30["held"][f"spectral_caustics_{H}"] = {"pixels_differing": n_diff, "max_abs_err": err}
    if n_diff or not bool(torch.isfinite(got).all()):
        failed.append(f"spectral_caustics at {H}x{W}: {n_diff} pixels differ")
    del got, ref
    fresh = subprocess.run(
        [sys.executable, "-c", "import json, torch; from k1_device_time import k1_device_ms; "
         "print(json.dumps(k1_device_ms(('spectral_caustics',), torch.device('cuda', 0))))"],
        capture_output=True, text=True, timeout=600, check=True)
    dev30 = json.loads(fresh.stdout.strip().splitlines()[-1])["spectral_caustics"]
    ev30 = path_events(torch, sc, cfg, ro, rd, pix, 0, 0)
    b30 = bound(ev30, sc, cfg, adjoint=False)
    o30 = occ[("K1 medium", "spectral_caustics")]
    print(f"phase 30: path events of spectral_caustics at {H}x{W}: {json.dumps(ev30)}")
    print(f"phase 30: {card}: spectral_caustics at {H}x{W}, {cfg.max_bounces} bounces: "
          f"sample_radiance pass {pass30[0]:.3f} ms (q1 {pass30[1]:.3f}, q3 {pass30[2]:.3f}; "
          f"median of 7, CUDA events), K1's medium copy through trace_forward "
          f"{k1_30[0]:.3f} ms (q1 {k1_30[1]:.3f}, q3 {k1_30[2]:.3f}), its device time "
          f"{dev30[0]:.5f} ms (k1_device_time.py in a fresh process, rounds "
          f"{[round(x, 5) for x in dev30[1]]}), plain version {plain30:.3f} ms (median of 3); "
          f"bound {b30[0]:.6f} ms ({b30[1]}; {100 * b30[0] / dev30[0]:.2f} % of the device "
          f"time); {o30['blocks']} blocks of 128 per SM at {o30['registers']} registers, "
          f"{o30['local_bytes']} bytes of local memory; lane use {ev30['lane_use']:.4f}")
    out30.update(ms=k1_30[0], pass_ms=pass30[0], pass_quartiles=pass30[1:],
                 device_ms=dev30[0], plain_ms=plain30, bound_ms=b30[0], bound_by=b30[1],
                 events=ev30,
                 blocks_per_sm=o30["blocks"], registers=o30["registers"],
                 local_bytes=o30["local_bytes"])

    # refused before any launch: a gradient w.r.t. a texel array (K2, item
    # 14) and ReSTIR with either flag (item 10)
    before = counts()
    refusals = []
    noise = sc.noise.clone().requires_grad_(True)
    try:
        megakernel.trace_forward(sc.replace(noise=noise), cfg, ro[:16, :16].contiguous(),
                                 rd[:16, :16].contiguous(), rng.pixel_ids(16, 16, device=dev),
                                 0, 0)
        refusals.append("K2 (texels): not refused")
    except NotImplementedError as exc:
        refusals.append(f"K2 (texels): {'item 14' in str(exc)}")
    demo, dcam, dcfg = presets.restir_demo(device=dev)
    for kw in (dict(use_volumetrics=True), dict(use_spectral=True),
               dict(use_volumetrics=True, restir_adhoc_motion=True)):
        try:
            Renderer(demo, dcam, dcfg.replace(**kw), 16, 16).step()
            refusals.append(f"ReSTIR {kw}: not refused")
        except NotImplementedError as exc:
            refusals.append(f"ReSTIR {kw}: {'item 10' in str(exc)}")
    torch.cuda.synchronize()
    print(f"phase 30: refused before any launch, naming item 14 or 10: {refusals}; launch counts "
          f"unchanged: {counts() == before}")
    if not all(r.endswith("True") for r in refusals) or counts() != before:
        failed.append(f"refusals {refusals}, counts {before} -> {counts()}")

    for f in failed:
        print(f"phase 30: FAILED: {f}")
    if failed:
        raise AssertionError(f"phase 30: {len(failed)} checks failed")
    return out30


def medium_grad_phase(torch, dev, card, occ, events):
    """Phase 31: K2's medium copy (`csrc/megakernel_bwd_medium.cu`), the
    adjoint of hero-wavelength spectral transport and the homogeneous
    medium.  `events` are phase 30's path events of preset 8 at 512x512
    (pass 0's rays).  Returns the figures of the kernels' JSON line and
    raises after printing every failed check."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer0_tpu_torch import optimize, rng
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.ops import megakernel, restir_kernel, restir_split, restir_vertex
    from raytracer0_tpu_torch.render import integrator
    from raytracer0_tpu_torch.render.renderer import sample_radiance

    counters = ((megakernel, "LAUNCHES"), (megakernel, "BWD_LAUNCHES"),
                (megakernel, "BWD_MEDIUM_LAUNCHES"), (restir_kernel, "LAUNCHES"),
                (restir_kernel, "BWD_LAUNCHES"), (restir_split, "GBUF_LAUNCHES"),
                (restir_vertex, "VERTEX_LAUNCHES"))
    plain_trace, plain_calls = integrator.trace, [0]

    def counted_plain(*args, **kw):
        plain_calls[0] += 1
        return plain_trace(*args, **kw)

    def counts():
        return tuple(getattr(m, a) for m, a in counters) + (plain_calls[0],)

    def zero_counts():
        for m, a in counters:
            setattr(m, a, 0)
        plain_calls[0] = 0

    failed, out31 = [], {"held": {}}

    # K2's medium copy against the plain autograd at 64x64, each scene at
    # its own depth (preset 8: 12 bounces, where the flint's IOR carries a
    # gradient), arbitrated as phase 6 does; two launches, the same bits
    for name, (where, kw) in MEDIUM_HOLDS.items():
        sc, cam, cfg = getattr(presets, where)(device=dev)
        cfg = cfg.replace(**kw)
        if megakernel.unsupported_bwd(sc, cfg) is not None or \
                megakernel.bwd_copy(sc, cfg) != "medium":
            failed.append(f"{name}: not in K2's medium copy")
            continue
        ro, rd = generate_rays(cam, 64, 64, 0)
        pix = rng.pixel_ids(64, 64, device=dev)
        timed = {}
        grads_of = cached_grads(torch, sc, cfg, ro, rd, pix, timed)
        before = counts()
        out, got = grads_of("kernel", None)
        launched = tuple(a - b for a, b in zip(counts(), before))[:3]
        ref, want = grads_of("plain", None)
        identical = torch.equal(out, ref)
        try:
            errs, left_out, arbitrated, _ = arbitrated_errors(got, want, grads_of)
        except AssertionError as exc:
            failed.append(f"{name}: {exc}")
            print(f"phase 31: FAILED {name}: {exc}")
            continue
        table = megakernel.scene_table(sc)
        ct = torch.rand(ro.shape, generator=torch.Generator(dev).manual_seed(3), device=dev)
        first, second = (megakernel._launch_backward(sc, cfg, table, ro, rd, pix, 0, 0, ct)
                         for _ in range(2))
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        shown = {k: e for k, e in errs.items() if want[k].abs().max().item() > 0.0}
        print(f"phase 31: {name} at 64x64, {cfg.max_bounces} bounces (use_spectral "
              f"{cfg.use_spectral}, use_volumetrics {cfg.use_volumetrics}): K2's medium copy "
              f"against plain autograd, max relative error per leaf (after float64 arbitration:"
              f" {left_out} pixels left out, {arbitrated} entries arbitrated) "
              + ", ".join(f"{k} {e[0]:.2e} ({e[1]:.2e})" for k, e in shown.items())
              + f"; launches (K1, K2, K2 medium) {launched}; K1's radiance the plain version's "
              f"bit for bit: {identical}; the same bits on two launches: {same}; plain "
              f"autograd {timed['plain']:.1f} ms")
        out31["held"][name] = {"max_rel_err": max(e[1] for e in errs.values()),
                               "max_rel_err_raw": max(e[0] for e in errs.values()),
                               "max_abs_err": max((got[k] - want[k]).abs().max().item()
                                                  for k in want),
                               "pixels_left_out": left_out, "entries_arbitrated": arbitrated,
                               "same_bits": same, "plain_fwd_bwd_ms_64": timed["plain"],
                               "ior_gradient": got["ior"].abs().max().item()}
        if launched != (1, 1, 1) or not identical or not same:
            failed.append(f"{name}: launches {launched}, identical {identical}, same {same}")
        if where == "spectral_caustics" and cfg.use_spectral and \
                not got["ior"].abs().max().item() > 0.0:
            failed.append(f"{name}: the flint's IOR carries no gradient")
        del grads_of, first, second
    stamp("phase 31: K2's medium copy held")

    # the main path: optimize.fit of the two lights' emission at 64x64, its
    # counts set to 0 just before and read just after
    sc, cam, cfg = presets.spectral_caustics(device=dev)
    rows = torch.zeros(sc.num_meshes, 1, device=dev)
    rows[[k for k, m in enumerate(sc.mat_types_static) if m == 0]] = 1.0
    fit_steps = 10
    with torch.no_grad():
        target = optimize.render_linear(sc, cfg, cam, 64, 64)
    start = sc.replace(emission=sc.emission * (1.0 - 0.3 * rows))
    zero_counts()
    integrator.trace = counted_plain
    try:
        fitted, losses = optimize.fit(start, cfg, cam, target, ("emission",), steps=fit_steps,
                                      learning_rate=0.05, param_mask={"emission": rows})
        torch.cuda.synchronize()
    finally:
        integrator.trace = plain_trace
    fit_counts = counts()
    print(f"phase 31: optimize.fit of spectral_caustics' two lights' emission at 64x64, "
          f"{fit_steps} steps from 0.7 of it: loss {losses[0]:.6e} -> {losses[-1]:.6e}; "
          f"launches (K1, K2, K2 medium, K6, K7, K4, K6v, plain calls) {fit_counts}")
    if fit_counts != (fit_steps,) * 3 + (0,) * 5 or not losses[-1] < losses[0]:
        failed.append(f"the fit ran {fit_counts}, loss {losses[0]} -> {losses[-1]}")
    out31["fit_launches"] = fit_counts[2]
    out31["fit_losses"] = (losses[0], losses[-1])

    # a fwd+bwd step at 512x512, 12 bounces: d sum(sample_radiance) /
    # d(color, emission, pos, joker, ior), its counts from 0
    leaves31 = ("color", "emission", "pos", "joker", "ior")

    def step():
        lv = {k: getattr(sc, k).detach().clone().requires_grad_(True) for k in leaves31}
        img = sample_radiance(sc.replace(**lv), cfg, cam, H, W, 0)
        return torch.autograd.grad(img.sum(), list(lv.values()))

    zero_counts()
    integrator.trace = counted_plain
    try:
        g = step()
        torch.cuda.synchronize()
    finally:
        integrator.trace = plain_trace
    step_counts = counts()
    finite = all(bool(x.isfinite().all()) for x in g)
    if step_counts != (1, 1, 1) + (0,) * 5 or not finite or not bool((g[4] != 0).any()):
        failed.append(f"the 512x512 step ran {step_counts}, finite {finite}")
    stats = time_stats(torch, step, runs=5, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    d31, tot31 = device_times_ms(prof, ("fwd_kernel_medium", "bwd_wide_kernel", "reduce_kernel"),
                                 per_launch=True)
    # K2 alone on pass 0's rays, ones as the cotangent, as k1_device_time.py
    # times it (key k2_spectral_caustics), and the plain backward at 64x64
    ro, rd = generate_rays(cam, H, W, 0)
    pix = rng.pixel_ids(H, W, device=dev)
    ct = torch.ones((H, W, 3), dtype=torch.float32, device=dev)
    table = megakernel.scene_table(sc)
    k2_ms = time_stats(torch, lambda: megakernel._launch_backward(
        sc, cfg, table, ro, rd, pix, 0, 0, ct), runs=5, warmup=1)
    from k1_device_time import k2_device_ms

    k2_dev = k2_device_ms(dev, ("k2_spectral_caustics",)).get("k2_spectral_caustics", {})
    b31 = bound(events, sc, cfg, adjoint=True)
    o31 = occ[("K2", "spectral_caustics")]
    warp31 = megakernel.bwd_layout(sc, cfg)[0]
    txt = lambda v: "not measured" if v is None else f"{v:.5f} ms"
    dev_ms = k2_dev.get("ms")
    print(f"phase 31: {card}: spectral_caustics at {H}x{W}, {cfg.max_bounces} bounces: a fwd+bwd "
          f"step d sum(sample_radiance) / d({', '.join(leaves31)}) {stats[0]:.3f} ms (q1 "
          f"{stats[1]:.3f}, q3 {stats[2]:.3f}; median and quartiles of 5, CUDA events), launches "
          f"(K1, K2, K2 medium, K6, K7, K4, K6v, plain calls) {step_counts}; device time per "
          f"step (profiler): K1's medium copy {txt(d31['fwd_kernel_medium'])}, K2's "
          f"{txt(d31['bwd_wide_kernel'])}, its reduction {txt(d31['reduce_kernel'])}, all "
          f"kernels {txt(None if tot31 is None else tot31 / 3)}; K2's medium copy alone "
          f"{k2_ms[0]:.3f} ms (q1 {k2_ms[1]:.3f}, q3 {k2_ms[2]:.3f}; CUDA events), device "
          f"{txt(dev_ms)} (k1_device_time.py, rounds "
          f"{[round(x, 5) for x in k2_dev.get('rounds', [])]}); bound {b31[0]:.6f} ms "
          f"({b31[1]}; the forward once and its adjoint, from phase 30's path events)"
          + ("" if dev_ms is None else f", {100 * b31[0] / dev_ms:.2f} % of the device time")
          + f"; {o31['blocks']} blocks of {o31['threads']} per SM at {o31['registers']} "
          f"registers, {o31['local_bytes']} bytes of local memory, a column of cotangents per "
          f"{'warp' if warp31 else 'thread'}")
    plain64 = [v["plain_fwd_bwd_ms_64"] for k, v in out31["held"].items()
               if k == "spectral_caustics"]
    out31.update(step_ms=stats[0], step_quartiles=stats[1:], step_launches=step_counts[:3],
                 ms=k2_ms[0], device_ms=dev_ms, device_ms_in_step=d31["bwd_wide_kernel"],
                 plain_ms=plain64[0] if plain64 else None, bound_ms=b31[0], bound_by=b31[1],
                 registers=o31["registers"], local_bytes=o31["local_bytes"],
                 blocks_per_sm=o31["blocks"], digest_d_table=k2_dev.get("digest_d_table"))

    # refused before any launch: a ReSTIR gradient with the medium (item 10)
    demo, dcam, dcfg = presets.restir_demo(device=dev)
    before = counts()
    try:
        em = demo.emission.clone().requires_grad_(True)
        optimize.render_linear(demo.replace(emission=em), dcfg.replace(use_volumetrics=True),
                               dcam, 16, 16).sum().backward()
        refused = "not refused"
    except NotImplementedError as exc:
        refused = str("item 10" in str(exc))
    torch.cuda.synchronize()
    print(f"phase 31: a ReSTIR gradient with the medium refused before any launch, naming item "
          f"10: {refused}; launch counts unchanged: {counts() == before}")
    if refused != "True" or counts() != before:
        failed.append(f"the ReSTIR gradient with the medium: {refused}")

    for f in failed:
        print(f"phase 31: FAILED: {f}")
    if failed:
        raise AssertionError(f"phase 31: {len(failed)} checks failed")
    return out31


def restir_grad_sdf_phase(torch, dev, card, occ, events=None):
    """Phase 29: K7's whole-SDF copy (`csrc/restir_bwd_sdf.cu`) over the
    scenes of `k7_sdf_scenes`: against the plain autograd over chains of
    passes from an empty ring (the same bits on two launches), a ReSTIR
    fwd+bwd step at 512x512 of `animated_restir` as shipped and of the
    `mandelbulb` ReSTIR view timed with K7's bound, and `optimize.fit`
    through it on the preset.  `events` ({scene: path_events}) holds the
    events of a scene's pass 2 at 512x512 where another phase counted them
    (phase 28: the `mandelbulb` view's).  Returns the figures of the
    kernels' JSON line and raises after printing every failed
    comparison."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer0_tpu_torch import optimize, rng
    from raytracer0_tpu_torch.models import scene as scene_mod
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.ops import megakernel, restir, restir_kernel, restir_split
    from raytracer0_tpu_torch.render.renderer import render_pass
    from raytracer0_tpu_torch.render.state import RenderState

    names = ("K6", "K7", "K7 whole-SDF", "K1", "K2", "K5")

    def counts():
        return (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES,
                restir_kernel.BWD_SDF_LAUNCHES, megakernel.LAUNCHES, megakernel.BWD_LAUNCHES,
                restir_split.CAST_LAUNCHES)

    def zero_counts():
        restir_kernel.LAUNCHES = restir_kernel.BWD_LAUNCHES = restir_kernel.BWD_SDF_LAUNCHES = 0
        megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = restir_split.CAST_LAUNCHES = 0

    def chain(trace, sc, cfg, cam, size, passes, t):
        """(loss, {leaf: gradient, "ro"/"rd": every pass's}) of seeded
        weights on each pass's radiance and on the last ring's float fields,
        over `passes` passes from an empty ring at the frame time t, every
        scene-table leaf a leaf
        (tests/test_torch_kernel_host_restir_sdf.py::chain_grads)."""
        leaves = {k: getattr(sc, k).detach().clone().requires_grad_(True) for k in TABLE_LEAVES}
        s = scene_mod.animate_positions(sc.replace(**leaves), t, int(cfg.render_mode))
        state = RenderState.create(size, size, device=dev)
        pix = rng.pixel_ids(size, size, device=dev)
        gen = torch.Generator(dev).manual_seed(5)
        weights = lambda shape: torch.rand(shape, generator=gen, device=dev) + 0.5
        loss, rays = 0.0, []
        for p in range(passes):
            ro, rd = generate_rays(cam, size, size, p)
            rays += [ro.detach().requires_grad_(True), rd.detach().requires_grad_(True)]
            rad, new = trace(s, cfg, rays[-2], rays[-1], pix, p, 0, state.restir_back,
                             state.restir_hist1, state.restir_hist2)
            loss = loss + (rad * weights(rad.shape)).sum()
            state = state.rotate_reservoirs(new)
        for k in restir_kernel.RING_FLOATS:
            loss = loss + (getattr(state.restir_back, k) * weights((size, size))).sum() * 0.1
        got = torch.autograd.grad(loss, list(leaves.values()) + rays, allow_unused=True)
        out = {k: torch.zeros_like(leaves[k]) if g is None else g
               for k, g in zip(TABLE_LEAVES, got)}
        n = len(TABLE_LEAVES)
        out["ro"], out["rd"] = torch.stack(got[n::2]), torch.stack(got[n + 1::2])
        return loss.detach().item(), out

    def errors(got, want):
        """Per leaf (max|a - b| / max|b|, max|a - b|); inf where the kernel's
        gradient is not finite."""
        out = {}
        for k, b in want.items():
            a = got[k]
            diff = (a - b).abs().max().item() if bool(a.isfinite().all()) else float("inf")
            out[k] = (diff / max(b.abs().max().item(), 1e-12), diff)
        return out

    failed, out29 = [], {"held": {}}
    scenes = k7_sdf_scenes(dev)
    for name in scenes:
        o = occ[("K7 whole-SDF", name)]
        print(f"phase 29: K7's whole-SDF copy on {name} ({scenes[name][0].num_meshes} meshes, "
              f"{len(restir_kernel.bwd_columns(scenes[name][0]))} columns a mesh): "
              f"{o['blocks']} blocks of {o['threads']} threads per SM at {o['registers']} "
              f"registers, {o['local_bytes']} bytes of local memory, {o['smem']} bytes of shared "
              f"memory")

    # the holds: K7 against the plain autograd over passes from an empty
    # ring at 32x32, each scene at its own depth: 4 passes on the preset as
    # shipped, 2 on its STATIC twin, `polygons` and `textured_cornell` (the
    # ring's reuse from pass to pass), 1 on the scenes whose plain passes
    # take 4-35 s each (their launches, not their pixels): the `mandelbulb`
    # view (12 bounces, 128 marching steps), `every_shape` and
    # `textured_restir_demo`
    hs = 32
    passes_of = {"mandelbulb": 1, "every_shape": 1, "textured_restir_demo": 1,
                 "animated_restir_static": 2, "polygons": 2, "textured_cornell": 2}
    for name, (sc, cam, c) in scenes.items():
        passes = passes_of.get(name, 4)
        t = 0.5 if int(c.render_mode) else 0.0   # a constant frame time under ANIMATED
        before = counts()
        loss_k, got = chain(restir_kernel._fused, sc, c, cam, hs, passes, t)
        torch.cuda.synchronize()
        n = tuple(a - b for a, b in zip(counts(), before))
        _, again = chain(restir_kernel._fused, sc, c, cam, hs, passes, t)
        same = all(torch.equal(got[k], again[k]) for k in got)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        loss_p, want = chain(restir.trace_sample, sc, c, cam, hs, passes, t)
        ev1.record()
        torch.cuda.synchronize()
        plain_ms = ev0.elapsed_time(ev1) / passes
        errs = errors(got, want)
        worst = max(e[0] for e in errs.values())
        engaged = [k for k in TABLE_LEAVES + ("ro", "rd") if want[k].abs().max().item() > 0.0]
        print(f"phase 29: K7's whole-SDF copy on {name} ({c.max_bounces} bounces, "
              f"{c.marching_steps} marching steps) at {hs}x{hs}, passes 0-{passes - 1}, against "
              f"the plain autograd: worst relative error {worst:.3e}; per leaf "
              f"{ {k: f'{e[0]:.2e}' for k, e in errs.items()} }; loss {loss_k:.6f} vs "
              f"{loss_p:.6f}; same bits on two launches: {same}; launches "
              f"{dict(zip(names, n))}; leaves with a gradient {engaged}; plain autograd "
              f"{plain_ms:.1f} ms per pass")
        if (worst >= GRAD_TOL or not same or abs(loss_k - loss_p) > 1e-5 * abs(loss_p)
                or n != (passes,) * 3 + (0, 0, 0)):
            failed.append(f"the hold on {name}")
        out29["held"][name] = {"max_rel_err": worst, "max_abs_err": max(e[1] for e in errs.values()),
                               "same_bits": same, "plain_ms_per_pass": plain_ms, "size": hs,
                               "bounces": c.max_bounces, "marching_steps": c.marching_steps}
        stamp(f"phase 29: K7 held on {name}")

    # a ReSTIR fwd+bwd step at full size: the preset as shipped, the mandelbulb view
    step_passes = 2
    out29["step"] = {}
    for name in ("animated_restir", "mandelbulb"):
        sc, cam, cfg = scenes[name]

        def fwd_bwd(sc=sc, cam=cam, cfg=cfg):
            lv = {k: getattr(sc, k).detach().clone().requires_grad_(True)
                  for k in ("emission", "color")}
            img = optimize.render_linear(sc.replace(**lv), cfg, cam, H, W, passes=step_passes)
            return torch.autograd.grad(img.sum(), list(lv.values()))

        zero_counts()   # the main path: counts from 0 just before, read just after
        fwd_bwd()
        torch.cuda.synchronize()
        got = counts()
        stats = time_stats(torch, fwd_bwd, runs=5, warmup=1)
        # K7 alone, its three kernels, on the ring two passes leave
        frame = scene_mod.animate_positions(sc, 0.0, int(cfg.render_mode))
        st = RenderState.create(H, W, device=dev)
        with torch.no_grad():
            for _ in range(2):
                st = render_pass(sc, cam, cfg, st, H, W)
        ro, rd = generate_rays(cam, H, W, 2)
        pix = rng.pixel_ids(H, W, device=dev)
        grids = (st.restir_back, st.restir_hist1, st.restir_hist2)
        ct = torch.ones((H, W, 3), dtype=torch.float32, device=dev)
        ct_res = [torch.ones((H, W), dtype=torch.float32, device=dev) for _ in range(4)]
        table = megakernel.scene_table(frame)
        k7 = lambda: restir_kernel._launch_backward(frame, cfg, table, ro, rd, pix, 2, 0, grids,
                                                    ct, ct_res)
        ms_k7 = time_ms(torch, k7, runs=5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                k7()
            torch.cuda.synchronize()
        d29, _ = device_times_ms(prof, ("restir_bwd_kernel", "tap_gather_kernel",
                                        "restir_reduce_kernel"), per_launch=True)
        dev_ms = None if d29["restir_bwd_kernel"] is None else sum(d29.values())
        ev = (events or {}).get(name) or path_events(torch, frame, cfg, ro, rd, pix, 2, 0,
                                                     ring=st)
        b = bound(ev, frame, cfg, adjoint=True, restir=True, sdf_adjoint=True)
        o = occ[("K7 whole-SDF", name)]
        txt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        print(f"phase 29: {card}: {name} at {H}x{W} ({cfg.max_bounces} bounces, "
              f"{cfg.marching_steps} marching steps): a ReSTIR fwd+bwd step "
              f"(render_linear, passes={step_passes}) {stats[0]:.3f} ms (q1 {stats[1]:.3f}, q3 "
              f"{stats[2]:.3f}; CUDA events), launches per step {dict(zip(names, got))}; K7's "
              f"whole-SDF copy alone {ms_k7:.3f} ms per launch (CUDA events), device "
              f"{txt(dev_ms)} per launch (profiler: adjoint {txt(d29['restir_bwd_kernel'])}, tap "
              f"gather {txt(d29['tap_gather_kernel'])}, reduction "
              f"{txt(d29['restir_reduce_kernel'])}); bound {b[0]:.6f} ms ({b[1]}); "
              f"{o['blocks']} blocks of {o['threads']} threads per SM at {o['registers']} "
              f"registers and {o['local_bytes']} bytes of local memory")
        if got != (step_passes,) * 3 + (0, 0, 0):
            failed.append(f"the 512x512 step of {name} did not run through K6 and K7's "
                          "whole-SDF copy alone")
        out29["step"][name] = {"step_ms": stats[0], "step_quartiles": stats[1:],
                               "launches": got[2], "ms": ms_k7, "device_ms": dev_ms,
                               "device_ms_by_kernel": d29, "bound_ms": b[0], "bound_by": b[1],
                               "registers": o["registers"], "local_bytes": o["local_bytes"],
                               "blocks_per_sm": o["blocks"], "threads": o["threads"]}
        del st, grids, frame
        stamp(f"phase 29: the 512x512 step of {name} timed")

    # optimize.fit through it on the preset as shipped: the METAL rounded
    # box's color (its METAL texel blends into its emission, the
    # glossiness) and the lights' emission, toward the shipped values
    sc, cam, cfg = scenes["animated_restir"]
    fit_size, fit_steps, fit_passes = 128, 6, 2
    with torch.no_grad():
        target = optimize.render_linear(sc, cfg, cam, fit_size, fit_size, passes=fit_passes)
    is_light = (sc.mat_type == 0).float()[:, None]
    box = torch.zeros_like(is_light)
    box[-1] = 1.0   # row 17, the METAL ROUND_BOX
    start = sc.replace(emission=sc.emission * (1.0 + 0.6 * is_light),
                       color=sc.color * (1.0 - 0.4 * box))
    zero_counts()   # the main path: counts from 0 just before, read just after
    fitted, losses = optimize.fit(start, cfg, cam, target, ("emission", "color"),
                                  steps=fit_steps, learning_rate=0.08, passes=fit_passes,
                                  param_mask={"emission": is_light, "color": box})
    torch.cuda.synchronize()
    got = counts()
    print(f"phase 29: optimize.fit of animated_restir as shipped at {fit_size}x{fit_size}, "
          f"passes={fit_passes}, {fit_steps} steps (the lights' emission from 1.6x, the METAL "
          f"box's color from 0.6x): loss {losses[0]:.6f} -> {losses[-1]:.6f}, the box's color "
          f"{[round(v, 4) for v in fitted.color[-1].tolist()]} (truth "
          f"{[round(v, 4) for v in sc.color[-1].tolist()]}); launches {dict(zip(names, got))}")
    want = fit_steps * fit_passes
    if got != (want, want, want, 0, 0, 0) or not losses[-1] < losses[0]:
        failed.append("the fit did not lower the loss through K6 and K7's whole-SDF copy alone")
    out29["fit_launches"] = got[2]
    out29["fit_losses"] = (losses[0], losses[-1])
    if failed:
        raise AssertionError(f"phase 29 failed: {'; '.join(failed)}")
    return out29


def main() -> int:
    import time

    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    try:
        from raytracer0_tpu_torch import optimize, rng
        from raytracer0_tpu_torch.models.camera import generate_rays
        from raytracer0_tpu_torch.models.materials import MeshType, SdfShape
        from raytracer0_tpu_torch.models.presets import cornell_default, cubemap_demo
        from raytracer0_tpu_torch.ops import bsdf, intersect, sky
        from raytracer0_tpu_torch.ops import megakernel
        from raytracer0_tpu_torch.render import integrator
        from raytracer0_tpu_torch.models import presets
        from raytracer0_tpu_torch.models import scene as scene_mod
        from raytracer0_tpu_torch.ops import restir, restir_kernel, restir_split, restir_vertex
        from raytracer0_tpu_torch.render.renderer import Renderer, render_pass, sample_radiance
        from raytracer0_tpu_torch.render.state import RESERVOIR_FIELDS, RenderState
        from k1_device_time import (K1_COPIES, K2_COPIES, k1_device_ms, k2_device_ms,
                                    ptxas_functions)
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2

    # ---- phase 1: the card ----
    stamp("phase 1 starts (the card)")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"phase 1: {torch.cuda.device_count()} CUDA device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card)

    # ---- phase 2: build the six kernels at once (K2 in three libraries, K7 in two) ----
    stamp("phase 2 starts (build the six kernels at once (K2 in three libraries, K7 in two))")
    # the longest builds first: nvcc takes minutes for K2's and K7's copies
    with concurrent.futures.ThreadPoolExecutor(9) as pool:
        builds = [pool.submit(megakernel.build), pool.submit(megakernel.build_bwd),
                  pool.submit(restir_vertex.build), pool.submit(restir_kernel.build_bwd),
                  pool.submit(restir_split.build_gbuffer), pool.submit(restir_split.build_cast),
                  pool.submit(megakernel.build_bwd_sdf), pool.submit(restir_kernel.build_bwd_sdf),
                  pool.submit(megakernel.build_bwd_medium)]
        infos = [f.result()[1] for f in builds]
    for name, info in zip(("K1", "K2", "K6v", "K7", "K4", "K5", "K2 whole-SDF", "K7 whole-SDF",
                           "K2 medium"), infos):
        print(f"phase 2: {name} build {info.seconds:.2f} s, cache "
              f"{'hit' if info.cache_hit else 'miss'}, {info.path}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                print(f"phase 2: {name} ptxas: {line.strip()}")
    occ = kernel_occupancy(dev)
    for (name, where), o in occ.items():
        print(f"phase 2: {name} on {where}: {o['blocks']} blocks of {o['threads']} threads, "
              f"{o['warps']} warps per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at "
              f"{o['smem']} bytes of dynamic shared memory, {o['registers']} registers and "
              f"{o['local_bytes']} bytes of local memory per thread")
    # K1's copies by their kernel's name; the old copies keep the lines they
    # had before the medium copy came (K1_PTXAS: the parent's, PERF.md §6)
    k1_fns = ptxas_functions(infos[0].log)
    for copy, tag in K1_COPIES.items():
        line = [v for k, v in k1_fns.items() if tag in k]
        line = line[0] if line else None
        held1 = K1_PTXAS.get(copy)
        print(f"phase 2: K1 ptxas, its {copy} copy: {line}"
              + ("" if held1 is None else f"; as before the medium copy: {line == held1}"))
        if held1 is not None and line != held1:
            raise AssertionError(f"K1's {copy} copy moved: {line}, expected {held1}")
    o1 = occ[("K1", "cornell_default")]
    print(f"phase 2: K1 on Cornell at {H}x{W}: one pixel per thread, a grid of "
          f"{-(-H * W // 128)} blocks of 128, {o1['blocks']} blocks per SM at {o1['registers']} "
          f"registers ({o1['local_bytes']} bytes of local memory)")
    for where in ("restir_demo", "animated_untextured"):
        o4 = occ[("K4", where)]
        grid = restir_split.resident_blocks(dev, True, o4["smem"])
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        print(f"phase 2: K4 on {where}: a persistent grid of {grid} blocks of 128 "
              f"({o4['blocks']} blocks per SM x {sms} SMs) at {o4['registers']} registers "
              f"({o4['local_bytes']} bytes of local memory); {-(-H * W // 128)} blocks of pixels "
              f"at {H}x{W}")
    k2_fns = {**ptxas_functions(infos[1].log), **ptxas_functions(infos[6].log),
              **ptxas_functions(infos[8].log)}
    k2_ptxas = {}
    for copy, tag in K2_COPIES.items():
        line = [v for k, v in k2_fns.items() if tag in k]
        k2_ptxas[copy] = line[0] if line else None
        print(f"phase 2: K2 ptxas, its {copy} copy: {k2_ptxas[copy]}")
    for name, line in k2_fns.items():
        if not any(tag in name for tag in K2_COPIES.values()):
            print(f"phase 2: K2 ptxas, {name}: {line}")
    for where, (sc, c2) in k2_cases(dev).items():
        o2 = occ[("K2", where)]
        warp2 = megakernel.bwd_layout(sc, c2)[0]
        copy2 = {"cornell": "Cornell", "wide": "wide", "whole_sdf": "whole-SDF",
                 "medium": "medium"}[megakernel.bwd_copy(sc, c2)]
        print(f"phase 2: K2 on {where} ({sc.num_meshes} meshes, its {copy2} copy, "
              f"{len(megakernel.bwd_columns(sc, c2))} columns a mesh): {o2['registers']} "
              f"registers, {o2['local_bytes']} bytes of local memory per thread, {o2['smem']} "
              f"bytes of shared memory a block of {o2['threads']} (a column of cotangent "
              f"accumulators per {'warp' if warp2 else 'thread'}), {o2['blocks']} blocks per SM")
        if not warp2 and o2["blocks"] < 3:
            raise AssertionError("K2 keeps a column per thread where it fits < 3 blocks per SM")
    # the Cornell and wide copies keep the lines they had before the
    # whole-SDF copy came (PERF.md §6)
    held = {("K2", "cornell_default"): (128, 928), ("K2", "mis_demo"): (128, 2160),
            ("K2", "many_meshes_uniform"): (64, 2464)}
    for key, want2 in held.items():
        got2 = (occ[key]["registers"], occ[key]["local_bytes"])
        print(f"phase 2: K2 on {key[1]} keeps its {want2[0]} registers and {want2[1]} bytes "
              f"of local memory: {got2 == want2}")
        if got2 != want2:
            raise AssertionError(f"K2's copy on {key[1]} moved: {got2}, expected {want2}")
    o7 = occ[("K7", "restir_demo")]
    k7_fns = {**ptxas_functions(infos[3].log), **ptxas_functions(infos[7].log)}
    k7_ptxas = {}
    for copy, tag in (("ROUND_BOX", "restir_bwd_kernelILb0E"),
                      ("whole-SDF", "restir_bwd_kernelILb1E")):
        line = [v for k, v in k7_fns.items() if tag in k]
        k7_ptxas[copy] = line[0] if line else None
        print(f"phase 2: K7 ptxas, its {copy} copy: {k7_ptxas[copy]}")
    print(f"phase 2: K7's ROUND_BOX copy keeps its 168 registers and 1,328-byte stack: "
          f"{(o7['registers'], o7['local_bytes']) == (168, 1328)}")
    if (o7["registers"], o7["local_bytes"]) != (168, 1328):
        raise AssertionError("K7's ROUND_BOX copy moved with the whole-SDF copy's template")
    # K4's and K6v's copies by the template instance of their kernels; the
    # old copies keep the lines they had before the whole-SDF copies came
    # (80 registers and a 56-byte stack, 20-28 bytes spilled; 64 and 72
    # registers and a 32-byte stack: PERF.md §6)
    for name, info, tags in (
            ("K4", infos[4], {"gbuf_kernelILb0ELb0E": "no SDF", "gbuf_kernelILb1ELb0E": "SDF",
                              "gbuf_kernelILb1ELb1E": "whole-SDF"}),
            ("K6v", infos[2], {"restir_vertex_kernelILb0ELb0E": "fused",
                               "restir_vertex_kernelILb1ELb0E": "split",
                               "restir_vertex_kernelILb0ELb1E": "fused whole-SDF",
                               "restir_vertex_kernelILb1ELb1E": "split whole-SDF"})):
        fns = ptxas_functions(info.log)
        for tag, copy in tags.items():
            line = [v for k, v in fns.items() if tag in k]
            print(f"phase 2: {name} ptxas, its {copy} copy: {line[0] if line else None}")
    held = {("K4", "restir_demo"): (80, 56), ("K6v", "restir_demo"): (64, 32),
            ("K6v split", "animated_untextured"): (72, 32)}
    for key, want2 in held.items():
        got2 = (occ[key]["registers"], occ[key]["local_bytes"])
        print(f"phase 2: {key[0]} on {key[1]} keeps its {want2[0]} registers and {want2[1]} "
              f"bytes of local memory: {got2 == want2}")
        if got2 != want2:
            raise AssertionError(f"{key[0]}'s copy on {key[1]} moved: {got2}, expected {want2}")

    scene, cam, cfg = cornell_default(device=dev, use_mis=True)

    def rays(h, w, pass_idx):
        ro, rd = generate_rays(cam, h, w, pass_idx)
        return ro, rd, rng.pixel_ids(h, w, device=dev)

    # ---- phase 3: K1 against its plain version ----
    stamp("phase 3 starts (K1 against its plain version)")
    small = cfg.replace(max_bounces=3)
    ro, rd, pix = rays(16, 128, 0)
    out = megakernel.trace_forward(scene, small, ro, rd, pix, 0, 0)
    ref = integrator.trace(scene, small, ro, rd, pix, 0, 0)
    torch.cuda.synchronize()
    compare("16x128, 3 bounces", out, ref, PARITY_TOL, PARITY_FRAC)

    ro, rd, pix = rays(H, W, 0)
    out = megakernel.trace_forward(scene, cfg, ro, rd, pix, 0, 0)
    ref = integrator.trace(scene, cfg, ro, rd, pix, 0, 0)
    torch.cuda.synchronize()
    max_abs_err = compare(f"{H}x{W}, {cfg.max_bounces} bounces", out, ref,
                          GOLDEN_TOL, GOLDEN_FRAC)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("K1 output is not finite")
    del out, ref

    # ---- phase 4: the render main path ----
    stamp("phase 4 starts (the render main path)")
    megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = 0
    renderer = Renderer(scene, cam, cfg, H, W)
    img = renderer.render(PASSES)
    torch.cuda.synchronize()
    launches, bwd_render = megakernel.LAUNCHES, megakernel.BWD_LAUNCHES
    print(f"phase 4: Renderer.render({PASSES}) at {H}x{W}: {launches} K1 launches, "
          f"{bwd_render} K2 launches")
    if launches != PASSES or bwd_render != 0:
        raise AssertionError(f"expected {PASSES} K1 and 0 K2 launches, saw "
                             f"{launches} and {bwd_render}")
    if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"image is not finite f32[{H},{W},3]")
    mean = img.mean().item()
    mid = img[H * 2 // 5:H * 3 // 5]
    left = mid[:, :W // 20].mean(dim=(0, 1)).tolist()    # red wall (x = -1.5)
    right = mid[:, -W // 20:].mean(dim=(0, 1)).tolist()  # green wall (x = +1.5)
    print(f"phase 4: image mean {mean:.4f}, left wall RGB "
          f"{[round(v, 4) for v in left]}, right wall RGB {[round(v, 4) for v in right]}")
    if not mean > 0.05:
        raise AssertionError("image is black")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError("walls do not show red (left) and green (right)")

    # ---- phase 5: time per pass, K1 and the plain version ----
    stamp("phase 5 starts (time per pass, K1 and the plain version)")
    def plain_pass():
        ro, rd = generate_rays(cam, H, W, 0)
        return integrator.trace(scene, cfg, ro, rd, pix, 0, 0)

    ms_trace = time_ms(torch, lambda: megakernel.trace_forward(
        scene, cfg, ro, rd, pix, 0, 0))
    plain_ms_trace = time_ms(torch, lambda: integrator.trace(
        scene, cfg, ro, rd, pix, 0, 0))
    ms_pass = time_ms(torch, lambda: sample_radiance(scene, cfg, cam, H, W, 0))
    plain_ms_pass = time_ms(torch, plain_pass)
    ms_rays = time_ms(torch, lambda: generate_rays(cam, H, W, 0))
    rays_per_pass = H * W * cfg.max_bounces   # bench.py:396
    print(f"phase 5: {card}: sample_radiance at {H}x{W}, {cfg.max_bounces} bounces: "
          f"K1 {ms_pass:.3f} ms/pass ({rays_per_pass / ms_pass / 1e3:.1f} Mrays/s), "
          f"plain {plain_ms_pass:.3f} ms/pass ({rays_per_pass / plain_ms_pass / 1e3:.1f} Mrays/s)")
    print(f"phase 5: {card}: trace alone: K1 {ms_trace:.3f} ms, plain "
          f"{plain_ms_trace:.3f} ms; generate_rays alone {ms_rays:.3f} ms")
    ev = path_events(torch, scene, cfg, ro, rd, pix, 0, 0)
    k1_bound, k1_by = bound(ev, scene, cfg, adjoint=False)
    k2_bound, k2_by = bound(ev, scene, cfg, adjoint=True)
    print(f"phase 5: path events at {H}x{W}: {json.dumps(ev)}")
    print(f"phase 5: bound K1 {k1_bound:.6f} ms ({k1_by}), K2 {k2_bound:.6f} ms ({k2_by})")
    print(f"phase 5: {card}: K1 {ms_trace:.3f} ms on Cornell beside its bounce loop's warp lane "
          f"use {ev['lane_use']:.4f} (plain replay, 32 pixels a warp, one pixel per thread)")

    # ---- phase 6: K2 against the plain version's autograd ----
    stamp("phase 6 starts (K2 against the plain version's autograd)")
    for h, w, kw in ADJ_CONFIGS:
        c6 = cfg.replace(**kw)
        ro6, rd6, pix6 = rays(h, w, 2)
        before = megakernel.BWD_LAUNCHES
        got = grads(torch, megakernel.trace_forward, scene, c6, ro6, rd6, pix6)
        torch.cuda.synchronize()
        if megakernel.BWD_LAUNCHES != before + 1:
            raise AssertionError("expected one K2 launch per backward")
        errs = grad_errors(got, grads(torch, integrator.trace, scene, c6, ro6, rd6, pix6))
        worst = max(e[0] for e in errs.values())
        print(f"phase 6: {h}x{w} {kw}: max relative error per leaf "
              + ", ".join(f"{k} {e[0]:.2e}" for k, e in errs.items()))
        if worst >= GRAD_TOL:
            raise AssertionError(f"K2 disagrees with plain autograd at {h}x{w} {kw}: {worst:.3e}")
    got = grads(torch, megakernel.trace_forward, scene, cfg, ro, rd, pix, 0)
    want = grads(torch, integrator.trace, scene, cfg, ro, rd, pix, 0)
    torch.cuda.synchronize()
    errs = grad_errors(got, want)
    k2_rel = max(e[0] for e in errs.values())
    k2_abs = max(e[1] for e in errs.values())
    print(f"phase 6: {H}x{W}, {cfg.max_bounces} bounces: max relative error per leaf "
          + ", ".join(f"{k} {e[0]:.2e}" for k, e in errs.items())
          + f"; max abs error {k2_abs:.3e}")
    if k2_rel >= GRAD_TOL_FULL:
        raise AssertionError(f"K2 disagrees with plain autograd at {H}x{W}: {k2_rel:.3e}")
    del got, want
    # the 47-mesh scene (41 sphere lights), in 128-thread blocks
    many, many_cam, many_cfg = presets.many_lights(device=dev)
    hm, wm = 64, 128
    rom, rdm = generate_rays(many_cam, hm, wm, 2)
    pixm = rng.pixel_ids(hm, wm, device=dev)
    before = megakernel.BWD_LAUNCHES
    got = grads(torch, megakernel.trace_forward, many, many_cfg, rom, rdm, pixm)
    torch.cuda.synchronize()
    if megakernel.BWD_LAUNCHES != before + 1:
        raise AssertionError("expected one K2 launch per backward")
    errs = grad_errors(got, grads(torch, integrator.trace, many, many_cfg, rom, rdm, pixm))
    k2_many_rel = max(e[0] for e in errs.values())
    print(f"phase 6: the {many.num_meshes}-mesh scene at {hm}x{wm}, {many_cfg.max_bounces} "
          f"bounces: max relative error per leaf "
          + ", ".join(f"{k} {e[0]:.2e}" for k, e in errs.items()))
    if k2_many_rel >= GRAD_TOL:
        raise AssertionError(f"K2 disagrees with plain autograd on the many-mesh scene: "
                             f"{k2_many_rel:.3e}")
    del got, errs
    # two launches on the same inputs give the same bits
    for where, sc, cam6, c6 in (("cornell_default", scene, cam, cfg),
                                ("many_meshes", many, many_cam, many_cfg)):
        ro6, rd6 = generate_rays(cam6, H, W, 0)
        ct6 = torch.rand((H, W, 3), generator=torch.Generator(dev).manual_seed(3), device=dev)
        runs = [megakernel._launch_backward(sc, c6, megakernel.scene_table(sc), ro6, rd6, pix,
                                            0, 0, ct6) for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"phase 6: K2 on {where} at {H}x{W}: two launches give the same d_table, d_ro and "
              f"d_rd bits: {same}")
        if not same:
            raise AssertionError(f"K2 is not deterministic on {where}")
    del runs
    # the wide copy, on each scene class K2 covers beyond Cornell: the
    # gradient against the plain version's autograd, K2 alone timed, its bound
    sun, sun_cam = sun_scene(dev)
    wide_cases = {name: getattr(presets, name)(device=dev) for name in
                  ("config2", "mis_demo", "cornell_box", "textured_gloss", "cubemap_demo",
                   "textured_cornell", "textured_emitter")}
    wide_cases["dir"] = (sun, sun_cam, cfg.replace(use_mis=False))
    wide_cases["cornell_uniform"] = (scene, cam, cfg.replace(use_biased_sampling=False))
    k2_wide = {}
    for name, (sw, cw, cfgw) in wide_cases.items():
        if megakernel.unsupported_bwd(sw, cfgw) is not None or megakernel.cornell_copy(sw, cfgw):
            raise AssertionError(f"{name}: expected in K2's wide copy")
        row, rdw = generate_rays(cw, H, W, 0)
        before = megakernel.BWD_LAUNCHES
        _, got = table_grads(torch, megakernel.trace_forward, sw, cfgw, row, rdw, pix, 0)
        torch.cuda.synchronize()
        if megakernel.BWD_LAUNCHES != before + 1:
            raise AssertionError("expected one K2 launch per backward")
        _, want = table_grads(torch, integrator.trace, sw, cfgw, row, rdw, pix, 0)
        errs, left_out, arbitrated, _ = arbitrated_errors(got, want, lambda kind, mask: table_grads(
            torch, megakernel.trace_forward if kind == "kernel" else integrator.trace, sw, cfgw,
            row, rdw, pix, 0, torch.float64 if kind == "plain64" else None, mask))
        rel, raw = max(e[1] for e in errs.values()), max(e[0] for e in errs.values())
        print(f"phase 6: {name} {H}x{W}, {cfgw.max_bounces} bounces, K2's wide copy: max "
              "relative error per leaf against plain autograd (after float64 arbitration on "
              f"the pixels whose float32 and float64 radiances agree: {left_out} pixels left "
              f"out, {arbitrated} entries arbitrated) "
              + ", ".join(f"{k} {e[0]:.2e} ({e[1]:.2e})" for k, e in errs.items()
                          if want[k].abs().max().item() > 0.0))
        if rel >= GRAD_TOL:
            raise AssertionError(f"K2 disagrees with plain autograd on {name}: {rel:.3e}")
        del got, want
        ctw = torch.ones((H, W, 3), dtype=torch.float32, device=dev)
        tablew = megakernel.scene_table(sw)
        ms_w = time_ms(torch, lambda: megakernel._launch_backward(
            sw, cfgw, tablew, row, rdw, pix, 0, 0, ctw))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                megakernel._launch_backward(sw, cfgw, tablew, row, rdw, pix, 0, 0, ctw)
            torch.cuda.synchronize()
        dev_w, _ = device_times_ms(prof, ("bwd_wide_kernel",))
        dev_w = None if dev_w["bwd_wide_kernel"] is None else dev_w["bwd_wide_kernel"] / 3
        evw = path_events(torch, sw, cfgw, row, rdw, pix, 0, 0)
        bound_w, by_w = bound(evw, sw, cfgw, adjoint=True)
        k2_wide[name] = {"max_rel_err": rel, "max_rel_err_raw": raw,
                         "pixels_left_out": left_out, "entries_arbitrated": arbitrated, "ms": ms_w,
                         "device_ms": dev_w, "bound_ms": bound_w, "bound_by": by_w}
        print(f"phase 6: {card}: K2 on {name} at {H}x{W}: {ms_w:.3f} ms (device "
              + ("not measured" if dev_w is None else f"{dev_w:.4f} ms")
              + f", profiler); bound {bound_w:.6f} ms ({by_w})")

    # ---- phase 7: K2 against finite differences of K1 ----
    stamp("phase 7 starts (K2 against finite differences of K1)")
    fd_size = 128
    light = scene.lights_static[0]
    wall = 3   # MAT_CORNELL_RED, the plane at x = +1.5
    for name, row, step in (("emission", light, 1e-2), ("color", wall, 1e-2)):
        base = getattr(scene, name)
        leaf = base.detach().clone().requires_grad_(True)
        out = sample_radiance(scene.replace(**{name: leaf}), cfg, cam, fd_size, fd_size, 0)
        ad = torch.autograd.grad(out.sum(), leaf)[0][row].sum().item()
        sums = []
        for sign in (1.0, -1.0):
            moved = base.clone()
            moved[row] += sign * step
            with torch.no_grad():
                img = sample_radiance(scene.replace(**{name: moved}), cfg, cam,
                                      fd_size, fd_size, 0)
            sums.append(img.double().sum().item())
        fd = (sums[0] - sums[1]) / (2.0 * step)
        rel = abs(ad - fd) / max(abs(fd), 1e-6)
        print(f"phase 7: d sum / d {name}[{row}] at {fd_size}x{fd_size}, "
              f"{cfg.max_bounces} bounces: K2 {ad:.6f}, K1 central difference "
              f"{fd:.6f}, relative error {rel:.2e}")
        if not rel < FD_TOL:
            raise AssertionError(f"K2 disagrees with finite differences of K1 ({name})")

    # the wide copy: d sum / d config 2's glass IOR, and d sum / d
    # mis_demo's SDF box height, against central differences of K1 on the
    # pixels where K1's radiance is linear in the parameter (the difference
    # over the step is twice the one over half the step, within 10 %): a
    # pixel whose path flips a discrete decision between the two renders
    # (a Fresnel choice, a shadow ray's hit) carries a boundary term that
    # the detached-decision gradient of the plain version and of JAX leaves
    # out by design
    def masked_fd(sc, c7, cm7, leaf, row, comp, step, size):
        base = getattr(sc, leaf)
        index = row if comp is None else (row, comp)

        def render(delta):
            moved = base.clone()
            moved[index] += delta
            with torch.no_grad():
                return sample_radiance(sc.replace(**{leaf: moved}), c7, cm7, size, size,
                                       0).double()

        d1, d2 = render(step) - render(-step), render(step / 2) - render(-step / 2)
        lin = ((d1 - 2.0 * d2).abs() <= 0.1 * d1.abs() + 1e-6).all(dim=-1)
        fd = (d1 * lin[..., None]).sum().item() / (2.0 * step)
        lf = base.detach().clone().requires_grad_(True)
        img = sample_radiance(sc.replace(**{leaf: lf}), c7, cm7, size, size, 0)
        ad = torch.autograd.grad((img * lin[..., None].float()).sum(), lf)[0][index].sum().item()
        return ad, fd, lin.float().mean().item()

    c2_scene, c2_cam, c2_cfg = presets.config2(device=dev)
    md_scene, md_cam, md_cfg = presets.mis_demo(device=dev)
    fd_wide = {}
    for name, sc, cm7, c7, leaf, row, comp in (
            ("config2 ior[7]", c2_scene, c2_cam, c2_cfg, "ior", 7, None),
            ("mis_demo pos[7].y", md_scene, md_cam, md_cfg, "pos", 7, 1)):
        ad, fd, share = masked_fd(sc, c7, cm7, leaf, row, comp, 1e-2, fd_size)
        rel = abs(ad - fd) / max(abs(fd), 1e-6)
        fd_wide[name] = {"ad": ad, "fd": fd, "rel": rel, "linear_share": share}
        print(f"phase 7: d sum / d {name} at {fd_size}x{fd_size}, {c7.max_bounces} bounces, on "
              f"the {share:.4f} of pixels linear in it (step 1e-2): K2 {ad:.6f}, K1 central "
              f"difference {fd:.6f}, relative error {rel:.2e}")
        if not rel < FD_TOL:
            raise AssertionError(f"K2 disagrees with finite differences of K1 ({name})")

    # ---- phase 8: the gradient main path, timed, and a fit ----
    stamp("phase 8 starts (the gradient main path, timed, and a fit)")
    def step_fn(trace_route):
        leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
                  for k in LEAVES}
        s = scene.replace(**leaves)
        if trace_route == "kernel":   # what a user calls: the renderer
            out = sample_radiance(s, cfg, cam, H, W, 0)
        else:                          # the same step through the plain version
            ro8, rd8 = generate_rays(cam, H, W, 0)
            out = integrator.trace(s, cfg, ro8, rd8, pix, 0, 0)
        return torch.autograd.grad(out.sum(), list(leaves.values()))

    megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = 0
    for _ in range(GRAD_STEPS):
        g = step_fn("kernel")
    torch.cuda.synchronize()
    launches_grad, bwd_launches = megakernel.LAUNCHES, megakernel.BWD_LAUNCHES
    print(f"phase 8: {GRAD_STEPS} fwd+bwd steps at {H}x{W}: {launches_grad} K1 launches, "
          f"{bwd_launches} K2 launches")
    if launches_grad != GRAD_STEPS or bwd_launches != GRAD_STEPS:
        raise AssertionError("the gradient main path did not run through K1 and K2 once per step")
    if not all(bool(x.isfinite().all()) for x in g) or not bool((g[1] != 0).any()):
        raise AssertionError("gradients of the main path are not finite and nonzero")

    mem = {}
    for route in ("kernel", "plain"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        step_fn(route)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        mem[route] = (peak / 2**20, (peak - base_mem) / 2**20)
    step_k = time_stats(torch, lambda: step_fn("kernel"), runs=9)
    step_p = time_stats(torch, lambda: step_fn("plain"), runs=3, warmup=1)
    step_k2 = time_stats(torch, lambda: step_fn("kernel"), runs=9)
    for name, (med, q1, q3) in (("K1+K2", step_k), ("plain autograd", step_p),
                                ("K1+K2 again", step_k2)):
        print(f"phase 8: {card}: fwd+bwd step at {H}x{W}, {cfg.max_bounces} bounces, "
              f"{name}: {med:.3f} ms (q1 {q1:.3f}, q3 {q3:.3f}), "
              f"{rays_per_pass / med / 1e3:.1f} Mrays/s")
    print(f"phase 8: max_memory_allocated over one step: K1+K2 {mem['kernel'][0]:.1f} MiB "
          f"({mem['kernel'][1]:.1f} above what was allocated before it), plain autograd "
          f"{mem['plain'][0]:.1f} MiB ({mem['plain'][1]:.1f} above)")

    # K2 alone and the plain backward alone, on the same inputs
    ct = torch.ones((H, W, 3), dtype=torch.float32, device=dev)
    table = megakernel.scene_table(scene)
    ms_k2 = time_ms(torch, lambda: megakernel._launch_backward(
        scene, cfg, table, ro, rd, pix, 0, 0, ct))
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in LEAVES}
    o8 = ro.detach().clone().requires_grad_(True)
    d8 = rd.detach().clone().requires_grad_(True)
    plain_out = integrator.trace(scene.replace(**leaves), cfg, o8, d8, pix, 0, 0)
    plain_ms_bwd = time_ms(torch, lambda: torch.autograd.grad(
        plain_out, list(leaves.values()) + [o8, d8], ct, retain_graph=True), runs=3, warmup=1)
    del plain_out
    print(f"phase 8: {card}: backward alone: K2 {ms_k2:.3f} ms, plain autograd "
          f"{plain_ms_bwd:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step_fn("kernel")
        torch.cuda.synchronize()
    dev_ms, dev_total = device_times_ms(prof, ("fwd_kernel", "bwd_kernel", "reduce_kernel"))
    if dev_total is None:
        print("phase 8: profiler device time: not measured (no device events)")
    else:
        print(f"phase 8: {card}: device time per step (profiler, 3 steps): "
              f"K1 {dev_ms['fwd_kernel'] / 3:.4f} ms, K2 adjoint {dev_ms['bwd_kernel'] / 3:.4f} ms, "
              f"K2 reduction {dev_ms['reduce_kernel'] / 3:.4f} ms, all kernels {dev_total / 3:.4f} ms")

    fit_size, fit_steps = 128, 20
    small_cfg = cfg
    with torch.no_grad():
        target = optimize.render_linear(scene, small_cfg, cam, fit_size, fit_size)
    is_light = (scene.mat_type == 0)[:, None].float()
    start = scene.replace(emission=scene.emission * (1.0 + 0.6 * is_light))
    megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = 0
    fitted, losses = optimize.fit(start, small_cfg, cam, target, ("emission",),
                                  steps=fit_steps, learning_rate=0.08,
                                  param_mask={"emission": is_light})
    torch.cuda.synchronize()
    em = fitted.emission[scene.lights_static[0]].tolist()
    print(f"phase 8: optimize.fit at {fit_size}x{fit_size}, {fit_steps} steps: loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}, light emission {[round(v, 4) for v in em]} "
          f"(truth 4.0, start 6.4); {megakernel.BWD_LAUNCHES} K2 launches")
    if not losses[-1] < losses[0] or megakernel.BWD_LAUNCHES != fit_steps:
        raise AssertionError("the fit did not lower the loss through K2 once per step")
    # a fit through K2's wide copy: config 2's light emission; the plain
    # version is counted, and must not run
    c2s, c2cam, c2cfg = presets.config2(device=dev)
    with torch.no_grad():
        target2 = optimize.render_linear(c2s, c2cfg, c2cam, fit_size, fit_size)
    light2 = (c2s.mat_type == 0)[:, None].float()
    start2 = c2s.replace(emission=c2s.emission * (1.0 + 0.6 * light2))
    plain_calls, plain_trace = [], integrator.trace
    integrator.trace = lambda *a, **k: plain_calls.append(1) or plain_trace(*a, **k)
    megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = 0
    try:
        _, losses2 = optimize.fit(start2, c2cfg, c2cam, target2, ("emission",), steps=10,
                                  learning_rate=0.08, param_mask={"emission": light2})
        torch.cuda.synchronize()
    finally:
        integrator.trace = plain_trace
    fit2_launches = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    print(f"phase 8: optimize.fit of config2's light emission at {fit_size}x{fit_size}, 10 steps "
          f"through K2's wide copy: loss {losses2[0]:.6f} -> {losses2[-1]:.6f}; "
          f"{fit2_launches[0]} K1 and {fit2_launches[1]} K2 launches, {len(plain_calls)} "
          "calls of the plain version")
    if not losses2[-1] < losses2[0] or fit2_launches[1] != 10 or plain_calls:
        raise AssertionError("the config2 fit did not lower the loss through K2 alone")

    # ---- phase 9: the widened K1 against its plain version ----
    stamp("phase 9 starts (the widened K1 against its plain version)")
    cube_scene, cube_cam, cube_cfg = cubemap_demo(device=dev)
    cases = {
        "cubemap_demo": (cube_scene, cube_cam, cube_cfg),
        "config2": presets.config2(device=dev),
        "dir": sun_scene(dev) + (cfg.replace(use_mis=False),),
        "dir_mis": sun_scene(dev) + (cfg,),
        "cornell_uniform": (scene, cam, cfg.replace(use_biased_sampling=False)),
    }
    widened_err = {}
    for name, (s9, c9, cfg9) in cases.items():
        if megakernel.unsupported(s9, cfg9) is not None or \
                megakernel.unsupported_bwd(s9, cfg9) is not None or megakernel.cornell_copy(s9, cfg9):
            raise AssertionError(f"{name}: expected inside K1's class and K2's wide copy")
        for h, w, nb, tol, frac in ((16, 128, 3, PARITY_TOL, PARITY_FRAC),
                                    (H, W, cfg9.max_bounces, GOLDEN_TOL, GOLDEN_FRAC)):
            c = cfg9.replace(max_bounces=nb)
            ro9, rd9 = generate_rays(c9, h, w, 1)
            pix9 = rng.pixel_ids(h, w, device=dev)
            out = megakernel.trace_forward(s9, c, ro9, rd9, pix9, 1, 0)
            ref = integrator.trace(s9, c, ro9, rd9, pix9, 1, 0)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()) or not ref.max().item() > 0.1:
                raise AssertionError(f"{name}: K1 output not finite, or the plain one dark")
            widened_err[(name, h)] = compare(f"{name} {h}x{w}, {nb} bounces", out, ref,
                                             tol, frac, phase=9)

    # the cubemap shows: direct sky pixels and sky seen in the mirror
    ro9, rd9 = generate_rays(cube_cam, H, W, 1)
    pix9 = rng.pixel_ids(H, W, device=dev)
    out = megakernel.trace_forward(cube_scene, cube_cfg, ro9, rd9, pix9, 1, 0)
    ref = integrator.trace(cube_scene, cube_cfg, ro9, rd9, pix9, 1, 0)
    hit0 = intersect.intersect(cube_scene, ro9, rd9, cube_cfg)
    direct = hit0.missed
    mirror = ~hit0.missed & (cube_scene.mat_type[hit0.idx] == 3)
    inside0 = torch.where((rd9 * hit0.n).sum(-1) > 0.0, -1.0, 1.0)
    u1, u2 = rng.uniform2(pix9, 1, 0, 0, rng.Stream.BSDF_DIR)
    uc = rng.uniform(pix9, 1, 0, 0, rng.Stream.BSDF_CHOICE)
    bs0 = bsdf.sample(cube_scene, cube_cfg, hit0,
                      torch.clamp_min(cube_scene.color[hit0.idx], 0.001),
                      torch.clamp_min(cube_scene.emission[hit0.idx], 0.001),
                      inside0, rd9, u1, u2, uc)
    via = mirror & intersect.intersect(cube_scene, bs0.o, bs0.d, cube_cfg).missed
    for name, sel, dirs in (("direct", direct, rd9), ("via the mirror", via, bs0.d)):
        texel = sky.sample_cubemap(cube_scene.cubemap, dirs)[sel]
        k1, plain = out[sel], ref[sel]
        n_sel = int(sel.sum())
        gap = max((k1 - texel).abs().max().item(), (plain - texel).abs().max().item())
        print(f"phase 9: cubemap_demo {H}x{W}: {n_sel} pixels see the sky {name}; "
              f"min K1 value {k1.min().item():.4f}; max |K1 - texel|, |plain - texel| {gap:.3e}")
        if n_sel < 100 or not k1.min().item() > 0.0 or gap > 1e-6:
            raise AssertionError(f"the cubemap does not show {name}")
    del out, ref

    k1_ms, plain_ms, k1_dev_ms, k1_bound9 = {}, {}, {}, {}
    for name in ("config2", "cubemap_demo"):
        s9, c9, cfg9 = cases[name]
        ro9, rd9 = generate_rays(c9, H, W, 0)
        k1_ms[name] = time_ms(torch, lambda: megakernel.trace_forward(s9, cfg9, ro9, rd9, pix9, 0, 0))
        plain_ms[name] = time_ms(torch, lambda: integrator.trace(s9, cfg9, ro9, rd9, pix9, 0, 0),
                                 runs=3, warmup=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                megakernel.trace_forward(s9, cfg9, ro9, rd9, pix9, 0, 0)
            torch.cuda.synchronize()
        dev9, _ = device_times_ms(prof, ("fwd_kernel",))
        k1_dev_ms[name] = None if dev9["fwd_kernel"] is None else dev9["fwd_kernel"] / 3
        ev9 = path_events(torch, s9, cfg9, ro9, rd9, pix9, 0, 0)
        k1_bound9[name] = bound(ev9, s9, cfg9, adjoint=False)
        print(f"phase 9: path events of {name} at {H}x{W}: {json.dumps(ev9)}")
        print(f"phase 9: {card}: {name} trace at {H}x{W}, {cfg9.max_bounces} bounces: "
              f"K1 {k1_ms[name]:.3f} ms (device "
              + ("not measured" if k1_dev_ms[name] is None else f"{k1_dev_ms[name]:.4f} ms")
              + f", profiler), plain {plain_ms[name]:.3f} ms; bound {k1_bound9[name][0]:.6f} ms "
              f"({k1_bound9[name][1]})")

    # ---- phase 10: the cubemap main path ----
    stamp("phase 10 starts (the cubemap main path)")
    megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = 0
    img = Renderer(cube_scene, cube_cam, cube_cfg, H, W).render(PASSES)
    torch.cuda.synchronize()
    launches_cube, bwd_cube = megakernel.LAUNCHES, megakernel.BWD_LAUNCHES
    print(f"phase 10: Renderer(cubemap_demo).render({PASSES}) at {H}x{W}: {launches_cube} "
          f"K1 launches, {bwd_cube} K2 launches; image mean {img.mean().item():.4f}")
    if launches_cube != PASSES or bwd_cube != 0:
        raise AssertionError(f"expected {PASSES} K1 and 0 K2 launches, saw "
                             f"{launches_cube} and {bwd_cube}")
    if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()) \
            or not img.mean().item() > 0.05:
        raise AssertionError("the cubemap image is not finite, or black")

    def plain_cube_pass():
        ro10, rd10 = generate_rays(cube_cam, H, W, 0)
        return integrator.trace(cube_scene, cube_cfg, ro10, rd10, pix9, 0, 0)

    ms_cube_pass = time_ms(torch, lambda: sample_radiance(cube_scene, cube_cfg, cube_cam, H, W, 0))
    plain_cube_pass_ms = time_ms(torch, plain_cube_pass)
    print(f"phase 10: {card}: cubemap_demo sample_radiance at {H}x{W}, "
          f"{cube_cfg.max_bounces} bounces: K1 {ms_cube_pass:.3f} ms/pass, plain "
          f"{plain_cube_pass_ms:.3f} ms/pass")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            sample_radiance(cube_scene, cube_cfg, cube_cam, H, W, 0)
        torch.cuda.synchronize()
    cube_dev, cube_total = device_times_ms(prof, ("fwd_kernel",))
    cube_dev_ms = None if cube_dev["fwd_kernel"] is None else cube_dev["fwd_kernel"] / 3
    cube_bound, cube_by = k1_bound9["cubemap_demo"]
    print(f"phase 10: {card}: K1 in a cubemap_demo pass: device time "
          + ("not measured" if cube_dev_ms is None else
             f"{cube_dev_ms:.4f} ms of {cube_total / 3:.4f} ms on the device per pass")
          + f" (profiler, 3 passes), bound {cube_bound:.6f} ms ({cube_by})")

    # ---- phase 11: no gradient w.r.t. texel arrays ----
    stamp("phase 11 starts (no gradient w.r.t. texel arrays)")
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    texels = cube_scene.cubemap.clone().requires_grad_(True)
    try:
        sample_radiance(cube_scene.replace(cubemap=texels), cube_cfg, cube_cam, 16, 16, 0)
    except NotImplementedError as exc:
        print(f"phase 11: a gradient w.r.t. cubemap_demo's cubemap raises NotImplementedError: "
              f"{exc}")
        if "item 14" not in str(exc):
            raise AssertionError("the cubemap gradient is refused without naming item 14")
    else:
        raise AssertionError("a gradient w.r.t. the cubemap did not raise")
    if (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) != before:
        raise AssertionError("the refused gradient launched a kernel")

    # ---- phase 12: K1 against its plain version on textured scenes ----
    stamp("phase 12 starts (K1 against its plain version on textured scenes)")
    tex_cases = textured_scenes(dev)
    # no libm call in their texture paths: CHECK/RIPPLE on planes, the LUT types
    exact_scenes = ("procedural",)
    # sin (gradient noise) or asin/atan2 (sphere UV) decide a pattern: held to
    # the golden contract at both sizes
    libm_scenes = ("gradient_noise", "check_sphere")
    tex_err = {}
    for name, (s12, c12, cfg12) in tex_cases.items():
        if megakernel.unsupported(s12, cfg12) is not None:
            raise AssertionError(f"{name}: expected inside K1's class")
        small = (PARITY_TOL, PARITY_FRAC) if name not in libm_scenes else (GOLDEN_TOL, GOLDEN_FRAC)
        for h, w, nb, tol, frac in ((16, 128, 3) + small,
                                    (H, W, cfg12.max_bounces, GOLDEN_TOL, GOLDEN_FRAC)):
            c = cfg12.replace(max_bounces=nb)
            ro12, rd12 = generate_rays(c12, h, w, 1)
            pix12 = rng.pixel_ids(h, w, device=dev)
            out = megakernel.trace_forward(s12, c, ro12, rd12, pix12, 1, 0)
            ref = integrator.trace(s12, c, ro12, rd12, pix12, 1, 0)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()) or not ref.max().item() > 0.02:
                raise AssertionError(f"{name}: K1 output not finite, or the plain one dark")
            n_diff = int((out != ref).any(dim=-1).sum())
            print(f"phase 12: {name} {h}x{w}: {n_diff} of {h * w} pixels differ from the "
                  "plain version")
            tex_err[(name, h)] = compare(f"{name} {h}x{w}, {nb} bounces", out, ref, tol, frac,
                                         phase=12)
            if name in exact_scenes and tex_err[(name, h)] != 0.0:
                raise AssertionError(f"{name}: K1 is not bit-identical to the plain version")
    del out, ref

    # a gradient w.r.t. a texel array is refused before any launch; the
    # color's runs through K2
    t_scene, t_cam, t_cfg = tex_cases["textured_cornell"]
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    for leaf in ("images", "noise"):
        grad_leaf = getattr(t_scene, leaf).clone().requires_grad_(True)
        try:
            sample_radiance(t_scene.replace(**{leaf: grad_leaf}), t_cfg, t_cam, 16, 16, 0)
        except NotImplementedError as exc:
            print(f"phase 12: a gradient w.r.t. {leaf} through textured_cornell raises "
                  f"NotImplementedError: {exc}")
        else:
            raise AssertionError(f"a gradient w.r.t. {leaf} through textured_cornell did not raise")
    if (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) != before:
        raise AssertionError("the refused textured gradient launched a kernel")
    col = t_scene.color.clone().requires_grad_(True)
    sample_radiance(t_scene.replace(color=col), t_cfg, t_cam, 16, 16, 0).sum().backward()
    torch.cuda.synchronize()
    if (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) != (before[0] + 1, before[1] + 1):
        raise AssertionError("the textured color's gradient did not run through K1 and K2")

    # ---- phase 13: the texture main path ----
    stamp("phase 13 starts (the texture main path)")
    megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = 0
    img = Renderer(t_scene, t_cam, t_cfg, H, W).render(PASSES)
    torch.cuda.synchronize()
    launches_tex, bwd_tex = megakernel.LAUNCHES, megakernel.BWD_LAUNCHES
    ro13, rd13 = generate_rays(t_cam, H, W, 0)
    hit13 = intersect.intersect(t_scene, ro13, rd13, t_cfg)
    on_sphere = ~hit13.missed & (t_scene.tex_type[hit13.idx] >= 0)
    sphere_px = img[on_sphere]
    print(f"phase 13: Renderer(textured_cornell).render({PASSES}) at {H}x{W}: {launches_tex} K1 "
          f"launches, {bwd_tex} K2 launches; image mean {img.mean().item():.4f}; "
          f"{int(on_sphere.sum())} textured-sphere pixels, RGB std "
          f"{[round(v, 4) for v in sphere_px.std(dim=0).tolist()]}")
    if launches_tex != PASSES or bwd_tex != 0:
        raise AssertionError(f"expected {PASSES} K1 and 0 K2 launches, saw "
                             f"{launches_tex} and {bwd_tex}")
    if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()) \
            or not img.mean().item() > 0.05:
        raise AssertionError("the textured image is not finite, or black")
    if int(on_sphere.sum()) < 1000 or not sphere_px.std(dim=0).min().item() > 0.01:
        raise AssertionError("the textured sphere's pixels do not vary")

    g_scene, g_cam, g_cfg = tex_cases["textured_gloss"]
    megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = 0
    img = Renderer(g_scene, g_cam, g_cfg, H, W).render(PASSES)
    torch.cuda.synchronize()
    launches_gloss, bwd_gloss = megakernel.LAUNCHES, megakernel.BWD_LAUNCHES
    print(f"phase 13: Renderer(textured_gloss).render({PASSES}) at {H}x{W}: {launches_gloss} "
          f"K1 launches, {bwd_gloss} K2 launches; image mean {img.mean().item():.4f}")
    if launches_gloss != PASSES or bwd_gloss != 0 or not bool(torch.isfinite(img).all()) \
            or not img.mean().item() > 0.05:
        raise AssertionError("textured_gloss did not render through K1 once per pass")
    del img

    # ---- phase 14: K1 and the plain version on the textured scenes, timed ----
    stamp("phase 14 starts (K1 and the plain version on the textured scenes, timed)")
    tex_ms, tex_plain_ms, tex_dev_ms, tex_bound = {}, {}, {}, {}
    for name in ("textured_cornell", "textured_gloss"):
        s14, c14, cfg14 = tex_cases[name]
        ro14, rd14 = generate_rays(c14, H, W, 0)
        tex_ms[name] = time_ms(torch, lambda: megakernel.trace_forward(
            s14, cfg14, ro14, rd14, pix9, 0, 0))
        tex_plain_ms[name] = time_ms(torch, lambda: integrator.trace(
            s14, cfg14, ro14, rd14, pix9, 0, 0), runs=3, warmup=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                megakernel.trace_forward(s14, cfg14, ro14, rd14, pix9, 0, 0)
            torch.cuda.synchronize()
        dev14, _ = device_times_ms(prof, ("fwd_kernel",))
        tex_dev_ms[name] = None if dev14["fwd_kernel"] is None else dev14["fwd_kernel"] / 3
        ev14 = path_events(torch, s14, cfg14, ro14, rd14, pix9, 0, 0)
        tex_bound[name] = bound(ev14, s14, cfg14, adjoint=False)
        print(f"phase 14: path events of {name} at {H}x{W}: {json.dumps(ev14)}")
        print(f"phase 14: {card}: {name} trace at {H}x{W}, {cfg14.max_bounces} bounces: "
              f"K1 {tex_ms[name]:.3f} ms (device "
              + ("not measured" if tex_dev_ms[name] is None else f"{tex_dev_ms[name]:.4f} ms")
              + f", profiler), plain {tex_plain_ms[name]:.3f} ms; bound "
              f"{tex_bound[name][0]:.6f} ms ({tex_bound[name][1]})")

    # ---- phase 15: K1 with the SDF march against its plain version ----
    stamp("phase 15 starts (K1 with the SDF march against its plain version)")
    r_scene, r_cam, r_cfg = presets.restir_demo(device=dev)
    sdf_cases = {"mis_demo": presets.mis_demo(device=dev),
                 "restir_demo_nee": (r_scene, r_cam, r_cfg.replace(use_restir=False))}
    sdf_err = {}
    for name, (s15, c15, cfg15) in sdf_cases.items():
        if megakernel.unsupported(s15, cfg15) is not None:
            raise AssertionError(f"{name}: expected inside K1's class")
        for h, w, nb, tol, frac in ((16, 128, 3, PARITY_TOL, PARITY_FRAC),
                                    (H, W, cfg15.max_bounces, GOLDEN_TOL, GOLDEN_FRAC)):
            c = cfg15.replace(max_bounces=nb)
            ro15, rd15 = generate_rays(c15, h, w, 1)
            pix15 = rng.pixel_ids(h, w, device=dev)
            before = megakernel.LAUNCHES
            out = megakernel.trace_forward(s15, c, ro15, rd15, pix15, 1, 0)
            ref = integrator.trace(s15, c, ro15, rd15, pix15, 1, 0)
            torch.cuda.synchronize()
            if megakernel.LAUNCHES != before + 1:
                raise AssertionError(f"{name}: expected one K1 launch")
            if not bool(torch.isfinite(out).all()) or not ref.max().item() > 0.02:
                raise AssertionError(f"{name}: K1 output not finite, or the plain one dark")
            n_diff = int((out != ref).any(dim=-1).sum())
            print(f"phase 15: {name} {h}x{w}, {nb} bounces, {c.marching_steps} marching steps: "
                  f"{n_diff} of {h * w} pixels differ from the plain version")
            sdf_err[(name, h)] = compare(f"{name} {h}x{w}, {nb} bounces", out, ref, tol, frac,
                                         phase=15)
    del out, ref
    k1_dev = k1_device_ms(("cornell_default", "mis_demo"), dev)
    print(f"phase 15: {card}: K1 device time at {H}x{W}, 12 bounces (k1_device_time.py, "
          "median of 5 rounds of 20 launches): "
          + ", ".join(f"{k} {v[0]:.5f} ms (rounds {[round(x, 5) for x in v[1]]})"
                      for k, v in k1_dev.items()))
    m_scene, m_cam, m_cfg = sdf_cases["mis_demo"]
    ro15, rd15 = generate_rays(m_cam, H, W, 0)
    pix15 = rng.pixel_ids(H, W, device=dev)
    ms_sdf = time_ms(torch, lambda: megakernel.trace_forward(m_scene, m_cfg, ro15, rd15, pix15, 0, 0))
    plain_ms_sdf = time_ms(torch, lambda: integrator.trace(m_scene, m_cfg, ro15, rd15, pix15, 0, 0),
                           runs=3, warmup=1)
    ev15 = path_events(torch, m_scene, m_cfg, ro15, rd15, pix15, 0, 0)
    sdf_bound, sdf_by = bound(ev15, m_scene, m_cfg, adjoint=False)
    print(f"phase 15: path events of mis_demo at {H}x{W}: {json.dumps(ev15)}")
    print(f"phase 15: {card}: mis_demo trace at {H}x{W}, {m_cfg.max_bounces} bounces: K1 "
          f"{ms_sdf:.3f} ms, plain {plain_ms_sdf:.3f} ms; bound {sdf_bound:.6f} ms ({sdf_by})")
    before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    em = m_scene.emission.clone().requires_grad_(True)
    grid = tuple(int(MeshType.GRID_SDF) if t == int(MeshType.SDF) else t
                 for t in m_scene.mesh_types_static)
    other = m_scene.replace(emission=em, mesh_types_static=grid, mesh_type=torch.tensor(
        grid, dtype=m_scene.mesh_type.dtype, device=dev))
    try:
        sample_radiance(other, m_cfg, m_cam, 16, 16, 0)
    except NotImplementedError as exc:
        print(f"phase 15: a gradient through mis_demo with its box made a GRID_SDF raises "
              f"NotImplementedError: {exc}")
        if "item 8" not in str(exc):
            raise AssertionError("a GRID_SDF is refused without naming item 8")
    else:
        raise AssertionError("a gradient through a GRID_SDF did not raise")
    if (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) != before:
        raise AssertionError("the refused SDF gradient launched a kernel")

    # ---- phase 16: K6 against the plain restir.render_sample ----
    stamp("phase 16 starts (K6 against the plain restir.render_sample)")
    def restir_contract(name, out, ref, new, new_ref, bits=False):
        """JAX's fused-versus-wavefront contract (tests/test_restir.py:312-352),
        with `bits` equality of the radiance and every reservoir field;
        returns the radiance's max abs error."""
        err = (out - ref).abs()
        agree = new.light_index == new_ref.light_index
        field_err = max((getattr(new, k)[agree] - getattr(new_ref, k)[agree]).abs().max().item()
                        for k in ("weight_sum", "m", "w", "age", "light_pos", "light_color"))
        n_diff = int((out != ref).any(dim=-1).sum())
        mx, med, share = err.max().item(), err.median().item(), agree.float().mean().item()
        print(f"phase 16: {name}: radiance max abs err {mx:.3e}, median {med:.3e}, "
              f"{n_diff} pixels differ; light index agrees at {share:.5f}; reservoir fields "
              f"max abs err {field_err:.3e} where it does; {int((new.light_index >= 0).sum())} "
              "pixels hold a light")
        if not (mx < 5e-3 and med < 1e-6 and share >= 0.995 and field_err <= 1e-4):
            raise AssertionError(f"{name}: K6 disagrees with the plain render_sample")
        if bits and (n_diff or not all(torch.equal(getattr(new, k), getattr(new_ref, k))
                                       for k in RESERVOIR_FIELDS)):
            raise AssertionError(f"{name}: K6 differs from the plain render_sample's bits")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: K6 radiance is not finite")
        return mx

    k6_err = {}
    k6_counts = lambda: (restir_kernel.LAUNCHES, restir_split.GBUF_LAUNCHES,
                         restir_vertex.VERTEX_LAUNCHES, megakernel.LAUNCHES)
    for name, kw in (("restir_demo", {}), ("restir_stress", {}), ("restir_demo_mis", {})):
        preset = getattr(presets, name.replace("_mis", ""))
        s16, c16, cfg16 = preset(device=dev, use_mis=True) if name.endswith("_mis") \
            else preset(device=dev, **kw)
        if restir_kernel.unsupported_restir(s16, cfg16) is not None:
            raise AssertionError(f"{name}: expected inside K6's class")
        for h, w, nb, n_pass in ((16, 128, 3, 12), (H, W, cfg16.max_bounces, 4)):
            c = cfg16.replace(max_bounces=nb)
            kernel_ring = RenderState.create(h, w, device=dev)
            plain_ring = RenderState.create(h, w, device=dev)
            for p in range(n_pass):
                before = k6_counts()
                out, new = restir_kernel.render_sample_fused(s16, c, c16, kernel_ring, h, w, p)
                ref, new_ref = restir.render_sample(s16, c, c16, plain_ring, h, w, p)
                torch.cuda.synchronize()
                if k6_counts() != (before[0] + 1, before[1] + 1, before[2] + 1, before[3]):
                    raise AssertionError("expected one K6 pass (one K4 and one K6v launch) and "
                                         "no K1 launch per pass")
                k6_err[(name, h, p)] = restir_contract(
                    f"{name} {h}x{w}, {nb} bounces, pass {p}", out, ref, new, new_ref,
                    bits=True)
                # the gradient path gathers the light data from the scene
                pos16, col16 = restir_kernel.light_data(s16, new.light_index)
                if not (torch.equal(pos16, new.light_pos) and torch.equal(col16, new.light_color)):
                    raise AssertionError(f"{name}: light_data differs from K6v's light data")
                kernel_ring = kernel_ring.rotate_reservoirs(new)
                plain_ring = plain_ring.rotate_reservoirs(new_ref)
    del out, ref, kernel_ring, plain_ring
    k6_max_err = max(v for (name, h, p), v in k6_err.items() if h == H and name == "restir_demo")

    # ---- phase 17: the ReSTIR main path ----
    stamp("phase 17 starts (the ReSTIR main path)")
    restir_kernel.LAUNCHES = megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = 0
    restir_split.GBUF_LAUNCHES = restir_split.CAST_LAUNCHES = restir_vertex.VERTEX_LAUNCHES = 0
    r_renderer = Renderer(r_scene, r_cam, r_cfg, H, W)
    img = r_renderer.render(PASSES)
    torch.cuda.synchronize()
    launches_k6, k1_restir, k2_restir = (restir_kernel.LAUNCHES, megakernel.LAUNCHES,
                                         megakernel.BWD_LAUNCHES)
    k4_restir, k6v_restir, k5_restir = (restir_split.GBUF_LAUNCHES, restir_vertex.VERTEX_LAUNCHES,
                                        restir_split.CAST_LAUNCHES)
    res = r_renderer.state.restir_back
    held = (res.light_index >= 0).float().mean().item()
    print(f"phase 17: Renderer(*restir_demo()).render({PASSES}) at {H}x{W}: {launches_k6} K6 "
          f"passes ({k4_restir} K4 and {k6v_restir} K6v launches), {k5_restir} K5, {k1_restir} K1, "
          f"{k2_restir} K2 launches; max M {res.m.max().item():.4f}, max W "
          f"{res.w.max().item():.4f}, share of pixels holding a light {held:.5f}")
    if (launches_k6, k4_restir, k6v_restir, k5_restir, k1_restir, k2_restir) != \
            (PASSES, PASSES, PASSES, 0, 0, 0):
        raise AssertionError(f"expected {PASSES} K4 and K6v launches and no K5, K1 or K2 launch")
    if not (res.m.max().item() > 0.0 and res.w.max().item() <= 12.0 and held > 0.1):
        raise AssertionError("the reservoirs are not populated")
    accum_restir = r_renderer.state.accum / PASSES
    nee_renderer = Renderer(r_scene, r_cam, r_cfg.replace(use_restir=False), H, W)
    for _ in range(PASSES):
        nee_renderer.step()
    torch.cuda.synchronize()
    m_restir = accum_restir.mean().item()
    m_nee = (nee_renderer.state.accum / PASSES).mean().item()
    print(f"phase 17: mean radiance over {PASSES} passes: ReSTIR {m_restir:.6f}, per-light NEE "
          f"{m_nee:.6f}, ratio {m_restir / m_nee:.4f} (1/9..2 expected, tests/test_restir.py:94-129)")
    if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"the ReSTIR image is not finite f32[{H},{W},3]")
    if not (m_nee > 0.003 and 1.0 / 9.0 < m_restir / m_nee < 2.0):
        raise AssertionError("the ReSTIR image's mean is off the per-light NEE render's")
    del accum_restir, nee_renderer

    ms_restir_pass = time_stats(torch, r_renderer.step)
    ro17, rd17 = generate_rays(r_cam, H, W, PASSES)
    pix17 = rng.pixel_ids(H, W, device=dev)
    st = r_renderer.state
    k6_call = lambda: restir_kernel.trace_forward_restir_fused(
        r_scene, r_cfg, ro17, rd17, pix17, PASSES, 0, st.restir_back, st.restir_hist1,
        st.restir_hist2)
    ms_k6 = time_ms(torch, k6_call)
    # K6's two kernels alone, on the pass's inputs
    table17 = megakernel.scene_table(r_scene)
    rad17, gbuf17 = restir_split.launch_gbuffer(r_scene, r_cfg, table17, ro17, rd17, pix17,
                                                PASSES, 0)
    k4_rad17 = rad17.clone()   # K6v's fused form writes its radiance over rad17
    grids17 = (st.restir_back, st.restir_hist1, st.restir_hist2)
    ms_k4_demo = time_ms(torch, lambda: restir_split.launch_gbuffer(
        r_scene, r_cfg, table17, ro17, rd17, pix17, PASSES, 0))
    ms_k6v = time_ms(torch, lambda: restir_vertex.launch(
        r_scene, r_cfg, table17, ro17, rd17, pix17, PASSES, 0, grids17, gbuf17, rad17))
    # K6v's plain version: the reservoir phases as PyTorch ops on K4's
    # G-buffer (STATIC, so the split pass's light data is the slot table's)
    gbuf17_slots = [{k: v[i] for k, v in gbuf17.items()} for i in range(len(gbuf17["pos"]))]
    plain_ms_k6v = time_ms(torch, lambda: restir_split.render_sample_split(
        r_scene, r_cfg, r_cam, st, H, W, PASSES, 0.0, lambda *a: (k4_rad17, gbuf17_slots),
        restir.default_cast), runs=3, warmup=1)
    plain_restir = time_stats(torch, lambda: restir.render_sample(
        r_scene, r_cfg, r_cam, st, H, W, PASSES), runs=3, warmup=1)
    k6_kernels = ("gbuf_kernel", "restir_vertex_kernel")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            k6_call()
        torch.cuda.synchronize()
    # per launch the profile recorded: one run read K4 at 0.0986 ms here
    # against 0.149 in every other measure of the same launch
    dev17, _ = device_times_ms(prof, k6_kernels, per_launch=True)
    k4_demo_dev_ms, k6v_dev_ms = dev17.values()
    records17 = [sum(e.count for e in prof.key_averages() if n in e.key) for n in k6_kernels]
    k6_dev_ms = None if k6v_dev_ms is None else k4_demo_dev_ms + k6v_dev_ms
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            r_renderer.step()
        torch.cuda.synchronize()
    pass_dev, pass_total = device_times_ms(prof, k6_kernels)
    k6_pass_dev = None if pass_total is None else sum(pass_dev.values()) / 3
    ev17 = path_events(torch, r_scene, r_cfg, ro17, rd17, pix17, PASSES, 0, ring=st)
    k6_bound, k6_by = bound(ev17, r_scene, r_cfg, adjoint=False, restir=True)
    slots17 = restir_split.gbuffer_slots(r_cfg)
    k4_grid17 = restir_split.resident_blocks(dev, True, megakernel.packed_smem_bytes(r_scene))
    ev17_k4 = path_events(torch, r_scene, r_cfg, ro17, rd17, pix17, PASSES, 0, gbuffer=True,
                          resident_warps=k4_grid17 * 4)
    k4_demo_bound, k4_demo_by = bound(ev17_k4, r_scene, r_cfg, adjoint=False,
                                      gbuffer_slots=slots17)
    k6v_bound, k6v_by = vertex_bound(ev17, r_scene, r_cfg, slots17)
    o6v = occ[("K6v", "restir_demo")]
    dev_txt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    print(f"phase 17: path events of a restir_demo pass at {H}x{W}: {json.dumps(ev17)}")
    print(f"phase 17: {card}: K4 on restir_demo {dev_txt(k4_demo_dev_ms)} of device time "
          f"({ms_k4_demo:.3f} ms alone) on a persistent grid of {k4_grid17} blocks; its bounce "
          f"loop's warp lane use (plain replay, 32 pixels a warp): {ev17_k4['lane_use']:.4f} one "
          f"pixel per thread, {ev17_k4['lane_use_regenerated']:.4f} simulated under regeneration "
          f"on {k4_grid17 * 4} resident warps; its SDF march's "
          f"{ev17_k4.get('march_lane_use', 1.0):.4f}")
    print(f"phase 17: {card}: restir_demo at {H}x{W}, {r_cfg.max_bounces} bounces, "
          f"{r_cfg.marching_steps} marching steps: pass (Renderer.step) {ms_restir_pass[0]:.3f} ms "
          f"(q1 {ms_restir_pass[1]:.3f}, q3 {ms_restir_pass[2]:.3f}); K6 pass {ms_k6:.3f} ms "
          f"(device {dev_txt(k6_dev_ms)}: K4 {dev_txt(k4_demo_dev_ms)} + K6v "
          f"{dev_txt(k6v_dev_ms)}, profiler, {records17} launches recorded of 3 each); alone K4 "
          f"{ms_k4_demo:.3f} ms, K6v {ms_k6v:.3f} ms "
          f"(CUDA events); in a pass K4 + K6v {dev_txt(k6_pass_dev)}"
          + ("" if pass_total is None else f" of {pass_total / 3:.4f} ms on the device")
          + f"; plain render_sample {plain_restir[0]:.3f} ms per pass; bounds: the pass "
          f"{k6_bound:.6f} ms ({k6_by}), K4 {k4_demo_bound:.6f} ms ({k4_demo_by}), K6v "
          f"{k6v_bound:.6f} ms ({k6v_by}); K6v occupancy {o6v['blocks']} blocks of "
          f"{o6v['threads']} threads ({o6v['warps']} warps) per SM at {o6v['registers']} "
          "registers")
    del rad17, k4_rad17, gbuf17, gbuf17_slots

    counts = lambda: (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES, restir_kernel.LAUNCHES,
                      restir_kernel.BWD_LAUNCHES)
    before = counts()
    aux = r_scene.aux.clone().requires_grad_(True)
    try:
        render_pass(r_scene.replace(aux=aux), r_cam, r_cfg, RenderState.create(16, 16, dev),
                    16, 16)
    except NotImplementedError as exc:
        print(f"phase 17: a gradient w.r.t. aux through restir_demo raises NotImplementedError: "
              f"{exc}")
    else:
        raise AssertionError("a gradient w.r.t. aux through restir_demo did not raise")
    if counts() != before:
        raise AssertionError("the refused ReSTIR gradient launched a kernel")
    # ---- phase 18: K7 against the plain version's autograd ----
    stamp("phase 18 starts (K7 against the plain version's autograd)")
    def restir_chain(trace, s, cfg_, cam_, h, w, passes, seed=5):
        """(loss, d loss / d(scene leaves, every pass's rays)) for seeded
        weights on every pass's radiance and on the last ring's floats, over
        `passes` passes from an empty ring, each traced by `trace` (K6 with
        K7, or the plain `restir.trace_sample`)."""
        leaves = {k: getattr(s, k).detach().clone().requires_grad_(True) for k in RESTIR_LEAVES}
        sc = s.replace(**leaves)
        state = RenderState.create(h, w, device=dev)
        pix_ = rng.pixel_ids(h, w, device=dev)
        gen = torch.Generator().manual_seed(seed)
        weights = lambda shape: (0.5 + torch.rand(shape, generator=gen)).to(dev)
        loss, rays_ = 0.0, []
        for p in range(passes):
            ro_, rd_ = generate_rays(cam_, h, w, p)
            rays_ += [ro_.detach().requires_grad_(True), rd_.detach().requires_grad_(True)]
            rad, new = trace(sc, cfg_, rays_[-2], rays_[-1], pix_, p, 0, state.restir_back,
                             state.restir_hist1, state.restir_hist2)
            loss = loss + (rad * weights(rad.shape)).sum()
            state = state.rotate_reservoirs(new)
        for k in restir_kernel.RING_FLOATS:
            loss = loss + (getattr(state.restir_back, k) * weights((h, w))).sum() * 0.1
        got = torch.autograd.grad(loss, list(leaves.values()) + rays_)
        out = dict(zip(RESTIR_LEAVES, got))
        out["ro"] = torch.stack(got[-2 * passes::2])
        out["rd"] = torch.stack(got[-2 * passes + 1::2])
        return loss.detach(), out

    k7_rel = {}
    for name in ("restir_demo", "restir_stress"):
        s18, c18, cfg18 = getattr(presets, name)(device=dev)
        c = cfg18.replace(max_bounces=3)
        before = (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES)
        _, got = restir_chain(restir_kernel.trace_forward_restir_fused, s18, c, c18, 16, 128, 4)
        torch.cuda.synchronize()
        if (restir_kernel.LAUNCHES - before[0], restir_kernel.BWD_LAUNCHES - before[1]) != (4, 4):
            raise AssertionError("expected one K6 pass and one K7 launch per pass")
        _, again = restir_chain(restir_kernel.trace_forward_restir_fused, s18, c, c18, 16, 128, 4)
        _, want = restir_chain(restir.trace_sample, s18, c, c18, 16, 128, 4)
        torch.cuda.synchronize()
        errs = grad_errors(got, want)
        same = all(torch.equal(got[k], again[k]) for k in got)
        k7_rel[name] = max(e[0] for e in errs.values())
        print(f"phase 18: {name} 16x128, 3 bounces, passes 0-3: max relative error per leaf "
              + ", ".join(f"{k} {e[0]:.2e}" for k, e in errs.items())
              + f"; two K7 runs {'give identical bits' if same else 'DIFFER'}")
        if k7_rel[name] >= GRAD_TOL or not same:
            raise AssertionError(f"K7 disagrees with plain autograd on {name}, or is not "
                                 "deterministic")

    # at full size, over as many passes (up to 4) as the plain autograd fits
    # in the card's memory
    def chain_memory(trace, size, passes):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        result = restir_chain(trace, r_scene, r_cfg, r_cam, size, size, passes)[1]
        torch.cuda.synchronize()
        return result, (torch.cuda.max_memory_allocated() - base_mem) / 2**20

    _, plain_mib_256 = chain_memory(restir.trace_sample, 256, 1)
    free_mib = torch.cuda.mem_get_info()[0] / 2**20
    full = H if plain_mib_256 * (H * W) / 256**2 < 0.8 * free_mib else 256
    per_pass = plain_mib_256 * (full * full) / 256**2
    n_full = max(1, min(4, int(0.8 * free_mib // per_pass)))
    print(f"phase 18: plain autograd of one restir_demo pass at 256x256, {r_cfg.max_bounces} "
          f"bounces takes {plain_mib_256:.1f} MiB; {free_mib:.0f} MiB free: comparing at "
          f"{full}x{full} over passes 0-{n_full - 1}")
    got, k7_mib = chain_memory(restir_kernel.trace_forward_restir_fused, full, n_full)
    want, plain_mib = chain_memory(restir.trace_sample, full, n_full)
    again, _ = chain_memory(restir_kernel.trace_forward_restir_fused, full, n_full)
    errs = grad_errors(got, want)
    k7_rel_full = max(e[0] for e in errs.values())
    k7_abs = max(e[1] for e in errs.values())
    same_full = all(torch.equal(got[k], again[k]) for k in got)
    print(f"phase 18: restir_demo {full}x{full}, {r_cfg.max_bounces} bounces, passes "
          f"0-{n_full - 1}: max relative error per leaf "
          + ", ".join(f"{k} {e[0]:.2e}" for k, e in errs.items())
          + f"; max abs error {k7_abs:.3e}; two K7 runs "
          + ("give identical bits" if same_full else "DIFFER")
          + f"; memory above the inputs: K6+K7 {k7_mib:.1f} MiB, plain autograd {plain_mib:.1f} MiB")
    if k7_rel_full >= GRAD_TOL or not same_full:
        raise AssertionError(f"K7 disagrees with plain autograd at {full}x{full}, or is not "
                             "deterministic")
    del got, want, again

    # the plain backward alone of that pass, for the kernels line
    leaves = {k: getattr(r_scene, k).detach().clone().requires_grad_(True) for k in RESTIR_LEAVES}
    ro18, rd18 = generate_rays(r_cam, full, full, 0)
    ring18 = RenderState.create(full, full, device=dev)
    rad18, _ = restir.trace_sample(r_scene.replace(**leaves), r_cfg, ro18, rd18,
                                   rng.pixel_ids(full, full, device=dev), 0, 0,
                                   ring18.restir_back, ring18.restir_hist1, ring18.restir_hist2)
    plain_ms_k7 = time_ms(torch, lambda: torch.autograd.grad(
        rad18, list(leaves.values()), torch.ones_like(rad18), retain_graph=True,
        allow_unused=True), runs=3, warmup=1)
    del rad18, leaves

    # ---- phase 19: K7 against K6's finite differences ----
    stamp("phase 19 starts (K7 against K6's finite differences)")
    fd_passes = 4
    is_light = (r_scene.mat_type == 0).float()[:, None]

    def linear_sum(em=None, pos=None):
        sc = r_scene.replace(emission=r_scene.emission if em is None else em,
                             pos=r_scene.pos if pos is None else pos)
        return optimize.render_linear(sc, r_cfg, r_cam, fd_size, fd_size,
                                      passes=fd_passes).double().sum()

    s19 = torch.tensor(1.0, device=dev, requires_grad=True)
    before = counts()
    value = linear_sum(em=r_scene.emission * (1.0 + (s19 - 1.0) * is_light))
    ad = torch.autograd.grad(value, s19)[0].item()
    torch.cuda.synchronize()
    if counts()[2:] != (before[2] + fd_passes, before[3] + fd_passes) or counts()[:2] != before[:2]:
        raise AssertionError("the finite-difference gradient did not run on K6 and K7 alone")
    eps19 = 0.05
    with torch.no_grad():
        fd = (linear_sum(em=r_scene.emission * (1.0 + eps19 * is_light)).item()
              - linear_sum(em=r_scene.emission * (1.0 - eps19 * is_light)).item()) / (2 * eps19)
    rel_fd = abs(ad - fd) / max(abs(fd), 1e-6)
    rel_value = abs(ad - value.item()) / max(abs(value.item()), 1e-6)
    print(f"phase 19: d sum(render_linear) / ds, every light's emission scaled by s, "
          f"{fd_size}x{fd_size}, {r_cfg.max_bounces} bounces, {fd_passes} passes: K7 {ad:.6f}, "
          f"K6 central difference {fd:.6f} (relative error {rel_fd:.2e}), sum at s = 1 "
          f"{value.item():.6f} (relative error {rel_value:.2e})")
    if not (rel_fd < FD_TOL and rel_value < 1e-2):
        raise AssertionError("K7's emission gradient is not the linear one")
    light19 = r_scene.lights_static[4]   # the central light, (0, 1.8, 0)
    pos = r_scene.pos.detach().clone().requires_grad_(True)
    ad_pos = torch.autograd.grad(linear_sum(pos=pos), pos)[0][light19, 1].item()
    sums = []
    for sign in (1.0, -1.0):
        moved = r_scene.pos.clone()
        moved[light19, 1] += sign * 1e-2
        with torch.no_grad():
            sums.append(linear_sum(pos=moved).item())
    fd_pos = (sums[0] - sums[1]) / 2e-2
    print(f"phase 19: d sum(render_linear) / d pos[{light19}].y (step 1e-2): K7 {ad_pos:.6f}, "
          f"K6 central difference {fd_pos:.6f} (a measurement: the light, radius 0.02, is seen "
          "directly and moving it moves discontinuous visibility, which the detached-decision "
          "gradient leaves out)")

    # ---- phase 20: the ReSTIR gradient main path ----
    stamp("phase 20 starts (the ReSTIR gradient main path)")
    fit_size, fit_steps, fit_passes = 128, 20, 4
    with torch.no_grad():
        target = optimize.render_linear(r_scene, r_cfg, r_cam, fit_size, fit_size,
                                        passes=fit_passes)
    start = r_scene.replace(emission=r_scene.emission * (1.0 + 0.6 * is_light))
    megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = 0
    restir_kernel.LAUNCHES = restir_kernel.BWD_LAUNCHES = 0
    fitted, losses = optimize.fit(start, r_cfg, r_cam, target, ("emission",), steps=fit_steps,
                                  learning_rate=0.08, passes=fit_passes,
                                  param_mask={"emission": is_light})
    torch.cuda.synchronize()
    k1_fit, k2_fit, k6_fit, launches_k7 = counts()
    em = fitted.emission[r_scene.lights_static[4]].tolist()
    print(f"phase 20: optimize.fit of restir_demo at {fit_size}x{fit_size}, passes={fit_passes}, "
          f"{fit_steps} steps: loss {losses[0]:.6f} -> {losses[-1]:.6f}, central light emission "
          f"{[round(v, 4) for v in em]} (truth 4.0, start 6.4); {k6_fit} K6 passes, "
          f"{launches_k7} K7, {k1_fit} K1, {k2_fit} K2 launches")
    if (k6_fit, launches_k7, k1_fit, k2_fit) != (fit_steps * fit_passes,) * 2 + (0, 0) \
            or not losses[-1] < losses[0]:
        raise AssertionError("the ReSTIR fit did not lower the loss through K6 and K7 alone")

    def restir_step(route, size):
        leaves = {k: getattr(r_scene, k).detach().clone().requires_grad_(True)
                  for k in RESTIR_LEAVES}
        sc = r_scene.replace(**leaves)
        if route == "kernel":   # what a user calls
            img = optimize.render_linear(sc, r_cfg, r_cam, size, size, passes=fit_passes)
        else:                   # the same step through the plain version
            state = RenderState.create(size, size, device=dev)
            total = 0.0
            for p in range(fit_passes):
                rad, new = restir.render_sample(sc, r_cfg, r_cam, state, size, size, p)
                state = state.rotate_reservoirs(new)
                total = total + rad
            img = total / fit_passes
        return torch.autograd.grad(img.sum(), list(leaves.values()))

    mem20 = {}
    for route, size in (("kernel", H), ("kernel", 128), ("plain", 128)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        restir_step(route, size)
        torch.cuda.synchronize()
        mem20[(route, size)] = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    step_full = time_stats(torch, lambda: restir_step("kernel", H), runs=9)
    step_small = time_stats(torch, lambda: restir_step("kernel", 128), runs=9)
    # the plain step's ops ran in phases 18 and 19: no warm-up
    step_plain = time_stats(torch, lambda: restir_step("plain", 128), runs=3, warmup=0)
    for name, size, (med, q1, q3) in (("K6+K7", H, step_full), ("K6+K7", 128, step_small),
                                      ("plain autograd", 128, step_plain)):
        print(f"phase 20: {card}: fwd+bwd step of render_linear(passes={fit_passes}) at "
              f"{size}x{size}, {r_cfg.max_bounces} bounces, {name}: {med:.3f} ms (q1 {q1:.3f}, "
              f"q3 {q3:.3f}); memory above the inputs {mem20[('kernel' if name != 'plain autograd' else 'plain', size)]:.1f} MiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            restir_step("kernel", H)
        torch.cuda.synchronize()
    dev20, total20 = device_times_ms(prof, ("restir_bwd_kernel", "tap_gather_kernel",
                                            "restir_reduce_kernel", "gbuf_kernel",
                                            "restir_vertex_kernel"))
    per_launch = 3 * fit_passes
    k7_dev_ms = None if dev20["restir_bwd_kernel"] is None else \
        (dev20["restir_bwd_kernel"] + dev20["tap_gather_kernel"]
         + dev20["restir_reduce_kernel"]) / per_launch
    if total20 is None:
        print("phase 20: profiler device time: not measured (no device events)")
    else:
        print(f"phase 20: {card}: device time per launch in the 512x512 step (profiler, 3 "
              f"steps of {fit_passes} passes): K7 adjoint "
              f"{dev20['restir_bwd_kernel'] / per_launch:.4f} ms, tap gather "
              f"{dev20['tap_gather_kernel'] / per_launch:.4f} ms, reduction "
              f"{dev20['restir_reduce_kernel'] / per_launch:.4f} ms; K6 pass "
              f"{(dev20['gbuf_kernel'] + dev20['restir_vertex_kernel']) / per_launch:.4f} ms "
              f"(K4 {dev20['gbuf_kernel'] / per_launch:.4f} + K6v "
              f"{dev20['restir_vertex_kernel'] / per_launch:.4f}); all kernels "
              f"{total20 / 3:.4f} ms per step")
    # K7 alone on the phase-17 inputs, and its bound
    ct20 = torch.ones((H, W, 3), dtype=torch.float32, device=dev)
    ct_res20 = [torch.ones((H, W), dtype=torch.float32, device=dev) for _ in range(4)]
    table20 = megakernel.scene_table(r_scene)
    ms_k7 = time_ms(torch, lambda: restir_kernel._launch_backward(
        r_scene, r_cfg, table20, ro17, rd17, pix17, PASSES, 0,
        (st.restir_back, st.restir_hist1, st.restir_hist2), ct20, ct_res20))
    k7_bound, k7_by = bound(ev17, r_scene, r_cfg, adjoint=True, restir=True)
    o7 = occ[("K7", "restir_demo")]
    share = "not measured" if k7_dev_ms is None else f"{k7_bound / k7_dev_ms:.2%} of it"
    print(f"phase 20: {card}: K7 alone at {H}x{W}, {r_cfg.max_bounces} bounces: {ms_k7:.3f} ms per "
          f"launch (CUDA events); plain backward of one pass at {full}x{full} "
          f"{plain_ms_k7:.3f} ms; bound {k7_bound:.6f} ms ({k7_by}), the step's device time "
          f"per launch {'not measured' if k7_dev_ms is None else f'{k7_dev_ms:.4f} ms'} reaches "
          f"{share}; occupancy {o7['blocks']} blocks of {o7['threads']} threads "
          f"({o7['warps']} warps) per SM at {o7['registers']} registers, {o7['smem']} bytes of "
          "shared memory")

    # ---- phase 21: K5 against the plain intersect.intersect ----
    stamp("phase 21 starts (K5 against the plain intersect.intersect)")
    rt_scene, rt_cam, rt_cfg = presets.animated_untextured(device=dev)   # the slice's scene
    rt_adhoc = rt_cfg.replace(restir_adhoc_motion=True)
    frame = lambda t: scene_mod.animate_positions(rt_scene, t, int(rt_cfg.render_mode))
    k5_err = {}
    for name, (s21, c21, cfg21) in (("restir_demo", presets.restir_demo(device=dev)),
                                    ("mis_demo", presets.mis_demo(device=dev)),
                                    ("the real-time scene at t = 0.5",
                                     (frame(0.5), rt_cam, rt_adhoc))):
        ro21, rd21 = generate_rays(c21, H, W, 1)
        pix21 = rng.pixel_ids(H, W, device=dev)
        t21, _, _ = restir.default_cast(s21, cfg21)(ro21, rd21)
        origins = {"the primary hits": ro21 + rd21 * t21[..., None]}
        if restir_split.unsupported_gbuffer(s21, cfg21) is None:
            _, gb21 = restir_split.gbuffer_plain(s21, cfg21, ro21, rd21, pix21, 1, 0)
            origins.update({f"G-buffer slot {k}": g["pos"] for k, g in enumerate(gb21)})
        lights21 = s21.pos[torch.clamp_min(s21.light_idx.long(), 0)]
        lp21 = lights21[pix21 % lights21.shape[0]]   # each pixel toward one of the lights
        rays21 = {"primary rays": (ro21, rd21)}
        for k, x in origins.items():
            d = (lp21 - x) / torch.linalg.vector_norm(lp21 - x, dim=-1, keepdim=True).clamp_min(1e-12)
            rays21[f"rays from {k} toward the lights"] = ((x + d * cfg21.epsilon).contiguous(),
                                                          d.contiguous())
        for what, (o, d) in rays21.items():
            t, idx, missed = restir_split.cast_rays(s21, cfg21, o, d)
            t_ref, idx_ref, missed_ref = restir.default_cast(s21, cfg21)(o, d)
            torch.cuda.synchronize()
            n_diff = int(((t != t_ref) | (idx.long() != idx_ref) | (missed != missed_ref)).sum())
            k5_err[(name, what)] = (t - t_ref).abs().max().item()
            print(f"phase 21: K5 on {name}, {what}, {H}x{W}: {n_diff} rays differ from the plain "
                  f"intersect (max |dt| {k5_err[(name, what)]:.3e}); {int(missed.sum())} misses")
            if n_diff:
                raise AssertionError(f"K5 disagrees with the plain intersect on {name}")
    k5_max_err = max(k5_err.values())

    # ---- phase 22: K4 against its plain version ----
    stamp("phase 22 starts (K4 against its plain version)")
    k4_err = {}
    for name, (s22, c22, cfg22) in (("restir_demo", presets.restir_demo(device=dev)),
                                    ("the real-time scene at t = 0.5",
                                     (frame(0.5), rt_cam, rt_adhoc))):
        for h, w in ((16, 128), (H, W)):
            ro22, rd22 = generate_rays(c22, h, w, 2)
            pix22 = rng.pixel_ids(h, w, device=dev)
            out, gb = restir_split.trace_forward_gbuffer(s22, cfg22, ro22, rd22, pix22, 2, 0)
            ref, gref = restir_split.gbuffer_plain(s22, cfg22, ro22, rd22, pix22, 2, 0)
            torch.cuda.synchronize()
            diffs = {"radiance": int((out != ref).any(-1).sum())}
            errs = [(out - ref).abs().max().item()]
            for k, (g, gr) in enumerate(zip(gb, gref)):
                for f in g:
                    ne = g[f] != gr[f]
                    diffs[f"{f}[{k}]"] = int((ne.any(-1) if ne.dim() == 3 else ne).sum())
                    if g[f].is_floating_point():
                        errs.append((g[f] - gr[f]).abs().max().item())
            k4_err[(name, h)] = max(errs)
            print(f"phase 22: K4 on {name}, {h}x{w}, {cfg22.max_bounces} bounces, {len(gb)} "
                  f"slots: pixels that differ per field {json.dumps(diffs)}; max abs err "
                  f"{max(errs):.3e}; valid vertices per slot {[int(g['valid'].sum()) for g in gb]}")
            if any(diffs.values()):
                raise AssertionError(f"K4 disagrees with its plain version on {name}")
            # the same launch forced onto one block: every lane regenerates
            # some H*W/128 times
            resident = restir_split.resident_blocks
            restir_split.resident_blocks = lambda *a: 1
            try:
                out1, gb1 = restir_split.trace_forward_gbuffer(s22, cfg22, ro22, rd22, pix22, 2, 0)
            finally:
                restir_split.resident_blocks = resident
            torch.cuda.synchronize()
            same = torch.equal(out1, ref) and all(torch.equal(g[f], gr[f]) for g, gr in
                                                  zip(gb1, gref) for f in g)
            print(f"phase 22: K4 on {name}, {h}x{w}, forced onto a grid of 1 block: bit for bit "
                  f"against the plain version: {same}")
            if not same:
                raise AssertionError(f"K4 on one block disagrees with its plain version on {name}")
    k4_max_err = max(k4_err.values())

    # ---- phase 23: K6 and K7 under ANIMATED accumulation ----
    stamp("phase 23 starts (K6 and K7 under ANIMATED accumulation)")
    def refreshed(fr, st):
        """The ring `st` with its light data replaced by the frame's
        (`restir_kernel.light_data`), which is what K6 reads."""
        def fresh(g):
            pos_, col_ = restir_kernel.light_data(fr, g.light_index)
            return dataclasses.replace(g, light_pos=pos_, light_color=col_)
        return st.replace(restir_back=fresh(st.restir_back), restir_hist1=fresh(st.restir_hist1),
                          restir_hist2=fresh(st.restir_hist2))

    k6_anim_err = {}
    for chain in ("constant", "moving, refreshed", "moving"):
        kernel_ring = RenderState.create(H, W, device=dev)
        plain_ring = RenderState.create(H, W, device=dev)
        for p in range(4):
            t = 0.9 if chain == "constant" else p / 30
            if chain == "moving, refreshed":
                plain_ring = refreshed(frame(t), plain_ring)
            before = restir_kernel.LAUNCHES
            out, new = restir_kernel.render_sample_fused(rt_scene, rt_cfg, rt_cam, kernel_ring,
                                                         H, W, p, t)
            ref, new_ref = restir.render_sample(rt_scene, rt_cfg, rt_cam, plain_ring, H, W, p, t)
            torch.cuda.synchronize()
            if restir_kernel.LAUNCHES != before + 1:
                raise AssertionError("expected one K6 pass per pass")
            n_diff = int((out != ref).any(-1).sum())
            same_res = all(torch.equal(getattr(new, k), getattr(new_ref, k))
                           for k in RESERVOIR_FIELDS)
            k6_anim_err[(chain, p)] = (out - ref).abs().max().item()
            print(f"phase 23: K6 under ANIMATED, {chain} frame time, pass {p} (t = {t:.4f}), "
                  f"{H}x{W}: {n_diff} pixels ({n_diff / (H * W):.5f} of them) differ from the "
                  f"plain render_sample, max abs err {k6_anim_err[(chain, p)]:.3e}; reservoirs "
                  + ("equal" if same_res else "differ"))
            if chain != "moving" and (n_diff or not same_res):
                raise AssertionError(f"K6 under ANIMATED ({chain}) differs from the plain version")
            kernel_ring = kernel_ring.rotate_reservoirs(new)
            plain_ring = plain_ring.rotate_reservoirs(new_ref)
    del kernel_ring, plain_ring

    animate9 = lambda s: scene_mod.animate_positions(s, 0.9, int(rt_cfg.render_mode))
    k7_kernel = lambda s, *a: restir_kernel.trace_forward_restir_fused(animate9(s), *a)
    before = (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES)
    _, got = restir_chain(k7_kernel, rt_scene, rt_cfg, rt_cam, 16, 128, 4)
    torch.cuda.synchronize()
    if (restir_kernel.LAUNCHES - before[0], restir_kernel.BWD_LAUNCHES - before[1]) != (4, 4):
        raise AssertionError("expected one K6 pass and one K7 launch per pass")
    _, again = restir_chain(k7_kernel, rt_scene, rt_cfg, rt_cam, 16, 128, 4)
    _, want = restir_chain(lambda s, *a: restir.trace_sample(animate9(s), *a), rt_scene, rt_cfg,
                           rt_cam, 16, 128, 4)
    torch.cuda.synchronize()
    errs = grad_errors(got, want)
    k7_rel_anim = max(e[0] for e in errs.values())
    same = all(torch.equal(got[k], again[k]) for k in got)
    print(f"phase 23: K7 under ANIMATED, the real-time scene at t = 0.9, 16x128, "
          f"{rt_cfg.max_bounces} bounces, passes 0-3: max relative error per leaf "
          + ", ".join(f"{k} {e[0]:.2e}" for k, e in errs.items())
          + f"; two K7 runs {'give identical bits' if same else 'DIFFER'}")
    if k7_rel_anim >= GRAD_TOL or not same:
        raise AssertionError("K7 under ANIMATED disagrees with plain autograd, or is not "
                             "deterministic")
    del got, again, want
    # the ANIMATED gradient path: render_linear through K6 and K7
    restir_kernel.LAUNCHES = restir_kernel.BWD_LAUNCHES = 0
    em23 = rt_scene.emission.detach().clone().requires_grad_(True)
    img23 = optimize.render_linear(rt_scene.replace(emission=em23), rt_cfg, rt_cam, 128, 128,
                                   passes=4)
    g23 = torch.autograd.grad(img23.sum(), em23)[0]
    torch.cuda.synchronize()
    k6_anim_grad, k7_anim_grad = restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES
    print(f"phase 23: d sum(render_linear(passes=4)) / d emission of the real-time scene at "
          f"128x128 under ANIMATED: {k6_anim_grad} K6 passes and {k7_anim_grad} K7 launches, "
          f"finite "
          f"{bool(torch.isfinite(g23).all())}, max |g| {g23.abs().max().item():.4e}")
    if (k6_anim_grad, k7_anim_grad) != (4, 4) or not bool(torch.isfinite(g23).all()):
        raise AssertionError("the ANIMATED gradient did not run on K6 and K7")

    # ---- phase 24: the real-time main path ----
    stamp("phase 24 starts (the real-time main path)")
    frames = 16
    slots = restir_split.gbuffer_slots(rt_adhoc)
    restir_split.GBUF_LAUNCHES = restir_split.CAST_LAUNCHES = restir_vertex.VERTEX_LAUNCHES = 0
    restir_kernel.LAUNCHES = restir_kernel.BWD_LAUNCHES = 0
    megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = 0
    rt_renderer = Renderer(rt_scene, rt_cam, rt_adhoc, H, W)
    for k in range(frames):
        if k == frames - 1:
            held = rt_renderer.state   # the ring the last frame reads
        rt_renderer.step(time_s=k / 30)
    torch.cuda.synchronize()
    launches_k4, launches_k5, launches_k6v = (restir_split.GBUF_LAUNCHES,
                                              restir_split.CAST_LAUNCHES,
                                              restir_vertex.VERTEX_LAUNCHES)
    k6_rt, k7_rt, k1_rt, k2_rt = (restir_kernel.LAUNCHES, restir_kernel.BWD_LAUNCHES,
                                  megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
    rt_img = rt_renderer.image()
    res24 = rt_renderer.state.restir_back
    print(f"phase 24: Renderer(real-time scene, ANIMATED_CONFIG with restir_adhoc_motion, {H}, "
          f"{W}).step(time_s=k/30) for k < {frames}: {launches_k4} K4, {launches_k6v} K6v, "
          f"{launches_k5} K5, {k6_rt} K6 passes, {k7_rt} K7, {k1_rt} K1, {k2_rt} K2 launches; "
          f"{slots} G-buffer slots; image mean {rt_img.mean().item():.6f}; share of pixels "
          f"holding a light {(res24.light_index >= 0).float().mean().item():.5f}")
    if (launches_k4, launches_k6v, launches_k5, k6_rt, k7_rt, k1_rt, k2_rt) != \
            (frames, frames, 0, 0, 0, 0, 0):
        raise AssertionError(f"expected {frames} K4 and {frames} K6v launches and no other")
    if tuple(rt_img.shape) != (H, W, 3) or not bool(torch.isfinite(rt_img).all()) \
            or not rt_img.mean().item() > 0.0:
        raise AssertionError("the real-time image is not a finite, lit f32[H, W, 3]")
    t_last = (frames - 1) / 30
    rad24, new24 = restir_split.render_sample_fast(rt_scene, rt_adhoc, rt_cam, held, H, W,
                                                   frames - 1, t_last)
    ref24, ref_new24 = restir_split.render_sample_split(
        rt_scene, rt_adhoc, rt_cam, held, H, W, frames - 1, t_last, restir_split.gbuffer_plain,
        restir.default_cast)
    wave24, _ = restir.render_sample(rt_scene, rt_adhoc, rt_cam, held, H, W, frames - 1, t_last)
    torch.cuda.synchronize()
    same24 = torch.equal(rad24, ref24) and all(torch.equal(getattr(new24, k),
                                                           getattr(ref_new24, k))
                                               for k in RESERVOIR_FIELDS)
    k6v_split_err = (rad24 - ref24).abs().max().item()
    err24 = (rad24 - wave24).abs()
    rt_max_err, rt_med_err = err24.max().item(), err24.median().item()
    print(f"phase 24: frame {frames - 1} (t = {t_last:.4f}): K4+K6v against render_sample_split "
          f"with the plain G-buffer and caster on the card: "
          f"{'identical bits' if same24 else 'DIFFER'} (radiance and reservoirs); against the "
          f"plain render_sample: max abs err {rt_max_err:.3e}, median {rt_med_err:.3e}, "
          f"{int((rad24 != wave24).any(-1).sum())} pixels differ (5e-3 and 1e-6 allowed, "
          "tests/test_restir.py:284-310)")
    if not (same24 and rt_max_err < 5e-3 and rt_med_err < 1e-6):
        raise AssertionError("the real-time frame disagrees with its plain versions")
    del ref24, wave24

    # what a frame costs, and where its time goes
    rt_frame = time_stats(torch, lambda: rt_renderer.step(time_s=0.5), runs=9)
    fr24 = frame(0.5)
    ro24, rd24 = generate_rays(rt_cam, H, W, frames)
    pix24 = rng.pixel_ids(H, W, device=dev)
    table24 = megakernel.scene_table(fr24)
    st24 = rt_renderer.state
    grids24 = (st24.restir_back, st24.restir_hist1, st24.restir_hist2)
    rad24k, gbuf24 = restir_split.launch_gbuffer(fr24, rt_adhoc, table24, ro24, rd24, pix24,
                                                 frames, 0)
    sum24 = torch.zeros_like(rad24k)
    ms_k4 = time_ms(torch, lambda: restir_split.trace_forward_gbuffer(
        fr24, rt_adhoc, ro24, rd24, pix24, frames, 0))
    ms_k6v_split = time_ms(torch, lambda: restir_vertex.launch(
        fr24, rt_adhoc, table24, ro24, rd24, pix24, frames, 0, grids24, gbuf24, rad24k,
        total=sum24))
    plain_ms_k4 = time_ms(torch, lambda: restir_split.gbuffer_plain(
        fr24, rt_adhoc, ro24, rd24, pix24, frames, 0), runs=3, warmup=1)
    ms_rays24 = time_ms(torch, lambda: generate_rays(rt_cam, H, W, frames))
    # the reservoir phases as PyTorch ops, on K4's G-buffer: K6v's plain
    # version (with its casts on K5, as the JAX split path casts them, and
    # on the plain intersector); their shadow rays are K5's inputs
    gbuf24_slots = [{k: v[i] for k, v in gbuf24.items()} for i in range(slots)]
    cached_k4 = lambda *a: (rad24k, gbuf24_slots)
    cast_inputs = []

    def k5_caster(scene, cfg):
        table = megakernel.scene_table(scene)

        def cast(o, d):
            cast_inputs.append((o, d))
            return restir_split.cast_rays(scene, cfg, o, d, table=table)
        return cast

    split_k5 = lambda: restir_split.render_sample_split(
        rt_scene, rt_adhoc, rt_cam, st24, H, W, frames, 0.5, cached_k4, k5_caster)
    split_k5()
    k5_inputs = list(cast_inputs)   # one pass's casts: 2 per slot
    phases_k5 = time_stats(torch, split_k5, runs=3, warmup=1)
    plain_ms_k6v_split = time_ms(torch, lambda: restir_split.render_sample_split(
        rt_scene, rt_adhoc, rt_cam, st24, H, W, frames, 0.5, cached_k4, restir.default_cast),
        runs=3, warmup=1)
    ms_k5_each = [time_ms(torch, lambda o=o, d=d: restir_split._launch_cast(
        fr24, rt_adhoc, table24, o, d)) for o, d in k5_inputs]
    ms_k5 = statistics.mean(ms_k5_each)
    plain_ms_k5 = time_ms(torch, lambda: restir.default_cast(fr24, rt_adhoc)(*k5_inputs[0]),
                          runs=3, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            rt_renderer.step(time_s=0.5)
        torch.cuda.synchronize()
    dev24, total24 = device_times_ms(prof, ("gbuf_kernel", "restir_vertex_kernel"))
    launches24 = device_launches(prof)
    k4_dev_ms = None if dev24["gbuf_kernel"] is None else dev24["gbuf_kernel"] / 3
    k6v_split_dev_ms = (None if dev24["restir_vertex_kernel"] is None
                        else dev24["restir_vertex_kernel"] / 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            for o, d in k5_inputs:
                restir_split._launch_cast(fr24, rt_adhoc, table24, o, d)
        torch.cuda.synchronize()
    dev24c, _ = device_times_ms(prof, ("cast_kernel",))
    k5_dev_ms = (None if dev24c["cast_kernel"] is None
                 else dev24c["cast_kernel"] / (3 * len(k5_inputs)))
    k4_grid24 = restir_split.resident_blocks(dev, True, megakernel.packed_smem_bytes(fr24))
    ev24 = path_events(torch, fr24, rt_adhoc, ro24, rd24, pix24, frames, 0, gbuffer=True,
                       resident_warps=k4_grid24 * 4)
    k4_bound, k4_by = bound(ev24, fr24, rt_adhoc, adjoint=False, gbuffer_slots=slots)
    ev24v = path_events(torch, fr24, rt_adhoc, ro24, rd24, pix24, frames, 0, ring=st24)
    k6v_split_bound, k6v_split_by = vertex_bound(ev24v, fr24, rt_adhoc, slots, split=True)
    k5_bounds = [cast_bound(torch, fr24, rt_adhoc, o, d) for o, d in k5_inputs]
    k5_bound = statistics.mean(b[0] for b in k5_bounds)
    k5_by = "operations" if sum(b[1] == "operations" for b in k5_bounds) * 2 > len(k5_bounds) \
        else "bytes"
    rest = rt_frame[0] - ms_rays24 - ms_k4 - ms_k6v_split
    o6s = occ[("K6v split", "animated_untextured")]
    print(f"phase 24: path events of K4 on a real-time frame at {H}x{W}: {json.dumps(ev24)}")
    print(f"phase 24: {card}: K4 on the real-time frame "
          + ("not measured" if k4_dev_ms is None else f"{k4_dev_ms:.4f} ms")
          + f" of device time ({ms_k4:.3f} ms alone) on a persistent grid of {k4_grid24} blocks; "
          f"its bounce loop's warp lane use (plain replay, 32 pixels a warp): "
          f"{ev24['lane_use']:.4f} one pixel per thread, {ev24['lane_use_regenerated']:.4f} "
          f"simulated under regeneration; its SDF march's {ev24.get('march_lane_use', 1.0):.4f}")
    print(f"phase 24: path events of the frame's reservoir vertices: {json.dumps(ev24v)}")
    print(f"phase 24: K5 events per launch of the plain split pass: "
          + "; ".join(json.dumps(b[2]) for b in k5_bounds))
    print(f"phase 24: {card}: real-time frame (Renderer.step, ANIMATED + ad-hoc motion, "
          f"{H}x{W}, {rt_adhoc.max_bounces} bounces, {rt_adhoc.marching_steps} marching steps): "
          f"{rt_frame[0]:.3f} ms (q1 {rt_frame[1]:.3f}, q3 {rt_frame[2]:.3f}), "
          + ("device launches not measured" if launches24 is None else
             f"{launches24 / 3:.1f} device launches per frame (profiler)")
          + f"; of it, alone (CUDA events): generate_rays {ms_rays24:.3f} ms, K4 {ms_k4:.3f} ms, "
          f"K6v {ms_k6v_split:.3f} ms, the rest {rest:.3f} ms ({rest / rt_frame[0]:.3f} of the "
          "frame); device time per launch (profiler): K4 "
          + ("not measured" if k4_dev_ms is None else f"{k4_dev_ms:.4f} ms")
          + ", K6v " + ("not measured" if k6v_split_dev_ms is None else
                        f"{k6v_split_dev_ms:.4f} ms")
          + ("" if total24 is None else f", all kernels {total24 / 3:.4f} ms per frame")
          + f"; bounds: K4 {k4_bound:.6f} ms ({k4_by}), K6v {k6v_split_bound:.6f} ms "
          f"({k6v_split_by}); K6v occupancy {o6s['blocks']} blocks ({o6s['warps']} warps) per "
          f"SM at {o6s['registers']} registers; plain K4 {plain_ms_k4:.3f} ms")
    print(f"phase 24: {card}: the frame's reservoir phases as PyTorch ops on K4's G-buffer "
          f"(K6v's plain version, with ray generation): casts on K5 (the JAX split path's) "
          f"{phases_k5[0]:.3f} ms (q1 {phases_k5[1]:.3f}, q3 {phases_k5[2]:.3f}), on the plain "
          f"intersector {plain_ms_k6v_split:.3f} ms; K5 on their {len(k5_inputs)} casts "
          f"{' + '.join(f'{m:.3f}' for m in ms_k5_each)} ms (CUDA events), device "
          + ("not measured" if k5_dev_ms is None else f"{k5_dev_ms:.4f} ms")
          + f" per launch, bound {k5_bound:.6f} ms ({k5_by}); plain K5 {plain_ms_k5:.3f} ms")
    del rad24k, gbuf24, gbuf24_slots, sum24

    # the ANIMATED frame through K6 (no ad-hoc motion), and through K1 (ReSTIR off)
    restir_kernel.LAUNCHES = 0
    k6_renderer = Renderer(rt_scene, rt_cam, rt_cfg, H, W)
    for k in range(frames):
        k6_renderer.step(time_s=k / 30)
    torch.cuda.synchronize()
    launches_k6_anim = restir_kernel.LAUNCHES
    k6_frame = time_stats(torch, lambda: k6_renderer.step(time_s=0.5), runs=9)
    nee_cfg = rt_cfg.replace(use_restir=False)
    megakernel.LAUNCHES = 0
    k1_renderer = Renderer(rt_scene, rt_cam, nee_cfg, H, W)
    for k in range(frames):
        k1_renderer.step(time_s=k / 30)
    torch.cuda.synchronize()
    launches_k1_anim = megakernel.LAUNCHES
    k1_frame = time_stats(torch, lambda: k1_renderer.step(time_s=0.5), runs=9)
    out24 = sample_radiance(rt_scene, nee_cfg, rt_cam, H, W, 3, 0.5)
    ro_k1, rd_k1 = generate_rays(rt_cam, H, W, 3)
    ref_k1 = integrator.trace(frame(0.5), nee_cfg, ro_k1, rd_k1, pix24, 3, 0)
    torch.cuda.synchronize()
    k1_anim_diff = int((out24 != ref_k1).any(-1).sum())
    print(f"phase 24: {card}: the ANIMATED frame at {H}x{W} through K6 (no ad-hoc motion): "
          f"{launches_k6_anim} K6 passes in {frames} frames, {k6_frame[0]:.3f} ms (q1 "
          f"{k6_frame[1]:.3f}, q3 {k6_frame[2]:.3f}); through K1 (ReSTIR off, per-light NEE): "
          f"{launches_k1_anim} K1 launches in {frames} frames, {k1_frame[0]:.3f} ms (q1 "
          f"{k1_frame[1]:.3f}, q3 {k1_frame[2]:.3f}), {k1_anim_diff} pixels of a pass differ "
          "from the plain version")
    if launches_k6_anim != frames or launches_k1_anim != frames or k1_anim_diff:
        raise AssertionError("the ANIMATED frames did not run on K6 and K1, or K1 disagrees")

    # ---- phase 25: refusals before any launch ----
    stamp("phase 25 starts (refusals before any launch)")
    split_counts = lambda: (restir_split.GBUF_LAUNCHES, restir_split.CAST_LAUNCHES,
                            restir_vertex.VERTEX_LAUNCHES) + counts()
    before = split_counts()
    em25 = rt_scene.emission.clone().requires_grad_(True)
    # what -> (the call, the ROADMAP item its refusal names)
    refusals = {
        "a gradient through the split path": (lambda: Renderer(
            rt_scene.replace(emission=em25), rt_cam, rt_adhoc, 16, 16).step(0.1), None),
        "optimize.render_linear with ad-hoc motion and a gradient": (
            lambda: optimize.render_linear(rt_scene.replace(emission=em25), rt_adhoc, rt_cam, 16,
                                           16, passes=2), None),
    }
    # fault 15's rule: K6 admits these since K4 and K6v gained their
    # whole-SDF copies, and K7 since its whole-SDF copy is held (phase 29);
    # a gradient K7 still does not compute, w.r.t. a texel array (the noise
    # LUT), is refused before any launch, naming item 14
    for label, (sc25, cam25, cfg25) in k7_sdf_scenes(dev).items():
        k6_why, k7_why = (restir_kernel.unsupported_restir(sc25, cfg25),
                          restir_kernel.unsupported_restir_bwd(sc25, cfg25))
        print(f"phase 25: {label}: K6's gate {k6_why}; K7's gate {k7_why}, its copy "
              f"{restir_kernel.bwd_copy(sc25)}")
        if k6_why is not None or k7_why is not None or restir_kernel.bwd_copy(sc25) != "whole_sdf":
            raise AssertionError(f"{label}: K6 or K7 refuses it, or K7 runs its ROUND_BOX copy")
        lut_k7 = sc25.noise.clone().requires_grad_(True)
        refusals[f"a ReSTIR gradient w.r.t. the noise LUT of {label} (K7)"] = (
            lambda sc=sc25, cm=cam25, c=cfg25, n=lut_k7: optimize.render_linear(
                sc.replace(noise=n), c.replace(max_bounces=2), cm, 8, 8, passes=2), "item 14")
    # three classes of the whole SDF class: K5 refuses them naming item 8;
    # the ReSTIR gates, K7's among them, admit the Mandelbulb (K4's, K6v's
    # and K7's whole-SDF copies) and refuse default_scene (no light for
    # ReSTIR) and the SDF light (its slot is no LIGHT sphere) naming item 11
    new_classes = {"a Mandelbulb": presets.mandelbulb(device=dev),
                   "a textured BOX SDF (default_scene)": presets.default_scene(device=dev),
                   "an SDF light": presets.sdf_view("sdf_light", device=dev)}
    for label, (sc25, cam25, cfg25) in new_classes.items():
        em_n = sc25.emission.clone().requires_grad_(True)
        rc25 = cfg25.replace(use_restir=True, use_mis=False)
        ro25, rd25 = generate_rays(cam25, 8, 8, 0)
        if megakernel.unsupported_bwd(sc25, cfg25) is not None:
            raise AssertionError(f"K2 refuses {label}: {megakernel.unsupported_bwd(sc25, cfg25)}")
        gates = {"K4": restir_split.unsupported_gbuffer(sc25, rc25),
                 "K5": restir_split.unsupported_cast(sc25),
                 "K6": restir_kernel.unsupported_restir(sc25, rc25),
                 "K6v": restir_vertex.unsupported(sc25, restir_split.gbuffer_slots(rc25)),
                 "K7": restir_kernel.unsupported_restir_bwd(sc25, rc25),
                 "ReSTIR": integrator.unsupported(sc25, rc25)}
        restir_item = None if label == "a Mandelbulb" else "item 11"
        for gate, why in gates.items():
            want = "item 8" if gate == "K5" else None if gate == "K6v" else restir_item
            print(f"phase 25: {gate}'s gate on {label}: {why}")
            if (why is None) != (want is None) or (want is not None and want not in why):
                raise AssertionError(f"{gate}'s gate on {label}: expected {want}, got {why}")
        if restir_item is not None:
            refusals[f"a ReSTIR pass on {label} (K4, K6)"] = (
                lambda sc=sc25, cm=cam25, c=rc25: Renderer(sc, cm, c, 8, 8).step(), restir_item)
            refusals[f"the split path on {label} (K4, K6v)"] = (
                lambda sc=sc25, cm=cam25, c=rc25: Renderer(
                    sc, cm, c.replace(restir_adhoc_motion=True), 8, 8).step(0.1), restir_item)
            # a ReSTIR gradient's route asks K6's gate before K7's
            refusals[f"a ReSTIR gradient on {label} (K6, then K7)"] = (
                lambda sc=sc25, cm=cam25, c=rc25, e=em_n: optimize.render_linear(
                    sc.replace(emission=e), c, cm, 8, 8, passes=2), restir_item)
        refusals[f"K5's cast on {label}"] = (
            lambda sc=sc25, c=cfg25, o=ro25, r=rd25: restir_split.cast_rays(sc, c, o, r),
            "item 8")
    demo25, demo_cam25, demo_cfg25 = presets.restir_demo(device=dev)
    adhoc25 = demo_cfg25.replace(restir_adhoc_motion=True)
    # a BOX row in a scene K4 and K6v march without the whole SDF class:
    # K7 refuses it, naming item 8
    box25 = demo25.replace(sdf_shapes_static=(0,),
                           emission=demo25.emission.clone().requires_grad_(True))
    refusals["a ReSTIR gradient on restir_demo with its rounded box a BOX (K7)"] = (
        lambda: optimize.render_linear(box25, demo_cfg25, demo_cam25, 8, 8, passes=2), "item 8")
    refusals["restir_demo with a cubemap on the split path"] = (lambda: Renderer(
        demo25, demo_cam25, adhoc25.replace(use_cubemap=True, use_procedural_sky=False),
        16, 16).step(0.1), "item 11")
    for what, (call, item) in refusals.items():
        try:
            call()
        except NotImplementedError as exc:
            print(f"phase 25: {what} raises NotImplementedError: {exc}")
            if item is not None and item not in str(exc):
                raise AssertionError(f"{what} is refused without naming {item}")
        else:
            raise AssertionError(f"{what} did not raise")
    if split_counts() != before:
        raise AssertionError("a refused call launched a kernel")

    # ---- phase 26: the whole SDF class on K1: the reference's presets 0, 2 and 3 ----
    stamp("phase 26 starts (the whole SDF class on K1: the reference's presets 0, 2 and 3)")
    plain_trace, plain_calls = integrator.trace, [0]

    def counted_plain(*args, **kw):
        plain_calls[0] += 1
        return plain_trace(*args, **kw)

    whole, events26 = {}, {}
    for name in ("default_scene", "mandelbulb", "menger_sponge"):
        sc26, cam26, cfg26 = getattr(presets, name)(device=dev)
        if megakernel.unsupported(sc26, cfg26) is not None or not megakernel.whole_sdf(sc26):
            raise AssertionError(f"{name}: expected in K1's whole-SDF class")
        # the main path, its counts set to 0 just before and read just after
        megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = plain_calls[0] = 0
        integrator.trace = counted_plain
        try:
            img26 = Renderer(sc26, cam26, cfg26, H, W).render(2)
            torch.cuda.synchronize()
        finally:
            integrator.trace = plain_trace
        launches26 = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES, plain_calls[0])
        print(f"phase 26: {name}: Renderer.render(2) at {H}x{W}, {cfg26.max_bounces} bounces, "
              f"{cfg26.marching_steps} marching steps: {launches26[0]} K1 launches, "
              f"{launches26[1]} K2, {launches26[2]} calls of the plain version; image mean "
              f"{img26.mean().item():.6f}")
        if launches26 != (2, 0, 0) or not bool(torch.isfinite(img26).all()) \
                or not img26.mean().item() > 0.01:
            raise AssertionError(f"{name}: the main path did not run K1 alone, or its image is "
                                 "not finite or black")
        stamp(f"phase 26: {name}: the main path ran")
        ro26, rd26 = generate_rays(cam26, H, W, 0)
        pix26 = rng.pixel_ids(H, W, device=dev)
        out26 = megakernel.trace_forward(sc26, cfg26, ro26, rd26, pix26, 0, 0)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        ref26 = integrator.trace(sc26, cfg26, ro26, rd26, pix26, 0, 0)
        ev1.record()
        torch.cuda.synchronize()
        n_diff = int((out26 != ref26).any(dim=-1).sum())
        err26 = (out26 - ref26).abs().max().item()
        print(f"phase 26: {name}: K1 against the plain version at {H}x{W}: {n_diff} of {H * W} "
              f"pixels differ (share {n_diff / (H * W):.6f}), max abs err {err26:.3e}; means "
              f"{out26.mean().item():.6f} and {ref26.mean().item():.6f}")
        if n_diff:
            raise AssertionError(f"{name}: K1's whole-SDF copy differs from the plain version")
        stamp(f"phase 26: {name}: held against the plain version")
        pass26 = time_stats(torch, lambda: sample_radiance(sc26, cfg26, cam26, H, W, 0))
        dev26 = k1_device_ms((name,), dev)[name]
        stamp(f"phase 26: {name}: timed")
        # the path events of pass 0's rays, which phase 27's bound of K2 on
        # the same rays reads too
        ev26 = events26[name] = path_events(torch, sc26, cfg26, ro26, rd26, pix26, 0, 0)
        stamp(f"phase 26: {name}: path events counted")
        b26 = bound(ev26, sc26, cfg26, adjoint=False)
        flops = {SdfShape(s).name: OPS_SDF_SHAPE[int(s)] for s in sc26.sdf_shapes_static}
        print(f"phase 26: path events of {name} at {H}x{W}: {json.dumps(ev26)}")
        print(f"phase 26: {card}: {name}: sample_radiance pass {pass26[0]:.3f} ms (q1 "
              f"{pass26[1]:.3f}, q3 {pass26[2]:.3f}; CUDA events), K1 device time "
              f"{dev26[0]:.5f} ms (k1_device_time.py, rounds {[round(x, 5) for x in dev26[1]]}), "
              f"plain version {ev0.elapsed_time(ev1):.3f} ms; bound {b26[0]:.6f} ms ({b26[1]}), "
              f"float operations per distance {flops}; march lane use "
              f"{ev26.get('march_lane_use', 1.0):.4f}")
        whole[name] = {"launches": launches26[0], "max_abs_err": err26, "pixels_differing": n_diff,
                       "ms": pass26[0], "device_ms": dev26[0], "plain_ms": ev0.elapsed_time(ev1),
                       "bound_ms": b26[0], "bound_by": b26[1]}
        del out26, ref26

    # ---- phase 27: the whole SDF class on K2 ----
    stamp("phase 27 starts (the whole SDF class on K2)")
    t27 = time.perf_counter()
    failed27 = []

    def hold27(what, check):
        """Run `check`; a failure is kept, and phase 27 fails after its last
        comparison, so one run prints every reading."""
        try:
            return check()
        except AssertionError as exc:
            failed27.append(f"{what}: {exc}")
            print(f"phase 27: FAILED {what}: {exc}")
            return None

    def picked27(grads_of, on, rows):
        """`grads_of` with the cotangents of the mesh `rows` and of the rays
        of the `on` pixels alone."""
        def picked(kind, mask):
            out, g = grads_of(kind, mask)
            return out, {k: v[on] if k in ("ro", "rd") else v[rows] for k, v in g.items()}

        return picked

    def held_text(errs, left_out, arbitrated, held):
        return (f"(after float64 arbitration: {left_out} pixels left out, {arbitrated} entries "
                "arbitrated) " + ", ".join(f"{k} {e[0]:.2e} ({e[1]:.2e})" for k, e in errs.items())
                + "".join(f"; {k} held against float64: K2 misses it by {e[1]:.3e}, the float32 "
                          f"plain autograd by {e[0]:.3e}" for k, e in held.items()))

    # K2's adjoint of each SDF shape's distance, in the scene that holds it
    # (the every-shape scene, presets 0, 2 and 3): the cotangents of that
    # shape's rows and of the rays whose first hit is one of them
    from raytracer0_tpu_torch.ops import intersect as intersect27

    shape_scene27 = {"BOX": "default_scene", "MENGER_SPONGE": "menger_sponge",
                     "MANDELBULB": "mandelbulb"}
    scene_grads27, dist27 = {}, {}
    for shape in [sh.name for sh in SdfShape] + ["every_shape"]:
        where = shape_scene27.get(shape, "every_shape")
        if where not in scene_grads27:
            sc, cm, c = (presets.sdf_view(where, device=dev) if where == "every_shape"
                         else getattr(presets, where)(device=dev))
            c = c.replace(max_bounces=2, marching_steps=64)
            r27, d27 = generate_rays(cm, 64, 64, 0)
            p27 = rng.pixel_ids(64, 64, device=dev)
            hit27 = intersect27.intersect(sc, r27, d27, c, need_normal=False)
            scene_grads27[where] = (sc, torch.where(hit27.missed, -1, hit27.idx),
                                    cached_grads(torch, sc, c, r27, d27, p27))
        sc, first27, all27 = scene_grads27[where]
        rows = [sc.num_analytic + k for k, sh in enumerate(sc.sdf_shapes_static)
                if shape == "every_shape" or sh == int(SdfShape[shape])]
        on = torch.isin(first27, torch.tensor(rows, device=dev))
        grads_of = picked27(all27, on, rows)
        res = hold27(f"{shape}'s distance adjoint", lambda: arbitrated_errors(
            grads_of("kernel", None)[1], grads_of("plain", None)[1], grads_of,
            ill_conditioned=where == "menger_sponge",
            f64_leaves=("pos", "joker", "ro", "rd") if where == "default_scene" else ()))
        if res is not None:
            dist27[shape] = {"scene": where, "pixels": int(on.sum().item()),
                             "max_rel_err": max(e[1] for e in res[0].values()),
                             "float64_held": res[3]}
            print(f"phase 27: {shape}'s distance adjoint on its {dist27[shape]['pixels']} pixels "
                  f"of {where} at 64x64, 2 bounces, 64 marching steps: max relative error per "
                  "leaf against plain autograd " + held_text(*res))
    del scene_grads27
    stamp("phase 27: the distance adjoints held")

    # K2's whole-SDF copy against plain autograd: the class scenes at 64x64,
    # the presets at 128x128, 4 bounces and 64 marching steps
    cases27 = {name: presets.sdf_view(name, device=dev)
               for name in ("every_shape", "sdf_light", "textured_sdf")}
    cases27["sdf_light_mis"] = cases27["sdf_light"][:2] + (
        cases27["sdf_light"][2].replace(use_mis=True),)
    for name in ("default_scene", "mandelbulb", "menger_sponge"):
        cases27[name] = getattr(presets, name)(device=dev)
    k2_whole, plain27 = {}, {}
    for name, (sc, cm, c) in cases27.items():
        c = c.replace(max_bounces=4, marching_steps=64)
        size = 128 if hasattr(presets, name) else 64
        if megakernel.unsupported_bwd(sc, c) is not None or megakernel.bwd_copy(sc, c) != "whole_sdf":
            raise AssertionError(f"{name}: expected in K2's whole-SDF copy")
        r27, d27 = generate_rays(cm, size, size, 0)
        p27 = rng.pixel_ids(size, size, device=dev)
        plain27[name] = {}
        grads_of = cached_grads(torch, sc, c, r27, d27, p27, plain27[name])
        before = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES)
        out27, got = grads_of("kernel", None)
        torch.cuda.synchronize()
        if (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES) != (before[0] + 1, before[1] + 1):
            raise AssertionError("expected one K1 and one K2 launch per backward")
        ref27, want = grads_of("plain", None)
        if not torch.equal(out27, ref27):
            raise AssertionError(f"{name}: K1 differs from the plain version under the gradient")
        res = hold27(f"K2 on {name}", lambda: arbitrated_errors(
            got, want, grads_of, ill_conditioned=name == "menger_sponge",
            f64_leaves=("pos", "joker", "ro", "rd") if name == "default_scene" else ()))
        if res is None:
            k2_whole[name] = {}
            continue
        errs, left_out, arbitrated, held = res
        shown = {k: e for k, e in errs.items() if want[k].abs().max().item() > 0.0}
        print(f"phase 27: {name} {size}x{size}, {c.max_bounces} bounces, {c.marching_steps} "
              f"marching steps, K2's whole-SDF copy: max relative error per leaf against plain "
              "autograd " + held_text(shown, left_out, arbitrated, held))
        k2_whole[name] = {"max_rel_err": max(e[1] for e in errs.values()),
                          "max_rel_err_raw": max(e[0] for e in errs.values()),
                          "pixels_left_out": left_out, "entries_arbitrated": arbitrated,
                          "float64_held": held}
        del got, want, grads_of
        stamp(f"phase 27: K2 held on {name}")
    print(f"phase 27: gradients held in {time.perf_counter() - t27:.1f} s")

    # central differences of K1 on the pixels linear in the parameter: held
    # where the parameter moves smooth SDF surfaces (the SDF light's pos.y and
    # joker scale: its NEE point and the implicit t of its shadow rays; the
    # textured SDF sphere's pos.y: its hits' implicit t and texel); printed
    # alone on the fractal and the box (PERF.md §7): `menger_sponge`'s
    # gradient w.r.t. its scale is the tetrahedral normal's derivative where
    # its taps straddle carvings finer than the step (the plain version's
    # alike), and `default_scene`'s SPEC box under the cubemap at infinity
    # moves no linear pixel
    fd27 = {}
    mg_scene, mg_cam, mg_cfg = presets.menger_sponge(device=dev)
    ds_scene, ds_cam, ds_cfg = presets.default_scene(device=dev)
    sl_scene, sl_cam, sl_cfg = presets.sdf_view("sdf_light", device=dev)
    tx_scene, tx_cam, tx_cfg = presets.sdf_view("textured_sdf", device=dev)
    for name, sc, cm7, c7, leaf, row, comp, held in (
            ("sdf_light pos[6].y (the SDF light)", sl_scene, sl_cam, sl_cfg, "pos", 6, 1, True),
            ("sdf_light joker[6, 0:3] (the SDF light's scale)", sl_scene, sl_cam, sl_cfg, "joker",
             6, slice(0, 3), True),
            ("textured_sdf pos[5].y (the textured SDF sphere)", tx_scene, tx_cam, tx_cfg, "pos",
             5, 1, True),
            ("menger_sponge joker[0, 0:3] (its scale)", mg_scene, mg_cam, mg_cfg, "joker", 0,
             slice(0, 3), False),
            ("default_scene pos[0].y (the upper box)", ds_scene, ds_cam, ds_cfg, "pos", 0, 1,
             False)):
        c7 = c7.replace(max_bounces=4, marching_steps=64)
        ad, fd, share = masked_fd(sc, c7, cm7, leaf, row, comp, 1e-2, fd_size)
        rel = abs(ad - fd) / max(abs(fd), 1e-6)
        fd27[name] = {"ad": ad, "fd": fd, "rel": rel, "linear_share": share, "held": held}
        print(f"phase 27: d sum / d {name} at {fd_size}x{fd_size}, {c7.max_bounces} bounces, on "
              f"the {share:.4f} of pixels linear in it (step 1e-2): K2 {ad:.6f}, K1 central "
              f"difference {fd:.6f}, relative error {rel:.2e}"
              + ("" if held else " (printed, not held)"))
        if held and not rel < FD_TOL:
            failed27.append(f"K2 disagrees with finite differences of K1 ({name})")
    stamp("phase 27: the central differences held")

    # the gradient main path on the class: optimize.fit through K1 and K2
    # alone, on `mandelbulb`'s emission and color, `menger_sponge`'s color
    # and joker (its scale: a geometric leaf through the implicit t and the
    # normal) and the SDF light's position (a geometric leaf through the
    # implicit t of its shadow rays), each lowering its loss
    fits27 = {}
    light_row = (torch.arange(sl_scene.num_meshes, device=dev) == 6).float()[:, None]
    for name, names27, start27, mask27 in (
            ("mandelbulb", ("emission", "color"), lambda sc: dict(
                emission=sc.emission * 0.7, color=sc.color * 0.7), None),
            ("menger_sponge", ("color",), lambda sc: dict(color=sc.color * 0.7), None),
            ("sdf_light", ("pos",), lambda sc: dict(pos=sc.pos - 0.1 * light_row * torch.tensor(
                [0.0, 1.0, 0.0], device=dev)), {"pos": light_row}),
            ("menger_sponge joker", ("joker",), lambda sc: dict(joker=sc.joker * 0.9), None)):
        sc, cm, c = (presets.sdf_view("sdf_light", device=dev) if name == "sdf_light"
                     else getattr(presets, name.split()[0])(device=dev))
        c = c.replace(max_bounces=4, marching_steps=64)
        target27 = sample_radiance(sc, c, cm, 64, 64, 0)
        megakernel.LAUNCHES = megakernel.BWD_LAUNCHES = plain_calls[0] = 0
        integrator.trace = counted_plain
        try:
            _, losses27 = optimize.fit(sc.replace(**start27(sc)), c, cm, target27, list(names27),
                                       steps=10, learning_rate=2e-2, param_mask=mask27)
            torch.cuda.synchronize()
        finally:
            integrator.trace = plain_trace
        counts27 = (megakernel.LAUNCHES, megakernel.BWD_LAUNCHES, plain_calls[0])
        fits27[name] = {"loss_first": losses27[0], "loss_last": losses27[-1],
                        "k1_launches": counts27[0], "k2_launches": counts27[1],
                        "plain_calls": counts27[2]}
        print(f"phase 27: optimize.fit of {name.split()[0]}'s {', '.join(names27)} at 64x64, 10 "
              f"steps: loss {losses27[0]:.6e} -> {losses27[-1]:.6e}; {counts27[0]} K1 launches, "
              f"{counts27[1]} K2, {counts27[2]} calls of the plain version")
        if counts27 != (10, 10, 0) or not losses27[-1] < losses27[0]:
            failed27.append(f"the fit of {name} did not lower its loss through K1 and K2 alone")
    whole_grad_launches = sum(v["k2_launches"] for v in fits27.values())
    print(f"phase 27: central differences and fits in {time.perf_counter() - t27:.1f} s")
    if failed27:
        raise AssertionError("phase 27: " + "; ".join(failed27))

    # K2's whole-SDF copy timed on the presets at 512x512, 12 bounces, 128
    # steps, its bound from phase 26's path events of the same rays
    stamp("phase 27: the fits ran")
    occ27 = kernel_occupancy(dev)
    k2_dev27 = k2_device_ms(dev, tuple(f"k2_{n}" for n in ("default_scene", "mandelbulb",
                                                              "menger_sponge")))
    pix27 = rng.pixel_ids(H, W, device=dev)
    for name in ("default_scene", "mandelbulb", "menger_sponge"):
        sc, cm, c = getattr(presets, name)(device=dev)
        r27, d27 = generate_rays(cm, H, W, 0)
        ct27 = torch.ones((H, W, 3), dtype=torch.float32, device=dev)
        table27 = megakernel.scene_table(sc)
        ms27 = time_stats(torch, lambda: megakernel._launch_backward(
            sc, c, table27, r27, d27, pix27, 0, 0, ct27), runs=5, warmup=1)
        b27 = bound(events26[name], sc, c, adjoint=True, sdf_adjoint=True)
        # the plain version's forward and backward: its hold's above, at
        # 128x128, 4 bounces, 64 marching steps (its time is its launches,
        # per bounce and marching step, not its pixels)
        plain_ms27 = plain27[name].get("plain")
        dev_ms = k2_dev27.get(f"k2_{name}", {}).get("ms")
        o27 = occ27[("K2", name)]
        share27 = None if dev_ms is None else b27[0] / dev_ms
        k2_whole[name].update({"ms": ms27[0], "device_ms": dev_ms,
                               "plain_fwd_bwd_ms_128_4_bounces": plain_ms27,
                               "bound_ms": b27[0], "bound_by": b27[1], "share_of_bound": share27,
                               "registers": o27["registers"], "local_bytes": o27["local_bytes"],
                               "blocks_per_sm": o27["blocks"],
                               "ptxas": k2_ptxas["whole-SDF per thread"]
                               if not megakernel.bwd_layout(sc, c)[0]
                               else k2_ptxas["whole-SDF per warp"]})
        print(f"phase 27: {card}: K2 on {name} at {H}x{W}, {c.max_bounces} bounces, "
              f"{c.marching_steps} marching steps: {ms27[0]:.3f} ms (q1 {ms27[1]:.3f}, q3 "
              f"{ms27[2]:.3f}; CUDA events), device "
              + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
              + f" (k1_device_time.py); bound {b27[0]:.6f} ms ({b27[1]}, the distance adjoints "
              f"counted), share of the bound "
              + ("not measured" if share27 is None else f"{share27:.4f}")
              + f"; the plain forward and backward at 128x128, 4 bounces, 64 marching steps "
              f"{plain_ms27:.1f} ms; {o27['registers']} "
              f"registers, {o27['local_bytes']} bytes of local memory, {o27['blocks']} blocks "
              f"per SM; ptxas {k2_whole[name]['ptxas']}")

    # ---- phase 28: ReSTIR over the whole SDF class and blended textures ----
    stamp("phase 28 starts (ReSTIR over the whole SDF class and blended textures)")
    t28 = time.perf_counter()
    p28 = restir_sdf_phase(torch, dev, card, occ)
    print(f"phase 28: {time.perf_counter() - t28:.1f} s")
    bulb28, held28 = p28["mandelbulb"], p28["held"]
    plain_bulb28 = statistics.median(held28["mandelbulb"]["plain_ms_pass"])

    # ---- phase 29: K7 over the whole SDF class and blended textures ----
    stamp("phase 29 starts (K7 over the whole SDF class and blended textures)")
    t29 = time.perf_counter()
    p29 = restir_grad_sdf_phase(torch, dev, card, occ,
                                {"mandelbulb": p28["mandelbulb_events"]})
    print(f"phase 29: {time.perf_counter() - t29:.1f} s")
    held29, step29 = p29["held"], p29["step"]

    # ---- phase 30: spectral transport and the homogeneous medium on K1 ----
    stamp("phase 30 starts (spectral transport and the homogeneous medium on K1)")
    t30 = time.perf_counter()
    p30 = medium_phase(torch, dev, card, occ)
    print(f"phase 30: {time.perf_counter() - t30:.1f} s")

    # ---- phase 31: the adjoint of spectral transport and the medium on K2 ----
    stamp("phase 31 starts (the adjoint of spectral transport and the medium on K2)")
    t31 = time.perf_counter()
    p31 = medium_grad_phase(torch, dev, card, occ, p30["events"])
    print(f"phase 31: {time.perf_counter() - t31:.1f} s")

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    common = dict(route="cuda", library_ms=None)
    print(json.dumps({"kernels": [
        {"name": "K1 forward megakernel", **common,
         "source": "raytracer0_tpu_torch/csrc/megakernel.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:2357",
         "launches": launches,
         "launches_by_path": {"render": launches, "gradient": launches_grad,
                              "cubemap_render": launches_cube, "texture_render": launches_tex,
                              "gloss_render": launches_gloss,
                              "animated_render": launches_k1_anim,
                              "whole_sdf_render": sum(v["launches"] for v in whole.values())},
         "max_abs_err": max_abs_err, "ms": ms_trace, "plain_ms": plain_ms_trace,
         "bound_ms": k1_bound, "bound_by": k1_by,
         "ms_config2": k1_ms["config2"], "device_ms_config2": k1_dev_ms["config2"],
         "plain_ms_config2": plain_ms["config2"], "bound_ms_config2": k1_bound9["config2"][0],
         "max_abs_err_config2": widened_err[("config2", H)],
         "max_abs_err_mis_demo": sdf_err[("mis_demo", H)],
         "ms_mis_demo": ms_sdf, "device_ms_mis_demo": k1_dev["mis_demo"][0],
         "plain_ms_mis_demo": plain_ms_sdf, "bound_ms_mis_demo": sdf_bound,
         "device_ms_cornell_alone": k1_dev["cornell_default"][0],
         "whole_sdf_copy": whole},
        {"name": "K1 forward megakernel, its medium copy (spectral transport and the "
                 "homogeneous medium)", **common,
         "source": "raytracer0_tpu_torch/csrc/megakernel.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:1731",
         "also_replaces": "raytracer0_tpu/ops/megakernel.py:461, :434, :454, :1551, :2056, "
                          ":2237 (the hero wavelength, HG, the fog, Cauchy's IOR, the HG "
                          "continuation of _build_bounce)",
         "scene": "spectral_caustics (the reference's preset 8)",
         "launches": p30["launches"],
         "max_abs_err": max(v["max_abs_err"] for v in p30["held"].values()),
         "held": p30["held"], "ms": p30["ms"], "device_ms": p30["device_ms"],
         "pass_ms": p30["pass_ms"], "plain_ms": p30["plain_ms"], "bound_ms": p30["bound_ms"],
         "bound_by": p30["bound_by"], "blocks_per_sm": p30["blocks_per_sm"],
         "registers": p30["registers"], "local_bytes": p30["local_bytes"]},
        {"name": "K2 adjoint megakernel", **common,
         "source": "raytracer0_tpu_torch/csrc/megakernel_bwd.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:2545",
         "also_serves": "raytracer0_tpu/ops/megakernel.py:2445 (K3, the whole-trace "
                        "adjoint body, same outputs)",
         "launches": bwd_launches,
         "launches_by_path": {"render": bwd_render, "gradient": bwd_launches,
                              "config2_fit": fit2_launches[1],
                              "whole_sdf_gradient": whole_grad_launches},
         "max_abs_err": k2_abs, "max_rel_err": k2_rel,
         "max_rel_err_many_meshes": k2_many_rel, "ms": ms_k2,
         "plain_ms": plain_ms_bwd, "bound_ms": k2_bound, "bound_by": k2_by,
         "wide_copy": k2_wide, "finite_differences_wide": fd_wide,
         "whole_sdf_copy": k2_whole, "whole_sdf_distances": dist27,
         "finite_differences_whole_sdf": fd27, "whole_sdf_fits": fits27},
        {"name": "K2 adjoint megakernel, its medium copy (the adjoint of spectral transport "
                 "and the homogeneous medium)", **common,
         "source": "raytracer0_tpu_torch/csrc/megakernel_bwd_medium.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:2545",
         "also_replaces": "the vjp of raytracer0_tpu/ops/megakernel.py:1728-1760, :2237-2239, "
                          ":1551-1556, :2056-2060 (the medium event and its in-scatter NEE, "
                          "the HG continuation, the fog, Cauchy's IOR of _build_bounce)",
         "scene": "spectral_caustics (the reference's preset 8)",
         "launches": p31["fit_launches"],
         "launches_by_path": {"fit": p31["fit_launches"], "step": p31["step_launches"][2]},
         "max_abs_err": max(v["max_abs_err"] for v in p31["held"].values()),
         "max_rel_err": max(v["max_rel_err"] for v in p31["held"].values()),
         "compared_at": "64x64, each scene at its own depth", "held": p31["held"],
         "ms": p31["ms"], "device_ms": p31["device_ms"],
         "device_ms_in_step": p31["device_ms_in_step"], "step_ms": p31["step_ms"],
         "step_quartiles": p31["step_quartiles"], "plain_ms": p31["plain_ms"],
         "plain_ms_at": "64x64, 12 bounces, the plain autograd's forward and backward",
         "bound_ms": p31["bound_ms"], "bound_by": p31["bound_by"],
         "blocks_per_sm": p31["blocks_per_sm"], "registers": p31["registers"],
         "local_bytes": p31["local_bytes"], "fit_losses": p31["fit_losses"]},
        {"name": "K9 env forward, served by K1", **common,
         "source": "raytracer0_tpu_torch/csrc/megakernel.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:3414",
         "launches": launches_cube,
         "max_abs_err": widened_err[("cubemap_demo", H)], "ms": k1_ms["cubemap_demo"],
         "device_ms": k1_dev_ms["cubemap_demo"], "plain_ms": plain_ms["cubemap_demo"],
         "bound_ms": cube_bound, "bound_by": cube_by},
        {"name": "K10 image-texture forward, served by K1", **common,
         "source": "raytracer0_tpu_torch/csrc/megakernel.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:3586",
         "launches": launches_tex,
         "max_abs_err": tex_err[("textured_cornell", H)], "ms": tex_ms["textured_cornell"],
         "device_ms": tex_dev_ms["textured_cornell"],
         "plain_ms": tex_plain_ms["textured_cornell"],
         "bound_ms": tex_bound["textured_cornell"][0],
         "bound_by": tex_bound["textured_cornell"][1]},
        {"name": "K6 ReSTIR pass: K4, then K6v's fused form", **common,
         "source": "raytracer0_tpu_torch/csrc/restir_vertex.cu",
         "stages": ["raytracer0_tpu_torch/csrc/gbuffer.cu",
                    "raytracer0_tpu_torch/csrc/restir_vertex.cu"],
         "replaces": "raytracer0_tpu/ops/megakernel.py:2880",
         "launches": launches_k6,
         "launches_by_path": {"render": launches_k6, "gradient": k6_fit,
                              "animated_render": launches_k6_anim,
                              "animated_gradient": k6_anim_grad, "realtime_adhoc": k6_rt},
         "max_abs_err": k6_max_err,
         "max_abs_err_animated": max(v for (c, p), v in k6_anim_err.items() if c != "moving"),
         "ms": ms_k6, "device_ms": k6_dev_ms, "device_ms_k4": k4_demo_dev_ms,
         "device_ms_k6v": k6v_dev_ms, "plain_ms": plain_restir[0], "bound_ms": k6_bound,
         "bound_by": k6_by,
         "whole_sdf_copy": {
             "scene": "the mandelbulb ReSTIR view", "launches": p28["launches_k6_mandelbulb"],
             "max_abs_err": max(v["max_abs_err"] for v in held28.values()),
             "pixels_differing": {k: v["k6_pixels_differing"] for k, v in held28.items()},
             "ms": bulb28["ms_k6"],
             "device_ms": None if bulb28["device_ms_k6v"] is None
             else bulb28["device_ms_k4"] + bulb28["device_ms_k6v"],
             "plain_ms_64": plain_bulb28, "bound_ms": bulb28["bound_ms_k6"],
             "bound_by": bulb28["bound_by_k6"], "march_lane_use": bulb28["march_lane_use"],
             "frame_ms_animated_restir_k6": p28["frame_ms_k6"]}},
        {"name": "K6v reservoir-vertex kernel (K6's second stage; the split path's reservoir "
                 "phases)", **common,
         "source": "raytracer0_tpu_torch/csrc/restir_vertex.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:2880",
         "also_replaces": "raytracer0_tpu/ops/restir.py:689 (the XLA reservoir phases of "
                          "render_sample_fast)",
         "launches": k6v_restir,
         "launches_by_path": {"render": k6v_restir, "realtime_adhoc": launches_k6v},
         "max_abs_err": k6_max_err, "ms": ms_k6v, "device_ms": k6v_dev_ms,
         "plain_ms": plain_ms_k6v, "bound_ms": k6v_bound, "bound_by": k6v_by,
         "blocks_per_sm": occ[("K6v", "restir_demo")]["blocks"],
         "max_abs_err_split": k6v_split_err, "ms_split": ms_k6v_split,
         "device_ms_split": k6v_split_dev_ms, "plain_ms_split": plain_ms_k6v_split,
         "bound_ms_split": k6v_split_bound, "bound_by_split": k6v_split_by,
         "whole_sdf_copy": {
             "scene": "the mandelbulb ReSTIR view (fused form); animated_restir as shipped "
                      "(split form)",
             "launches": p28["launches_k6_mandelbulb"],
             "launches_split": p28["launches_k6v_split"],
             "max_abs_err": max(v["max_abs_err"] for v in held28.values()),
             "max_abs_err_split": p28["split_max_abs_err"], "ms": bulb28["ms_k6v"],
             "device_ms": bulb28["device_ms_k6v"],
             "device_ms_split": p28["frame_device"]["animated_restir"]["restir_vertex_kernel"],
             "plain_ms_64": plain_bulb28, "bound_ms": bulb28["bound_ms_k6v"],
             "bound_by": bulb28["bound_by_k6v"],
             "registers": occ[("K6v whole-SDF", "mandelbulb")]["registers"],
             "registers_split": occ[("K6v split whole-SDF", "animated_restir")]["registers"],
             "blocks_per_sm": occ[("K6v whole-SDF", "mandelbulb")]["blocks"]}},
        {"name": "K7 fused ReSTIR adjoint", **common,
         "source": "raytracer0_tpu_torch/csrc/restir_bwd.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:3017",
         "launches": launches_k7,
         "launches_by_path": {"gradient": launches_k7, "animated_gradient": k7_anim_grad},
         "max_abs_err": k7_abs, "max_rel_err": k7_rel_full,
         "max_rel_err_animated": k7_rel_anim,
         "compared_at": f"{full}x{full}, passes 0-{n_full - 1}", "ms": ms_k7, "device_ms": k7_dev_ms,
         "plain_ms": plain_ms_k7, "bound_ms": k7_bound, "bound_by": k7_by,
         "blocks_per_sm": occ[("K7", "restir_demo")]["blocks"]},
        {"name": "K7 fused ReSTIR adjoint, its whole-SDF copy", **common,
         "source": "raytracer0_tpu_torch/csrc/restir_bwd_sdf.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:3017",
         "also_serves": "raytracer0_tpu/ops/megakernel.py:3089 (K8)",
         "launches": p29["fit_launches"],
         "launches_by_path": {"fit_animated_restir": p29["fit_launches"],
                              **{f"step_{k}": v["launches"] for k, v in step29.items()}},
         "max_abs_err": max(v["max_abs_err"] for v in held29.values()),
         "max_rel_err": max(v["max_rel_err"] for v in held29.values()),
         "compared_at": "32x32, passes 0-3 on animated_restir, 0-1 on its STATIC twin, "
                        "polygons and textured_cornell, pass 0 alone on mandelbulb, "
                        "every_shape and textured_restir_demo, each scene at its own depth",
         "held": held29,
         "ms": step29["animated_restir"]["ms"],
         "device_ms": step29["animated_restir"]["device_ms"],
         "plain_ms": held29["animated_restir"]["plain_ms_per_pass"],
         "plain_ms_at": "32x32, one pass's fwd+bwd",
         "bound_ms": step29["animated_restir"]["bound_ms"],
         "bound_by": step29["animated_restir"]["bound_by"],
         "mandelbulb": step29["mandelbulb"], "animated_restir": step29["animated_restir"],
         "blocks_per_sm": step29["animated_restir"]["blocks_per_sm"],
         "fit_losses": p29["fit_losses"]},
        {"name": "K8 per-slot fused ReSTIR adjoint, served by K7", **common,
         "source": "raytracer0_tpu_torch/csrc/restir_bwd.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:3089",
         "launches": launches_k7, "max_abs_err": k7_abs, "ms": ms_k7, "device_ms": k7_dev_ms,
         "plain_ms": plain_ms_k7, "bound_ms": k7_bound, "bound_by": k7_by},
        {"name": "K4 G-buffer forward", **common,
         "source": "raytracer0_tpu_torch/csrc/gbuffer.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:2775",
         "launches": launches_k4,
         "launches_by_path": {"realtime_adhoc": launches_k4, "render": k4_restir},
         "max_abs_err": k4_max_err, "ms": ms_k4, "device_ms": k4_dev_ms,
         "plain_ms": plain_ms_k4, "bound_ms": k4_bound, "bound_by": k4_by,
         "ms_restir_demo": ms_k4_demo, "device_ms_restir_demo": k4_demo_dev_ms,
         "bound_ms_restir_demo": k4_demo_bound,
         "whole_sdf_copy": {
             "scene": "the mandelbulb ReSTIR view; animated_restir as shipped (real-time)",
             "launches": p28["launches_k6_mandelbulb"],
             "launches_realtime": p28["launches_k4"],
             "identical_bits": {k: v["k4_identical"] for k, v in held28.items()},
             "max_abs_err": 0.0 if all(v["k4_identical"] is not False for v in held28.values())
             else None,
             "ms": bulb28["ms_k4"], "device_ms": bulb28["device_ms_k4"],
             "device_ms_realtime": p28["frame_device"]["animated_restir"]["gbuf_kernel"],
             "plain_ms_64": held28["every_shape"]["plain_ms_k4"],
             "plain_ms_64_scene": "the every_shape ReSTIR view",
             "bound_ms": bulb28["bound_ms_k4"], "bound_by": bulb28["bound_by_k4"],
             "registers": occ[("K4 whole-SDF", "mandelbulb")]["registers"],
             "blocks_per_sm": occ[("K4 whole-SDF", "mandelbulb")]["blocks"],
             "frame_ms": p28["frame_ms"], "frame_quartiles": p28["frame_quartiles"],
             "frame_device": p28["frame_device"]}},
        {"name": "K5 ray cast, served by K6v on the split path (csrc/cast.cu held in phase 21)",
         **common,
         "source": "raytracer0_tpu_torch/csrc/restir_vertex.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:3349",
         "launches": launches_k6v, "launches_by_path": {"realtime_adhoc": launches_k6v},
         "max_abs_err": k6v_split_err, "ms": ms_k6v_split, "device_ms": k6v_split_dev_ms,
         "plain_ms": plain_ms_k6v_split, "bound_ms": k6v_split_bound,
         "bound_by": k6v_split_by,
         "cast_cu": {"launches_on_main_paths": launches_k5, "max_abs_err": k5_max_err,
                     "ms": ms_k5, "device_ms": k5_dev_ms, "plain_ms": plain_ms_k5,
                     "bound_ms": k5_bound, "bound_by": k5_by}},
        {"name": "K11 gloss suffix-resume forward, served by K1", **common,
         "source": "raytracer0_tpu_torch/csrc/megakernel.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:3969",
         "launches": launches_gloss,
         "max_abs_err": tex_err[("textured_gloss", H)], "ms": tex_ms["textured_gloss"],
         "device_ms": tex_dev_ms["textured_gloss"], "plain_ms": tex_plain_ms["textured_gloss"],
         "bound_ms": tex_bound["textured_gloss"][0],
         "bound_by": tex_bound["textured_gloss"][1]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
