#!/usr/bin/env python3
"""K1's, K2's, K7's and the ReSTIR pass K6's device times on a few presets, the
ReSTIR frame, pass and gradient step, and digests of the kernels' outputs,
to compare two checkouts on one card.

Run from the root of a checkout (any slice of the port: presets that the
checkout lacks are skipped):

    python3 k1_device_time.py

Prints the card's name and power limit, then one JSON line: ptxas' register
and spill lines for K1, K2, K4, K5, K6v and K7 (K1's copies in the order
nvcc compiles them: the four of the BOX/ROUND_BOX class, then the
whole-SDF copies, then the medium copy), and per preset of PRESETS
(Cornell, the textured presets, `mis_demo`, `cubemap_demo`, config 2, the
reference's SDF presets `default_scene`, `mandelbulb` and `menger_sponge`
and its preset 8 `spectral_caustics`, which runs K1's medium copy) the
median over 5 rounds of
K1's device time (torch.profiler, 20 launches per round) at 512x512 with 12
bounces, after 5 warm-up launches; and the same for K7 (the adjoint kernel
alone, and with its tap gather and reduction) on `restir_demo` and
`restir_stress` at 512x512, 12 bounces, on the inputs of `chip_smoke.py`'s
phase 17 (the ring after `Renderer(...).render(16)`, the rays of pass 16)
with ones as cotangents, through `restir_kernel._launch_backward`; in a
checkout whose K7 has its whole-SDF copy, the same of that copy on
`animated_restir` as shipped (`ANIMATED_CONFIG`, frame time 0) and the
`mandelbulb` ReSTIR view (12 bounces, 128 marching steps;
`k7_whole_sdf_*`), and on `restir_demo`, whose scenes the ROUND_BOX copy
serves, with the whole-SDF copy forced (`k7_whole_sdf_restir_demo`: the
two copies on the same work).

Then the ReSTIR pass K6 (`restir_kernel.trace_forward_restir_fused`: one
fused kernel in older checkouts, K4 then K6v in newer) on the same inputs, and on the
real-time scene under ANIMATED accumulation at t = 0.5 after 16 frames:
the median over 5 rounds of the device time of every kernel the call
launches, per kernel and in all.  Then host times (CUDA events, median and
quartiles of 9 after 2 warm-ups) of a `Renderer.step` of `restir_demo`, of
the real-time frame (`animated_untextured` with `restir_adhoc_motion`, the
split path) and of the ANIMATED frame through K6, and of the ReSTIR
gradient step d sum(`render_linear(passes=4)`) / d(emission, color, pos,
joker, ior) with its peak memory above the inputs, all at 512x512.  In a
checkout with K4's and K6v's whole-SDF copies (`presets.restir_sdf_view`)
the same K6 numbers and digests for `animated_restir` as shipped (its METAL
ROUND_BOX, at t = 0.5) and the `mandelbulb` ReSTIR view, and the real-time
frame of the preset as shipped (`realtime_frame_as_shipped_ms`,
`digest_realtime_frames_as_shipped`).
Finally a sha256 prefix of each kernel route's outputs on fixed inputs
(K1, K4, K7, the K6 pass and the real-time frame), so two checkouts that
should agree bit for bit can be seen to; with `--plain-nan`, the count of
non-finite entries of the plain version's gradient of a `mandelbulb` pass
(`plain_grad_nonfinite`), which differs between checkouts before and
after ROADMAP fault 14.

It also prints the ptxas lines of K2's two libraries (the whole-SDF copy
is a library of its own; also by function, `ptxas_functions`: each
copy's template instance, `K2_COPIES`) and K4, and K1's (Cornell) and K4's
(`restir_demo`, the real-time scene) blocks per SM, registers and K4's
persistent grid.

K2, the adjoint of K1, on K2_SCENES at 512x512 with 12 bounces: Cornell
with and without MIS, and `presets.many_lights` (`restir_stress`'s planes
and the first 4, 5, 8, 9, 10, 18 or all 41 of its sphere lights: 10, 11,
14, 15, 16, 24 and 47 meshes, on both sides of the switch from a column
of cotangent accumulators per thread to one per warp), all on its Cornell
copy; Cornell with MIS forced onto its wide copy (`cornell_mis_wide`);
the scenes of the wide copy: `k2_` and the preset `config2`,
`mis_demo`, `cornell_box`, `textured_gloss`, `cubemap_demo`; and those of
the whole-SDF copy: `k2_default_scene`, `k2_mandelbulb`,
`k2_menger_sponge` and `k2_every_shape` (`presets.sdf_view`'s
scene of every shape the presets lack) at 128 marching steps (a scene a
checkout cannot differentiate on the card is skipped); the median over 5
rounds of 20 launches of its device time (torch.profiler), alone and
with its reduction, on the rays of pass 0 with ones as cotangents, its
layout, blocks per SM and registers, sha256 prefixes of d_table, d_ro
and d_rd, and d_table's values.  `--compare REF.json RUN.json ...` reads the JSON
lines of earlier runs (one file each) and prints which digests differ
from the first run's and d_table's worst relative difference per leaf.

`chip_smoke.py` imports `k1_device_ms`.  Comparing two checkouts: run
each checkout's own copy from its root (Python puts the script's own
directory first on the path) in turns in one call (parent, change,
change, parent), and compare the keys both print.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

def ptxas_functions(log):
    """{function: its ptxas line} of an nvcc build log: the stack, spill and
    register lines under each "Compiling entry function" or "Function
    properties for" line, joined."""
    out, name = {}, None
    for line in log.splitlines():
        for key in ("Compiling entry function '", "Function properties for "):
            if key in line:
                name = line.split(key, 1)[1].split("'")[0].strip()
                out.setdefault(name, [])
        if name is not None and ("stack" in line or "registers" in line):
            out[name].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items() if v}


#: K2's copies by the template instance of its kernel in the mangled name
K2_COPIES = {"Cornell per thread": "10bwd_kernelILb0E", "Cornell per warp": "10bwd_kernelILb1E",
             "wide per thread": "15bwd_wide_kernelILb0ELb0ELb0E",
             "wide per warp": "15bwd_wide_kernelILb1ELb0ELb0E",
             "whole-SDF per thread": "15bwd_wide_kernelILb0ELb1ELb0E",
             "whole-SDF per warp": "15bwd_wide_kernelILb1ELb1ELb0E",
             "medium per thread": "15bwd_wide_kernelILb0ELb1ELb1E",
             "medium per warp": "15bwd_wide_kernelILb1ELb1ELb1E"}


#: K1's copies by the template instance of its kernel in the mangled name:
#: the SDF march, the shadow hit's texel, the whole SDF class; the medium copy
K1_COPIES = {"analytic": "10fwd_kernelILb0ELb0ELb0E", "SDF": "10fwd_kernelILb1ELb0ELb0E",
             "textured light": "10fwd_kernelILb0ELb1ELb0E",
             "SDF, textured light": "10fwd_kernelILb1ELb1ELb0E",
             "whole-SDF": "10fwd_kernelILb1ELb0ELb1E",
             "whole-SDF, textured light": "10fwd_kernelILb1ELb1ELb1E",
             "medium": "17fwd_kernel_medium"}


PRESETS = ("cornell_default", "textured_cornell", "textured_gloss", "mis_demo", "cubemap_demo",
           "config2", "textured_emitter", "cornell_box", "default_scene", "mandelbulb",
           "menger_sponge", "spectral_caustics")
K7_PRESETS = ("restir_demo", "restir_stress")
#: the scenes of K7's whole-SDF copy it times: `animated_restir` as shipped
#: (at frame time 0) and the `mandelbulb` ReSTIR view
K7_WHOLE = {"whole_sdf_animated_restir": lambda presets, dev: presets.animated_restir(device=dev),
            "whole_sdf_mandelbulb": lambda presets, dev: presets.restir_sdf_view(
                "mandelbulb", device=dev),
            "whole_sdf_restir_demo": lambda presets, dev: presets.restir_demo(device=dev)}
#: the names of `K7_WHOLE` whose scene the ROUND_BOX copy serves: timed
#: with `restir_kernel.bwd_copy` answering "whole_sdf"
K7_FORCED = ("whole_sdf_restir_demo",)


def k1_device_ms(names, dev):
    """{preset: (median, rounds)} of K1's device milliseconds per launch at
    512x512, 12 bounces, for each preset of `names` this checkout has
    (`cornell_default` with MIS): each round the profiler's K1 time over
    the K1 launches it recorded of 20."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracer0_tpu_torch import rng
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.ops import megakernel

    res = {}
    for name in names:
        if not hasattr(presets, name):
            continue
        kw = dict(use_mis=True) if name == "cornell_default" else {}
        scene, cam, cfg = getattr(presets, name)(device=dev, **kw)
        ro, rd = generate_rays(cam, 512, 512, 0)
        pix = rng.pixel_ids(512, 512, device=dev)
        for _ in range(5):
            megakernel.trace_forward(scene, cfg, ro, rd, pix, 0, 0)
        rounds = []
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    megakernel.trace_forward(scene, cfg, ro, rd, pix, 0, 0)
                torch.cuda.synchronize()
            k1 = [e for e in prof.key_averages() if "fwd_kernel" in e.key]
            us = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                     for e in k1)
            # per recorded launch: late in a long process the profiler can
            # miss some launches of a window of long kernels (6 of 20 in
            # rounds of 2-4 ms launches, which then read 0.70x)
            rounds.append(us / max(sum(e.count for e in k1), 1) / 1e3)
        res[name] = (statistics.median(rounds), rounds)
    return res


def k7_device_ms(names, dev):
    """{preset: (median, rounds, median with gather and reduction)} of K7's
    device milliseconds per launch at 512x512, 12 bounces, on phase 17's
    inputs with ones as cotangents, for each preset of `names` this
    checkout has; a name of `K7_WHOLE` is the scene of K7's whole-SDF copy,
    skipped where this checkout's K7 refuses it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracer0_tpu_torch import rng
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.ops import megakernel, restir_kernel
    from raytracer0_tpu_torch.render.renderer import Renderer

    res = {}
    for name in names:
        if name in K7_WHOLE:
            if not hasattr(presets, "restir_sdf_view") or not hasattr(restir_kernel, "bwd_copy"):
                continue
            scene, cam, cfg = K7_WHOLE[name](presets, dev)
            if restir_kernel.unsupported_restir_bwd(scene, cfg) is not None:
                continue
        elif not hasattr(presets, name) or not hasattr(restir_kernel, "_launch_backward"):
            continue
        else:
            scene, cam, cfg = getattr(presets, name)(device=dev)
        renderer = Renderer(scene, cam, cfg, 512, 512)
        renderer.render(16)
        st = renderer.state
        ro, rd = generate_rays(cam, 512, 512, 16)
        pix = rng.pixel_ids(512, 512, device=dev)
        table = megakernel.scene_table(scene)
        ct = torch.ones((512, 512, 3), dtype=torch.float32, device=dev)
        ct_res = [torch.ones((512, 512), dtype=torch.float32, device=dev) for _ in range(4)]

        def launch():
            restir_kernel._launch_backward(scene, cfg, table, ro, rd, pix, 16, 0,
                                           (st.restir_back, st.restir_hist1, st.restir_hist2),
                                           ct, ct_res)

        if name in K7_FORCED:
            own_copy = launch

            def launch(bwd_copy=restir_kernel.bwd_copy):
                restir_kernel.bwd_copy = lambda _scene: "whole_sdf"
                try:
                    own_copy()
                finally:
                    restir_kernel.bwd_copy = bwd_copy

        for _ in range(5):
            launch()
        rounds, whole = [], []
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    launch()
                torch.cuda.synchronize()
            us = {k: sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                         for e in prof.key_averages() if k in e.key)
                  for k in ("restir_bwd_kernel", "tap_gather_kernel", "restir_reduce_kernel")}
            rounds.append(us["restir_bwd_kernel"] / 20 / 1e3)
            whole.append(sum(us.values()) / 20 / 1e3)
        res[name] = (statistics.median(rounds), rounds, statistics.median(whole))
    return res


RESTIR_PRESETS = ("restir_demo", "restir_stress")

#: K2's scenes: Cornell with and without MIS, and `presets.many_lights`
#: with this many sphere lights (6 meshes more).
K2_MANY_LIGHTS = {"meshes_10": 4, "meshes_11": 5, "meshes_14": 8, "meshes_15": 9,
                  "meshes_16": 10, "meshes_24": 18, "many_meshes": 41}
#: K2's scenes of its wide copy: "k2_" and a preset's name
K2_WIDE = ("k2_config2", "k2_mis_demo", "k2_cornell_box", "k2_textured_gloss", "k2_cubemap_demo")
#: K2's scenes of its whole-SDF copy: the reference's SDF presets and the
#: scene of every shape they lack (presets.SDF_SCENE_VIEWS)
K2_WHOLE = ("k2_default_scene", "k2_mandelbulb", "k2_menger_sponge", "k2_every_shape")
#: K2's scene of its medium copy: the reference's preset 8
K2_MEDIUM = ("k2_spectral_caustics",)
K2_SCENES = ("cornell_mis", "cornell_nomis", *K2_MANY_LIGHTS, "cornell_mis_wide", *K2_WIDE,
             *K2_WHOLE, *K2_MEDIUM)


def k2_scene(name, device):
    """(scene, camera, cfg) of K2's scene `name` (K2_SCENES)."""
    from raytracer0_tpu_torch.models import presets

    if name in K2_MANY_LIGHTS:
        return presets.many_lights(device=device, n_lights=K2_MANY_LIGHTS[name])
    if name == "k2_every_shape":
        return presets.sdf_view("every_shape", device=device, max_bounces=12)
    if name in K2_WIDE + K2_WHOLE + K2_MEDIUM:
        return getattr(presets, name[3:])(device=device)
    return presets.cornell_default(device=device, use_mis=name != "cornell_nomis")


def _k2_copy(megakernel, name):
    """A context that runs `name` on the copy K2 picks, or, for
    `cornell_mis_wide`, forces its wide copy onto Cornell."""
    import contextlib
    import unittest.mock

    if name != "cornell_mis_wide":
        return contextlib.nullcontext()
    return unittest.mock.patch.object(megakernel, "cornell_copy", lambda scene, cfg: False)


def _k2_scenes(megakernel, dev):
    """The K2_SCENES this checkout differentiates on the card."""
    from raytracer0_tpu_torch.models import presets

    names = []
    for name in K2_SCENES:
        if name in K2_WIDE + K2_WHOLE + K2_MEDIUM and name != "k2_every_shape" \
                and not hasattr(presets, name[3:]):
            continue
        if name == "cornell_mis_wide" and not hasattr(megakernel, "cornell_copy"):
            continue
        scene, _, cfg = k2_scene(name, dev)
        if megakernel.unsupported_bwd(scene, cfg) is None:
            names.append(name)
    return names


def k2_device_ms(dev, names=None):
    """{scene: result} of K2 on each of K2_SCENES (or of `names`) at 512x512 with its
    budgets (12 bounces), on the rays of pass 0 with ones as the radiance's
    cotangent, through `megakernel._launch_backward`: the median over 5
    rounds of 20 launches of the adjoint kernel's device milliseconds per
    launch (torch.profiler), the rounds, the median with its reduction,
    sha256 prefixes of d_table, d_ro and d_rd, and d_table's values (for
    `--compare`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracer0_tpu_torch import rng
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.ops import megakernel

    res = {}
    pix = rng.pixel_ids(512, 512, device=dev)
    ct = torch.ones((512, 512, 3), dtype=torch.float32, device=dev)
    for name in _k2_scenes(megakernel, dev):
        if names is not None and name not in names:
            continue
        scene, cam, cfg = k2_scene(name, dev)
        ro, rd = generate_rays(cam, 512, 512, 0)
        table = megakernel.scene_table(scene)
        launch = lambda: megakernel._launch_backward(scene, cfg, table, ro, rd, pix, 0, 0, ct)
        with _k2_copy(megakernel, name):
            d_table, d_ro, d_rd = launch()
            for _ in range(4):
                launch()
            rounds, whole = [], []
            for _ in range(5):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        launch()
                    torch.cuda.synchronize()
                # the adjoint (bwd_kernel, or the wide and whole-SDF copies'
                # bwd_wide_kernel) and the reduction, per launch the profiler
                # recorded (late in a long process it misses some launches of
                # a window of long kernels, as k1_device_ms notes)
                us, count = {}, {}
                for k, kernels in (("adjoint", ("bwd_kernel", "bwd_wide_kernel")),
                                   ("reduce", ("reduce_kernel",))):
                    evts = [e for e in prof.key_averages()
                            if any(n in e.key for n in kernels) and "restir" not in e.key]
                    us[k] = sum(getattr(e, "self_device_time_total", None)
                                or e.self_cuda_time_total for e in evts)
                    count[k] = max(sum(e.count for e in evts), 1)
                rounds.append(us["adjoint"] / count["adjoint"] / 1e3)
                whole.append(sum(us[k] / count[k] for k in us) / 1e3)
        res[name] = {"ms": statistics.median(rounds), "rounds": rounds,
                     "ms_with_reduction": statistics.median(whole),
                     "digest_d_table": _digest(d_table), "digest_d_ro": _digest(d_ro),
                     "digest_d_rd": _digest(d_rd), "meshes": scene.num_meshes,
                     "d_table": d_table.cpu().flatten().tolist()}
    return res


def k2_occupancy(dev):
    """K2's blocks per SM, registers, local memory and shared memory on
    each of K2_SCENES in the layout its launcher picks."""
    from raytracer0_tpu_torch.ops import cuda_build, megakernel

    res = {}
    for name in _k2_scenes(megakernel, dev):
        scene, _, cfg = k2_scene(name, dev)
        with _k2_copy(megakernel, name):
            warp, smem = megakernel.bwd_layout(scene, cfg)
            wide = not megakernel.cornell_copy(scene, cfg)
            copy = megakernel.bwd_copy(scene, cfg) if wide else "cornell"
        whole = copy == "whole_sdf"
        # the export's flag: bit 0 a column per warp, bit 1 the wide copy,
        # bit 2 the whole-SDF copy, bit 3 the medium copy
        o = cuda_build.occupancy(*megakernel.bwd_library(copy),
                                 "rt0_trace_backward_occupancy", megakernel.BWD_THREADS,
                                 smem, int(warp) | 2 * int(wide and not whole) | 4 * int(whole)
                                 | 8 * int(copy == "medium"))
        res[f"occupancy_k2_{name}"] = {**{k: o[k] for k in ("blocks", "threads", "registers",
                                                            "local_bytes", "smem")},
                                       "warp_columns": warp, "wide_copy": wide,
                                       "whole_sdf_copy": whole, "medium_copy": copy == "medium"}
    return res


def compare(paths):
    """Print, for two or more JSON lines this script wrote (one file each,
    the first the reference), which digests differ from the reference's and
    the worst relative difference of K2's d_table per leaf (pos, joker,
    color, emission, ior and the texture columns: max |a - b| / max |b|
    over the scene's meshes; 0 / 0 counts 0)."""
    import numpy as np

    runs = []
    for p in paths:
        with open(p) as f:
            runs.append(json.loads([line for line in f if line.startswith("{")][-1]))
    ref = runs[0]
    leaves = {"pos": slice(0, 3), "joker": slice(3, 7), "color": slice(7, 10),
              "emission": slice(10, 13), "ior": slice(13, 14), "tex_params": slice(26, 30),
              "tex_cmask": slice(30, 33), "tex_emask": slice(33, 36)}
    for p, run in zip(paths[1:], runs[1:]):
        keys = sorted(k for k in ref if "digest" in k and not isinstance(ref[k], dict))
        keys += [f"{n}.{k}" for n in K2_SCENES if n in ref and n in run
                 for k in ref[n] if k.startswith("digest")]
        get = lambda r, k: r[k.split(".")[0]][k.split(".")[1]] if "." in k else r.get(k)
        differ = [k for k in keys if get(ref, k) != get(run, k)]
        worst = {}
        for n in K2_SCENES:
            if n in ref and n in run:
                a = np.asarray(run[n]["d_table"]).reshape(-1, 36)
                b = np.asarray(ref[n]["d_table"]).reshape(-1, 36)
                worst[n] = {leaf: float(np.abs(a[:, c] - b[:, c]).max()
                                        / max(np.abs(b[:, c]).max(), 1e-30))
                            for leaf, c in leaves.items() if np.abs(b[:, c]).max() > 0}
        print(json.dumps({"reference": paths[0], "run": p, "digests_compared": len(keys),
                          "digests_that_differ": differ, "k2_d_table_worst_relative": worst,
                          "k2_d_table_worst_relative_all": max(
                              (v for w in worst.values() for v in w.values()), default=None)}))


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _stats_ms(torch, fn, runs=9, warmup=2):
    """(median, q1, q3) milliseconds of `fn()` over `runs` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    q1, med, q3 = statistics.quantiles(times, n=4)
    return [statistics.median(times), q1, q3]


def restir_route_ms(dev):
    """The ReSTIR pass, frame and step numbers of the module docstring, and
    the digests of the K6 pass's and the real-time frame's outputs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracer0_tpu_torch import optimize, rng
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.models import scene as scene_mod
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.ops import restir_kernel
    from raytracer0_tpu_torch.render.renderer import Renderer

    res = {}
    pix = rng.pixel_ids(512, 512, device=dev)
    cases = [(name, *getattr(presets, name)(device=dev), None) for name in RESTIR_PRESETS]
    if hasattr(presets, "animated_untextured"):
        cases.append(("animated", *presets.animated_untextured(device=dev), 0.5))
    whole_sdf = hasattr(presets, "restir_sdf_view")   # K4's and K6v's whole-SDF copies
    if whole_sdf:
        cases.append(("animated_restir", *presets.animated_restir(device=dev), 0.5))
        cases.append(("mandelbulb_restir", *presets.restir_sdf_view("mandelbulb", device=dev),
                      None))
    for name, scene, cam, cfg, t in cases:
        renderer = Renderer(scene, cam, cfg, 512, 512)
        for k in range(16):
            renderer.step(0.0 if t is None else k / 30)
        st = renderer.state
        frame = scene if t is None else scene_mod.animate_positions(scene, t, int(cfg.render_mode))
        ro, rd = generate_rays(cam, 512, 512, 16)

        def k6():
            return restir_kernel.trace_forward_restir_fused(
                frame, cfg, ro, rd, pix, 16, 0, st.restir_back, st.restir_hist1,
                st.restir_hist2)

        out, new = k6()
        res[f"digest_k6_{name}"] = _digest(out, *new.fields().values())
        for _ in range(5):
            k6()
        rounds, per_kernel = [], []
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    k6()
                torch.cuda.synchronize()
            us = {e.key: getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()}
            us = {k: v for k, v in us.items() if v > 0}
            rounds.append(sum(us.values()) / 20 / 1e3)
            per_kernel.append({k: v / 20 / 1e3 for k, v in us.items()})
        res[f"k6_{name}"] = statistics.median(rounds)
        res[f"k6_{name}_rounds"] = rounds
        res[f"k6_{name}_by_kernel"] = {k: statistics.median(r[k] for r in per_kernel)
                                       for k in per_kernel[0]}
        if t is not None:
            res[f"{name}_k6_frame_ms"] = _stats_ms(torch, lambda: renderer.step(0.5))
        elif name == "restir_demo":
            res["restir_demo_pass_ms"] = _stats_ms(torch, renderer.step)
        del renderer, st, out, new

    if hasattr(presets, "animated_untextured"):   # the real-time frame: the split path
        scene, cam, cfg = presets.animated_untextured(device=dev, restir_adhoc_motion=True)
        renderer = Renderer(scene, cam, cfg, 512, 512)
        for k in range(16):
            renderer.step(k / 30)
        res["digest_realtime_frames"] = _digest(renderer.state.accum,
                                                *renderer.state.restir_back.fields().values())
        res["realtime_frame_ms"] = _stats_ms(torch, lambda: renderer.step(0.5))
        del renderer
    if whole_sdf:   # the real-time frame of the preset as shipped
        scene, cam, cfg = presets.animated_restir(device=dev, restir_adhoc_motion=True)
        renderer = Renderer(scene, cam, cfg, 512, 512)
        for k in range(16):
            renderer.step(k / 30)
        res["digest_realtime_frames_as_shipped"] = _digest(
            renderer.state.accum, *renderer.state.restir_back.fields().values())
        res["realtime_frame_as_shipped_ms"] = _stats_ms(torch, lambda: renderer.step(0.5))
        del renderer

    scene, cam, cfg = presets.restir_demo(device=dev)
    leaves = ("emission", "color", "pos", "joker", "ior")

    def step():
        params = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in leaves}
        img = optimize.render_linear(scene.replace(**params), cfg, cam, 512, 512, passes=4)
        return torch.autograd.grad(img.sum(), list(params.values()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = step()
    torch.cuda.synchronize()
    res["restir_step_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    res["digest_restir_step_grads"] = _digest(*grads)
    res["restir_step_ms"] = _stats_ms(torch, step)
    return res


def output_digests(dev):
    """sha256 prefixes of K1's radiance on every preset of PRESETS, K4's radiance and
    G-buffer and K7's cotangents on `restir_demo` (phase 17's inputs, ones
    as cotangents), at 512x512."""
    import torch

    from raytracer0_tpu_torch import rng
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.ops import megakernel, restir_kernel, restir_split
    from raytracer0_tpu_torch.render.renderer import Renderer

    res = {}
    pix = rng.pixel_ids(512, 512, device=dev)
    for name in PRESETS:
        if not hasattr(presets, name):
            continue
        kw = dict(use_mis=True) if name == "cornell_default" else {}
        scene, cam, cfg = getattr(presets, name)(device=dev, **kw)
        ro, rd = generate_rays(cam, 512, 512, 0)
        key = "digest_k1_cornell" if name == "cornell_default" else f"digest_k1_{name}"
        res[key] = _digest(megakernel.trace_forward(scene, cfg, ro, rd, pix, 0, 0))
    scene, cam, cfg = presets.restir_demo(device=dev)
    ro, rd = generate_rays(cam, 512, 512, 16)
    out, gbuf = restir_split.trace_forward_gbuffer(scene, cfg, ro, rd, pix, 16, 0)
    res["digest_k4_restir_demo"] = _digest(out, *[v for s in gbuf for v in s.values()])
    renderer = Renderer(scene, cam, cfg, 512, 512)
    renderer.render(16)
    st = renderer.state
    ct = torch.ones((512, 512, 3), dtype=torch.float32, device=dev)
    ct_res = [torch.ones((512, 512), dtype=torch.float32, device=dev) for _ in range(4)]
    d_table, d_ro, d_rd, d_ring = restir_kernel._launch_backward(
        scene, cfg, megakernel.scene_table(scene), ro, rd, pix, 16, 0,
        (st.restir_back, st.restir_hist1, st.restir_hist2), ct, ct_res)
    res["digest_k7_restir_demo"] = _digest(d_table, d_ro, d_rd, *d_ring)
    return res


def plain_grad_nonfinite(dev):
    """The non-finite entries of the plain version's autograd (the CPU
    route's, on the card) of one `mandelbulb` pass at 512x512 with the
    preset's budgets, d sum / d(pos, joker, color, emission, ro, rd), per
    leaf, and the pixels with a non-finite d ro or d rd: a Mandelbulb lane
    that is done and iterates on its own overflowing w gives NaN there
    (ROADMAP fault 14)."""
    import torch

    from raytracer0_tpu_torch import rng
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.render import integrator

    scene, cam, cfg = presets.mandelbulb(device=dev)
    ro, rd = generate_rays(cam, 512, 512, 0)
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in ("pos", "joker", "color", "emission")}
    o, d = ro.clone().requires_grad_(True), rd.clone().requires_grad_(True)
    out = integrator.trace(scene.replace(**leaves), cfg, o, d,
                           rng.pixel_ids(512, 512, device=dev), 0, 0)
    grads = torch.autograd.grad(out.sum(), [*leaves.values(), o, d])
    counts = {k: int((~torch.isfinite(g)).sum()) for k, g in zip((*leaves, "ro", "rd"), grads)}
    counts["pixels"] = int((~torch.isfinite(grads[-2]).all(-1)
                            | ~torch.isfinite(grads[-1]).all(-1)).sum())
    del out, grads
    torch.cuda.empty_cache()
    return {"plain_grad_nonfinite_mandelbulb": counts}


def occupancy(dev):
    """K1's (Cornell) and K4's (`restir_demo`, the real-time scene) blocks
    per SM and registers at the shared memory they launch with, and K4's
    grid (`restir_split.resident_blocks`)."""
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.ops import cuda_build, megakernel, restir_split

    smem = megakernel.packed_smem_bytes
    res = {}
    for kernel, lib, src, sym, name in (
            ("k1", "megakernel", megakernel.SOURCES, "rt0_trace_forward", "cornell_default"),
            ("k4", "gbuffer", restir_split.GBUF_SOURCES, "rt0_gbuffer_forward", "restir_demo"),
            ("k4", "gbuffer", restir_split.GBUF_SOURCES, "rt0_gbuffer_forward",
             "animated_untextured")):
        scene = getattr(presets, name)(device=dev)[0]
        sdf = scene.num_sdfs > 0
        o = cuda_build.occupancy(lib, src, sym + "_occupancy", 128, smem(scene), sdf)
        entry = {k: o[k] for k in ("blocks", "registers", "local_bytes", "smem")}
        if kernel == "k4":
            entry["grid"] = restir_split.resident_blocks(dev, sdf, smem(scene))
        res[f"occupancy_{kernel}_{name}"] = entry
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", nargs="+", metavar="JSON",
                    help="compare the outputs of earlier runs (the first is the reference)")
    ap.add_argument("--plain-nan", action="store_true",
                    help="also count the non-finite entries of the plain version's gradient "
                         "of a mandelbulb pass (plain_grad_nonfinite)")
    args = ap.parse_args()
    if args.compare:
        compare(args.compare)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k1_device_time: no CUDA device", file=sys.stderr)
        return 2
    from raytracer0_tpu_torch.ops import megakernel, restir_split, restir_vertex

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip())
    from raytracer0_tpu_torch.ops import restir_kernel

    ptxas = lambda info: [line.strip() for line in info.log.splitlines()
                          if "registers" in line or "spill" in line or "stack" in line]
    # every library at once (nvcc takes minutes for K2's and K7's copies),
    # then each loads from build/kernels
    import concurrent.futures

    builds = [megakernel.build, megakernel.build_bwd, megakernel.build_bwd_sdf,
              restir_split.build_gbuffer, restir_split.build_cast, restir_vertex.build,
              restir_kernel.build_bwd]
    builds += [getattr(m, b) for m, b in ((megakernel, "build_bwd_medium"),
                                          (restir_kernel, "build_bwd_sdf")) if hasattr(m, b)]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        for f in [pool.submit(b) for b in builds]:
            f.result()
    medium = hasattr(megakernel, "build_bwd_medium")
    res = {"tree": os.path.basename(os.getcwd()), "ptxas": ptxas(megakernel.build()[1]),
           "ptxas_k2": ptxas(megakernel.build_bwd()[1]),
           "ptxas_k2_whole_sdf": ptxas(megakernel.build_bwd_sdf()[1]),
           **({"ptxas_k2_medium": ptxas(megakernel.build_bwd_medium()[1])} if medium else {}),
           "ptxas_k2_by_function": {
               **ptxas_functions(megakernel.build_bwd()[1].log),
               **ptxas_functions(megakernel.build_bwd_sdf()[1].log),
               **(ptxas_functions(megakernel.build_bwd_medium()[1].log) if medium else {})},
           "ptxas_k4": ptxas(restir_split.build_gbuffer()[1]),
           "ptxas_k5": ptxas(restir_split.build_cast()[1]),
           "ptxas_k6v": ptxas(restir_vertex.build()[1]),
           "ptxas_k7": ptxas(restir_kernel.build_bwd()[1])}
    dev = torch.device("cuda", 0)
    res.update(occupancy(dev))
    res.update(k2_occupancy(dev))
    for name, (med, rounds) in k1_device_ms(PRESETS, dev).items():
        res[name] = med
        res[name + "_rounds"] = rounds
    res.update(k2_device_ms(dev))
    for name, (med, rounds, whole) in k7_device_ms(K7_PRESETS + tuple(K7_WHOLE), dev).items():
        res["k7_" + name] = med
        res["k7_" + name + "_rounds"] = rounds
        res["k7_" + name + "_with_gather_and_reduction"] = whole
    res.update(restir_route_ms(dev))
    res.update(output_digests(dev))
    if args.plain_nan:
        res.update(plain_grad_nonfinite(dev))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
