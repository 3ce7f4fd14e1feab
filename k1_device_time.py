#!/usr/bin/env python3
"""K1's and K7's device times on a few presets, to compare two checkouts on
one card.

Run from the root of a checkout (any slice of the port: presets that the
checkout lacks are skipped):

    python3 k1_device_time.py

Prints the card's name and power limit, then one JSON line: ptxas' register
and spill lines for K1 and K7, and per preset the median over 5 rounds of
K1's device time (torch.profiler, 20 launches per round) at 512x512 with 12
bounces, after 5 warm-up launches; and the same for K7 (the adjoint kernel
alone, and with its tap gather and reduction) on `restir_demo` and
`restir_stress` at 512x512, 12 bounces, on the inputs of `chip_smoke.py`'s
phase 17 (the ring after `Renderer(...).render(16)`, the rays of pass 16)
with ones as cotangents, through `restir_kernel._launch_backward`.
`chip_smoke.py` imports `k1_device_ms`.  Comparing two checkouts: copy
this script to the root of each (Python puts the script's own directory
first on the path, so run each checkout's copy) and run them in turns in
one call (parent, change, change, parent).
"""

import json
import os
import statistics
import subprocess
import sys

PRESETS = ("cornell_default", "textured_cornell", "textured_gloss", "mis_demo")
K7_PRESETS = ("restir_demo", "restir_stress")


def k1_device_ms(names, dev):
    """{preset: (median, rounds)} of K1's device milliseconds per launch at
    512x512, 12 bounces, for each preset of `names` this checkout has
    (`cornell_default` with MIS)."""
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
            us = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                     for e in prof.key_averages() if "fwd_kernel" in e.key)
            rounds.append(us / 20 / 1e3)
        res[name] = (statistics.median(rounds), rounds)
    return res


def k7_device_ms(names, dev):
    """{preset: (median, rounds, median with gather and reduction)} of K7's
    device milliseconds per launch at 512x512, 12 bounces, on phase 17's
    inputs with ones as cotangents, for each preset of `names` this
    checkout has."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracer0_tpu_torch import rng
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.ops import megakernel, restir_kernel
    from raytracer0_tpu_torch.render.renderer import Renderer

    res = {}
    for name in names:
        if not hasattr(presets, name) or not hasattr(restir_kernel, "_launch_backward"):
            continue
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_device_time: no CUDA device", file=sys.stderr)
        return 2
    from raytracer0_tpu_torch.ops import megakernel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip())
    from raytracer0_tpu_torch.ops import restir_kernel

    ptxas = lambda info: [line.strip() for line in info.log.splitlines()
                          if "registers" in line or "spill" in line or "stack" in line]
    res = {"tree": os.path.basename(os.getcwd()), "ptxas": ptxas(megakernel.build()[1]),
           "ptxas_k7": ptxas(restir_kernel.build_bwd()[1])}
    dev = torch.device("cuda", 0)
    for name, (med, rounds) in k1_device_ms(PRESETS, dev).items():
        res[name] = med
        res[name + "_rounds"] = rounds
    for name, (med, rounds, whole) in k7_device_ms(K7_PRESETS, dev).items():
        res["k7_" + name] = med
        res["k7_" + name + "_rounds"] = rounds
        res["k7_" + name + "_with_gather_and_reduction"] = whole
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
