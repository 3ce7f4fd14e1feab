#!/usr/bin/env python3
"""K1's device time on a few presets, to compare two checkouts on one card.

Run from the root of a checkout (any slice of the port: presets that the
checkout lacks are skipped):

    python3 k1_device_time.py

Prints the card's name and power limit, then one JSON line: ptxas' register
and spill lines for K1, and per preset the median over 5 rounds of K1's
device time (torch.profiler, 20 launches per round) at 512x512 with 12
bounces, after 5 warm-up launches.  `chip_smoke.py` imports `k1_device_ms`.  Comparing two checkouts: copy this
script to the root of each (Python puts the script's own directory first
on the path, so run each checkout's copy) and run them in turns in one
call (parent, change, change, parent).
"""

import json
import os
import statistics
import subprocess
import sys

PRESETS = ("cornell_default", "textured_cornell", "textured_gloss", "mis_demo")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_device_time: no CUDA device", file=sys.stderr)
        return 2
    from raytracer0_tpu_torch.ops import megakernel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip())
    _, info = megakernel.build()
    res = {"tree": os.path.basename(os.getcwd()),
           "ptxas": [line.strip() for line in info.log.splitlines()
                     if "registers" in line or "spill" in line]}
    for name, (med, rounds) in k1_device_ms(PRESETS, torch.device("cuda", 0)).items():
        res[name] = med
        res[name + "_rounds"] = rounds
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
