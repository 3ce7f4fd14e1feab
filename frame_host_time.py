#!/usr/bin/env python3
"""Host times of the real-time frame, of a `Renderer.step` of `restir_demo`
and of one call of K4's wrapper, to compare two checkouts on one card.

Run from the root of a checkout (slice 9 of the port or later):

    python3 frame_host_time.py

Prints the card's name and power limit, then one JSON line:

- `realtime_frame_ms`: the real-time frame (`animated_untextured` with
  `restir_adhoc_motion`, the split path: one K4 and one K6v launch) at
  512x512 and t = 0.5 after 16 frames, and `restir_demo_step_ms`: a
  `Renderer.step` of `restir_demo` at 512x512 after 16 passes; each the
  median, first and third quartile over 41 calls (CUDA events around each
  call, synchronized after it), after 5 warm-up calls;
- `k4_wrapper_host_us`: the host's wall-clock microseconds per call of
  `restir_split.trace_forward_gbuffer` on `restir_demo` (512x512, 12
  bounces), over 200 calls issued back to back with no synchronization
  between them, so the card's time is not in it: median and quartiles of
  5 rounds.

The frames are host-bound (PERF.md §5), so these numbers move with the
load on the host's cores: run each checkout's copy in turns in one call,
alternating which goes first (parent, change, change, parent, ...).
"""

import json
import statistics
import subprocess
import sys
import time


def _stats_ms(torch, fn, runs=41, warmup=5):
    """[median, q1, q3] milliseconds of `fn()` over `runs` calls, CUDA events."""
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
    q1, _, q3 = statistics.quantiles(times, n=4)
    return [statistics.median(times), q1, q3]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("frame_host_time: no CUDA device", file=sys.stderr)
        return 2
    from raytracer0_tpu_torch import rng
    from raytracer0_tpu_torch.models import presets
    from raytracer0_tpu_torch.models.camera import generate_rays
    from raytracer0_tpu_torch.ops import restir_split
    from raytracer0_tpu_torch.render.renderer import Renderer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    res = {}

    scene, cam, cfg = presets.animated_untextured(device=dev, restir_adhoc_motion=True)
    renderer = Renderer(scene, cam, cfg, 512, 512)
    for k in range(16):
        renderer.step(k / 30)
    res["realtime_frame_ms"] = _stats_ms(torch, lambda: renderer.step(0.5))
    del renderer

    scene, cam, cfg = presets.restir_demo(device=dev)
    renderer = Renderer(scene, cam, cfg, 512, 512)
    for _ in range(16):
        renderer.step()
    res["restir_demo_step_ms"] = _stats_ms(torch, renderer.step)
    del renderer

    pix = rng.pixel_ids(512, 512, device=dev)
    ro, rd = generate_rays(cam, 512, 512, 16)
    for _ in range(5):
        restir_split.trace_forward_gbuffer(scene, cfg, ro, rd, pix, 16, 0)
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(200):
            restir_split.trace_forward_gbuffer(scene, cfg, ro, rd, pix, 16, 0)
        rounds.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    q1, _, q3 = statistics.quantiles(rounds, n=4)
    res["k4_wrapper_host_us"] = [statistics.median(rounds), q1, q3]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
