#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases (each prints readable lines; any failure raises and exits non-zero):

1. requires a CUDA device; prints `nvidia-smi`'s name and power limit;
2. builds the K1 forward megakernel from `raytracer0_tpu_torch/csrc/` with
   nvcc (or loads it from `build/kernels/`) and prints the build time;
3. holds K1 against its plain PyTorch version (`render/integrator.trace`)
   on the card, on `cornell_default(use_mis=True)`: at 16x128 with 3
   bounces under the parity contract (>= 99 % of pixels within 1e-5,
   median < 1e-4), and at 512x512 with 12 bounces under the golden
   contract (median < 1e-4, >= 99 % of pixels within 2e-3);
4. drives the main path, `Renderer(...).render(16)` at 512x512, and checks
   that it launched K1 16 times and that the image is finite, not black and
   shows the red and green walls;
5. times one `sample_radiance` pass at 512x512 with 12 bounces through K1
   and through the plain version (CUDA events, median of 7 after warm-up).

The line before the last is a JSON object describing the kernel; the last
line is `{"ok": true, "device": {...}}`.  Without a CUDA device, or outside
the repository, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

PARITY_TOL, PARITY_FRAC = 1e-5, 0.99     # tests/test_megakernel.py:94
GOLDEN_TOL, GOLDEN_FRAC = 2e-3, 0.99     # tests/test_golden_cornell.py:26
MEDIAN_TOL = 1e-4                        # tests/test_golden_cornell.py:35
H = W = 512
PASSES = 16


def compare(name, out, ref, tol, frac):
    """Max-over-RGB abs error per pixel; raise unless the contract holds."""
    err = (out - ref).abs().amax(dim=-1)
    mx, med = err.max().item(), err.median().item()
    share_ok = (err < tol).float().mean().item()
    print(f"phase 3: {name}: max abs err {mx:.3e}, median {med:.3e}, "
          f"share of pixels beyond {tol:g}: {1.0 - share_ok:.5f}")
    if not (med < MEDIAN_TOL and share_ok >= frac):
        raise AssertionError(f"{name}: K1 disagrees with the plain version "
                             f"(median {med:.3e}, share within {share_ok:.5f})")
    return mx


def time_ms(torch, fn, runs=7, warmup=2):
    """Median milliseconds of `fn()` over `runs` calls, CUDA events."""
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
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from raytracer0_tpu_torch import rng
        from raytracer0_tpu_torch.models.camera import generate_rays
        from raytracer0_tpu_torch.models.presets import cornell_default
        from raytracer0_tpu_torch.ops import megakernel
        from raytracer0_tpu_torch.render import integrator
        from raytracer0_tpu_torch.render.renderer import Renderer, sample_radiance
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2

    # ---- phase 1: the card ----
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"phase 1: {torch.cuda.device_count()} CUDA device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card)

    # ---- phase 2: build ----
    _, info = megakernel.build()
    print(f"phase 2: K1 build {info.seconds:.2f} s, cache "
          f"{'hit' if info.cache_hit else 'miss'}, {info.path}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 2: ptxas: {line.strip()}")

    scene, cam, cfg = cornell_default(device=dev, use_mis=True)

    def rays(h, w, pass_idx):
        ro, rd = generate_rays(cam, h, w, pass_idx)
        return ro, rd, rng.pixel_ids(h, w, device=dev)

    # ---- phase 3: K1 against its plain version ----
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

    # ---- phase 4: the main path ----
    megakernel.LAUNCHES = 0
    renderer = Renderer(scene, cam, cfg, H, W)
    img = renderer.render(PASSES)
    torch.cuda.synchronize()
    launches = megakernel.LAUNCHES
    print(f"phase 4: Renderer.render({PASSES}) at {H}x{W}: {launches} K1 launches")
    if launches != PASSES:
        raise AssertionError(f"expected {PASSES} K1 launches, saw {launches}")
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

    print(json.dumps({"kernels": [{
        "name": "K1 forward megakernel",
        "route": "cuda",
        "source": "raytracer0_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracer0_tpu/ops/megakernel.py:2357",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms_trace,
        "plain_ms": plain_ms_trace,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
