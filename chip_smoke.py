#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases (each prints readable lines; any failure raises and exits non-zero):

1. requires a CUDA device; prints `nvidia-smi`'s name and power limit;
2. builds the forward megakernel K1 and its adjoint K2 from
   `raytracer0_tpu_torch/csrc/` with nvcc, both at once (or loads them from
   `build/kernels/`), and prints the build times and ptxas' register lines;
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
   per backward;
7. holds K2 against central differences of two K1 renders: d sum /
   d emission[light] and d sum / d color[red wall] within 5 % at 128x128,
   12 bounces;
8. drives the gradient main path, d sum(sample_radiance) / d(color,
   emission, pos, joker) at 512x512, 12 bounces (the step of bench.py's
   headline), checks that each step launched K1 and K2 once, times it
   through K1+K2 and through the plain version's autograd (CUDA events,
   median and quartiles of 9 after warm-up), prints rays/s, the kernels'
   device time from torch.profiler and each route's peak memory; then runs
   `optimize.fit` of the light's emission at 128x128 for 20 steps and
   checks that the loss falls and K2 ran once per step.

The line before the last is a JSON object describing the kernels; the last
line is `{"ok": true, "device": {...}}`.  Without a CUDA device, or outside
the repository, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import json
import statistics
import subprocess
import sys

PARITY_TOL, PARITY_FRAC = 1e-5, 0.99     # tests/test_megakernel.py:94
GOLDEN_TOL, GOLDEN_FRAC = 2e-3, 0.99     # tests/test_golden_cornell.py:26
MEDIAN_TOL = 1e-4                        # tests/test_golden_cornell.py:35
GRAD_TOL = 1e-4                          # tests/test_megakernel.py:128-129
GRAD_TOL_FULL = 1e-3                     # 512x512: sums in another order
FD_TOL = 0.05                            # tests/test_golden_cornell.py:112
H = W = 512
PASSES = 16
GRAD_STEPS = 3
LEAVES = ("color", "emission", "pos", "joker")
ADJ_CONFIGS = [                          # tests/test_torch_cuda.py
    (16, 128, dict(max_bounces=3)),
    (13, 77, dict(max_bounces=5)),
    (16, 128, dict(max_bounces=4, use_mis=False)),
    (16, 128, dict(max_bounces=4, sample_lights=False)),
]

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and float32 outside
# the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# Float operations per event of K1, counted from csrc/megakernel.cu and
# trace_common.cuh: each add, sub, mul, compare, min, max, sqrt, division,
# sin and cos counts one (so the count, and the bound, are lower bounds);
# the integer RNG hashing is not counted.
OPS_MESH = {0: 26, 1: 22, 2: 44}  # one ray against one sphere, plane, box
OPS_HIT = 29        # x = o + d t, normal, the two clamps, `inside`
OPS_DIFFUSE = 76    # draws, nl, cosine sample about nl, mask, o', cutoff
OPS_NEE = 108       # per light: cone toward the light, shadow-ray setup, contribution
OPS_NEE_MIS = 43    # per light under MIS: energy gate, both pdfs, heuristic
OPS_LIGHT = 12      # emissive hit: acc += mask c e w
OPS_LIGHT_MIS = 48  # its BSDF-side MIS weight
OPS_MISS = 28       # procedural sky and acc


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
            raise AssertionError(f"K2 gradient of {k} is not finite")
        diff = (a - b).abs().max().item()
        errs[k] = (diff / max(b.abs().max().item(), 1e-12), diff)
    return errs


def path_events(torch, scene, cfg, ro, rd, pix, pass_idx, sample_idx):
    """Events of every pixel's path, counted over the image: intersections
    by mesh type, diffuse bounces, shadow rays, emissive hits (and those
    with a MIS weight) and misses.  Replays K1's decisions with the plain
    version's functions, which make the same ones bit for bit."""
    from raytracer0_tpu_torch import rng
    from raytracer0_tpu_torch.ops import bsdf, intersect, vecmath

    n = ro.shape[:-1].numel()
    live_lights = sum(1 for li in scene.lights_static if li >= 0)
    ev = dict(rays=0, diffuse=0, shadow=0, light=0, light_mis=0, miss=0)
    o, d = ro, rd
    mask = torch.ones_like(ro)
    active = torch.ones(ro.shape[:-1], dtype=torch.bool, device=ro.device)
    n_diff = torch.zeros(ro.shape[:-1], dtype=torch.int32, device=ro.device)
    for depth in range(cfg.max_bounces):
        hit = intersect.intersect(scene, o, d, cfg)
        is_light = ~hit.missed & (scene.mat_type[hit.idx] == 0)
        diffuse = active & ~hit.missed & ~is_light
        n_light = int((active & is_light).sum())
        ev["rays"] += int(active.sum())
        ev["miss"] += int((active & hit.missed).sum())
        ev["light"] += n_light
        if cfg.use_mis and cfg.sample_lights and depth > 0:
            ev["light_mis"] += n_light
        ev["diffuse"] += int(diffuse.sum())
        if cfg.sample_lights:
            ev["shadow"] += int(diffuse.sum()) * live_lights
        c = torch.clamp_min(scene.color[hit.idx], 0.001)
        inside = torch.where(vecmath.vdot(d, hit.n) > 0.0, -1.0, 1.0)
        u1, u2 = rng.uniform2(pix, pass_idx, sample_idx, depth, rng.Stream.BSDF_DIR)
        bs = bsdf.sample(cfg, hit, c, inside, u1, u2)
        sel = diffuse[..., None]
        o = torch.where(sel, bs.o, o)
        d = torch.where(sel, bs.d, d)
        mask = torch.where(sel, mask * c, mask)
        n_diff = n_diff + diffuse.to(torch.int32)
        active = diffuse & ~(mask.amax(-1) < 0.01) & (n_diff < cfg.max_diff_bounces)
        if not bool(active.any()):
            break
    ev["pixels"] = n
    return ev


def bound(ev, scene, cfg, adjoint):
    """(bound_ms, bound_by) of K1 (or K2 when `adjoint`) for these events:
    the larger of the bytes over the HBM rate and the float operations over
    the float32 rate.  K2 replays each slot's forward and runs its adjoint,
    which takes at least as many operations, on top of a forward sweep
    without NEE."""
    types = [int(t) for t in scene.mesh_types_static]
    per_ray = sum(OPS_MESH.get(t, 0) + 2 for t in types)
    nee = OPS_NEE + (OPS_NEE_MIS if cfg.use_mis else 0)
    hits = ev["diffuse"] + ev["light"]
    sweep = ev["rays"] * per_ray + hits * OPS_HIT + ev["diffuse"] * OPS_DIFFUSE
    fwd = (sweep + ev["shadow"] * (per_ray + nee) + ev["light"] * OPS_LIGHT
           + ev["light_mis"] * OPS_LIGHT_MIS + ev["miss"] * OPS_MISS)
    table = 4 * scene.num_meshes * 36
    px = ev["pixels"]
    if adjoint:   # ro, rd, pix, ct in; d_ro, d_rd, d_table out
        ops, nbytes = sweep + 2 * fwd, px * (12 + 12 + 8 + 12 + 24) + 2 * table
    else:         # ro, rd, pix in; radiance out
        ops, nbytes = fwd, px * (12 + 12 + 8 + 12) + table
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_times_ms(prof, names):
    """Device milliseconds per profiled kernel whose name contains each of
    `names`, and the device total of all kernels; None where the profiler
    shows no device time."""
    evts = prof.key_averages()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return v
        return 0.0

    out = {n: sum(dev_us(e) for e in evts if n in e.key) / 1e3 for n in names}
    total = sum(dev_us(e) for e in evts) / 1e3
    if total <= 0.0:
        return {n: None for n in names}, None
    return out, total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from raytracer0_tpu_torch import optimize, rng
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

    # ---- phase 2: build both kernels at once ----
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(megakernel.build), pool.submit(megakernel.build_bwd)]
        infos = [f.result()[1] for f in builds]
    for name, info in zip(("K1", "K2"), infos):
        print(f"phase 2: {name} build {info.seconds:.2f} s, cache "
              f"{'hit' if info.cache_hit else 'miss'}, {info.path}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                print(f"phase 2: {name} ptxas: {line.strip()}")

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
    del out, ref

    # ---- phase 4: the render main path ----
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

    # ---- phase 6: K2 against the plain version's autograd ----
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

    # ---- phase 7: K2 against finite differences of K1 ----
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

    # ---- phase 8: the gradient main path, timed, and a fit ----
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
    step_p = time_stats(torch, lambda: step_fn("plain"), runs=9)
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
        plain_out, list(leaves.values()) + [o8, d8], ct, retain_graph=True))
    del plain_out
    print(f"phase 8: {card}: backward alone: K2 {ms_k2:.3f} ms, plain autograd "
          f"{plain_ms_bwd:.3f} ms")

    from torch.profiler import ProfilerActivity, profile
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

    common = dict(route="cuda", library_ms=None)
    print(json.dumps({"kernels": [
        {"name": "K1 forward megakernel", **common,
         "source": "raytracer0_tpu_torch/csrc/megakernel.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:2357",
         "launches": launches,
         "launches_by_path": {"render": launches, "gradient": launches_grad},
         "max_abs_err": max_abs_err, "ms": ms_trace, "plain_ms": plain_ms_trace,
         "bound_ms": k1_bound, "bound_by": k1_by},
        {"name": "K2 adjoint megakernel", **common,
         "source": "raytracer0_tpu_torch/csrc/megakernel_bwd.cu",
         "replaces": "raytracer0_tpu/ops/megakernel.py:2545",
         "also_serves": "raytracer0_tpu/ops/megakernel.py:2445 (K3, the whole-trace "
                        "adjoint body, same outputs)",
         "launches": bwd_launches,
         "launches_by_path": {"render": bwd_render, "gradient": bwd_launches},
         "max_abs_err": k2_abs, "max_rel_err": k2_rel, "ms": ms_k2,
         "plain_ms": plain_ms_bwd, "bound_ms": k2_bound, "bound_by": k2_by},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
