"""ReSTIR: spatiotemporal reservoir resampling for direct lighting (port of
ops/restir.py; raytracer.glsl:1264-1802).

This is the plain version of the ReSTIR pass K6 (`ops/restir_kernel.py`:
K4 then K6v, `csrc/restir_vertex.cu`) and, under torch.autograd, of its adjoint K7
(`csrc/restir_bwd.cu`), and the semantics oracle both are held against: the
reservoir pipeline of one diffuse vertex (candidates, temporal reuse,
spatial reuse, finalize and shade) over the pixel grid, hooked into
`integrator.trace` in place of per-light NEE, for the class that
`integrator.unsupported` states.

Differentiable state, as in the JAX package: the discrete decisions (which
light a candidate or a combine selects, validity, the gates, visibility and
the shadow rays' hits) carry no gradient, while the continuous weights
(target values, weight sums, M, W, age), the combines, finalize and the
shading do; `torch.where` zeroes the untaken branch.  The ring's float
fields carry the gradient from pass to pass (`optimize.render_linear`).

The JAX package's TPU workarounds are not ported, their results are: a
light slot's data is plain indexing, not the one-hot MXU `_row_select`; a
spatial tap is a direct gather at (row + dy, col + dx), rejected by the
in-bounds mask where it leaves the image, not a static roll.  The ablation
hook and the band/halo arguments of tiles and sharding (ROADMAP queue 1
items 12-13) stay out.  The shadow rays go through a `cast_fn` hook: the
plain intersector by default, or the ray-cast kernel K5 in the split
pass's `render_sample_split` (`ops/restir_split.py`, whose kernel route
runs the ad-hoc temporal reprojection of `cfg.restir_adhoc_motion` in
K6v).  Under ANIMATED accumulation the history's
light data is refreshed from the current scene, the temporal alpha fades
by a further 0.85 and spatial taps older than 2 passes are rejected
(raytracer.glsl:1669-1676, 1742-1744).

`light_index` holds the slot into `scene.light_idx`.  A divisor that is a
constant is written as a tensor, since PyTorch turns a division by or of a
Python float into a reciprocal multiply (PERF.md), and the kernel divides.
"""

from __future__ import annotations

import torch

from raytracer0_tpu_torch import rng
from raytracer0_tpu_torch.models import scene as scene_mod
from raytracer0_tpu_torch.models.camera import generate_rays
from raytracer0_tpu_torch.models.materials import MatType
from raytracer0_tpu_torch.ops import intersect as isect
from raytracer0_tpu_torch.ops import sampling as smp
from raytracer0_tpu_torch.ops import vecmath as vm
from raytracer0_tpu_torch.render.state import Reservoirs

ONE_OVER_PI = 0.31830989

# Constants (raytracer.glsl:1266-1273).
RESTIR_SPATIAL_SAMPLES = 8
SPATIAL_RADIUS = 16.0
TEMPORAL_ALPHA = 0.95
MAX_RESERVOIR_AGE = 30.0
MAX_TEMPORAL_SAMPLES = 2

# Poisson disk offsets (raytracer.glsl:1288-1297), unit disk.
POISSON_DISK = (
    (-0.4706, 0.4706), (0.8090, 0.2628), (-0.2628, -0.8090),
    (0.6882, -0.5000), (-0.9511, -0.1625), (0.1625, 0.9511),
    (0.5000, -0.6882), (-0.6882, 0.5000),
)
#: (row, column) pixel offset of each spatial tap.
TAP_OFFSETS = tuple((int(round(dy * SPATIAL_RADIUS)), int(round(dx * SPATIAL_RADIUS)))
                    for dx, dy in POISSON_DISK)


def _const(like, v):
    return torch.full_like(like, v)


# max, min and clip against constants with the gradient of jnp.maximum,
# jnp.minimum and jnp.clip: half to each side at a tie, where torch.clamp
# passes it whole.  The ring makes ties common (W = 0, M = 40, age = 30).
def _max(x, c):
    return torch.maximum(x, x.new_full((), c))


def _min(x, c):
    return torch.minimum(x, x.new_full((), c))


def _clip(x, lo, hi):
    return _min(_max(x, lo), hi)


def empty_reservoir(batch, device):
    """Reservoir fields that hold no light, over `batch` lanes."""
    return Reservoirs.empty(*batch, device=device).fields()


def evaluate_target(light_pos, light_color, hit_pos, hit_normal, mat_c, mat_nt,
                    mat_type):
    """Target function p̂ (raytracer.glsl:1361-1387): luminance of the
    emitted radiance x a material-aware BRDF weight x cosθ / d²."""
    lv = light_pos - hit_pos
    d2 = vm.vdot(lv, lv)
    cos_t = _max(vm.vdot(hit_normal, vm.normalize(lv)), 0.0)
    light_lum = vm.luminance(light_color)
    surface_lum = vm.luminance(mat_c)
    nnt = (mat_nt - 1.0) / _max(mat_nt + 1.0, 1e-6)
    r0 = nnt * nnt
    is_refr = ((mat_type == MatType.REFR_FRESNEL)
               | (mat_type == MatType.REFR_SCHLICK)).to(torch.float32)
    is_coat = (mat_type == MatType.COAT).to(torch.float32)
    base = vm.mix(surface_lum, r0, is_refr)
    brdf_weight = vm.mix(base, (1.0 - r0) * surface_lum, is_coat) * ONE_OVER_PI
    p_hat = light_lum * brdf_weight * cos_t / _max(d2, 1e-4)
    valid = (d2 >= 1e-6) & (cos_t > 0.0) & (light_lum > 0.0)
    return torch.where(valid, p_hat, torch.zeros_like(p_hat))


def update_reservoir(r, light_pos, light_color, light_slot, weight, rand):
    """Weighted reservoir update with M-overflow decay
    (raytracer.glsl:1305-1326)."""
    take = weight > 0.0
    zero = torch.zeros_like(weight)
    ws = r["weight_sum"] + torch.where(take, weight, zero)
    m = r["m"] + torch.where(take, torch.ones_like(weight), zero)
    overflow = m > 60.0
    ws = torch.where(overflow, ws * 0.95, ws)
    m = torch.where(overflow, m * 0.95, m)
    select = take & (ws > 0.0) & (rand < weight / torch.clamp_min(ws, 1e-12))
    return dict(r, light_pos=vm.where3(select, light_pos, r["light_pos"]),
                light_color=vm.where3(select, light_color, r["light_color"]),
                light_index=torch.where(select, light_slot, r["light_index"]),
                weight_sum=ws, m=m)


def is_valid_reservoir(r, num_lights):
    """Validity gates (raytracer.glsl:1340-1359)."""
    ok = (torch.isfinite(r["m"]) & torch.isfinite(r["weight_sum"])
          & torch.isfinite(r["w"]) & torch.isfinite(r["age"]))
    ok &= (r["m"] > 0.0) & (r["m"] <= 200.0)
    ok &= (r["weight_sum"] > 0.0) & (r["weight_sum"] <= 1000.0)
    ok &= (r["w"] >= 0.0) & (r["w"] <= 20.0)
    ok &= (r["age"] >= 0.0) & (r["age"] <= MAX_RESERVOIR_AGE + 5.0)
    lc2 = vm.vdot(r["light_color"], r["light_color"])
    ok &= (lc2 >= 1e-6) & (lc2 <= 1e4)
    ok &= r["light_index"] < num_lights
    lp2 = vm.vdot(r["light_pos"], r["light_pos"])
    ok &= ~((lp2 < 1e-6) & (r["light_index"] >= 0))
    return ok


def combine_reservoirs(target, source, hit_pos, hit_normal, mat_c, mat_nt,
                       mat_type, rand_val, num_lights, source_ok=None):
    """Merge `source` into `target` with target-function reweighting and
    the M cap of 40 with proportional weight rescale
    (raytracer.glsl:1579-1611)."""
    ok = is_valid_reservoir(source, num_lights)
    if source_ok is not None:
        ok &= source_ok
    tw = evaluate_target(source["light_pos"], source["light_color"], hit_pos,
                         hit_normal, mat_c, mat_nt, mat_type)
    ok &= tw > 0.0
    contribution = _clip(tw * _max(source["w"], 0.0) * _max(source["m"], 1.0), 0.0, 200.0)
    zero = torch.zeros_like(tw)
    ws = target["weight_sum"] + torch.where(ok, contribution, zero)
    m = target["m"] + torch.where(ok, source["m"], zero)
    scale = torch.where(m > 40.0, _const(m, 40.0) / _max(m, 1e-6), torch.ones_like(m))
    ws = ws * scale
    m = _min(m, 40.0)
    select = ok & (ws > 0.0) & (rand_val < contribution / torch.clamp_min(ws, 1e-12))
    new_age = _min(source["age"] + 0.25, MAX_RESERVOIR_AGE)
    return dict(
        light_pos=vm.where3(select, source["light_pos"], target["light_pos"]),
        light_color=vm.where3(select, source["light_color"], target["light_color"]),
        light_index=torch.where(select, source["light_index"], target["light_index"]),
        age=torch.where(select, new_age, target["age"]),
        weight_sum=ws, m=m, w=target["w"])


def _cast(scene, cfg, o, d):
    """Nearest hit of shadow rays: (t, mesh index, missed)."""
    hit = isect.intersect(scene, o, d, cfg, need_normal=False, need_uv=False)
    return hit.t, hit.idx, hit.missed


def default_cast(scene, cfg):
    """The `cast_fn` of the plain version: `(o, d) -> (t, idx, missed)`
    through `intersect.intersect`."""
    return lambda o, d: _cast(scene, cfg, o, d)


def is_visible(scene, cfg, from_pos, to_pos, cast_fn=None):
    """Shadow-ray visibility (raytracer.glsl:1389-1414): occluders that are
    themselves lights do not block.  `cast_fn(o, d) -> (t, idx, missed)`
    casts the ray (`default_cast` when None)."""
    cast_fn = cast_fn or default_cast(scene, cfg)
    sd = to_pos - from_pos
    dist = vm.safe_length(sd)
    close = dist < cfg.epsilon * 10.0
    sdir = sd / dist[..., None]
    t, idx, missed = cast_fn(from_pos + sdir * (cfg.epsilon * 2.0), sdir)
    blocked = (t < dist - cfg.epsilon * 2.0) & ~missed
    blocker_is_light = scene.mat_type[idx] == MatType.LIGHT
    return close | ~blocked | (blocked & blocker_is_light)


def finalize_reservoir(r, hit_pos, hit_normal, mat_c, mat_nt, mat_type, visible):
    """W = weight_sum / (p̂·clamp(M, 1, 40)) with the age and M bias
    corrections, visibility, the W clamp [0, 12] and a NaN guard
    (raytracer.glsl:1525-1576)."""
    p_hat = evaluate_target(r["light_pos"], r["light_color"], hit_pos, hit_normal,
                            mat_c, mat_nt, mat_type)
    good = (r["weight_sum"] > 0.0) & (r["m"] > 0.0) & (p_hat > 0.0) & visible
    m_cl = _clip(r["m"], 1.0, 40.0)
    raw_w = r["weight_sum"] / _max(p_hat * m_cl, 1e-12)
    one = torch.ones_like(raw_w)
    norm_age = _clip(r["age"] / _const(raw_w, MAX_RESERVOIR_AGE), 0.0, 1.0)
    bias = torch.where(r["age"] > 0.0, vm.mix(0.85, 1.0, 1.0 - norm_age * 0.3), one)
    bias = bias * torch.where(m_cl > 16.0, vm.safe_sqrt(_const(m_cl, 16.0) / m_cl), one)
    w = _clip(bias * raw_w, 0.0, 12.0)
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    return dict(r, w=torch.where(good, w, torch.zeros_like(w)))


def _shade_selected(scene, cfg, slot_map, x, nl, pix, pass_idx, sample_idx, depth,
                    cast_fn=None):
    """calcDirectLighting for the selected light slot of each pixel
    (raytracer.glsl:1779 → 1174-1230): a uniform cone toward the sphere
    light, verified by a shadow ray cast by `cast_fn`."""
    cast_fn = cast_fn or default_cast(scene, cfg)
    slot = torch.clamp(slot_map, 0, scene.num_lights - 1).long()
    li = torch.clamp_min(scene.light_idx.long(), 0)[slot]
    l_pos = scene.pos[li]
    r = scene.joker[li, 0]
    u1, u2 = rng.uniform2(pix, pass_idx, sample_idx, depth, rng.Stream.NEE_CONE, 77)
    sw = l_pos - x
    d2 = vm.vdot(sw, sw)
    cos_a_max = vm.safe_sqrt(1.0 - _clip(vm.safe_div(r * r, d2), 0.0, 1.0))
    sr_dir = smp.sample_cone(vm.normalize(sw), 1.0 - cos_a_max, u1, u2)
    _, idx, missed = cast_fn(x + nl * cfg.epsilon, sr_dir)
    hit_is_light = (scene.mat_type[idx] == MatType.LIGHT) & ~missed
    lit_c = _max(scene.color[idx], 0.001)
    cos_term = _max(vm.vdot(sr_dir, nl), 0.001)
    weight = 2.0 * (1.0 - cos_a_max)
    contrib = lit_c * scene.emission[idx] * (weight * cos_term)[..., None]
    return vm.where3(hit_is_light, contrib, torch.zeros_like(contrib))


def light_table(scene):
    """Per light slot: position, color·emission and liveness (the slot
    names a mesh)."""
    li = torch.clamp_min(scene.light_idx.long(), 0)
    return scene.pos[li], scene.color[li] * scene.emission[li], scene.light_idx >= 0


def reservoir_direct(scene, cfg, back, hist, x, nl, mat_idx, pix, pass_idx,
                     sample_idx, depth, *, height, width, cast_fn=None):
    """The reservoir pipeline of one diffuse vertex per pixel (candidate
    generation → temporal reuse → spatial reuse → finalize and shade,
    raytracer.glsl:1619-1801).  `back` and `hist` (two levels) are
    reservoir field dicts over the [height, width] grid; `pix` gives each
    lane's pixel.  `depth` is the bounce depth, an int or a per-lane
    integer tensor (the split path's G-buffer depth); either keys the RNG
    alike.  `cast_fn(o, d) -> (t, idx, missed)` casts the two shadow rays
    (`default_cast` when None).  Returns (direct radiance without the
    throughput mask, reservoir dict)."""
    rows, cols = pix // width, pix % width
    L = scene.num_lights
    animated = int(cfg.render_mode) == 1
    mat_c = scene.color[mat_idx]
    mat_nt = torch.abs(scene.ior)[mat_idx]
    mat_ty = scene.mat_type[mat_idx]
    pos_tab, col_tab, live_tab = light_table(scene)

    # ---- phase 1: candidate generation (1630-1654) ----
    res = empty_reservoir(x.shape[:-1], x.device)
    for i in range(min(cfg.restir_samples, max(4, L))):
        r1, r2 = rng.uniform2(pix, pass_idx, sample_idx, depth, i,
                              rng.Stream.RESTIR_CANDIDATE)
        slot = torch.clamp((r1 * L).to(torch.int32), 0, L - 1)
        lp, lc = pos_tab[slot.long()], col_tab[slot.long()]
        tv = evaluate_target(lp, lc, x, nl, mat_c, mat_nt, mat_ty)
        tv = torch.where(live_tab[slot.long()], tv, torch.zeros_like(tv))
        res = update_reservoir(res, lp, lc, slot, tv, r2)

    # ---- phase 2: temporal reuse at the pixel itself (1656-1709) ----
    frame_ok = pass_idx > MAX_TEMPORAL_SAMPLES
    for level in range(MAX_TEMPORAL_SAMPLES):
        if cfg.restir_adhoc_motion:
            # ad-hoc motion vector and jitter (1486-1496): the history is
            # read at the reprojected pixel, rejected near the border
            ju, jv = rng.uniform2(pix, pass_idx, sample_idx, depth, level,
                                  rng.Stream.RESTIR_TEMPORAL)
            motion_scale = 0.001 * (level + 1)   # the motion vector: x relative to
            mx = x[..., 0] * motion_scale         # a camera at the origin
            my = x[..., 1] * motion_scale
            colf, rowf = cols.to(torch.float32), rows.to(torch.float32)
            uv_x = (colf + 0.5) / _const(colf, width) + mx + (ju - 0.5) * 0.002
            uv_y = (rowf + 0.5) / _const(rowf, height) + my + (jv - 0.5) * 0.002
            in_bounds = (uv_x > 0.01) & (uv_x < 0.99) & (uv_y > 0.01) & (uv_y < 0.99)
            hr = torch.clamp((uv_y * height).to(torch.int64), 0, height - 1)
            hc = torch.clamp((uv_x * width).to(torch.int64), 0, width - 1)
            h = {k: v[hr, hc] for k, v in hist[level].items()}
            ok = is_valid_reservoir(h, L) & in_bounds & frame_ok
        else:
            h = {k: v[rows, cols] for k, v in hist[level].items()}
            ok = is_valid_reservoir(h, L) & frame_ok
        ok &= (h["m"] > 0.0) & (h["age"] < MAX_RESERVOIR_AGE)
        if animated:
            # the held light as it is in this frame (1669-1676)
            held = h["light_index"] >= 0
            slot_h = torch.clamp(h["light_index"], 0, L - 1).long()
            h["light_pos"] = vm.where3(held, pos_tab[slot_h], h["light_pos"])
            h["light_color"] = vm.where3(held, col_tab[slot_h], h["light_color"])
        h["age"] = h["age"] + (level + 1.0)
        alpha = TEMPORAL_ALPHA * (0.80 if level == 1 else 1.0) * (0.85 if animated else 1.0)
        h["m"] = h["m"] * alpha
        h["weight_sum"] = h["weight_sum"] * alpha
        t_rand = rng.uniform(pix, pass_idx, sample_idx, depth, level,
                             rng.Stream.RESTIR_TEMPORAL, 991)
        res = combine_reservoirs(res, h, x, nl, mat_c, mat_nt, mat_ty, t_rand, L,
                                 source_ok=ok)

    # post-combine clamp (1705-1708)
    over = res["m"] > 100.0
    res["m"] = torch.where(over, _min(res["m"], 80.0), res["m"])
    res["weight_sum"] = torch.where(over, res["weight_sum"] * 0.9, res["weight_sum"])

    # ---- phase 3: spatial reuse on the previous pass's grid (1711-1748) ----
    n_spatial = RESTIR_SPATIAL_SAMPLES if L <= 10 else max(4, RESTIR_SPATIAL_SAMPLES // 2)
    few_frames = pass_idx < 10
    for i in range(n_spatial):
        s1, s2 = rng.uniform2(pix, pass_idx, sample_idx, depth, i,
                              rng.Stream.RESTIR_SPATIAL)
        drow, dcol = TAP_OFFSETS[i]
        nr, nc = rows + drow, cols + dcol
        in_b = (nr >= 0) & (nr < height) & (nc >= 0) & (nc < width)
        nr, nc = torch.clamp(nr, 0, height - 1), torch.clamp(nc, 0, width - 1)
        n = {k: v[nr, nc] for k, v in back.items()}
        ok = in_b & (n["m"] > 0.0)
        if i >= max(2, n_spatial // 2) and few_frames:
            ok = torch.zeros_like(ok)       # warm-up halving (1721-1723)
        ld = n["light_pos"] - x
        ok &= ~((n["light_index"] >= 0) & (vm.vdot(ld, ld) > 225.0))
        ok &= ~(n["age"] > (2.0 if animated else MAX_RESERVOIR_AGE * 0.8))
        ok &= ~(s1 < 0.03)
        res = combine_reservoirs(res, n, x, nl, mat_c, mat_nt, mat_ty, s2, L,
                                 source_ok=ok)

    # ---- phase 4: finalize and shade (1750-1800) ----
    visible = is_visible(scene, cfg, x, res["light_pos"], cast_fn)
    res = finalize_reservoir(res, x, nl, mat_c, mat_nt, mat_ty, visible)
    res["age"] = _min(res["age"], MAX_RESERVOIR_AGE)
    shade_ok = (res["w"] > 0.0) & (res["light_index"] >= 0) & (res["light_index"] < L)
    light = _shade_selected(scene, cfg, res["light_index"], x, nl, pix, pass_idx,
                            sample_idx, depth, cast_fn)
    eff_w = _clip(res["w"], 0.0, 8.0)
    eff_w = eff_w * torch.where(res["m"] > 30.0,
                                vm.safe_sqrt(_const(eff_w, 30.0) / _max(res["m"], 1e-6)),
                                torch.ones_like(eff_w))
    out = light * eff_w[..., None]
    # NaN/Inf in any channel kills the whole contribution (1791-1793)
    keep = torch.isfinite(out).all(dim=-1) & shade_ok
    return vm.where3(keep, out, torch.zeros_like(out)), res


def make_sampler(back, hist, height, width):
    """The `restir_sampler` hook of `integrator.trace` over reservoir field
    dicts (`back`, and `hist` of two levels)."""

    def sampler(scene, cfg, hit, nl, mask, pix, pass_idx, sample_idx, depth):
        out, res = reservoir_direct(scene, cfg, back, hist, hit.pos, nl, hit.idx,
                                    pix, pass_idx, sample_idx, depth,
                                    height=height, width=width)
        return out * mask, res

    return sampler


def trace_sample(scene, cfg, ro, rd, pix, pass_idx, sample_idx, back, hist1, hist2):
    """One ReSTIR sample per pixel of the [H, W] grid `pix` through the
    plain integrator, reading the ring `back`, `hist1`, `hist2`
    (Reservoirs): (radiance f32[H, W, 3], new back Reservoirs).  The plain
    version of `restir_kernel.trace_forward_restir_fused` (K6, and K7 for its
    gradient)."""
    from raytracer0_tpu_torch.render import integrator  # it imports this module

    height, width = pix.shape
    sampler = make_sampler(back.fields(), [hist1.fields(), hist2.fields()], height, width)
    rad, res = integrator.trace(scene, cfg, ro, rd, pix, pass_idx, sample_idx,
                                restir_sampler=sampler)
    return rad, Reservoirs(**res)


def render_sample(scene, cfg, camera, state, height, width, pass_idx, time_s=0.0):
    """One ReSTIR pass through the plain integrator: (mean radiance
    f32[H, W, 3], the new back reservoirs), the reference kernel's two
    render targets (raytracer.glsl:2171-2179).  Differentiable with respect
    to the scene, the camera and the ring's float fields (module
    docstring)."""
    scene = scene_mod.animate_positions(scene, time_s, int(cfg.render_mode))
    pix = rng.pixel_ids(height, width, device=scene.device)
    total = torch.zeros((height, width, 3), dtype=torch.float32, device=scene.device)
    new = None
    for s in range(cfg.samples_per_pass):
        ro, rd = generate_rays(camera, height, width, pass_idx, sample_idx=s)
        rad, new = trace_sample(scene, cfg, ro, rd, pix, pass_idx, s, state.restir_back,
                                state.restir_hist1, state.restir_hist2)
        total = total + rad
    return total / cfg.samples_per_pass, new
