// restir.cuh — the reservoir vertex of the ReSTIR kernels: the
// reservoir-vertex kernel K6v (restir_vertex.cu), the second stage of the
// ReSTIR pass K6, and the pass's adjoint K7 (restir_bwd.cu).
//
// `RestirVertex` is restir.reservoir_direct for one diffuse vertex of one
// pixel: candidate generation, temporal reuse at the pixel itself, spatial
// reuse on the previous pass's grid, finalize and shade.  It reads its spatial
// taps in place at (row + dy, col + dx), behind the in-bounds test, its
// history at its own pixel, and the light slots (position, color·emission,
// radius, live) from a table in shared memory by index; the target function
// p̂ is evaluated for the slot that each step needs.  Since every reservoir's
// light data is its slot's in this frame, the history's light data is fresh
// under ANIMATED accumulation without a refresh step, as in the Pallas
// kernel; the plain version refreshes the history's copy and reads the
// spatial taps' stored copies (PERF.md, the ANIMATED divergence).
//
// `run` takes a tape: K6v passes `NoTape`, whose hooks compile to nothing;
// K7 records the decisions and the values its reverse sweep needs (the
// reservoir before each combine, the selections, the visibility and the
// shading ray's hit), so both kernels take every decision in this one copy.
//
// The split form (`RestirVertexT<true>`, K6v on the split path of
// restir_split.render_sample_fast) is restir.reservoir_direct as the split
// path's plain version runs it: every reservoir carries its light's
// position and color·emission (`ResL`), taken from the slot table when a
// candidate is selected and read from the grids' stored copies for the
// spatial taps and the history; under ANIMATED accumulation the history's
// copy is refreshed from the slot table; the target function, validity,
// the taps' distance gate and the visibility ray read the carried copy; and
// with `adhoc` (cfg.restir_adhoc_motion) the history is read at the pixel
// the ad-hoc motion vector reprojects to.  The default form
// (`RestirVertex`) is the fused form K6v and K7 run; the split form's
// additions are `if constexpr`, so they leave its code, and K7's, as they
// are (chip_smoke.py phase 2 checks K7's registers).
//
// `kAll` selects K6v's whole-SDF copy, for scenes whose SDF rows go beyond
// BOX and ROUND_BOX or are textured (use_tex bit 2,
// megakernel.whole_sdf): its two shadow rays march every shape
// (trace_common.cuh::intersect_scene<true, true>, the scene map of K1's
// whole-SDF copy), which the casts of the plain version's
// intersect.intersect and of the TPU's cast kernel run.  It reads no
// texel: the target function and the shading read the rows' own color and
// emission, as the plain version does.  K7's ROUND_BOX copy compiles
// neither flag, its whole-SDF copy `kAll`.

#pragma once

#include <type_traits>

#include "path.cuh"

namespace {

constexpr float MAX_AGE = 30.0f;                    // MAX_RESERVOIR_AGE
constexpr float ALPHA0 = 0.95f;                     // TEMPORAL_ALPHA
constexpr float ALPHA1 = (float)(0.95 * 0.80);      // TEMPORAL_ALPHA * 0.8
// under ANIMATED accumulation, a further 0.85: the double products in the
// plain version's order, rounded once
constexpr float ALPHA0_ANIMATED = (float)(0.95 * 1.0 * 0.85);
constexpr float ALPHA1_ANIMATED = (float)(0.95 * 0.80 * 0.85);
constexpr int NSLOT = 8;                            // floats per light slot
constexpr int MAX_SPATIAL = 8;                      // RESTIR_SPATIAL_SAMPLES
constexpr uint32_t S_RESTIR_CANDIDATE = 11u, S_RESTIR_TEMPORAL = 12u, S_RESTIR_SPATIAL = 13u;

// One reservoir grid: five fields over [height, width], and the light data
// [height, width, 3] the split form reads (null for the fused form and K7).
struct ResIn {
  const float *ws, *m, *w, *age;
  const int32_t *idx;
  const float *pos, *col;
};

struct RestirArgs {
  ResIn back, hist[2];    // the previous pass's grid, the two history levels
  float *pos, *col;       // outputs [n_pix, 3] (K6v)
  float *ws, *m, *w, *age;  // outputs [n_pix] (K6v)
  int32_t *idx;           // output [n_pix] (K6v)
  int taps[16];           // (row, column) offsets of the 8 spatial taps
  int height, width;
  int n_cand, n_spatial;  // candidates, spatial taps
  float eps2, eps10;      // f32(cfg.epsilon * 2), f32(cfg.epsilon * 10)
  int animated;           // ANIMATED accumulation: faster fade, younger taps
  int adhoc;              // split form: the history at the reprojected pixel
};

struct Res {
  float ws, m, w, age;
  int idx;
};

// A reservoir with the light data it carries (the split form).
struct ResL : Res {
  V3 pos, col;
};

// restir.py's ad-hoc motion scale 0.001 * (level + 1), the Python double
// rounded once to float32, and the jitter's scale
constexpr float MOTION0 = (float)(0.001 * 1), MOTION1 = (float)(0.001 * 2);
constexpr float JITTER = 0.002f;

// Host side: the reservoir arguments of both launchers from the wrapper's
// pointer arrays (`res_out` null for K7, which writes no reservoirs).
inline RestirArgs restir_args(const void *const *res_in, void *const *res_out, const int32_t *taps,
                              int height, int width, int n_cand, int n_spatial, float eps2,
                              float eps10, int animated) {
  RestirArgs ra = {};
  ResIn *grids[3] = {&ra.back, &ra.hist[0], &ra.hist[1]};
  for (int g = 0; g < 3; ++g) {
    grids[g]->ws = static_cast<const float *>(res_in[5 * g]);
    grids[g]->m = static_cast<const float *>(res_in[5 * g + 1]);
    grids[g]->w = static_cast<const float *>(res_in[5 * g + 2]);
    grids[g]->age = static_cast<const float *>(res_in[5 * g + 3]);
    grids[g]->idx = static_cast<const int32_t *>(res_in[5 * g + 4]);
  }
  if (res_out != nullptr) {
    ra.pos = static_cast<float *>(res_out[0]);
    ra.col = static_cast<float *>(res_out[1]);
    ra.ws = static_cast<float *>(res_out[2]);
    ra.m = static_cast<float *>(res_out[3]);
    ra.w = static_cast<float *>(res_out[4]);
    ra.age = static_cast<float *>(res_out[5]);
    ra.idx = static_cast<int32_t *>(res_out[6]);
  }
  for (int k = 0; k < 16; ++k) ra.taps[k] = taps[k];
  ra.height = height;
  ra.width = width;
  ra.n_cand = n_cand;
  ra.n_spatial = n_spatial;
  ra.eps2 = eps2;
  ra.eps10 = eps10;
  ra.animated = animated;
  return ra;
}

// The tape K6v passes: records nothing.
struct NoTape {
  __device__ __forceinline__ void candidate(int, bool, bool) {}
  __device__ __forceinline__ void combine(const Res &, bool, float, float, bool) {}
  __device__ __forceinline__ void post_clamp(bool, float) {}
  __device__ __forceinline__ void finalize(const Res &, bool) {}
  __device__ __forceinline__ void shade(int, bool, bool) {}
};

// Fill the light-slot table: per slot its light's position, color·emission,
// radius and liveness (a slot of -1 reads row 0, as the plain version's
// clamp does).  The caller synchronises the block before reading it.
__device__ __forceinline__ void load_slots(const TraceArgs &a, float *slots) {
  for (int l = threadIdx.x; l < a.n_lights; l += blockDim.x) {
    const int li = a.lights[l];
    const float *row = a.table + (long long)(li < 0 ? 0 : li) * NCOLS;
    float *t = slots + l * NSLOT;
    for (int k = 0; k < 3; ++k) {
      t[k] = row[C_PX + k];
      t[3 + k] = row[C_CR + k] * row[C_ER + k];
    }
    t[6] = row[C_J0];
    t[7] = li >= 0 ? 1.0f : 0.0f;
  }
}

// The reservoir vertex (restir.reservoir_direct) of one diffuse vertex:
// `run` returns the shaded direct light without the throughput and keeps
// the vertex's reservoir in `r`.  `kSplit` selects the split form, `kAll`
// the whole-SDF copy (the header comment).
template <bool kSplit = false, bool kAll = false>
struct RestirVertexT {
  using R = std::conditional_t<kSplit, ResL, Res>;
  const SceneSmem &s;
  const SdfScene &sd;
  const TraceArgs &a;
  const RestirArgs &ra;
  const float *slots;  // [n_lights, 8]: position, color·emission, radius, live
  int row, col;
  R r;

  __device__ __forceinline__ V3 slot_pos(int l) const {
    return {slots[l * NSLOT], slots[l * NSLOT + 1], slots[l * NSLOT + 2]};
  }
  __device__ __forceinline__ V3 slot_col(int l) const {
    return {slots[l * NSLOT + 3], slots[l * NSLOT + 4], slots[l * NSLOT + 5]};
  }
  __device__ __forceinline__ bool in_range(int l) const { return l >= 0 && l < s.n_lights; }

  // A shadow ray's nearest hit (intersect.intersect): the march over the
  // BOX and ROUND_BOX rows, or over every shape in the whole-SDF copy.
  __device__ __forceinline__ void cast(V3 o, V3 d, float &t, int &idx) const {
    if constexpr (kAll)
      intersect_scene<true, true>(s, sd, o, d, a.eps, a.inf, t, idx, a.noise, a.noise_n);
    else
      intersect_scene<true>(s, sd, o, d, a.eps, a.inf, t, idx);
  }

  // The light data reservoir q holds: the carried copy in the split form,
  // else its slot's (zeros for no slot).
  __device__ __forceinline__ V3 held_pos(const R &q) const {
    if constexpr (kSplit) return q.pos;
    else return in_range(q.idx) ? slot_pos(q.idx) : V3{0.0f, 0.0f, 0.0f};
  }
  __device__ __forceinline__ V3 held_col(const R &q) const {
    if constexpr (kSplit) return q.col;
    else return in_range(q.idx) ? slot_col(q.idx) : V3{0.0f, 0.0f, 0.0f};
  }
  // Select light slot l (a candidate) or reservoir q's light into r.
  __device__ __forceinline__ void take_slot(int l) {
    r.idx = l;
    if constexpr (kSplit) {
      r.pos = slot_pos(l);
      r.col = slot_col(l);
    }
  }
  __device__ __forceinline__ void take_light(const R &q) {
    r.idx = q.idx;
    if constexpr (kSplit) {
      r.pos = q.pos;
      r.col = q.col;
    }
  }
  __device__ __forceinline__ static R empty() {
    R e{};
    e.idx = -1;
    return e;
  }

  // The material-aware BRDF weight of the shading mesh mi (evaluate_target).
  __device__ __forceinline__ float brdf_weight(int mi) const {
    const V3 mc = s.c(mi);
    const float nt = fabsf(s.ior(mi));
    const int mt = s.mat[mi];
    const float surface_lum = mc.x * 0.2126f + mc.y * 0.7152f + mc.z * 0.0722f;
    const float nnt = (nt - 1.0f) / fmaxf(nt + 1.0f, 1e-6f);
    const float r0 = nnt * nnt;
    const float is_refr = (mt == MAT_REFR_FRESNEL || mt == MAT_REFR_SCHLICK) ? 1.0f : 0.0f;
    const float is_coat = mt == MAT_COAT ? 1.0f : 0.0f;
    const float base = surface_lum + (r0 - surface_lum) * is_refr;
    return (base + ((1.0f - r0) * surface_lum - base) * is_coat) * ONE_OVER_PI;
  }

  // restir.evaluate_target of a light at lp of color·emission lc at (x, nl).
  __device__ __forceinline__ float target_at(V3 lp, V3 lc, V3 x, V3 nl, float brdf) const {
    const V3 lv = lp - x;
    const float d2 = dot(lv, lv);
    const float cos_t = fmaxf(dot(nl, normalize(lv)), 0.0f);
    const float light_lum = lc.x * 0.2126f + lc.y * 0.7152f + lc.z * 0.0722f;
    const float p_hat = light_lum * brdf * cos_t / fmaxf(d2, 1e-4f);
    return (d2 >= 1e-6f && cos_t > 0.0f && light_lum > 0.0f) ? p_hat : 0.0f;
  }

  // restir.evaluate_target of slot l at (x, nl); 0 for no slot.
  __device__ __forceinline__ float target(int l, V3 x, V3 nl, float brdf) const {
    if (!in_range(l)) return 0.0f;
    return target_at(slot_pos(l), slot_col(l), x, nl, brdf);
  }

  // restir.evaluate_target of reservoir q's light.
  __device__ __forceinline__ float target_of(const R &q, V3 x, V3 nl, float brdf) const {
    if constexpr (kSplit) return target_at(q.pos, q.col, x, nl, brdf);
    else return target(q.idx, x, nl, brdf);
  }

  // restir.is_valid_reservoir of q and the light data it holds.
  __device__ __forceinline__ bool valid(const R &q) const {
    bool ok = isfinite(q.m) && isfinite(q.ws) && isfinite(q.w) && isfinite(q.age);
    ok = ok && q.m > 0.0f && q.m <= 200.0f && q.ws > 0.0f && q.ws <= 1000.0f;
    ok = ok && q.w >= 0.0f && q.w <= 20.0f && q.age >= 0.0f && q.age <= MAX_AGE + 5.0f;
    const V3 lc = held_col(q);
    const V3 lp = held_pos(q);
    const float lc2 = dot(lc, lc), lp2 = dot(lp, lp);
    ok = ok && lc2 >= 1e-6f && lc2 <= 1e4f && q.idx < s.n_lights;
    return ok && !(lp2 < 1e-6f && q.idx >= 0);
  }

  // restir.combine_reservoirs of `q` into r.
  template <class Tape>
  __device__ __forceinline__ void combine(const R &q, bool ok, float rand, V3 x, V3 nl,
                                          float brdf, Tape &tape) {
    ok = ok && valid(q);
    const float tw = target_of(q, x, nl, brdf);
    ok = ok && tw > 0.0f;
    const float contribution =
        fminf(fmaxf(tw * fmaxf(q.w, 0.0f) * fmaxf(q.m, 1.0f), 0.0f), 200.0f);
    float ws = r.ws + (ok ? contribution : 0.0f);
    float m = r.m + (ok ? q.m : 0.0f);
    const float m_new = m;
    const float ws_before = r.ws;
    const float scale = m > 40.0f ? 40.0f / fmaxf(m, 1e-6f) : 1.0f;
    ws = ws * scale;
    m = fminf(m, 40.0f);
    const bool select = ok && ws > 0.0f && rand < contribution / fmaxf(ws, 1e-12f);
    if (select) {
      r.age = fminf(q.age + 0.25f, MAX_AGE);
      take_light(q);
    }
    r.ws = ws;
    r.m = m;
    tape.combine(q, ok, ws_before, m_new, select);
  }

  __device__ __forceinline__ R load(const ResIn &g, long long q) const {
    if constexpr (kSplit) {
      R v;
      static_cast<Res &>(v) = {__ldg(g.ws + q), __ldg(g.m + q), __ldg(g.w + q),
                               __ldg(g.age + q), __ldg(g.idx + q)};
      v.pos = {__ldg(g.pos + 3 * q), __ldg(g.pos + 3 * q + 1), __ldg(g.pos + 3 * q + 2)};
      v.col = {__ldg(g.col + 3 * q), __ldg(g.col + 3 * q + 1), __ldg(g.col + 3 * q + 2)};
      return v;
    } else {
      return {__ldg(g.ws + q), __ldg(g.m + q), __ldg(g.w + q), __ldg(g.age + q),
              __ldg(g.idx + q)};
    }
  }

  // Candidate i's light slot and its second draw.
  __device__ __forceinline__ int candidate_slot(uint32_t h_depth, int i, float &r2) const {
    const int L = s.n_lights;
    const uint32_t h = fold_step(fold_step(h_depth, (uint32_t)i, 4u), S_RESTIR_CANDIDATE, 5u);
    const float r1 = u01(h);
    r2 = u01(pcg(h));
    int slot = (int)(r1 * (float)L);
    return slot < 0 ? 0 : (slot > L - 1 ? L - 1 : slot);
  }

  // The uniforms of the cone sample that shades the selected slot.
  __device__ __forceinline__ void shade_draws(uint32_t h_depth, float &u1, float &u2) const {
    const uint32_t hs = fold_step(fold_step(h_depth, S_NEE_CONE, 4u), 77u, 5u);
    u1 = u01(hs);
    u2 = u01(pcg(hs));
  }

  // The spatial taps' gate (restir.reservoir_direct phase 3) and draws.
  __device__ __forceinline__ bool tap_ok(int i, const R &q, bool in_b, V3 x, uint32_t h_depth,
                                         float &s2) const {
    const uint32_t h = fold_step(fold_step(h_depth, (uint32_t)i, 4u), S_RESTIR_SPATIAL, 5u);
    const float s1 = u01(h);
    s2 = u01(pcg(h));
    const bool few_frames = a.pass_idx < 10u;
    const int halve = ra.n_spatial / 2 > 2 ? ra.n_spatial / 2 : 2;
    bool ok = in_b && q.m > 0.0f && !(i >= halve && few_frames);
    if (q.idx >= 0 && (kSplit || in_range(q.idx))) {
      const V3 ld = held_pos(q) - x;
      ok = ok && !(dot(ld, ld) > 225.0f);
    }
    return ok && !(q.age > (ra.animated ? 2.0f : MAX_AGE * 0.8f)) && !(s1 < 0.03f);
  }

  // Spatial tap i's grid cell (clamped into the image) and whether it is in
  // bounds.
  __device__ __forceinline__ long long tap_cell(int i, bool &in_b) const {
    const int nr = row + ra.taps[2 * i], nc = col + ra.taps[2 * i + 1];
    in_b = nr >= 0 && nr < ra.height && nc >= 0 && nc < ra.width;
    const int cr = nr < 0 ? 0 : (nr > ra.height - 1 ? ra.height - 1 : nr);
    const int cc = nc < 0 ? 0 : (nc > ra.width - 1 ? ra.width - 1 : nc);
    return (long long)cr * ra.width + cc;
  }

  // The temporal fade of history level `level`.
  __device__ __forceinline__ float alpha(int level) const {
    if (ra.animated) return level == 1 ? ALPHA1_ANIMATED : ALPHA0_ANIMATED;
    return level == 1 ? ALPHA1 : ALPHA0;
  }

  // The grid cell the ad-hoc motion vector of level `level` reprojects the
  // pixel to (restir.reservoir_direct's `adhoc_motion` branch, in the plain
  // version's float32 operations), and whether it is inside the border.
  __device__ __forceinline__ long long reproject(int level, V3 x, uint32_t h_depth,
                                                 bool &in_b) const {
    const uint32_t h = fold_step(fold_step(h_depth, (uint32_t)level, 4u), S_RESTIR_TEMPORAL, 5u);
    const float ju = u01(h), jv = u01(pcg(h));
    const float motion = level == 1 ? MOTION1 : MOTION0;
    const float uv_x = ((float)col + 0.5f) / (float)ra.width + x.x * motion + (ju - 0.5f) * JITTER;
    const float uv_y = ((float)row + 0.5f) / (float)ra.height + x.y * motion + (jv - 0.5f) * JITTER;
    in_b = uv_x > 0.01f && uv_x < 0.99f && uv_y > 0.01f && uv_y < 0.99f;
    const long long hr = (long long)(uv_y * (float)ra.height);  // truncates, as .to(int64)
    const long long hc = (long long)(uv_x * (float)ra.width);
    const long long cr = hr < 0 ? 0 : (hr > ra.height - 1 ? ra.height - 1 : hr);
    const long long cc = hc < 0 ? 0 : (hc > ra.width - 1 ? ra.width - 1 : hc);
    return cr * ra.width + cc;
  }

  // History level `level` at the pixel itself (or, in the split form with
  // `adhoc`, at the reprojected pixel), aged and faded for the temporal
  // combine; `ok` its gate.
  __device__ __forceinline__ R history(int level, V3 x, uint32_t h_depth, bool &ok) const {
    bool in_b = true;
    long long q = (long long)row * ra.width + col;
    if constexpr (kSplit) {
      if (ra.adhoc) q = reproject(level, x, h_depth, in_b);
    }
    R h = load(ra.hist[level], q);
    ok = valid(h) && in_b && a.pass_idx > 2u && h.m > 0.0f && h.age < MAX_AGE;
    if constexpr (kSplit) {
      if (ra.animated && h.idx >= 0) {  // the held light as it is in this frame
        const int L = s.n_lights;
        const int sl = h.idx > L - 1 ? L - 1 : h.idx;
        h.pos = slot_pos(sl);
        h.col = slot_col(sl);
      }
    }
    h.age = h.age + (float)(level + 1);
    const float fade = alpha(level);
    h.m = h.m * fade;
    h.ws = h.ws * fade;
    return h;
  }

  // The shadow ray toward the selected light: whether it is visible.
  __device__ __forceinline__ bool visibility(V3 x) const {
    const V3 wp = held_pos(r);
    const V3 sdv = wp - x;
    const float dist = sqrtf(fmaxf(dot(sdv, sdv), EPS));
    const V3 sdir = {sdv.x / dist, sdv.y / dist, sdv.z / dist};
    float tv;
    int iv;
    cast(x + sdir * ra.eps2, sdir, tv, iv);
    const bool blocked = tv < a.inf && tv < dist - ra.eps2;
    return dist < ra.eps10 || !blocked || s.mat[iv] == MAT_LIGHT;
  }

  // The selected light's slot for shading (clamped into range).
  __device__ __forceinline__ int shade_slot() const {
    const int L = s.n_lights;
    return r.idx < 0 ? 0 : (r.idx > L - 1 ? L - 1 : r.idx);
  }

  template <class Tape>
  __device__ V3 run(V3 x, V3 nl, int mi, uint32_t h_depth, Tape &tape) {
    const int L = s.n_lights;
    const float brdf = brdf_weight(mi);

    // ---- phase 1: candidate generation ----
    r = empty();
    for (int i = 0; i < ra.n_cand; ++i) {
      float r2;
      const int slot = candidate_slot(h_depth, i, r2);
      const float tv = slots[slot * NSLOT + 7] > 0.0f ? target(slot, x, nl, brdf) : 0.0f;
      const bool take = tv > 0.0f;
      float ws = r.ws + (take ? tv : 0.0f);
      float m = r.m + (take ? 1.0f : 0.0f);
      const bool overflow = m > 60.0f;
      if (overflow) {
        ws = ws * 0.95f;
        m = m * 0.95f;
      }
      if (take && ws > 0.0f && r2 < tv / fmaxf(ws, 1e-12f)) take_slot(slot);
      r.ws = ws;
      r.m = m;
      tape.candidate(i, take, overflow);
    }

    // ---- phase 2: temporal reuse at the pixel itself ----
    for (int level = 0; level < 2; ++level) {
      bool ok;
      const R h = history(level, x, h_depth, ok);
      const uint32_t ht = fold_step(
          fold_step(fold_step(h_depth, (uint32_t)level, 4u), S_RESTIR_TEMPORAL, 5u), 991u, 6u);
      combine(h, ok, u01(ht), x, nl, brdf, tape);
    }
    const bool over = r.m > 100.0f;  // post-combine clamp
    tape.post_clamp(over, r.m);
    if (over) {
      r.m = fminf(r.m, 80.0f);
      r.ws = r.ws * 0.9f;
    }

    // ---- phase 3: spatial reuse on the previous pass's grid ----
    for (int i = 0; i < ra.n_spatial; ++i) {
      bool in_b;
      const R q = load(ra.back, tap_cell(i, in_b));
      float s2;
      const bool ok = tap_ok(i, q, in_b, x, h_depth, s2);
      combine(q, ok, s2, x, nl, brdf, tape);
    }

    // ---- phase 4: visibility, finalize and shade ----
    const bool visible = visibility(x);
    tape.finalize(r, visible);
    const float p_hat = target_of(r, x, nl, brdf);
    const bool good = r.ws > 0.0f && r.m > 0.0f && p_hat > 0.0f && visible;
    const float m_cl = fminf(fmaxf(r.m, 1.0f), 40.0f);
    const float raw_w = r.ws / fmaxf(p_hat * m_cl, 1e-12f);
    const float norm_age = fminf(fmaxf(r.age / MAX_AGE, 0.0f), 1.0f);
    float bias = r.age > 0.0f ? 0.85f + 0.15f * (1.0f - norm_age * 0.3f) : 1.0f;
    bias = bias * (m_cl > 16.0f ? safe_sqrt(16.0f / m_cl) : 1.0f);
    float w = fminf(fmaxf(bias * raw_w, 0.0f), 12.0f);
    w = isfinite(w) ? w : 0.0f;
    r.w = good ? w : 0.0f;
    r.age = fminf(r.age, MAX_AGE);

    // shade the selected slot: a cone toward the sphere light, a shadow ray
    const int slot = shade_slot();
    float u1, u2;
    shade_draws(h_depth, u1, u2);
    const float rad = slots[slot * NSLOT + 6];
    const V3 sw = slot_pos(slot) - x;
    const float d2 = dot(sw, sw);
    const float cos_a_max = safe_sqrt(1.0f - fminf(fmaxf(safe_div(rad * rad, d2), 0.0f), 1.0f));
    const V3 sr = sample_cone(normalize(sw), 1.0f - cos_a_max, u1, u2);
    float ts;
    int hidx;
    cast(x + nl * a.eps, sr, ts, hidx);
    V3 light = {0.0f, 0.0f, 0.0f};
    const bool lit = ts < a.inf && s.mat[hidx] == MAT_LIGHT;
    if (lit) {
      const float cos_term = fmaxf(dot(sr, nl), 0.001f);
      const float weight = 2.0f * (1.0f - cos_a_max);
      light = vmax(s.c(hidx), 0.001f) * s.e(hidx) * (weight * cos_term);
    }
    float eff_w = fminf(fmaxf(r.w, 0.0f), 8.0f);
    eff_w = eff_w * (r.m > 30.0f ? safe_sqrt(30.0f / fmaxf(r.m, 1e-6f)) : 1.0f);
    const V3 out = light * eff_w;
    const bool keep = isfinite(out.x) && isfinite(out.y) && isfinite(out.z) && r.w > 0.0f &&
                      r.idx >= 0 && r.idx < L;
    tape.shade(hidx, lit, keep);
    return keep ? out : V3{0.0f, 0.0f, 0.0f};
  }
};

using RestirVertex = RestirVertexT<false>;

}  // namespace
