// restir.cu — the fused ReSTIR forward kernel K6 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// raytracer0_tpu/ops/megakernel.py::_fused_restir_kernel_body (launched by
// `_fused_restir_fwd_impl`): the path trace of K1 with the reservoir
// pipeline of a diffuse vertex (`_build_restir_vertex`: candidate
// generation, temporal reuse, spatial reuse, finalize and shade) in place of
// per-light NEE, in one launch.  Its outputs are the radiance f32[n_pix, 3]
// and the new back reservoirs of the pass (the last diffuse vertex's, as the
// reference's g_final_reservoir overwrite): light_pos, light_color,
// weight_sum, m, w, age and light_index.  Its plain PyTorch version is
// raytracer0_tpu_torch/ops/restir.py::render_sample (integrator.trace with
// restir.make_sampler's hook); the kernel follows its operations in order.
//
// The bounce loop is K1's (path.cuh::trace_path); this file adds the
// reservoir vertex as the loop's direct-light functor.
//
// What the TPU kernel does that this one does not: Mosaic cannot gather, so
// the Pallas kernel reads its spatial taps from a copy of the back grid
// pre-rolled by the 8 Poisson offsets ([8, 5, H, W], built by `roll_taps`
// in XLA before every launch), and selects a light's data by chained
// compares over the slots.  Here a thread reads each tap at (row + dy,
// col + dx) directly, rejected by the in-bounds test where it leaves the
// image; its own history at its own pixel; and a light slot's position,
// color·emission and radius from a table in shared memory by index.  The
// target function p̂ is evaluated for the slot that each step needs rather
// than for every slot up front.
//
// What bounds it: each pixel reads 28 bytes of rays and id, 3 x 20 bytes of
// reservoirs at its own pixel and up to 8 x 20 bytes of spatial taps (the
// taps of neighbouring threads overlap and come from L2), and writes 12 + 44
// bytes.  The work is K1's bounce loop plus, at each diffuse vertex, up to
// 16 candidates, 2 temporal and 8 spatial combines, and two shadow rays
// (visibility, shading), each a scan over the meshes and an SDF march: like
// K1 it is bound by instruction latency and divergence, not by memory.
// The reservoir carry (5 values) stays in registers; one thread per pixel.
//
// Numerics: no fast math, no FMA contraction; the f32 constants the plain
// version derives in Python doubles (epsilon * 2, epsilon * 10, 0.95 * 0.8)
// arrive from the wrapper or are written as the double product cast once.

#include "path.cuh"

namespace {

constexpr int THREADS = 128;
constexpr float MAX_AGE = 30.0f;                    // MAX_RESERVOIR_AGE
constexpr float ALPHA0 = 0.95f;                     // TEMPORAL_ALPHA
constexpr float ALPHA1 = (float)(0.95 * 0.80);      // TEMPORAL_ALPHA * 0.8
constexpr int NSLOT = 8;                            // floats per light slot
constexpr uint32_t S_RESTIR_CANDIDATE = 11u, S_RESTIR_TEMPORAL = 12u, S_RESTIR_SPATIAL = 13u;

// One reservoir grid: five fields over [height, width].
struct ResIn {
  const float *ws, *m, *w, *age;
  const int32_t *idx;
};

struct RestirArgs {
  ResIn back, hist[2];    // the previous pass's grid, the two history levels
  float *pos, *col;       // outputs [n_pix, 3]
  float *ws, *m, *w, *age;  // outputs [n_pix]
  int32_t *idx;           // output [n_pix]
  int taps[16];           // (row, column) offsets of the 8 spatial taps
  int height, width;
  int n_cand, n_spatial;  // candidates, spatial taps
  float eps2, eps10;      // f32(cfg.epsilon * 2), f32(cfg.epsilon * 10)
};

struct Res {
  float ws, m, w, age;
  int idx;
};

// The reservoir vertex (restir.reservoir_direct) as trace_path's direct
// light: returns the shaded direct light without the throughput and keeps
// the vertex's reservoir in `r`, so the last diffuse vertex's remains.
struct RestirVertex {
  const SceneSmem &s;
  const SdfScene &sd;
  const TraceArgs &a;
  const RestirArgs &ra;
  const float *slots;  // [n_lights, 8]: position, color·emission, radius, live
  int row, col;
  Res r;

  __device__ __forceinline__ V3 slot_pos(int l) const {
    return {slots[l * NSLOT], slots[l * NSLOT + 1], slots[l * NSLOT + 2]};
  }
  __device__ __forceinline__ V3 slot_col(int l) const {
    return {slots[l * NSLOT + 3], slots[l * NSLOT + 4], slots[l * NSLOT + 5]};
  }
  __device__ __forceinline__ bool in_range(int l) const { return l >= 0 && l < s.n_lights; }

  // restir.evaluate_target of slot l at (x, nl); 0 for no slot.
  __device__ __forceinline__ float target(int l, V3 x, V3 nl, float brdf) const {
    if (!in_range(l)) return 0.0f;
    const V3 lv = slot_pos(l) - x;
    const float d2 = dot(lv, lv);
    const float cos_t = fmaxf(dot(nl, normalize(lv)), 0.0f);
    const V3 lc = slot_col(l);
    const float light_lum = lc.x * 0.2126f + lc.y * 0.7152f + lc.z * 0.0722f;
    const float p_hat = light_lum * brdf * cos_t / fmaxf(d2, 1e-4f);
    return (d2 >= 1e-6f && cos_t > 0.0f && light_lum > 0.0f) ? p_hat : 0.0f;
  }

  // restir.is_valid_reservoir; the stored light data is the slot's.
  __device__ __forceinline__ bool valid(const Res &q) const {
    bool ok = isfinite(q.m) && isfinite(q.ws) && isfinite(q.w) && isfinite(q.age);
    ok = ok && q.m > 0.0f && q.m <= 200.0f && q.ws > 0.0f && q.ws <= 1000.0f;
    ok = ok && q.w >= 0.0f && q.w <= 20.0f && q.age >= 0.0f && q.age <= MAX_AGE + 5.0f;
    const V3 lc = in_range(q.idx) ? slot_col(q.idx) : V3{0.0f, 0.0f, 0.0f};
    const V3 lp = in_range(q.idx) ? slot_pos(q.idx) : V3{0.0f, 0.0f, 0.0f};
    const float lc2 = dot(lc, lc), lp2 = dot(lp, lp);
    ok = ok && lc2 >= 1e-6f && lc2 <= 1e4f && q.idx < s.n_lights;
    return ok && !(lp2 < 1e-6f && q.idx >= 0);
  }

  // restir.combine_reservoirs of `q` into r.
  __device__ __forceinline__ void combine(const Res &q, bool ok, float rand, V3 x, V3 nl,
                                          float brdf) {
    ok = ok && valid(q);
    const float tw = target(q.idx, x, nl, brdf);
    ok = ok && tw > 0.0f;
    const float contribution =
        fminf(fmaxf(tw * fmaxf(q.w, 0.0f) * fmaxf(q.m, 1.0f), 0.0f), 200.0f);
    float ws = r.ws + (ok ? contribution : 0.0f);
    float m = r.m + (ok ? q.m : 0.0f);
    const float scale = m > 40.0f ? 40.0f / fmaxf(m, 1e-6f) : 1.0f;
    ws = ws * scale;
    m = fminf(m, 40.0f);
    if (ok && ws > 0.0f && rand < contribution / fmaxf(ws, 1e-12f)) {
      r.age = fminf(q.age + 0.25f, MAX_AGE);
      r.idx = q.idx;
    }
    r.ws = ws;
    r.m = m;
  }

  __device__ __forceinline__ Res load(const ResIn &g, long long q) const {
    return {__ldg(g.ws + q), __ldg(g.m + q), __ldg(g.w + q), __ldg(g.age + q), __ldg(g.idx + q)};
  }

  __device__ V3 operator()(V3 x, V3 nl, int mi, uint32_t h_depth) {
    const int L = s.n_lights;
    // the shading point's material: raw color, |ior| and type
    const V3 mc = s.c(mi);
    const float nt = fabsf(s.ior(mi));
    const int mt = s.mat[mi];
    const float surface_lum = mc.x * 0.2126f + mc.y * 0.7152f + mc.z * 0.0722f;
    const float nnt = (nt - 1.0f) / fmaxf(nt + 1.0f, 1e-6f);
    const float r0 = nnt * nnt;
    const float is_refr = (mt == MAT_REFR_FRESNEL || mt == MAT_REFR_SCHLICK) ? 1.0f : 0.0f;
    const float is_coat = mt == MAT_COAT ? 1.0f : 0.0f;
    const float base = surface_lum + (r0 - surface_lum) * is_refr;
    const float brdf = (base + ((1.0f - r0) * surface_lum - base) * is_coat) * ONE_OVER_PI;

    // ---- phase 1: candidate generation ----
    r = {0.0f, 0.0f, 0.0f, 0.0f, -1};
    for (int i = 0; i < ra.n_cand; ++i) {
      const uint32_t h = fold_step(fold_step(h_depth, (uint32_t)i, 4u), S_RESTIR_CANDIDATE, 5u);
      const float r1 = u01(h), r2 = u01(pcg(h));
      int slot = (int)(r1 * (float)L);
      slot = slot < 0 ? 0 : (slot > L - 1 ? L - 1 : slot);
      const float tv = slots[slot * NSLOT + 7] > 0.0f ? target(slot, x, nl, brdf) : 0.0f;
      const bool take = tv > 0.0f;
      float ws = r.ws + (take ? tv : 0.0f);
      float m = r.m + (take ? 1.0f : 0.0f);
      if (m > 60.0f) {
        ws = ws * 0.95f;
        m = m * 0.95f;
      }
      if (take && ws > 0.0f && r2 < tv / fmaxf(ws, 1e-12f)) r.idx = slot;
      r.ws = ws;
      r.m = m;
    }

    // ---- phase 2: temporal reuse at the pixel itself ----
    const long long own = (long long)row * ra.width + col;
    for (int level = 0; level < 2; ++level) {
      Res h = load(ra.hist[level], own);
      const bool ok = valid(h) && a.pass_idx > 2u && h.m > 0.0f && h.age < MAX_AGE;
      h.age = h.age + (float)(level + 1);
      const float alpha = level == 1 ? ALPHA1 : ALPHA0;
      h.m = h.m * alpha;
      h.ws = h.ws * alpha;
      const uint32_t ht = fold_step(
          fold_step(fold_step(h_depth, (uint32_t)level, 4u), S_RESTIR_TEMPORAL, 5u), 991u, 6u);
      combine(h, ok, u01(ht), x, nl, brdf);
    }
    if (r.m > 100.0f) {  // post-combine clamp
      r.m = fminf(r.m, 80.0f);
      r.ws = r.ws * 0.9f;
    }

    // ---- phase 3: spatial reuse on the previous pass's grid ----
    const bool few_frames = a.pass_idx < 10u;
    const int halve = ra.n_spatial / 2 > 2 ? ra.n_spatial / 2 : 2;
    for (int i = 0; i < ra.n_spatial; ++i) {
      const uint32_t h = fold_step(fold_step(h_depth, (uint32_t)i, 4u), S_RESTIR_SPATIAL, 5u);
      const float s1 = u01(h), s2 = u01(pcg(h));
      const int nr = row + ra.taps[2 * i], nc = col + ra.taps[2 * i + 1];
      const bool in_b = nr >= 0 && nr < ra.height && nc >= 0 && nc < ra.width;
      const int cr = nr < 0 ? 0 : (nr > ra.height - 1 ? ra.height - 1 : nr);
      const int cc = nc < 0 ? 0 : (nc > ra.width - 1 ? ra.width - 1 : nc);
      const Res q = load(ra.back, (long long)cr * ra.width + cc);
      bool ok = in_b && q.m > 0.0f && !(i >= halve && few_frames);
      if (q.idx >= 0 && in_range(q.idx)) {
        const V3 ld = slot_pos(q.idx) - x;
        ok = ok && !(dot(ld, ld) > 225.0f);
      }
      ok = ok && !(q.age > MAX_AGE * 0.8f) && !(s1 < 0.03f);
      combine(q, ok, s2, x, nl, brdf);
    }

    // ---- phase 4: visibility, finalize and shade ----
    const V3 wp = in_range(r.idx) ? slot_pos(r.idx) : V3{0.0f, 0.0f, 0.0f};
    const V3 sdv = wp - x;
    const float dist = sqrtf(fmaxf(dot(sdv, sdv), EPS));
    const V3 sdir = {sdv.x / dist, sdv.y / dist, sdv.z / dist};
    float tv;
    int iv;
    intersect_scene<true>(s, sd, x + sdir * ra.eps2, sdir, a.eps, a.inf, tv, iv);
    const bool blocked = tv < a.inf && tv < dist - ra.eps2;
    const bool visible = dist < ra.eps10 || !blocked || s.mat[iv] == MAT_LIGHT;

    const float p_hat = target(r.idx, x, nl, brdf);
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
    const int slot = r.idx < 0 ? 0 : (r.idx > L - 1 ? L - 1 : r.idx);
    const uint32_t hs = fold_step(fold_step(h_depth, S_NEE_CONE, 4u), 77u, 5u);
    const float u1 = u01(hs), u2 = u01(pcg(hs));
    const float rad = slots[slot * NSLOT + 6];
    const V3 sw = slot_pos(slot) - x;
    const float d2 = dot(sw, sw);
    const float cos_a_max = safe_sqrt(1.0f - fminf(fmaxf(safe_div(rad * rad, d2), 0.0f), 1.0f));
    const V3 sr = sample_cone(normalize(sw), 1.0f - cos_a_max, u1, u2);
    float ts;
    int hidx;
    intersect_scene<true>(s, sd, x + nl * a.eps, sr, a.eps, a.inf, ts, hidx);
    V3 light = {0.0f, 0.0f, 0.0f};
    if (ts < a.inf && s.mat[hidx] == MAT_LIGHT) {
      const float cos_term = fmaxf(dot(sr, nl), 0.001f);
      const float weight = 2.0f * (1.0f - cos_a_max);
      light = vmax(s.c(hidx), 0.001f) * s.e(hidx) * (weight * cos_term);
    }
    float eff_w = fminf(fmaxf(r.w, 0.0f), 8.0f);
    eff_w = eff_w * (r.m > 30.0f ? safe_sqrt(30.0f / fmaxf(r.m, 1e-6f)) : 1.0f);
    const V3 out = light * eff_w;
    const bool keep = isfinite(out.x) && isfinite(out.y) && isfinite(out.z) && r.w > 0.0f &&
                      r.idx >= 0 && r.idx < L;
    return keep ? out : V3{0.0f, 0.0f, 0.0f};
  }
};

__global__ void __launch_bounds__(THREADS) restir_kernel(TraceArgs a, RestirArgs ra) {
  extern __shared__ float smem[];
  // the light-slot table follows what load_path() fills
  float *slots = smem + path_smem_bytes(a.n_mesh, a.n_lights, a.n_sdf) / sizeof(float);
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
  SceneSmem s;
  const PathSmem ps = load_path(a, smem, s);  // synchronises the block
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.n_pix) return;  // ragged edge

  const uint32_t id = (uint32_t)a.pix[p];
  RestirVertex v = {s, ps.sd, a, ra, slots, (int)(id / (uint32_t)ra.width),
                    (int)(id % (uint32_t)ra.width), {0.0f, 0.0f, 0.0f, 0.0f, -1}};
  const V3 acc = trace_path<true>(a, s, ps, p, v);
  a.out[3 * p] = acc.x;
  a.out[3 * p + 1] = acc.y;
  a.out[3 * p + 2] = acc.z;
  const bool held = v.r.idx >= 0 && v.r.idx < a.n_lights;
  const V3 lp = held ? v.slot_pos(v.r.idx) : V3{0.0f, 0.0f, 0.0f};
  const V3 lc = held ? v.slot_col(v.r.idx) : V3{0.0f, 0.0f, 0.0f};
  ra.pos[3 * p] = lp.x;
  ra.pos[3 * p + 1] = lp.y;
  ra.pos[3 * p + 2] = lp.z;
  ra.col[3 * p] = lc.x;
  ra.col[3 * p + 1] = lc.y;
  ra.col[3 * p + 2] = lc.z;
  ra.ws[p] = v.r.ws;
  ra.m[p] = v.r.m;
  ra.w[p] = v.r.w;
  ra.age[p] = v.r.age;
  ra.idx[p] = v.r.idx;
}

}  // namespace

// Launch K6 on `stream`; returns cudaGetLastError() of the launch.  The
// arguments up to `t0` are K1's (rt0_trace_forward); `res_in` holds the 15
// input grids (back, hist1, hist2; each ws, m, w, age, light_index) and
// `res_out` the 7 outputs (light_pos, light_color, ws, m, w, age,
// light_index), all device pointers; `taps` (host memory) the 8 spatial
// taps' (row, column) offsets.
extern "C" int rt0_restir_forward(const float *table, const int32_t *mesh, const int32_t *mat,
                                  int n_mesh, const int32_t *lights, int n_lights, const float *ro,
                                  const float *rd, const int64_t *pix, float *out, long long n_pix,
                                  unsigned pass_idx, unsigned sample_idx, int max_bounces,
                                  int max_diff, int max_spec, int max_scatter, float eps,
                                  float inf, int sample_lights, int use_mis, int use_sky,
                                  const float *cubemap, int cube_h, int cube_w, int use_cubemap,
                                  int use_biased, const int32_t *tex, const int32_t *blend,
                                  const float *images, int img_h, int img_w, const float *noise,
                                  int noise_n, int use_tex, const int32_t *sdf, int n_analytic,
                                  int n_sdf, int steps, float fudge, float t0,
                                  const void *const *res_in, void *const *res_out,
                                  const int32_t *taps, int height, int width, int n_cand,
                                  int n_spatial, float eps2, float eps10, void *stream) {
  TraceArgs a = {table,   mesh,   mat,         lights,     n_mesh,      n_lights,
                 ro,      rd,     pix,         out,        n_pix,       pass_idx,
                 sample_idx, max_bounces, max_diff, max_spec, max_scatter, eps,
                 inf,     sample_lights, use_mis, use_sky, cubemap, cube_h, cube_w,
                 use_cubemap, use_biased, tex, blend, images, img_h, img_w, noise, noise_n,
                 use_tex, sdf, n_analytic, n_sdf, steps, fudge, t0};
  RestirArgs ra;
  ResIn *grids[3] = {&ra.back, &ra.hist[0], &ra.hist[1]};
  for (int g = 0; g < 3; ++g) {
    grids[g]->ws = static_cast<const float *>(res_in[5 * g]);
    grids[g]->m = static_cast<const float *>(res_in[5 * g + 1]);
    grids[g]->w = static_cast<const float *>(res_in[5 * g + 2]);
    grids[g]->age = static_cast<const float *>(res_in[5 * g + 3]);
    grids[g]->idx = static_cast<const int32_t *>(res_in[5 * g + 4]);
  }
  ra.pos = static_cast<float *>(res_out[0]);
  ra.col = static_cast<float *>(res_out[1]);
  ra.ws = static_cast<float *>(res_out[2]);
  ra.m = static_cast<float *>(res_out[3]);
  ra.w = static_cast<float *>(res_out[4]);
  ra.age = static_cast<float *>(res_out[5]);
  ra.idx = static_cast<int32_t *>(res_out[6]);
  for (int k = 0; k < 16; ++k) ra.taps[k] = taps[k];
  ra.height = height;
  ra.width = width;
  ra.n_cand = n_cand;
  ra.n_spatial = n_spatial;
  ra.eps2 = eps2;
  ra.eps10 = eps10;
  if (n_pix <= 0) return 0;
  const size_t smem = path_smem_bytes(n_mesh, n_lights, n_sdf) + sizeof(float) * NSLOT * n_lights;
  const unsigned blocks = (unsigned)((n_pix + THREADS - 1) / THREADS);
  restir_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a, ra);
  return (int)cudaGetLastError();
}
