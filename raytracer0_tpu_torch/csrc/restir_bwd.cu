// restir_bwd.cu — K7, the adjoint of the fused ReSTIR kernel K6, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// raytracer0_tpu/ops/megakernel.py::_fused_restir_bwd_kernel_body (launched
// by `_fused_restir_backward`, paired with K6 by the custom_vjp
// `_fused_restir_call`), and computes the same outputs as its per-slot twin
// `_fused_restir_bwd_slotted_kernel_body` (K8).  Given K6's inputs, the
// cotangent ct f32[n_pix, 3] of its radiance and the cotangents of its new
// reservoirs' float fields (weight_sum, m, w, age) it returns d_table
// f32[n_mesh, 36], d_ro and d_rd f32[n_pix, 3], and the cotangents of the
// ring's m, w and age: per history level at the pixel itself, and per
// spatial tap, which a second kernel gathers into the back grid.  These are
// the gradients torch.autograd gives through the plain version
// (raytracer0_tpu_torch/ops/restir.py::render_sample).  The Pallas kernels
// run jax.vjp inside the kernel; CUDA has no autodiff, so each step's
// adjoint is written out by hand (here and in adjoint.cuh).
//
// Two copies, each a template instance of restir_bwd_kernel:
//  * the ROUND_BOX copy (kAll = false): SDF rows of the ROUND_BOX shape, no
//    blended texture, the 14 columns 0:14; its code is the code K7 had
//    before the other copy came.
//  * the whole-SDF copy (kAll = true): every SDF shape through
//    adjoint.cuh::sdf_map_all_bwd (a Mandelbulb lane that is done skips
//    its dead iterations, mandelbulb_bwd), the texel blended into a hit's
//    color and emission (blend_bwd, texel_bwd: to the texture columns and,
//    through the texel, to the hit point), K6v's whole-SDF vertex
//    (RestirVertexT<false, true>, whose shadow rays march every shape),
//    and the scene's columns (restir_kernel.bwd_columns: 0:14, and the aux
//    and texture columns K2's wide copy keeps), mapped to accumulators in
//    shared memory.  Its forward sweep stashes each slot's hit, so its
//    reverse sweep marches no slot's ray again.
// The whole-SDF copy is a library of its own (restir_bwd_sdf.cu: this file
// with RT0_K7_WHOLE_SDF set), so that nvcc compiles it beside the
// ROUND_BOX copy's library; each library launches its own copy, and the
// caller picks the library (restir_kernel.bwd_copy).
//
// Scheme: a per-slot stash, one thread per pixel.
//  * forward sweep: run K6's bounce loop (path.cuh::trace_path) without the
//    accumulator and without the reservoir vertex (neither changes the
//    carry) and stash the carry entering every slot the path runs: o, d,
//    mask, prev_nl and the `specular` flag, 13 floats; note the path's last
//    diffuse vertex, whose reservoir K6 returns.  A slot may be diffuse,
//    specular (mirror, the reflection of glass or coat) or transmitting, so
//    the stash holds every slot up to max_bounces.
//  * reverse sweep: newest slot first, replay the slot from its stash (the
//    counter RNG replays every draw) and run its adjoint; at a diffuse vertex
//    replay the reservoir vertex (restir.cuh, the code K6 runs) with a tape
//    of its decisions and run its adjoint backwards through finalize and
//    shading, the spatial and temporal combines and the candidates.  The
//    output reservoir's cotangent enters at the last diffuse vertex alone.
// Discrete decisions (selections, validity, visibility, the shadow rays'
// hits, inside, Fresnel and Schlick choices, cutoff and caps) carry no
// gradient, as torch.where gives in the plain version.  The emission of a
// glossy surface bends its reflection detached, as in the plain version.
// The reservoir pipeline's max, min and clip split the gradient at a tie,
// as jnp.maximum does and the plain version's `_max`/`_min`/`_clip` do
// (W = 0, M = 40 and age = 30 are common in the ring); the bounce loop's
// clamps pass it whole, as K2's do.
//
// Light data: K6 reads a light's position and color·emission from the slot
// table by index, where the plain version carries them in the ring.  Their
// cotangents therefore go to the table rows of the light meshes, which over
// a chain of passes from an empty ring with one scene is the plain gradient.
//
// Deterministic reductions: scene cotangents (table columns 0:14: pos,
// joker, color, emission, ior; more in the whole-SDF copy) are summed per
// thread in shared memory, per block in thread order and across blocks in
// block order, as K2 does; the
// tap cotangents are written per pixel and tap and gathered per back-grid
// cell in tap order, without atomics.  Two runs give the same bits.
//
// What bounds it: like K6, instruction latency and divergence.  Per pixel it
// replays every slot twice (forward and reverse sweep), each diffuse vertex's
// reservoir pipeline and its two shadow rays once more, and runs an adjoint
// about twice their arithmetic; the stash and the vertex tape live in local
// memory.

#include <cassert>

#include "adjoint.cuh"
#include "restir.cuh"

// 1 in restir_bwd_sdf.cu: this library holds the whole-SDF copy alone
#ifndef RT0_K7_WHOLE_SDF
#define RT0_K7_WHOLE_SDF 0
#endif

namespace {

constexpr int MAX_SLOTS = 16;  // stash depth; the wrapper checks the bound
constexpr int ST = 13;         // stashed floats per slot: o, d, mask, prev_nl, specular
constexpr int ST_ALL = ST + 2; // the whole-SDF copy's: also the hit's t and mesh
constexpr int MAX_CAND = 32;   // candidates the tape holds; the wrapper checks the bound
constexpr int MAX_COMB = 2 + MAX_SPATIAL;
constexpr int BWD_THREADS = 128;
constexpr int RED_THREADS = 64;
constexpr int GATHER_THREADS = 256;
constexpr int NG = 14;  // scene-table columns 0:14 with a cotangent
constexpr unsigned long long NG_COLS = (1ull << NG) - 1ull;  // the same, as a column mask
constexpr int NF = 3;   // ring fields with a cotangent: m, w, age

struct Bwd7Args {
  const float *ct;         // [n_pix, 3] cotangent of the radiance
  const float *ct_res[4];  // [n_pix] cotangents of the new ws, m, w, age
  float *d_ro, *d_rd;      // [n_pix, 3]
  float *partials;         // [n_blocks, n_mesh, NG]
  float *dtap;             // [MAX_SPATIAL, NF, H * W] per spatial tap, by grid cell
  float *dhist;            // [2, NF, H * W] per history level, by grid cell
  unsigned long long cols; // the scene-table columns kept (NG_COLS in the ROUND_BOX copy)
  int ng;                  // their count
};

// This thread's column of the block's cotangent accumulators; `col` is a
// scene-table column below NG (the ROUND_BOX copy).
struct GradAcc {
  float *g;     // entry e at g[e * stride]
  int stride;   // blockDim.x
  __device__ __forceinline__ void add(int mesh, int col, float v) const {
    g[(mesh * NG + col) * stride] += v;
  }
  __device__ __forceinline__ void add3(int mesh, int col, V3 v) const {
    add(mesh, col, v.x);
    add(mesh, col + 1, v.y);
    add(mesh, col + 2, v.z);
  }
};

// This thread's column of the block's cotangent accumulators in the
// whole-SDF copy: `ng` per mesh, the scene's columns (restir_kernel.
// bwd_columns), `map` from table column to accumulator in shared memory.
struct ColAcc {
  float *g;        // entry e at g[e * stride]
  int stride;      // blockDim.x
  const int *map;  // [NCOLS]: the accumulator of each column kept, else -1
  int ng;
  __device__ __forceinline__ void add(int mesh, int col, float v) const {
#ifndef __CUDA_ARCH__
    assert(map[col] >= 0);  // the host build checks that every add has its column
#endif
    g[(mesh * ng + map[col]) * stride] += v;
  }
  __device__ __forceinline__ void add3(int mesh, int col, V3 v) const {
    add(mesh, col, v.x);
    add(mesh, col + 1, v.y);
    add(mesh, col + 2, v.z);
  }
};

// The columns of `cols` below `col`: the accumulator of column `col` when
// it is in the mask.
__host__ __device__ inline int cols_below(unsigned long long cols, int col) {
  int k = 0;
  for (int j = 0; j < col; ++j) k += (int)((cols >> j) & 1ull);
  return k;
}

// The decisions and values of one run of the reservoir vertex that its
// adjoint needs (restir.cuh's tape hooks).
struct VertexTape {
  uint32_t take, ovf;        // per candidate: taken, M overflowed
  int n;                     // combines recorded: 2 temporal, then the spatial taps
  uint32_t ok, sel;          // per combine: merged, selected
  Res q[MAX_COMB];           // the source of each combine
  float ws0[MAX_COMB];       // the target's weight_sum before it
  float m_new[MAX_COMB];     // M after the merge, before the cap of 40
  bool over;                 // the post-combine clamp ran
  float m_over;              // M before it
  Res pre;                   // the reservoir before finalize
  bool visible;
  int hidx;                  // the shading ray's hit
  bool lit, keep;

  __device__ __forceinline__ void candidate(int i, bool tk, bool ov) {
    take |= (tk ? 1u : 0u) << i;
    ovf |= (ov ? 1u : 0u) << i;
  }
  __device__ __forceinline__ void combine(const Res &src, bool merged, float ws_before,
                                          float m_merged, bool selected) {
    q[n] = src;
    ws0[n] = ws_before;
    m_new[n] = m_merged;
    ok |= (merged ? 1u : 0u) << n;
    sel |= (selected ? 1u : 0u) << n;
    ++n;
  }
  __device__ __forceinline__ void post_clamp(bool o, float m) {
    over = o;
    m_over = m;
  }
  __device__ __forceinline__ void finalize(const Res &r, bool vis) {
    pre = r;
    visible = vis;
  }
  __device__ __forceinline__ void shade(int h, bool l, bool k) {
    hidx = h;
    lit = l;
    keep = k;
  }
};

// Cotangents of the vertex's shading inputs.
struct VertexGrad {
  V3 x, nl;
  float brdf;
};

constexpr float LUM_R = 0.2126f, LUM_G = 0.7152f, LUM_B = 0.0722f;

// restir.evaluate_target of slot l at (x, nl) for its cotangent g.
template <class V, class Acc>
__device__ void target_bwd(const V &v, int l, V3 x, V3 nl, float brdf, float g, VertexGrad &vg,
                           const Acc &G) {
  if (!v.in_range(l) || g == 0.0f) return;
  const int li = v.s.lights[l] < 0 ? 0 : v.s.lights[l];
  const V3 lv = v.slot_pos(l) - x;
  const float d2 = dot(lv, lv);
  const V3 ln = normalize(lv);
  const float cos_t = fmaxf(dot(nl, ln), 0.0f);
  const V3 lc = v.slot_col(l);
  const float lum = lc.x * LUM_R + lc.y * LUM_G + lc.z * LUM_B;
  if (!(d2 >= 1e-6f && cos_t > 0.0f && lum > 0.0f)) return;
  const float dd = fmaxf(d2, 1e-4f);
  const float lb = lum * brdf;
  const float num = lb * cos_t;
  const float g_num = g / dd;
  const float g_d2 = -g * num / (dd * dd) * dmax(d2, 1e-4f);
  const float g_lb = g_num * cos_t;
  const float g_cos = g_num * lb;
  const float g_lum = g_lb * brdf;
  vg.brdf += g_lb * lum;
  vg.nl = vg.nl + ln * g_cos;
  const V3 g_lv = normalize_bwd(lv, nl * g_cos) + lv * (2.0f * g_d2);
  G.add3(li, C_PX, g_lv);
  vg.x = vg.x - g_lv;
  const V3 g_lc = {g_lum * LUM_R, g_lum * LUM_G, g_lum * LUM_B};
  G.add3(li, C_CR, g_lc * v.s.e(li));
  G.add3(li, C_ER, g_lc * v.s.c(li));
}

// RestirVertex::brdf_weight of mesh mi for its cotangent g.
template <class Acc>
__device__ void brdf_bwd(const SceneSmem &s, int mi, float g, const Acc &G) {
  if (g == 0.0f) return;
  const V3 mc = s.c(mi);
  const float ior = s.ior(mi);
  const float nt = fabsf(ior);
  const int mt = s.mat[mi];
  const float sl = mc.x * LUM_R + mc.y * LUM_G + mc.z * LUM_B;
  const float den = fmaxf(nt + 1.0f, 1e-6f);
  const float nnt = (nt - 1.0f) / den;
  const float r0 = nnt * nnt;
  const float is_refr = (mt == MAT_REFR_FRESNEL || mt == MAT_REFR_SCHLICK) ? 1.0f : 0.0f;
  const float is_coat = mt == MAT_COAT ? 1.0f : 0.0f;
  const float g_in = g * ONE_OVER_PI;
  const float g_base = g_in * (1.0f - is_coat);
  const float g_coat = g_in * is_coat;  // of (1 - r0) * surface_lum
  const float g_sl = g_coat * (1.0f - r0) + g_base * (1.0f - is_refr);
  const float g_r0 = -g_coat * sl + g_base * is_refr;
  const float g_nnt = 2.0f * nnt * g_r0;
  const float g_nt = g_nnt / den - g_nnt * (nt - 1.0f) / (den * den) * dmax(nt + 1.0f, 1e-6f);
  G.add(mi, C_IOR, g_nt * signf(ior));
  G.add3(mi, C_CR, V3{LUM_R, LUM_G, LUM_B} * g_sl);
}

// Combine k of the tape (restir.combine_reservoirs) backwards: g_ws, g_m
// and g_age enter as the cotangents of the reservoir after it and leave as
// those before it; g_q gets the source's m, w and age.
template <class V, class Acc>
__device__ void combine_bwd(const V &v, const VertexTape &tp, int k, V3 x, V3 nl, float brdf,
                            float &g_ws, float &g_m, float &g_age, float g_q[NF], VertexGrad &vg,
                            const Acc &G) {
  const Res &q = tp.q[k];
  const bool ok = (tp.ok >> k) & 1u, select = (tp.sel >> k) & 1u;
  const float m_new = tp.m_new[k];
  const float scale = m_new > 40.0f ? 40.0f / fmaxf(m_new, 1e-6f) : 1.0f;
  const float tw = ok ? v.target(q.idx, x, nl, brdf) : 0.0f;
  const float qa = fmaxf(q.w, 0.0f), qb = fmaxf(q.m, 1.0f);
  const float raw = tw * qa * qb;
  const float contribution = fminf(fmaxf(raw, 0.0f), 200.0f);
  const float wsum = tp.ws0[k] + (ok ? contribution : 0.0f);
  const float g_wsum = g_ws * scale;
  const float g_scale = g_ws * wsum;
  float g_mn = g_m * dmin(m_new, 40.0f);
  if (m_new > 40.0f) g_mn += -g_scale * 40.0f / (m_new * m_new);
  g_q[0] = g_q[1] = g_q[2] = 0.0f;
  if (select) {
    g_q[2] = g_age * dmin(q.age + 0.25f, MAX_AGE);
    g_age = 0.0f;
  }
  if (ok) {
    g_q[0] = g_mn;
    const float g_raw = g_wsum * dclip(raw, 0.0f, 200.0f);
    const float g_ta = g_raw * qb;  // of tw * qa
    g_q[1] = g_ta * tw * dmax(q.w, 0.0f);
    g_q[0] += g_raw * (tw * qa) * dmax(q.m, 1.0f);
    target_bwd(v, q.idx, x, nl, brdf, g_ta * qa, vg, G);
  }
  g_ws = g_wsum;
  g_m = g_mn;
}

// The reservoir vertex at (x, nl) of mesh mi backwards.  g_out: the
// cotangent of its direct light; gr: of its reservoir's ws, m, w, age (zero
// unless it is the path's last diffuse vertex).  Adds the cotangents of x,
// nl, the scene, the spatial taps (g_taps) and the history levels (g_hist);
// returns the direct light.
template <class V, class Acc>
__device__ V3 vertex_bwd(V &v, V3 x, V3 nl, int mi, uint32_t h_depth, V3 g_out, const float gr[4],
                         V3 &g_x, V3 &g_nl, float *g_taps, float *g_hist, const Acc &G) {
  VertexTape tp;
  tp.take = tp.ovf = tp.ok = tp.sel = 0u;
  tp.n = 0;
  const V3 out = v.run(x, nl, mi, h_depth, tp);
  const SceneSmem &s = v.s;
  const float brdf = v.brdf_weight(mi);
  VertexGrad vg = {zero3(), zero3(), 0.0f};
  const Res r = v.r;  // after finalize
  float g_ws = gr[0], g_m = gr[1], g_w = gr[2];

  // ---- shade: out = light * clamp(w, 0, 8) * (M > 30 ? sqrt(30 / M) : 1) ----
  if (tp.keep) {
    const float e1 = fminf(fmaxf(r.w, 0.0f), 8.0f);
    const float q30 = 30.0f / fmaxf(r.m, 1e-6f);
    const float f2 = r.m > 30.0f ? safe_sqrt(q30) : 1.0f;
    const float eff = e1 * f2;
    float g_eff = 0.0f;
    if (tp.lit) {
      const int slot = v.shade_slot();
      const int li = s.lights[slot] < 0 ? 0 : s.lights[slot];
      float u1, u2;
      v.shade_draws(h_depth, u1, u2);
      const V3 light =
          cone_light_bwd(s, li, tp.hidx, x, nl, u1, u2, g_out * eff, vg.x, vg.nl, G);
      g_eff = dot(g_out, light);
    }
    g_w += g_eff * f2 * dclip(r.w, 0.0f, 8.0f);
    if (r.m > 30.0f && q30 > 0.0f)
      g_m += (g_eff * e1 / (2.0f * f2)) * (-30.0f / (r.m * r.m));
  }

  // ---- finalize, and the age clamp after it ----
  const Res &pre = tp.pre;
  float g_age = gr[3] * dmin(pre.age, MAX_AGE);
  const float p_hat = v.target(pre.idx, x, nl, brdf);
  if (pre.ws > 0.0f && pre.m > 0.0f && p_hat > 0.0f && tp.visible && g_w != 0.0f) {
    const float m_cl = fminf(fmaxf(pre.m, 1.0f), 40.0f);
    const float den_raw = p_hat * m_cl;
    const float den = fmaxf(den_raw, 1e-12f);
    const float raw_w = pre.ws / den;
    const float an = pre.age / MAX_AGE;
    const float norm_age = fminf(fmaxf(an, 0.0f), 1.0f);
    const float b1 = pre.age > 0.0f ? 0.85f + 0.15f * (1.0f - norm_age * 0.3f) : 1.0f;
    const float b2 = m_cl > 16.0f ? safe_sqrt(16.0f / m_cl) : 1.0f;
    const float bw = b1 * b2 * raw_w;
    if (isfinite(bw)) {
      const float g_bw = g_w * dclip(bw, 0.0f, 12.0f);
      const float g_bias = g_bw * raw_w, g_raw = g_bw * (b1 * b2);
      g_ws += g_raw / den;
      const float g_den = -g_raw * pre.ws / (den * den);
      const float g_dr = g_den * dmax(den_raw, 1e-12f);
      const float g_phat = g_dr * m_cl;
      float g_mcl = g_dr * p_hat;
      const float g_b1 = g_bias * b2, g_b2 = g_bias * b1;
      if (m_cl > 16.0f) g_mcl += (g_b2 / (2.0f * b2)) * (-16.0f / (m_cl * m_cl));
      if (pre.age > 0.0f) g_age += (-0.3f * (g_b1 * 0.15f)) * dclip(an, 0.0f, 1.0f) / MAX_AGE;
      g_m += g_mcl * dclip(pre.m, 1.0f, 40.0f);
      target_bwd(v, pre.idx, x, nl, brdf, g_phat, vg, G);
    }
  }

  // ---- spatial combines, newest first ----
  float g_q[NF];
  for (int k = tp.n - 1; k >= 2; --k) {
    combine_bwd(v, tp, k, x, nl, brdf, g_ws, g_m, g_age, g_q, vg, G);
    for (int f = 0; f < NF; ++f) g_taps[(k - 2) * NF + f] += g_q[f];
  }
  // ---- the post-combine clamp ----
  if (tp.over) {
    g_ws = g_ws * 0.9f;
    g_m = g_m * dmin(tp.m_over, 80.0f);
  }
  // ---- temporal combines: the source is the history, aged and faded ----
  for (int k = 1; k >= 0; --k) {
    combine_bwd(v, tp, k, x, nl, brdf, g_ws, g_m, g_age, g_q, vg, G);
    g_hist[k * NF] += g_q[0] * v.alpha(k);
    g_hist[k * NF + 1] += g_q[1];
    g_hist[k * NF + 2] += g_q[2];
  }
  // ---- candidates: weight_sum is the (decayed) sum of the target values ----
  for (int i = v.ra.n_cand - 1; i >= 0; --i) {
    if ((tp.ovf >> i) & 1u) g_ws = g_ws * 0.95f;
    if ((tp.take >> i) & 1u) {
      float r2;
      const int slot = v.candidate_slot(h_depth, i, r2);
      target_bwd(v, slot, x, nl, brdf, g_ws, vg, G);
    }
  }
  brdf_bwd(s, mi, vg.brdf, G);
  g_x = g_x + vg.x;
  g_nl = g_nl + vg.nl;
  return out;
}

// Adjoint of slot `depth` of K6's loop.  In: the stashed carry entering the
// slot and, in g_*, the cotangents of the carry leaving it (zero for the
// last slot); `gr` the cotangents of the output reservoir when this slot is
// the path's last diffuse vertex, else zeros.  Out: g_* hold the cotangents
// of the carry entering it; the scene's go into G, the ring's into g_taps
// and g_hist.  kAll (the whole-SDF copy): the hit (t, mesh) comes from the
// stash, an SDF hit is of any shape (adjoint.cuh::sdf_map_all_bwd), and
// the hit's color and emission blend its texel in (blend_bwd carries their
// cotangents to the texture columns and, through the texel, to the hit
// point), as K4's path_step<., true> renders them.
template <bool kAll, class V, class Acc>
__device__ void slot_bwd(V &v, const PathSmem &ps, int depth, uint32_t h_pix, const float *sk,
                         V3 ct, const float gr[4], V3 &g_o, V3 &g_d, V3 &g_mask, V3 &g_pnl,
                         float *g_taps, float *g_hist, const Acc &G) {
  const SceneSmem &s = v.s;
  const TraceArgs &a = v.a;
  const V3 o = {sk[0], sk[1], sk[2]}, d = {sk[3], sk[4], sk[5]};
  const V3 mask = {sk[6], sk[7], sk[8]}, prev_nl = {sk[9], sk[10], sk[11]};
  const bool specular = sk[12] != 0.0f;
  const V3 go_out = g_o, gd_out = g_d, gm_out = g_mask, gp_out = g_pnl;
  g_o = g_d = g_mask = g_pnl = zero3();

  float t;
  int idx;
  bool sdf_hit;
  if constexpr (kAll) {
    t = sk[ST];
    idx = (int)sk[ST + 1];
    sdf_hit = idx >= ps.sd.first;  // the SDF rows follow the analytic ones
  } else {
    sdf_hit = intersect_scene<true>(s, ps.sd, o, d, a.eps, a.inf, t, idx);
  }
  const float *lut = kAll ? a.noise : nullptr;  // a SNOWBALL's value noise
  const int lut_n = kAll ? a.noise_n : 0;

  // ---- miss: acc += mask * sky(d) ----
  if (!(t < a.inf)) {
    if ((specular || !a.sample_lights) && !a.use_cubemap && a.use_sky) {
      g_mask = ct * procedural_sky(d);
      g_d.y = sky_bwd(d, ct * mask);
    }
    return;
  }

  const V3 x = o + d * t;
  const V3 n = sdf_hit ? sdf_normal<kAll>(s, ps.sd, x, a.eps, lut, lut_n) : normal_at(s, idx, x);
  // the normal whose dominant axis picks a texel's planar UV: an SDF hit's
  // row's box normal, as in path_step (piecewise constant: no gradient)
  const V3 n_tex = kAll && sdf_hit ? normal_at(s, idx, x) : n;
  V3 c_raw, e_raw;
  if constexpr (kAll) {
    blended_color_emission(a, s, ps, idx, x, n_tex, c_raw, e_raw);
  } else {
    c_raw = s.c(idx);
    e_raw = s.e(idx);
  }
  const V3 c = vmax(c_raw, 0.001f), e = vmax(e_raw, 0.001f);
  const float inside = dot(d, n) > 0.0f ? -1.0f : 1.0f;
  const int mat = s.mat[idx];
  V3 g_x = zero3();

  if (mat == MAT_LIGHT) {
    // ---- emissive hit: acc += mask * c * e * mis_w ----
    const bool mis = a.use_mis && a.sample_lights && depth > 0 && !specular;
    float mis_w = 1.0f, l_pdf = 0.0f, b_pdf = 0.0f, b_cos = 0.0f;
    V3 light_dir = zero3();
    if (mis) {
      light_dir = normalize(x - o);
      l_pdf = s.mesh[idx] == MESH_SPHERE ? sphere_light_pdf(s.p(idx), s.j0(idx), o) : INV_FOUR_PI;
      b_cos = dot(light_dir, prev_nl);
      b_pdf = fmaxf(b_cos, 0.0f) * ONE_OVER_PI;
      mis_w = power_heuristic(b_pdf, l_pdf);
    }
    g_mask = ct * c * e * mis_w;
    if constexpr (kAll) {
      g_x = blend_bwd(a, s, ps, idx, x, n_tex, ct * mask * e * mis_w, ct * mask * c * mis_w, G);
    } else {
      G.add3(idx, C_CR, pass_ge(c_raw, 0.001f, ct * mask * e * mis_w));
      G.add3(idx, C_ER, pass_ge(e_raw, 0.001f, ct * mask * c * mis_w));
    }
    if (mis) {
      float g_b, g_l;
      power_heuristic_bwd(b_pdf, l_pdf, dot(ct, mask * c * e), g_b, g_l);
      if (b_cos >= 0.0f) {
        const float gc = g_b * ONE_OVER_PI;
        g_pnl = light_dir * gc;
        const V3 g_xo = normalize_bwd(x - o, prev_nl * gc);
        g_x = g_x + g_xo;
        g_o = g_o - g_xo;
      }
      if (s.mesh[idx] == MESH_SPHERE) {
        V3 g_lp, g_op;
        float g_r;
        sphere_light_pdf_bwd(s.p(idx), s.j0(idx), o, g_l, g_lp, g_r, g_op);
        G.add3(idx, C_PX, g_lp);
        G.add(idx, C_J0, g_r);
        g_o = g_o + g_op;
      }
    }
  } else if (mat == MAT_DIR_LIGHT) {
    return;  // the path ends without a contribution
  } else {
    // ---- a BSDF bounce: o', d' = bsdf_sample(...), mask' = mask mult,
    //      prev_nl' = nl, and at a diffuse vertex acc += direct * mask' ----
    const uint32_t h_depth = fold_step(h_pix, (uint32_t)depth, 3u);
    const uint32_t h_dir = fold_step(h_depth, S_BSDF_DIR, 4u);
    const float u1 = u01(h_dir), u2 = u01(pcg(h_dir));
    const V3 nl = n * inside;
    const Bounce b = bsdf_sample(s, idx, x, nl, d, c, e, inside, u1, u2,
                                 u01(fold_step(h_depth, S_BSDF_CHOICE, 4u)), a.eps, a.use_biased);
    const V3 mask_after = mask * b.mult;
    const bool transmit = b.scat != 0;
    const bool diffuse = !b.specular;

    g_x = go_out;
    V3 g_nl = gp_out + go_out * (transmit ? -a.eps : a.eps);
    V3 g_ma = gm_out;
    // K7's class samples cosine-weighted (restir_kernel.unsupported_restir_bwd)
    bounce_dir_bwd(s, idx, b, d, nl, e, inside, u1, u2, true, gd_out, g_d, g_nl, G);
    if (diffuse && a.sample_lights) {
      const V3 out = vertex_bwd(v, x, nl, idx, h_depth, ct * mask_after, gr, g_x, g_nl, g_taps,
                                g_hist, G);
      g_ma = g_ma + ct * out;
    }
    g_mask = g_ma * b.mult;
    const bool attenuates = mat == MAT_DIFF || mat == MAT_SPEC || transmit ||
                            (mat == MAT_COAT && diffuse);
    if constexpr (kAll) {
      // the emission bends the bounce detached: no cotangent reaches it
      g_x = g_x + blend_bwd(a, s, ps, idx, x, n_tex, attenuates ? g_ma * mask : zero3(), zero3(), G);
    } else {
      if (attenuates) G.add3(idx, C_CR, pass_ge(c_raw, 0.001f, g_ma * mask));
    }
    const V3 g_n = g_nl * inside;
    if (sdf_hit)
      g_x = g_x + sdf_normal_bwd<kAll, kAll>(s, ps.sd, x, a.eps, g_n, G, lut, lut_n);
    else
      normal_bwd(s, idx, x, g_n, g_x, G);
  }

  // ---- x = o + d t(o, d, scene) ----
  g_o = g_o + g_x;
  g_d = g_d + g_x * t;
  const float g_t = dot(g_x, d);
  if (sdf_hit)
    sdf_t_bwd<kAll, kAll>(s, ps.sd, o, d, t, a.eps, v.ra.eps2, g_t, g_o, g_d, G, lut, lut_n);
  else
    isect_bwd(s, idx, o, d, a.eps, g_t, g_o, g_d, G);
}

// Dynamic shared memory of one K7 block: K6's (the scene, texture codes,
// SDF shapes, light slots), then `threads` columns of `ng` cotangent
// accumulators per mesh (NG in the ROUND_BOX copy; the whole-SDF copy,
// `all`, keeps the scene's columns and their map, NCOLS ints, before them).
// ops/restir_kernel.py computes the same.
__host__ __device__ inline size_t bwd_smem_bytes(int n_mesh, int n_lights, int n_sdf, int threads,
                                                 bool all = false, int ng = NG) {
  return path_smem_bytes(n_mesh, n_lights, n_sdf) + sizeof(float) * NSLOT * n_lights +
         (all ? sizeof(int) * NCOLS : 0) + sizeof(float) * n_mesh * ng * threads;
}

// kAll: the whole-SDF copy (every SDF shape, textures blended into any row,
// the scene's columns; slot_bwd), else the ROUND_BOX copy.
template <bool kAll>
__global__ void __launch_bounds__(BWD_THREADS) restir_bwd_kernel(TraceArgs a, RestirArgs ra,
                                                                 Bwd7Args b) {
  extern __shared__ float smem[];
  float *slots = smem + path_smem_bytes(a.n_mesh, a.n_lights, a.n_sdf) / sizeof(float);
  float *gsm = slots + NSLOT * a.n_lights;
  int *map = nullptr;
  if constexpr (kAll) {
    map = reinterpret_cast<int *>(gsm);
    gsm += NCOLS;
    for (int c = threadIdx.x; c < NCOLS; c += blockDim.x)
      map[c] = ((b.cols >> c) & 1ull) ? cols_below(b.cols, c) : -1;
  }
  load_slots(a, slots);
  SceneSmem s;
  const PathSmem ps = load_path(a, smem, s);  // synchronises the block
  const int ng = kAll ? b.ng : NG;
  const int n_g = a.n_mesh * ng;
  for (int e = 0; e < n_g; ++e) gsm[e * blockDim.x + threadIdx.x] = 0.0f;
  using Acc = std::conditional_t<kAll, ColAcc, GradAcc>;
  Acc G;
  if constexpr (kAll)
    G = {gsm + threadIdx.x, (int)blockDim.x, map, ng};
  else
    G = {gsm + threadIdx.x, (int)blockDim.x};
  // the value-noise LUT of a SNOWBALL, for the whole-SDF copy's scene map
  const float *lut = kAll ? a.noise : nullptr;
  const int lut_n = kAll ? a.noise_n : 0;

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < a.n_pix) {  // ragged edge: idle threads still join the block sum
    const uint32_t id = (uint32_t)a.pix[p];
    const int row = (int)(id / (uint32_t)ra.width), col = (int)(id % (uint32_t)ra.width);
    const long long own = (long long)row * ra.width + col;
    const long long cells = (long long)ra.height * ra.width;
    RestirVertexT<false, kAll> v = {s, ps.sd, a, ra, slots, row, col, {0.0f, 0.0f, 0.0f, 0.0f, -1}};
    V3 o = {a.ro[3 * p], a.ro[3 * p + 1], a.ro[3 * p + 2]};
    V3 d = {a.rd[3 * p], a.rd[3 * p + 1], a.rd[3 * p + 2]};
    const uint32_t h_pix = pixel_hash(a, p);

    // ---- forward sweep: K6's carry updates, stashing each slot's input
    //      (and, in the whole-SDF copy, its hit) ----
    constexpr int STK = kAll ? ST_ALL : ST;
    float st[MAX_SLOTS * STK];
    V3 mask = {1.0f, 1.0f, 1.0f};
    V3 prev_nl = {0.0f, 1.0f, 0.0f};
    bool specular = true;
    int ndif = 0, nspec = 0, nscat = 0, n_run = 0, last_diff = -1;
    for (int depth = 0; depth < a.max_bounces && depth < MAX_SLOTS; ++depth) {
      float *sk = st + depth * STK;
      sk[0] = o.x, sk[1] = o.y, sk[2] = o.z, sk[3] = d.x, sk[4] = d.y, sk[5] = d.z;
      sk[6] = mask.x, sk[7] = mask.y, sk[8] = mask.z;
      sk[9] = prev_nl.x, sk[10] = prev_nl.y, sk[11] = prev_nl.z;
      sk[12] = specular ? 1.0f : 0.0f;
      n_run = depth + 1;

      float tmin;
      int idx;
      const bool sdf_hit =
          intersect_scene<true, kAll>(s, ps.sd, o, d, a.eps, a.inf, tmin, idx, lut, lut_n);
      if constexpr (kAll) {
        sk[ST] = tmin;
        sk[ST + 1] = (float)idx;
      }
      if (!(tmin < a.inf)) break;
      const V3 x = o + d * tmin;
      const V3 n = sdf_hit ? sdf_normal<kAll>(s, ps.sd, x, a.eps, lut, lut_n) : normal_at(s, idx, x);
      V3 c, e;
      if constexpr (kAll) {
        blended_color_emission(a, s, ps, idx, x, sdf_hit ? normal_at(s, idx, x) : n, c, e);
        c = vmax(c, 0.001f);
        e = vmax(e, 0.001f);
      } else {
        c = vmax(s.c(idx), 0.001f);
        e = vmax(s.e(idx), 0.001f);
      }
      const float inside = dot(d, n) > 0.0f ? -1.0f : 1.0f;
      const int mat = s.mat[idx];
      if (mat == MAT_LIGHT || mat == MAT_DIR_LIGHT) break;
      const uint32_t h_depth = fold_step(h_pix, (uint32_t)depth, 3u);
      const uint32_t h_dir = fold_step(h_depth, S_BSDF_DIR, 4u);
      const V3 nl = n * inside;
      const Bounce bb = bsdf_sample(s, idx, x, nl, d, c, e, inside, u01(h_dir), u01(pcg(h_dir)),
                                    u01(fold_step(h_depth, S_BSDF_CHOICE, 4u)), a.eps,
                                    a.use_biased);
      if (!bb.specular && a.sample_lights) last_diff = depth;
      o = bb.o;
      d = bb.d;
      mask = mask * bb.mult;
      specular = bb.specular;
      prev_nl = nl;
      ndif += bb.dif;
      nspec += bb.spec;
      nscat += bb.scat;
      if (fmaxf(fmaxf(mask.x, mask.y), mask.z) < 0.01f || ndif >= a.max_diff ||
          nspec >= a.max_spec || nscat >= a.max_scatter)
        break;
    }

    // ---- reverse sweep: newest slot first ----
    const V3 ct = {b.ct[3 * p], b.ct[3 * p + 1], b.ct[3 * p + 2]};
    const float gr_last[4] = {b.ct_res[0][p], b.ct_res[1][p], b.ct_res[2][p], b.ct_res[3][p]};
    const float gr_none[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float g_taps[MAX_SPATIAL * NF], g_hist[2 * NF];
    for (int k = 0; k < MAX_SPATIAL * NF; ++k) g_taps[k] = 0.0f;
    for (int k = 0; k < 2 * NF; ++k) g_hist[k] = 0.0f;
    V3 g_o = zero3(), g_d = zero3(), g_mask = zero3(), g_pnl = zero3();
    for (int k = n_run - 1; k >= 0; --k)
      slot_bwd<kAll>(v, ps, k, h_pix, st + k * STK, ct, k == last_diff ? gr_last : gr_none, g_o,
                     g_d, g_mask, g_pnl, g_taps, g_hist, G);
    b.d_ro[3 * p] = g_o.x;
    b.d_ro[3 * p + 1] = g_o.y;
    b.d_ro[3 * p + 2] = g_o.z;
    b.d_rd[3 * p] = g_d.x;
    b.d_rd[3 * p + 1] = g_d.y;
    b.d_rd[3 * p + 2] = g_d.z;
    for (int k = 0; k < MAX_SPATIAL * NF; ++k) b.dtap[k * cells + own] = g_taps[k];
    for (int k = 0; k < 2 * NF; ++k) b.dhist[k * cells + own] = g_hist[k];
  }

  // ---- this block's partial of d_table, summed in thread order ----
  __syncthreads();
  for (int e = threadIdx.x; e < n_g; e += blockDim.x) {
    float sum = 0.0f;
    for (int t = 0; t < (int)blockDim.x; ++t) sum += gsm[e * blockDim.x + t];
    b.partials[(size_t)blockIdx.x * n_g + e] = sum;
  }
}

// The back grid's cotangents: cell (r, c) gathers tap i of the pixel
// (r - dy_i, c - dx_i), where that pixel lies in the image, in tap order.
__global__ void __launch_bounds__(GATHER_THREADS)
    tap_gather_kernel(RestirArgs ra, const float *dtap, float *dback) {
  const long long cells = (long long)ra.height * ra.width;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= cells) return;
  const int r = (int)(p / ra.width), c = (int)(p % ra.width);
  for (int f = 0; f < NF; ++f) {
    float sum = 0.0f;
    for (int i = 0; i < ra.n_spatial; ++i) {
      const int sr = r - ra.taps[2 * i], sc = c - ra.taps[2 * i + 1];
      if (sr >= 0 && sr < ra.height && sc >= 0 && sc < ra.width)
        sum += dtap[(i * NF + f) * cells + (long long)sr * ra.width + sc];
    }
    dback[f * cells + p] = sum;
  }
}

// d_table[mesh, col] for the `ng` columns of `cols` (NG_COLS in the
// ROUND_BOX copy) = sum over blocks of the partials, in a fixed order: one
// block per (mesh, column kept), a strided sum per thread, then a fixed
// tree.  The other columns stay as the caller zeroed them.
__global__ void __launch_bounds__(RED_THREADS)
    restir_reduce_kernel(const float *partials, int n_blocks, int n_mesh, unsigned long long cols,
                         int ng, float *d_table) {
  __shared__ float red[RED_THREADS];
  const int mesh = blockIdx.x / ng, k = blockIdx.x % ng;
  float sum = 0.0f;
  for (int blk = threadIdx.x; blk < n_blocks; blk += RED_THREADS)
    sum += partials[(size_t)blk * n_mesh * ng + blockIdx.x];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int col = 0;  // the k-th column of the mask
    while (!((cols >> col) & 1ull) || cols_below(cols, col) != k) ++col;
    d_table[mesh * NCOLS + col] = red[0];
  }
}

// The copy of K7 this library holds: the whole-SDF copy where
// RT0_K7_WHOLE_SDF is set, else the ROUND_BOX copy.
constexpr bool kWholeSdf = RT0_K7_WHOLE_SDF != 0;

}  // namespace

// Launch K7 on `stream`: the adjoint kernel, the gather of the tap
// cotangents into the back grid, and the reduction of the per-block
// partials [ceil(n_pix / threads), n_mesh, ng] into d_table's columns
// `cols` (ng of them; the caller zeroes the others).  The arguments up to
// `eps10` are K6v's (rt0_restir_vertex; `out` unused); `ct_res` holds the
// four [n_pix] cotangents of the new ws, m, w and age; dtap [8, 3, H * W],
// dhist [2, 3, H * W] and dback [3, H * W] receive the cotangents of the
// ring's m, w and age.  This library's copy runs (kWholeSdf): the
// whole-SDF copy with the columns restir_kernel.bwd_columns lists (NG_COLS
// and more), or the ROUND_BOX copy with `cols` NG_COLS.  Returns the first
// CUDA error of the launches, or 0.
extern "C" int rt0_restir_backward(
    const float *table, const int32_t *mesh, const int32_t *mat, int n_mesh,
    const int32_t *lights, int n_lights, const float *ro, const float *rd, const int64_t *pix,
    float *out, long long n_pix, unsigned pass_idx, unsigned sample_idx, int max_bounces,
    int max_diff, int max_spec, int max_scatter, float eps, float inf, int sample_lights,
    int use_mis, int use_sky, const float *cubemap, int cube_h, int cube_w, int use_cubemap,
    int use_biased, const int32_t *tex, const int32_t *blend, const float *images, int img_h,
    int img_w, const float *noise, int noise_n, int use_tex, const int32_t *sdf, int n_analytic,
    int n_sdf, int steps, float fudge, float t0, const void *const *res_in, const int32_t *taps,
    int height, int width, int n_cand, int n_spatial, float eps2, float eps10, int animated,
    const float *ct,
    const void *const *ct_res, float *d_ro, float *d_rd, float *partials, float *d_table,
    float *dtap, float *dhist, float *dback, unsigned long long cols, int threads, void *stream) {
  const int ng = cols_below(cols, NCOLS);
  if (threads <= 0 || threads > BWD_THREADS || n_mesh <= 0 || n_cand > MAX_CAND ||
      n_spatial > MAX_SPATIAL || (cols >> NCOLS) != 0ull || (cols & NG_COLS) != NG_COLS ||
      (!kWholeSdf && cols != NG_COLS))
    return (int)cudaErrorInvalidValue;
  void (*kern)(TraceArgs, RestirArgs, Bwd7Args) = restir_bwd_kernel<kWholeSdf>;
  TraceArgs a = {table,   mesh,   mat,         lights,     n_mesh,      n_lights,
                 ro,      rd,     pix,         out,        n_pix,       pass_idx,
                 sample_idx, max_bounces, max_diff, max_spec, max_scatter, eps,
                 inf,     sample_lights, use_mis, use_sky, cubemap, cube_h, cube_w,
                 use_cubemap, use_biased, tex, blend, images, img_h, img_w, noise, noise_n,
                 use_tex, sdf, n_analytic, n_sdf, steps, fudge, t0};
  const RestirArgs ra = restir_args(res_in, nullptr, taps, height, width, n_cand, n_spatial,
                                    eps2, eps10, animated);
  Bwd7Args b = {ct, {}, d_ro, d_rd, partials, dtap, dhist, cols, ng};
  for (int k = 0; k < 4; ++k) b.ct_res[k] = static_cast<const float *>(ct_res[k]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = n_pix > 0 ? (unsigned)((n_pix + threads - 1) / threads) : 0u;
  if (blocks > 0) {
    const size_t smem = bwd_smem_bytes(n_mesh, n_lights, n_sdf, threads, kWholeSdf, ng);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<blocks, threads, smem, st>>>(a, ra, b);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long cells = (long long)height * width;
  if (cells > 0) {
    const unsigned gblocks = (unsigned)((cells + GATHER_THREADS - 1) / GATHER_THREADS);
    tap_gather_kernel<<<gblocks, GATHER_THREADS, 0, st>>>(ra, dtap, dback);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int n_red = n_mesh * ng;
  restir_reduce_kernel<<<n_red, RED_THREADS, 0, st>>>(partials, (int)blocks, n_mesh, cols, ng, d_table);
  return (int)cudaGetLastError();
}

// K7's occupancy at `threads` threads and `smem` bytes of dynamic shared
// memory (trace_common.cuh::kernel_occupancy) of this library's copy
// (`flags` unused).
extern "C" int rt0_restir_backward_occupancy(int flags, int threads, long long smem, int *out) {
  (void)flags;
  return kernel_occupancy(restir_bwd_kernel<kWholeSdf>, threads, (size_t)smem, out);
}
