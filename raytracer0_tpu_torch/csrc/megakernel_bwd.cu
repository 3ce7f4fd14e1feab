// megakernel_bwd.cu — K2, the adjoint of the forward megakernel K1, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// raytracer0_tpu/ops/megakernel.py::_bwd_slotted_kernel_body (launched by
// `_backward`), and computes the same outputs as its whole-trace twin
// `_bwd_kernel_body` (RT0_BWD_SLOTTED=0), for K1's Cornell class.  Given
// K1's inputs and the cotangent ct f32[n_pix, 3] of its radiance it returns
// d_table f32[n_mesh, 36] and d_ro, d_rd f32[n_pix, 3]: the gradients that
// torch.autograd gives through the plain version
// (raytracer0_tpu_torch/render/integrator.py::trace).  CUDA has no autodiff,
// so the adjoint of each step of a bounce is written out below by hand.
//
// Scheme: the per-slot stash of the Pallas kernel, one thread per pixel.
//  * forward sweep: run K1's bounce loop without NEE and without the
//    accumulator (neither changes the carry) and stash the carry entering
//    every slot the path runs: o, d, mask, prev_nl, 12 floats.  The
//    accumulator needs no stash (its cotangent is ct at every slot), nor do
//    the integer counters (no cotangent), and `specular` is (depth == 0) in
//    this class.  A path runs at most min(max_bounces, max_diff + 1) slots.
//  * reverse sweep: newest slot first, recompute the slot from its stash
//    (intersection, normal, BSDF sample, NEE shadow rays: the counter RNG
//    replays every draw exactly) and run its hand-derived adjoint, chaining
//    the carry cotangents back to the primary ray.
// Discrete decisions (winner index, shadow-ray hit, `inside`, validity, the
// MIS energy gate, cutoff and caps) carry no gradient, as `torch.where`
// gives in the plain version.  Ties follow the plain version's autograd:
// clamp and clamp_min pass the gradient at the bound, amax/amin split it
// evenly between tied slabs.
//
// The d_table reduction across pixels is deterministic: each thread adds
// into its own column of per-thread accumulators in shared memory (the 10
// table columns with a cotangent: pos 0:3, joker.x 3, color 7:10,
// emission 10:13), the block sums its columns in thread order into a
// per-block partial, and a second kernel sums the partials in block order
// with a fixed tree.  Two runs on the same inputs give the same bits.
//
// What bounds it: like K1, instruction latency and divergence, not memory.
// A pixel reads 40 bytes and writes 24; the work is the replay of every ran
// slot twice (forward sweep, reverse sweep) plus an adjoint about twice a
// bounce's arithmetic, with branches that diverge per pixel.  The stash
// (12 floats per slot) lives in local memory, which the L1 cache serves.

#include "trace_common.cuh"

namespace {

constexpr int MAX_SLOTS = 16;   // stash depth; the wrapper checks the bound
constexpr int ST = 12;          // stashed floats per slot: o, d, mask, prev_nl
constexpr int BWD_THREADS = 128;
constexpr int RED_THREADS = 256;

// cotangent columns kept per thread, and their scene-table columns
constexpr int NG = 10;
constexpr int G_P = 0, G_J0 = 3, G_C = 4, G_E = 7;
__host__ __device__ constexpr int table_col_of(int g) { return g < 4 ? g : g + 3; }

struct BwdArgs {
  TraceArgs t;           // K1's arguments (t.out unused)
  const float *ct;       // [n_pix, 3] cotangent of the radiance
  float *d_ro, *d_rd;    // [n_pix, 3]
  float *partials;       // [n_blocks, n_mesh, NG]
};

// This thread's column of the block's cotangent accumulators.
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

__device__ __forceinline__ V3 zero3() { return {0.0f, 0.0f, 0.0f}; }
// gradient of clamp_min(raw, lo): passes where raw >= lo
__device__ __forceinline__ V3 pass_ge(V3 raw, float lo, V3 g) {
  return {raw.x >= lo ? g.x : 0.0f, raw.y >= lo ? g.y : 0.0f, raw.z >= lo ? g.z : 0.0f};
}

// ------------------------------------------------------------ adjoints
// normalize(a) = a * (1 / sqrt(max(|a|^2, EPS)))
__device__ V3 normalize_bwd(V3 a, V3 g) {
  float s = dot(a, a);
  float len = sqrtf(fmaxf(s, EPS));
  float inv = 1.0f / len;
  V3 ga = g * inv;
  if (s >= EPS) {
    float g_len = -dot(g, a) * inv * inv;
    ga = ga + a * (2.0f * (g_len / (2.0f * len)));
  }
  return ga;
}

// safe_div(a, b): a / (sign(b) * max(|b|, EPS))
__device__ void safe_div_bwd(float a, float b, float g, float &ga, float &gb) {
  float mag = fmaxf(fabsf(b), EPS);
  float sd = b < 0.0f ? -mag : mag;
  ga = g / sd;
  float g_sd = -g * a / (sd * sd);
  float g_mag = b < 0.0f ? -g_sd : g_sd;
  gb = fabsf(b) >= EPS ? signf(b) * g_mag : 0.0f;
}

// onb(n) -> (u, v); the |n.z| ~ 1 guard gives constants.
__device__ V3 onb_bwd(V3 n, V3 gu, V3 gv) {
  if (fabsf(n.z) > 0.99999f) return zero3();
  float sig = n.z < 0.0f ? -1.0f : 1.0f;
  float den = sig + n.z;
  bool floored = fabsf(den) < EPS;
  float dd = floored ? EPS : den;
  float a = -1.0f / dd;
  float g_b = gu.y * sig + gv.x;
  float g_a = gu.x * sig * n.x * n.x + g_b * n.x * n.y + gv.y * n.y * n.y;
  return {gu.x * 2.0f * sig * n.x * a + g_b * n.y * a - gu.z * sig,
          g_b * n.x * a + gv.y * 2.0f * n.y * a - gv.z,
          floored ? 0.0f : g_a / (dd * dd)};
}

// around(w, u1, om, r_y) = normalize(u*cos(ang)*om + v*sin(ang)*om + w*r_y)
__device__ void around_bwd(V3 w, float u1, float om, float r_y, V3 g, V3 &g_w, float &g_om,
                           float &g_ry) {
  V3 u, v;
  onb(w, u, v);
  float ang = u1 * TWO_PI;
  float cs = cosf(ang), sn = sinf(ang);
  float ca = cs * om, sa = sn * om;
  V3 g_dv = normalize_bwd(u * ca + v * sa + w * r_y, g);
  g_w = g_dv * r_y + onb_bwd(w, g_dv * ca, g_dv * sa);
  g_om = dot(g_dv, u) * cs + dot(g_dv, v) * sn;
  g_ry = dot(g_dv, w);
}

// sample_biased(w, u1, u2): om and r_y depend on u2 only.
__device__ V3 sample_biased_bwd(V3 w, float u1, float u2, V3 g) {
  float r_y = sqrtf(fmaxf(u2, 1e-12f));
  float om = safe_sqrt(1.0f - r_y * r_y);
  V3 g_w;
  float g_om, g_ry;
  around_bwd(w, u1, om, r_y, g, g_w, g_om, g_ry);
  return g_w;
}

// sample_cone(w, extent, u1, u2)
__device__ void sample_cone_bwd(V3 w, float extent, float u1, float u2, V3 g, V3 &g_w,
                                float &g_extent) {
  float r_y = 1.0f - u2 * extent;
  float x = 1.0f - r_y * r_y;
  float om = safe_sqrt(x);
  float g_om, g_ry;
  around_bwd(w, u1, om, r_y, g, g_w, g_om, g_ry);
  if (x > 0.0f) g_ry += (g_om / (2.0f * om)) * (-2.0f * r_y);
  g_extent = -u2 * g_ry;
}

// power_heuristic(f, g) = max(f^2, 0) / max(f^2 + g^2, 1e-12), 0 when f^2 + g^2 <= 0
__device__ void power_heuristic_bwd(float f, float g, float gout, float &gf, float &gg) {
  float ff = f * f;
  float denom = ff + g * g;
  gf = gg = 0.0f;
  if (!(denom > 0.0f)) return;
  float dm = fmaxf(denom, 1e-12f);
  float g_ff = gout / dm;
  float g_den = denom >= 1e-12f ? -gout * fmaxf(ff, 0.0f) / (dm * dm) : 0.0f;
  gf = 2.0f * f * (g_ff + g_den);
  gg = 2.0f * g * g_den;
}

// sphere_light_pdf(lp, r, x)
__device__ void sphere_light_pdf_bwd(V3 lp, float r, V3 x, float g, V3 &g_lp, float &g_r,
                                     V3 &g_x) {
  V3 dv = lp - x;
  float d2 = dot(dv, dv);
  float r2 = r * r;
  float q = safe_div(r2, d2);
  float cos_max = safe_sqrt(1.0f - q);
  float denom = 1.0f - cos_max;
  g_lp = g_x = zero3();
  g_r = 0.0f;
  if (d2 <= r2 || denom < 1e-6f) return;
  float m_pre = TWO_PI * denom;
  float m = fmaxf(m_pre, 1e-12f);
  float g_den = m_pre >= 1e-12f ? (-g / (m * m)) * TWO_PI : 0.0f;
  float g_q = (1.0f - q) > 0.0f ? g_den / (2.0f * cos_max) : 0.0f;  // d/dq of -(1 - sqrt(1 - q))
  float g_r2, g_d2;
  safe_div_bwd(r2, d2, g_q, g_r2, g_d2);
  g_r = 2.0f * r * g_r2;
  g_lp = dv * (2.0f * g_d2);
  g_x = g_lp * -1.0f;
}

// procedural_sky(d): only d.y reaches it, through the clamp.
__device__ float sky_bwd(V3 d, V3 g) {
  float hp = d.y * 0.6f + 0.5f;
  float h = fminf(fmaxf(hp, 0.3f), 1.0f);
  float g_h = g.x * (-0.5f * sinf(TWO_PI * (0.525f + 0.9f * h))) * (TWO_PI * 0.9f) +
              g.y * (-0.5f * sinf(TWO_PI * (0.408f + 0.97f * h))) * (TWO_PI * 0.97f) +
              g.z * (-0.5f * sinf(TWO_PI * (0.409f + 0.8f * h))) * (TWO_PI * 0.8f);
  return (hp >= 0.3f && hp <= 1.0f) ? 0.6f * g_h : 0.0f;
}

// The winner's t of `intersect` with respect to o, d and mesh i's p, j0.
__device__ void isect_bwd(const SceneSmem &s, int i, V3 o, V3 d, float eps, float g_t, V3 &g_o,
                          V3 &g_d, const GradAcc &G) {
  V3 p = s.p(i);
  float j0 = s.j0(i);
  switch (s.mesh[i]) {
    case MESH_SPHERE: {
      V3 oc = o - p;
      float b = dot(oc, d);
      float c = dot(oc, oc) - j0 * j0;
      float sq = sqrtf(b * b - c);  // disc > 0 on a hit
      float t0 = -b - sq;
      float g_sq = t0 > eps ? -g_t : g_t;
      float g_disc = g_sq / (2.0f * sq);
      float g_b = -g_t + 2.0f * b * g_disc;
      float g_c = -g_disc;
      V3 g_oc = d * g_b + oc * (2.0f * g_c);
      g_d = g_d + oc * g_b;
      g_o = g_o + g_oc;
      G.add3(i, G_P, g_oc * -1.0f);
      G.add(i, G_J0, -2.0f * j0 * g_c);
      break;
    }
    case MESH_PLANE: {
      float denom = dot(p, d);
      float num = -j0 - dot(p, o);
      float g_num, g_den;
      safe_div_bwd(num, denom, g_t, g_num, g_den);
      G.add3(i, G_P, d * g_den - o * g_num);
      G.add(i, G_J0, -g_num);
      g_d = g_d + p * g_den;
      g_o = g_o - p * g_num;
      break;
    }
    case MESH_BOX: {
      float half = j0 * 0.5f;
      const float pp[3] = {p.x, p.y, p.z}, oo[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
      float m[3], lo[3], hi[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        m[k] = safe_div(1.0f, dd[k]);
        float n = m[k] * (pp[k] - oo[k]);
        float kk = fabsf(m[k]) * half;
        lo[k] = n - kk;
        hi[k] = n + kk;
      }
      float tn = fmaxf(fmaxf(lo[0], lo[1]), lo[2]);
      float tf = fminf(fminf(hi[0], hi[1]), hi[2]);
      float g_lo[3] = {0.0f, 0.0f, 0.0f}, g_hi[3] = {0.0f, 0.0f, 0.0f};
      if (tn > 0.0f) {
        float cnt = (float)((lo[0] == tn) + (lo[1] == tn) + (lo[2] == tn));
#pragma unroll
        for (int k = 0; k < 3; ++k) g_lo[k] = lo[k] == tn ? g_t / cnt : 0.0f;
      } else {
        float cnt = (float)((hi[0] == tf) + (hi[1] == tf) + (hi[2] == tf));
#pragma unroll
        for (int k = 0; k < 3; ++k) g_hi[k] = hi[k] == tf ? g_t / cnt : 0.0f;
      }
      float g_half = 0.0f, gp[3], go[3], gd[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float g_n = g_lo[k] + g_hi[k];
        float g_k = g_hi[k] - g_lo[k];
        float g_m = g_n * (pp[k] - oo[k]) + g_k * half * signf(m[k]);
        gp[k] = g_n * m[k];
        go[k] = -g_n * m[k];
        g_half += g_k * fabsf(m[k]);
        float g_one;
        safe_div_bwd(1.0f, dd[k], g_m, g_one, gd[k]);
      }
      G.add3(i, G_P, {gp[0], gp[1], gp[2]});
      G.add(i, G_J0, 0.5f * g_half);
      g_o = g_o + V3{go[0], go[1], go[2]};
      g_d = g_d + V3{gd[0], gd[1], gd[2]};
      break;
    }
    default:
      break;
  }
}

// normal_at(idx, x): sphere normalize(x - p), plane normalize(p), box constant.
__device__ void normal_bwd(const SceneSmem &s, int i, V3 x, V3 g_n, V3 &g_x, const GradAcc &G) {
  switch (s.mesh[i]) {
    case MESH_SPHERE: {
      V3 ga = normalize_bwd(x - s.p(i), g_n);
      g_x = g_x + ga;
      G.add3(i, G_P, ga * -1.0f);
      break;
    }
    case MESH_PLANE:
      G.add3(i, G_P, normalize_bwd(s.p(i), g_n));
      break;
    default:
      break;
  }
}

// shade_nee forward and adjoint in one pass: returns the NEE total (before
// the throughput factor) and adds the cotangents of x, nl and the scene for
// the cotangent g_tot of that total.
__device__ V3 shade_nee_bwd(const SceneSmem &s, V3 x, V3 nl, uint32_t h_depth, float eps,
                            float inf, bool use_mis, V3 g_tot, V3 &g_x, V3 &g_nl,
                            const GradAcc &G) {
  V3 total = zero3();
  for (int slot = 0; slot < s.n_lights; ++slot) {
    int li = s.lights[slot];
    if (li < 0) continue;  // sentinel slot: no light
    uint32_t h = fold_step(fold_step(h_depth, (uint32_t)slot, 4u), S_NEE_CONE, 5u);
    float u1 = u01(h), u2 = u01(pcg(h));
    V3 lp = s.p(li);
    float r = s.j0(li);
    V3 sw = lp - x;
    float d2 = dot(sw, sw);
    float q = safe_div(r * r, d2);
    float qc = fminf(fmaxf(q, 0.0f), 1.0f);
    float cos_a_max = safe_sqrt(1.0f - qc);
    V3 ldir = normalize(sw);
    float extent = 1.0f - cos_a_max;
    V3 sr = sample_cone(ldir, extent, u1, u2);
    float ts;
    int hidx;
    intersect(s, x + nl * eps, sr, eps, ts, hidx);
    if (!(ts < inf) || s.mat[hidx] != MAT_LIGHT) continue;
    float cos_raw = dot(sr, nl);
    float cos_term = fmaxf(cos_raw, 0.001f);
    float weight = 2.0f * (1.0f - cos_a_max);
    V3 lc_raw = s.c(hidx);
    V3 lc = vmax(lc_raw, 0.001f);
    V3 le = s.e(hidx);
    float sc = weight * cos_term;
    V3 contrib = lc * le * sc;
    V3 g_c = g_tot;  // cotangent of contrib
    V3 g_ldir = zero3();
    if (use_mis) {
      if (!(dot(contrib, contrib) > 1e-6f)) continue;
      float b_cos = dot(ldir, nl);
      float b_pdf = fmaxf(b_cos, 0.0f) * ONE_OVER_PI;
      float l_pdf = sphere_light_pdf(lp, r, x);
      float w = power_heuristic(l_pdf, b_pdf);
      float g_w = dot(g_c, contrib);
      contrib = contrib * w;
      g_c = g_c * w;
      float g_l, g_b;
      power_heuristic_bwd(l_pdf, b_pdf, g_w, g_l, g_b);
      if (b_cos >= 0.0f) {
        float gb = g_b * ONE_OVER_PI;
        g_ldir = nl * gb;
        g_nl = g_nl + ldir * gb;
      }
      V3 g_lp, g_xp;
      float g_r;
      sphere_light_pdf_bwd(lp, r, x, g_l, g_lp, g_r, g_xp);
      G.add3(li, G_P, g_lp);
      G.add(li, G_J0, g_r);
      g_x = g_x + g_xp;
    }
    total = total + contrib;

    // contrib = max(c, 0.001) * e * (weight * cos_term)
    G.add3(hidx, G_C, pass_ge(lc_raw, 0.001f, g_c * le * sc));
    G.add3(hidx, G_E, g_c * lc * sc);
    float g_sc = dot(g_c, lc * le);
    float g_cos = g_sc * weight;
    V3 g_sr = zero3();
    if (cos_raw >= 0.001f) {
      g_sr = nl * g_cos;
      g_nl = g_nl + sr * g_cos;
    }
    V3 g_ld2;
    float g_ext;
    sample_cone_bwd(ldir, extent, u1, u2, g_sr, g_ld2, g_ext);
    g_ldir = g_ldir + g_ld2;
    // weight = 2 (1 - cos_a_max), extent = 1 - cos_a_max
    float g_cam = -2.0f * (g_sc * cos_term) - g_ext;
    float g_qc = (1.0f - qc) > 0.0f ? -g_cam / (2.0f * cos_a_max) : 0.0f;
    float g_q = (q >= 0.0f && q <= 1.0f) ? g_qc : 0.0f;
    float g_r2, g_d2;
    safe_div_bwd(r * r, d2, g_q, g_r2, g_d2);
    G.add(li, G_J0, 2.0f * r * g_r2);
    V3 g_sw = sw * (2.0f * g_d2) + normalize_bwd(sw, g_ldir);
    G.add3(li, G_P, g_sw);
    g_x = g_x - g_sw;
  }
  return total;
}

// Adjoint of slot `depth` of K1's loop.  In: the carry entering the slot
// (o, d, mask, prev_nl) and, in g_*, the cotangents of the carry leaving it
// (zero for the last slot).  Out: g_* hold the cotangents of the carry
// entering it; the scene's cotangents are added into G.
__device__ void slot_bwd(const SceneSmem &s, const TraceArgs &a, int depth, uint32_t h_pix, V3 o,
                         V3 d, V3 mask, V3 prev_nl, V3 ct, V3 &g_o, V3 &g_d, V3 &g_mask,
                         V3 &g_pnl, const GradAcc &G) {
  const bool specular = depth == 0;  // only primary rays are specular in this class
  const V3 go_out = g_o, gd_out = g_d, gm_out = g_mask, gp_out = g_pnl;
  g_o = g_d = g_mask = g_pnl = zero3();

  float t;
  int idx;
  intersect(s, o, d, a.eps, t, idx);

  // ---- miss: acc += mask * sky(d) ----
  if (!(t < a.inf)) {
    if (a.use_sky && (specular || !a.sample_lights)) {
      g_mask = ct * procedural_sky(d);
      g_d.y = sky_bwd(d, ct * mask);
    }
    return;
  }

  V3 x = o + d * t;
  V3 c_raw = s.c(idx);
  V3 c = vmax(c_raw, 0.001f);
  V3 g_x = zero3();

  if (s.mat[idx] == MAT_LIGHT) {
    // ---- emissive hit: acc += mask * c * e * mis_w ----
    V3 e_raw = s.e(idx);
    V3 e = vmax(e_raw, 0.001f);
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
    G.add3(idx, G_C, pass_ge(c_raw, 0.001f, ct * mask * e * mis_w));
    G.add3(idx, G_E, pass_ge(e_raw, 0.001f, ct * mask * c * mis_w));
    if (mis) {
      float g_b, g_l;
      power_heuristic_bwd(b_pdf, l_pdf, dot(ct, mask * c * e), g_b, g_l);
      if (b_cos >= 0.0f) {
        float gc = g_b * ONE_OVER_PI;
        g_pnl = light_dir * gc;
        V3 g_xo = normalize_bwd(x - o, prev_nl * gc);
        g_x = g_x + g_xo;
        g_o = g_o - g_xo;
      }
      if (s.mesh[idx] == MESH_SPHERE) {
        V3 g_lp, g_op;
        float g_r;
        sphere_light_pdf_bwd(s.p(idx), s.j0(idx), o, g_l, g_lp, g_r, g_op);
        G.add3(idx, G_P, g_lp);
        G.add(idx, G_J0, g_r);
        g_o = g_o + g_op;
      }
    }
  } else {
    // ---- DIFF bounce: o' = x + nl eps, d' = sample_biased(nl), mask' = mask c,
    //      prev_nl' = nl, acc += nee(x, nl) * mask' ----
    V3 n = normal_at(s, idx, x);
    float inside = dot(d, n) > 0.0f ? -1.0f : 1.0f;
    const uint32_t h_depth = fold_step(h_pix, (uint32_t)depth, 3u);
    const uint32_t h_dir = fold_step(h_depth, S_BSDF_DIR, 4u);
    V3 nl = n * inside;
    V3 mask_after = mask * c;

    g_x = go_out;
    V3 g_nl = go_out * a.eps + gp_out + sample_biased_bwd(nl, u01(h_dir), u01(pcg(h_dir)), gd_out);
    V3 g_ma = gm_out;
    if (a.sample_lights) {
      V3 total = shade_nee_bwd(s, x, nl, h_depth, a.eps, a.inf, a.use_mis, ct * mask_after, g_x,
                               g_nl, G);
      g_ma = g_ma + ct * total;
    }
    g_mask = g_ma * c;
    G.add3(idx, G_C, pass_ge(c_raw, 0.001f, g_ma * mask));
    normal_bwd(s, idx, x, g_nl * inside, g_x, G);
  }

  // ---- x = o + d t(o, d, scene) ----
  g_o = g_o + g_x;
  g_d = g_d + g_x * t;
  isect_bwd(s, idx, o, d, a.eps, dot(g_x, d), g_o, g_d, G);
}

// Dynamic shared memory of one K2 block: the scene, then `threads` columns
// of NG cotangent accumulators per mesh (ops/megakernel.py computes the same).
__host__ __device__ inline size_t bwd_smem_bytes(int n_mesh, int n_lights, int threads) {
  return scene_smem_bytes(n_mesh, n_lights) + sizeof(float) * n_mesh * NG * threads;
}

__global__ void __launch_bounds__(BWD_THREADS) bwd_kernel(BwdArgs b) {
  const TraceArgs &a = b.t;
  extern __shared__ float smem[];
  const SceneSmem s = load_scene(a, smem);
  float *gsm = smem + scene_smem_bytes(a.n_mesh, a.n_lights) / sizeof(float);
  const int n_g = a.n_mesh * NG;
  for (int e = 0; e < n_g; ++e) gsm[e * blockDim.x + threadIdx.x] = 0.0f;
  const GradAcc G = {gsm + threadIdx.x, (int)blockDim.x};

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < a.n_pix) {  // ragged edge: idle threads still join the block sum
    V3 o = {a.ro[3 * p], a.ro[3 * p + 1], a.ro[3 * p + 2]};
    V3 d = {a.rd[3 * p], a.rd[3 * p + 1], a.rd[3 * p + 2]};
    const uint32_t h_pix = pixel_hash(a, p);

    // ---- forward sweep: K1's carry updates, stashing each slot's input ----
    float st[MAX_SLOTS * ST];
    V3 mask = {1.0f, 1.0f, 1.0f};
    V3 prev_nl = {0.0f, 1.0f, 0.0f};
    int ndif = 0, nspec = 0, nscat = 0, n_run = 0;
    for (int depth = 0; depth < a.max_bounces && depth < MAX_SLOTS; ++depth) {
      float *sk = st + depth * ST;
      sk[0] = o.x, sk[1] = o.y, sk[2] = o.z, sk[3] = d.x, sk[4] = d.y, sk[5] = d.z;
      sk[6] = mask.x, sk[7] = mask.y, sk[8] = mask.z;
      sk[9] = prev_nl.x, sk[10] = prev_nl.y, sk[11] = prev_nl.z;
      n_run = depth + 1;

      float tmin;
      int idx;
      intersect(s, o, d, a.eps, tmin, idx);
      if (!(tmin < a.inf) || s.mat[idx] == MAT_LIGHT) break;  // miss or emissive hit ends the path
      V3 x = o + d * tmin;
      V3 n = normal_at(s, idx, x);
      V3 c = vmax(s.c(idx), 0.001f);
      float inside = dot(d, n) > 0.0f ? -1.0f : 1.0f;
      const uint32_t h_dir = fold_step(fold_step(h_pix, (uint32_t)depth, 3u), S_BSDF_DIR, 4u);
      V3 nl = n * inside;
      V3 new_d = sample_biased(nl, u01(h_dir), u01(pcg(h_dir)));
      o = x + nl * a.eps;
      d = new_d;
      mask = mask * c;
      prev_nl = nl;
      ndif += 1;
      if (fmaxf(fmaxf(mask.x, mask.y), mask.z) < 0.01f || ndif >= a.max_diff ||
          nspec >= a.max_spec || nscat >= a.max_scatter)
        break;
    }

    // ---- reverse sweep: newest slot first ----
    const V3 ct = {b.ct[3 * p], b.ct[3 * p + 1], b.ct[3 * p + 2]};
    V3 g_o = zero3(), g_d = zero3(), g_mask = zero3(), g_pnl = zero3();
    for (int k = n_run - 1; k >= 0; --k) {
      const float *sk = st + k * ST;
      slot_bwd(s, a, k, h_pix, {sk[0], sk[1], sk[2]}, {sk[3], sk[4], sk[5]},
               {sk[6], sk[7], sk[8]}, {sk[9], sk[10], sk[11]}, ct, g_o, g_d, g_mask, g_pnl, G);
    }
    b.d_ro[3 * p] = g_o.x;
    b.d_ro[3 * p + 1] = g_o.y;
    b.d_ro[3 * p + 2] = g_o.z;
    b.d_rd[3 * p] = g_d.x;
    b.d_rd[3 * p + 1] = g_d.y;
    b.d_rd[3 * p + 2] = g_d.z;
  }

  // ---- this block's partial of d_table, summed in thread order ----
  __syncthreads();
  for (int e = threadIdx.x; e < n_g; e += blockDim.x) {
    float sum = 0.0f;
    for (int t = 0; t < (int)blockDim.x; ++t) sum += gsm[e * blockDim.x + t];
    b.partials[(size_t)blockIdx.x * n_g + e] = sum;
  }
}

// d_table[entry] = sum over blocks of the partials, in a fixed order: one
// block per table entry, a strided sum per thread, then a fixed tree.
__global__ void __launch_bounds__(RED_THREADS)
    reduce_kernel(const float *partials, int n_blocks, int n_mesh, float *d_table) {
  __shared__ float red[RED_THREADS];
  const int entry = blockIdx.x;
  const int mesh = entry / NCOLS, col = entry % NCOLS;
  int g = -1;
  for (int k = 0; k < NG; ++k)
    if (table_col_of(k) == col) g = k;
  float sum = 0.0f;
  if (g >= 0)
    for (int blk = threadIdx.x; blk < n_blocks; blk += RED_THREADS)
      sum += partials[(size_t)blk * n_mesh * NG + mesh * NG + g];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) d_table[entry] = red[0];
}

}  // namespace

// Launch K2 on `stream`: the adjoint kernel, then the reduction of its
// per-block partials [ceil(n_pix / threads), n_mesh, 10] into d_table.
// Returns the first CUDA error of the two launches, or 0.
extern "C" int rt0_trace_backward(const float *table, const int32_t *mesh, const int32_t *mat,
                                  int n_mesh, const int32_t *lights, int n_lights,
                                  const float *ro, const float *rd, const int64_t *pix,
                                  const float *ct, float *d_ro, float *d_rd, float *partials,
                                  float *d_table, long long n_pix, unsigned pass_idx,
                                  unsigned sample_idx, int max_bounces, int max_diff,
                                  int max_spec, int max_scatter, float eps, float inf,
                                  int sample_lights, int use_mis, int use_sky, int threads,
                                  void *stream) {
  if (threads <= 0 || threads > BWD_THREADS || n_mesh <= 0) return (int)cudaErrorInvalidValue;
  TraceArgs t = {table,       mesh,       mat,       lights,   n_mesh,      n_lights,
                 ro,          rd,         pix,       nullptr,  n_pix,       pass_idx,
                 sample_idx,  max_bounces, max_diff, max_spec, max_scatter, eps,
                 inf,         sample_lights, use_mis, use_sky};
  BwdArgs b = {t, ct, d_ro, d_rd, partials};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = n_pix > 0 ? (unsigned)((n_pix + threads - 1) / threads) : 0u;
  if (blocks > 0) {
    const size_t smem = bwd_smem_bytes(n_mesh, n_lights, threads);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    bwd_kernel<<<blocks, threads, smem, st>>>(b);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  reduce_kernel<<<n_mesh * NCOLS, RED_THREADS, 0, st>>>(partials, (int)blocks, n_mesh, d_table);
  return (int)cudaGetLastError();
}
