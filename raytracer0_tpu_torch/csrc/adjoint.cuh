// adjoint.cuh — hand-derived adjoints shared by K2 (megakernel_bwd.cu, the
// adjoint of K1) and K7 (restir_bwd.cu, the adjoint of the ReSTIR pass
// K6): normalize, the safe division, the orthonormal basis, the
// cosine and cone samplers, the power heuristic, the sphere-light pdf, the
// procedural sky, the analytic intersections and normals; and, reached by
// K7 so far, reflection, refraction, the ROUND_BOX signed distance, the
// tetrahedral SDF normal and the implicit reattachment of an SDF hit's t.
//
// Each function is the reverse-mode derivative of its forward twin in
// trace_common.cuh, which is the plain PyTorch version's operation for
// operation, so its result is what torch.autograd gives through the plain
// version: discrete decisions carry no gradient, clamp and clamp_min pass
// the gradient at the bound, abs and sign follow torch (sign(0) = 0).
// Scene cotangents go into an accumulator `G` whose add(mesh, column, v)
// and add3 take scene-table columns (C_PX, C_J0, C_CR, C_ER, C_IOR); each
// kernel maps the columns it keeps onto its own accumulators.

#pragma once

#include "trace_common.cuh"

namespace {

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
template <class Acc>
__device__ void isect_bwd(const SceneSmem &s, int i, V3 o, V3 d, float eps, float g_t, V3 &g_o,
                          V3 &g_d, const Acc &G) {
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
      G.add3(i, C_PX, g_oc * -1.0f);
      G.add(i, C_J0, -2.0f * j0 * g_c);
      break;
    }
    case MESH_PLANE: {
      float denom = dot(p, d);
      float num = -j0 - dot(p, o);
      float g_num, g_den;
      safe_div_bwd(num, denom, g_t, g_num, g_den);
      G.add3(i, C_PX, d * g_den - o * g_num);
      G.add(i, C_J0, -g_num);
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
      G.add3(i, C_PX, {gp[0], gp[1], gp[2]});
      G.add(i, C_J0, 0.5f * g_half);
      g_o = g_o + V3{go[0], go[1], go[2]};
      g_d = g_d + V3{gd[0], gd[1], gd[2]};
      break;
    }
    default:
      break;
  }
}

// normal_at(idx, x): sphere normalize(x - p), plane normalize(p), box constant.
template <class Acc>
__device__ void normal_bwd(const SceneSmem &s, int i, V3 x, V3 g_n, V3 &g_x, const Acc &G) {
  switch (s.mesh[i]) {
    case MESH_SPHERE: {
      V3 ga = normalize_bwd(x - s.p(i), g_n);
      g_x = g_x + ga;
      G.add3(i, C_PX, ga * -1.0f);
      break;
    }
    case MESH_PLANE:
      G.add3(i, C_PX, normalize_bwd(s.p(i), g_n));
      break;
    default:
      break;
  }
}

// d max(x, c) / dx, d min(x, c) / dx and d clip(x, lo, hi) / dx with the
// gradient of jnp.maximum, jnp.minimum and jnp.clip (and of torch.maximum
// and torch.minimum): half at a tie.  K7 and its plain version use these
// where torch.clamp would pass the whole gradient (ops/restir.py).
__device__ __forceinline__ float dmax(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dmin(float x, float c) {
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dclip(float x, float lo, float hi) {
  return dmax(x, lo) * dmin(fmaxf(x, lo), hi);
}

// reflect(d, n) = d - n (2 dot(d, n))
__device__ void reflect_bwd(V3 d, V3 n, V3 g, V3 &g_d, V3 &g_n) {
  const float s = 2.0f * dot(d, n);
  const float g_dot = 2.0f * -dot(g, n);
  g_d = g_d + g + n * g_dot;
  g_n = g_n - g * s + d * g_dot;
}

// refract(d, n, eta) where it does not reflect totally (k > 0 or k == 0):
// d eta - n (eta cos_i + safe_sqrt(k)), k = 1 - eta eta (1 - cos_i cos_i).
__device__ void refract_bwd(V3 d, V3 n, float eta, V3 g, V3 &g_d, V3 &g_n, float &g_eta) {
  const float cos_i = dot(d, n);
  const float w = 1.0f - cos_i * cos_i;
  const float k = 1.0f - eta * eta * w;
  const float sq = safe_sqrt(k);
  const float a = eta * cos_i + sq;
  g_d = g_d + g * eta;
  g_eta += dot(g, d);
  const float g_a = -dot(g, n);
  g_n = g_n - g * a;
  g_eta += g_a * cos_i;
  float g_cos = g_a * eta;
  if (k > 0.0f) {
    const float g_k = g_a / (2.0f * sq);
    g_eta += 2.0f * eta * (-g_k * w);
    g_cos += -2.0f * cos_i * (-g_k * (eta * eta));
  }
  g_d = g_d + n * g_cos;
  g_n = g_n + d * g_cos;
}

// d sdf_entry / d(p, the row's pos and joker 0:4) of a ROUND_BOX row,
// len(max(|q| - b, 0)) - r with q = p - pos, times g: returns the cotangent
// of p and adds the row's into G.  Where len is 0 (p on or in the core) its
// gradient is 0, as vecmath.length gives it.
template <class Acc>
__device__ V3 round_box_bwd(const SceneSmem &s, int row, V3 p, float g, const Acc &G) {
  const V3 q = p - s.p(row);
  const float *j = s.col(row, C_J0);
  const float qq[3] = {q.x, q.y, q.z};
  float dq[3], m[3], gq[3];
  for (int k = 0; k < 3; ++k) {
    dq[k] = fabsf(qq[k]) - j[k];
    m[k] = fmaxf(dq[k], 0.0f);
  }
  const float len = sqrtf(fmaxf(m[0] * m[0] + m[1] * m[1] + m[2] * m[2], 0.0f));
  const float g_s = len > 0.0f ? g / (2.0f * len) : 0.0f;  // d len / d(m . m)
  for (int k = 0; k < 3; ++k) {
    const float g_dq = dq[k] >= 0.0f ? 2.0f * m[k] * g_s : 0.0f;
    gq[k] = g_dq * signf(qq[k]);
    G.add(row, C_J0 + k, -g_dq);
  }
  G.add(row, C_J0 + 3, -g);
  const V3 gp = {gq[0], gq[1], gq[2]};
  G.add3(row, C_PX, gp * -1.0f);
  return gp;
}

// The SDF rows' distance at p (sdf_map) times g: the nearest entry's
// cotangents (the first on a tie, as the forward's winner).  ROUND_BOX
// rows only.
template <class Acc>
__device__ V3 sdf_map_bwd(const SceneSmem &s, const SdfScene &sd, V3 p, float g, const Acc &G) {
  int k;
  sdf_map(s, sd, p, k);
  return round_box_bwd(s, sd.first + k, p, g, G);
}

// sdf_normal(p) = normalize(sum_i tap_i f(p + tap_i eps)) for its cotangent
// g_n: returns the cotangent of p.
template <class Acc>
__device__ V3 sdf_normal_bwd(const SceneSmem &s, const SdfScene &sd, V3 p, float eps, V3 g_n,
                             const Acc &G) {
  const V3 taps[4] = {{1.0f, -1.0f, -1.0f}, {-1.0f, -1.0f, 1.0f}, {-1.0f, 1.0f, -1.0f},
                      {1.0f, 1.0f, 1.0f}};
  V3 n = {0.0f, 0.0f, 0.0f};
  int k;
  for (int i = 0; i < 4; ++i) n = n + taps[i] * sdf_map(s, sd, p + taps[i] * eps, k);
  const V3 g_raw = normalize_bwd(n, g_n);
  V3 g_p = zero3();
  for (int i = 0; i < 4; ++i)
    g_p = g_p + sdf_map_bwd(s, sd, p + taps[i] * eps, dot(g_raw, taps[i]), G);
  return g_p;
}

// An SDF hit's t, reattached as in ops/sdf.march: the march runs without a
// gradient, and t = t* - (f(x*) - sg f(x*)) / sg(df/dt) at x* = o + d t*,
// with df/dt the central difference at x* along d (step eps, `two_eps` =
// f32(2 eps)), floored to +-0.05.  Adds the cotangents of o and d for the
// cotangent g_t of t.
template <class Acc>
__device__ void sdf_t_bwd(const SceneSmem &s, const SdfScene &sd, V3 o, V3 d, float t, float eps,
                          float two_eps, float g_t, V3 &g_o, V3 &g_d, const Acc &G) {
  const V3 xs = o + d * t;
  int k;
  const float f_fwd = sdf_map(s, sd, xs + d * eps, k);
  const float f_bwd = sdf_map(s, sd, xs - d * eps, k);
  float dfdt = (f_fwd - f_bwd) / two_eps;
  if (fabsf(dfdt) < 0.05f) dfdt = dfdt < 0.0f ? -0.05f : 0.05f;
  const V3 g_xs = sdf_map_bwd(s, sd, xs, -g_t / dfdt, G);
  g_o = g_o + g_xs;
  g_d = g_d + g_xs * t;
}

// One cone sample toward the sphere light of row `li` (position lp, radius
// r) from (x, nl), that hit the LIGHT mesh `hidx`: the contribution
// max(c, 0.001) e (2 (1 - cos_a_max) max(dot(sr, nl), 0.001)) of
// restir._shade_selected, with its ties split as jnp.maximum does.
// Returns it, and adds the cotangents of x, nl and the scene for its
// cotangent g_c.
template <class Acc>
__device__ V3 cone_light_bwd(const SceneSmem &s, int li, int hidx, V3 x, V3 nl, float u1, float u2,
                             V3 g_c, V3 &g_x, V3 &g_nl, const Acc &G) {
  const V3 lp = s.p(li);
  const float r = s.j0(li);
  const V3 sw = lp - x;
  const float d2 = dot(sw, sw);
  const float q = safe_div(r * r, d2);
  const float qc = fminf(fmaxf(q, 0.0f), 1.0f);
  const float cos_a_max = safe_sqrt(1.0f - qc);
  const V3 ldir = normalize(sw);
  const float extent = 1.0f - cos_a_max;
  const V3 sr = sample_cone(ldir, extent, u1, u2);
  const float cos_raw = dot(sr, nl);
  const float cos_term = fmaxf(cos_raw, 0.001f);
  const float weight = 2.0f * (1.0f - cos_a_max);
  const V3 lc_raw = s.c(hidx);
  const V3 lc = vmax(lc_raw, 0.001f);
  const V3 le = s.e(hidx);
  const float sc = weight * cos_term;
  const V3 g_lc = g_c * sc * le;
  G.add3(hidx, C_CR, V3{g_lc.x * dmax(lc_raw.x, 0.001f), g_lc.y * dmax(lc_raw.y, 0.001f),
                        g_lc.z * dmax(lc_raw.z, 0.001f)});
  G.add3(hidx, C_ER, g_c * sc * lc);
  const float g_sc = dot(g_c, lc * le);
  const float g_cos = g_sc * weight * dmax(cos_raw, 0.001f);
  const V3 g_sr = nl * g_cos;
  g_nl = g_nl + sr * g_cos;
  V3 g_ld;
  float g_ext;
  sample_cone_bwd(ldir, extent, u1, u2, g_sr, g_ld, g_ext);
  const float g_cam = -2.0f * (g_sc * cos_term) - g_ext;
  const float g_qc = (1.0f - qc) > 0.0f ? -g_cam / (2.0f * cos_a_max) : 0.0f;
  float g_r2, g_d2;
  safe_div_bwd(r * r, d2, g_qc * dclip(q, 0.0f, 1.0f), g_r2, g_d2);
  G.add(li, C_J0, 2.0f * r * g_r2);
  const V3 g_sw = sw * (2.0f * g_d2) + normalize_bwd(sw, g_ld);
  G.add3(li, C_PX, g_sw);
  g_x = g_x - g_sw;
  return lc * le * sc;
}

}  // namespace
