// adjoint.cuh — hand-derived adjoints shared by K2 (megakernel_bwd.cu, the
// adjoint of K1) and K7 (restir_bwd.cu, the adjoint of the ReSTIR pass
// K6): normalize, the safe division, the orthonormal basis, the
// cosine, uniform and cone samplers, the power heuristic, the sphere-light
// pdf, the procedural sky and the cubemap fetch, the analytic intersections
// and normals, the direction of every BSDF sample (reflection, refraction),
// the BOX and ROUND_BOX signed distances, the scene map, the tetrahedral
// SDF normal and the implicit reattachment of an SDF hit's t; and, reached
// by K2 and K7's whole-SDF copy, the 14 distances, the texel of a hit (the
// UV, image bilinear, CHECK, RIPPLE, gradient and value noise, METAL fBm)
// and its blend into the hit's color and emission; and, reached by K2's
// medium copy alone, the HG sampler and phase, Cauchy's IOR and the
// in-scatter NEE of a medium event.
//
// Each function is the reverse-mode derivative of its forward twin in
// trace_common.cuh, which is the plain PyTorch version's operation for
// operation, so its result is what torch.autograd gives through the plain
// version: discrete decisions carry no gradient, clamp and clamp_min pass
// the gradient at the bound, abs and sign follow torch (sign(0) = 0).
// Scene cotangents go into an accumulator `G` whose add(mesh, column, v)
// and add3 take scene-table columns (C_PX, C_J0, C_CR, C_ER, C_IOR, C_TP,
// C_CM, C_EM); each kernel maps the columns it keeps onto its own
// accumulators.

#pragma once

#include "path.cuh"

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

// random_direction(w, u1, u2, biased): the cosine sample, or the uniform
// hemisphere (the cone of extent 1).
__device__ __forceinline__ V3 random_direction_bwd(V3 w, float u1, float u2, bool biased, V3 g) {
  if (biased) return sample_biased_bwd(w, u1, u2, g);
  V3 g_w;
  float g_extent;
  sample_cone_bwd(w, 1.0f, u1, u2, g, g_w, g_extent);
  return g_w;
}

// sample_hg(w, g, u1, u2) for its cotangent g_out: the cotangent of w.  The
// polar cosine and its sine depend on the constant g and the draws alone.
__device__ V3 sample_hg_bwd(V3 w, float g, float u1, float u2, V3 g_out) {
  float cos_t;
  if (fabsf(g) < 1e-3f) {
    cos_t = 1.0f - 2.0f * u1;
  } else {
    const float sqr = (1.0f - g * g) / ((1.0f - g) + 2.0f * g * u1);
    cos_t = ((1.0f + g * g) - sqr * sqr) / (2.0f * g);
  }
  V3 g_w;
  float g_om, g_ry;
  around_bwd(w, u2, safe_sqrt(1.0f - cos_t * cos_t), cos_t, g_out, g_w, g_om, g_ry);
  return g_w;
}

// hg_phase(cos_theta) = (1 - g^2) / (4 pi denom sqrt(denom)), denom =
// max(1 + g^2 - 2 g cos_theta, 1e-6), for its cotangent g_out: the
// cotangent of cos_theta (clamp_min passes it at the floor).
__device__ float hg_phase_bwd(float cos_theta, float one_p_g2, float two_g, float one_m_g2,
                              float g_out) {
  const float raw = one_p_g2 - two_g * cos_theta;
  if (!(raw >= 1e-6f)) return 0.0f;
  const float sq = sqrtf(raw);
  const float p = FOUR_PI * raw;
  const float den = p * sq;
  const float g_den = -g_out * one_m_g2 / (den * den);
  const float g_raw = g_den * sq * FOUR_PI + (g_den * p) / (2.0f * sq);
  return -two_g * g_raw;
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

// d sdf_entry / d(p, the row's pos and joker 0:3) of a BOX row,
// len(max(|q| - b, 0)) + min(max(|q| - b), 0) with q = p - pos, times g:
// returns the cotangent of p and adds the row's into G.  The max over the
// axes splits its gradient evenly between tied axes (torch.amax), and len
// has a zero gradient at 0, as for ROUND_BOX.
template <class Acc>
__device__ V3 sd_box_bwd(const SceneSmem &s, int row, V3 p, float g, const Acc &G) {
  const V3 q = p - s.p(row);
  const float *j = s.col(row, C_J0);
  const float qq[3] = {q.x, q.y, q.z};
  float dq[3], m[3], gq[3];
  for (int k = 0; k < 3; ++k) {
    dq[k] = fabsf(qq[k]) - j[k];
    m[k] = fmaxf(dq[k], 0.0f);
  }
  const float len = sqrtf(fmaxf(m[0] * m[0] + m[1] * m[1] + m[2] * m[2], 0.0f));
  const float g_s = len > 0.0f ? g / (2.0f * len) : 0.0f;
  const float mx = fmaxf(fmaxf(dq[0], dq[1]), dq[2]);
  const float ties = (float)((dq[0] == mx) + (dq[1] == mx) + (dq[2] == mx));
  const float g_mx = mx <= 0.0f ? g / ties : 0.0f;  // clamp_max(., 0) passes at 0
  for (int k = 0; k < 3; ++k) {
    const float g_dq = (dq[k] >= 0.0f ? 2.0f * m[k] * g_s : 0.0f) + (dq[k] == mx ? g_mx : 0.0f);
    gq[k] = g_dq * signf(qq[k]);
    G.add(row, C_J0 + k, -g_dq);
  }
  const V3 gp = {gq[0], gq[1], gq[2]};
  G.add3(row, C_PX, gp * -1.0f);
  return gp;
}

// ------------------------------------------------------------ SDF shapes
// The adjoints of the distances beyond BOX and ROUND_BOX (trace_common.cuh,
// "SDF shapes"; the whole-SDF copies of K2 and K7), each the reverse of the plain
// version's operations under torch.autograd: torch.maximum and
// torch.minimum split the gradient evenly at a tie (dmax, dmin), amin
// between all tied values, clamp_min and clamp pass it at the bound, abs
// and sign give 0 at 0, vecmath.length and safe_sqrt give 0 at 0,
// remainder has derivative 1 in its dividend.  Each takes the cotangent g
// of the distance and returns the cotangent of its point; those of the
// row's parameters go into G.

__device__ V3 value_noise_bwd(const float *__restrict__ lut, int n, V3 x, float g);  // below

// d |v| / d v (vecmath.length: 0 at 0) times g
__device__ __forceinline__ V3 len3_bwd(V3 v, float g) {
  const float s = dot(v, v);
  return s > 0.0f ? v * (g / sqrtf(s)) : zero3();
}

// sd_tri_prism(q, h): max(|q.z| - h1, max(|q.x| 0.866025 + q.y 0.5, -q.y) - h0 0.5)
__device__ V3 tri_prism_bwd(V3 q, const float *h, float g, float &g_h0, float &g_h1) {
  const float a = fabsf(q.z) - h[1];
  const float b1 = fabsf(q.x) * 0.866025f + q.y * 0.5f, b2 = -q.y;
  const float b = fmaxf(b1, b2) - h[0] * 0.5f;
  const float g_a = g * dmax(a, b), g_b = g * dmax(b, a);
  const float g_b1 = g_b * dmax(b1, b2), g_b2 = g_b * dmax(b2, b1);
  g_h1 = -g_a;
  g_h0 = -0.5f * g_b;
  return {g_b1 * 0.866025f * signf(q.x), g_b1 * 0.5f - g_b2, g_a * signf(q.z)};
}

// sd_cone(q, c) of (sin, cos, height) c about the y axis
__device__ V3 cone_bwd(V3 q, const float *c, float g, float (&g_c)[3]) {
  const float r2 = q.x * q.x + q.z * q.z;
  const float qx = safe_sqrt(r2), qy = q.y;
  const float d1 = -qy - c[2];
  const float e2 = qx * c[0] + qy * c[1];
  const float d2 = fmaxf(e2, qy);
  const float m1 = fmaxf(d1, 0.0f), m2 = fmaxf(d2, 0.0f);
  const float ss = m1 * m1 + m2 * m2;
  const float mm = fmaxf(d1, d2);
  const float g_mm = mm <= 0.0f ? g : 0.0f;  // clamp_max(., 0) passes at 0
  float g_d1 = g_mm * dmax(d1, d2), g_d2 = g_mm * dmax(d2, d1);
  const float g_ss = ss > 0.0f ? g / (2.0f * sqrtf(ss)) : 0.0f;
  if (d1 >= 0.0f) g_d1 += 2.0f * m1 * g_ss;
  if (d2 >= 0.0f) g_d2 += 2.0f * m2 * g_ss;
  const float g_e2 = g_d2 * dmax(e2, qy);
  float g_qy = g_d2 * dmax(qy, e2) + g_e2 * c[1] - g_d1;
  const float g_qx = g_e2 * c[0];
  g_c[0] = g_e2 * qx;
  g_c[1] = g_e2 * qy;
  g_c[2] = -g_d1;
  const float g_r2 = r2 > 0.0f ? g_qx / (2.0f * qx) : 0.0f;
  return {2.0f * q.x * g_r2, g_qy, 2.0f * q.z * g_r2};
}

// (safe_length(q / r) - 1) amin(r), the gradient of amin split between ties
__device__ V3 ellipsoid_bwd(V3 q, const float *r, float g, float (&g_r)[3]) {
  const V3 qr = {q.x / r[0], q.y / r[1], q.z / r[2]};
  const float s = dot(qr, qr);
  const float len = sqrtf(fmaxf(s, EPS));
  const float mn = fminf(fminf(r[0], r[1]), r[2]);
  const float g_len = g * mn, g_mn = g * (len - 1.0f);
  const float g_s = s >= EPS ? g_len / (2.0f * len) : 0.0f;
  const float ties = (float)((r[0] == mn) + (r[1] == mn) + (r[2] == mn));
  const float qq[3] = {q.x, q.y, q.z}, qrr[3] = {qr.x, qr.y, qr.z};
  float g_q[3];
  for (int k = 0; k < 3; ++k) {
    const float g_qr = 2.0f * qrr[k] * g_s;
    g_q[k] = g_qr / r[k];
    g_r[k] = -g_qr * qq[k] / (r[k] * r[k]) + (r[k] == mn ? g_mn / ties : 0.0f);
  }
  return {g_q[0], g_q[1], g_q[2]};
}

// sd_capsule(p, a, b, r) at the world point p: the cotangents of p (returned), a and b
__device__ V3 capsule_bwd(V3 p, V3 a, V3 b, float g, V3 &g_a, V3 &g_b) {
  const V3 pa = p - a, ba = b - a;
  const float num = dot(pa, ba), ee = dot(ba, ba);
  const float den = fmaxf(ee, 1e-12f);
  const float hr = num / den;
  const float h = fminf(fmaxf(hr, 0.0f), 1.0f);
  const V3 v = pa - ba * h;
  const V3 g_v = len3_bwd(v, g);
  const float g_h = -dot(g_v, ba);
  const float g_hr = (hr >= 0.0f && hr <= 1.0f) ? g_h : 0.0f;  // torch.clamp passes at its bounds
  const float g_num = g_hr / den;
  const float g_ee = ee >= 1e-12f ? -g_hr * num / (den * den) : 0.0f;
  const V3 g_pa = g_v + ba * g_num;
  g_b = g_v * -h + pa * g_num + ba * (2.0f * g_ee);
  g_a = (g_pa + g_b) * -1.0f;
  return g_pa;
}

// the sea's disp(P, phase) = 0.5 + 0.5 cos(P.x + 1.5 phase) sin(P.y + 2 phase)
// sin(P.z + phase) (torch.pow at 1 passes its gradient): the cotangent of P
__device__ __forceinline__ V3 disp_bwd(V3 P, float phase, float g) {
  const float A = P.x + 1.5f * phase, B = P.y + 2.0f * phase, C = P.z + 1.0f * phase;
  const float ca = cosf(A), sa = sinf(A), cb = cosf(B), sb = sinf(B), cc = cosf(C), sc = sinf(C);
  return {-0.5f * g * sa * sb * sc, 0.5f * g * ca * cb * sc, 0.5f * g * ca * sb * cc};
}

// sd_sea_box's sea plane (q.y * -1 + level) - disp(10 q) 0.07 - disp(15 q) 0.03,
// the cotangent of q for the cotangent g of the sea (that of level is g)
__device__ __forceinline__ V3 sea_bwd(V3 q, float g) {
  return V3{0.0f, -g, 0.0f} + disp_bwd(q * 10.0f, 2.5f, -0.07f * g) * 10.0f +
         disp_bwd(q * 15.0f, 4.5f, -0.03f * g) * 15.0f;
}

// siggraph_obj(q) = max(max(d1, d2), -d3)
__device__ V3 siggraph_bwd(V3 q, float g) {
  const V3 ax = {-2.0f / 3.0f, 2.0f / 3.0f, 1.0f / 3.0f};
  const float d1 = dot(q, ax) - 0.1f;
  const float d2 = len3(q) - 1.0f;
  const V3 pc = q - V3{0.0f, -0.2f, -0.2f};
  const V3 w = pc - ax * dot(pc, ax);
  const float nd3 = -(len3(w) - 1.0f);
  const float m12 = fmaxf(d1, d2);
  const float g_m12 = g * dmax(m12, nd3), g_d3 = -g * dmax(nd3, m12);
  const V3 g_w = len3_bwd(w, g_d3);
  const V3 g_pc = g_w - ax * dot(g_w, ax);
  return ax * (g_m12 * dmax(d1, d2)) + len3_bwd(q, g_m12 * dmax(d2, d1)) + g_pc;
}

// menger_sponge(q, box): the cotangent of q for g; that of the box's
// distance in g_box.  Each iteration's c and the running max are
// recomputed, then the chain of torch.maximum is walked back.
__device__ V3 menger_bwd(V3 q, float box, float g, float &g_box) {
  float cs[4], ds[4];
  float d = box, sc = 1.0f;
  for (int it = 0; it < 4; ++it) {
    const V3 ps = q * sc;
    const V3 a = {float_remainder(ps.x, 2.0f) - 1.0f, float_remainder(ps.y, 2.0f) - 1.0f,
                  float_remainder(ps.z, 2.0f) - 1.0f};
    sc = sc * 3.0f;
    const V3 r = {fabsf(1.0f - 3.0f * fabsf(a.x)), fabsf(1.0f - 3.0f * fabsf(a.y)),
                  fabsf(1.0f - 3.0f * fabsf(a.z))};
    const float c = (fminf(fmaxf(r.x, r.y), fminf(fmaxf(r.y, r.z), fmaxf(r.z, r.x))) - 1.0f) / sc;
    ds[it] = d;
    cs[it] = c;
    d = fmaxf(c, d);
  }
  V3 g_q = zero3();
  float g_d = g;
  for (int it = 3; it >= 0; --it) {
    const float g_c = g_d * dmax(cs[it], ds[it]);
    g_d = g_d * dmax(ds[it], cs[it]);
    if (g_c == 0.0f) continue;
    const float s_in = it == 0 ? 1.0f : (it == 1 ? 3.0f : (it == 2 ? 9.0f : 27.0f));
    const V3 ps = q * s_in;
    const float av[3] = {float_remainder(ps.x, 2.0f) - 1.0f, float_remainder(ps.y, 2.0f) - 1.0f,
                         float_remainder(ps.z, 2.0f) - 1.0f};
    float r[3], g_r[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 3; ++k) r[k] = fabsf(1.0f - 3.0f * fabsf(av[k]));
    const float da = fmaxf(r[0], r[1]), db = fmaxf(r[1], r[2]), dc = fmaxf(r[2], r[0]);
    const float mbc = fminf(db, dc);
    const float g_mn = g_c / (s_in * 3.0f);
    const float g_da = g_mn * dmin(da, mbc), g_mbc = g_mn * dmin(mbc, da);
    const float g_db = g_mbc * dmin(db, dc), g_dc = g_mbc * dmin(dc, db);
    g_r[0] += g_da * dmax(r[0], r[1]) + g_dc * dmax(r[0], r[2]);
    g_r[1] += g_da * dmax(r[1], r[0]) + g_db * dmax(r[1], r[2]);
    g_r[2] += g_db * dmax(r[2], r[1]) + g_dc * dmax(r[2], r[0]);
    float g_ps[3];
    for (int k = 0; k < 3; ++k)
      g_ps[k] = g_r[k] * signf(1.0f - 3.0f * fabsf(av[k])) * -3.0f * signf(av[k]);
    g_q = g_q + V3{g_ps[0], g_ps[1], g_ps[2]} * s_in;
  }
  g_box = g_d;
  return g_q;
}

// mandelbulb(q): the cotangent of q.  The forward's three iterations are
// replayed, keeping each live one's input; a lane that is done skips the
// rest (they leave w, m and dz as they are), so no overflow of a dead
// iteration reaches the adjoint (ops/sdf.mandelbulb iterates those on 0).
// The polynomial's adjoint follows its products factor by factor.
__device__ __attribute__((noinline)) V3 mandelbulb_bwd(V3 q, float g) {
  V3 ws[3];
  float ms[3], dzs[3];
  V3 w = q;
  float m = dot(w, w), dz = 1.0f;
  int live = 0;
  for (int it = 0; it < 3; ++it) {
    ws[it] = w;
    ms[it] = m;
    dzs[it] = dz;
    ++live;
    const float m2 = m * m, m4 = m2 * m2;
    dz = 8.0f * sqrtf(fmaxf(m4 * m2 * m, 1e-20f)) * dz + 1.0f;
    const float x = w.x, y = w.y, z = w.z;
    const float x2 = x * x, y2 = y * y, z2 = z * z;
    const float x4 = x2 * x2, y4 = y2 * y2, z4 = z2 * z2;
    const float k3 = x2 + z2;
    const float k3_2 = k3 * k3;
    const float k2 = 1.0f / sqrtf(fmaxf((k3 * k3_2) * (k3_2 * k3_2), 1e-20f));
    const float k1 = x4 + y4 + z4 - 6.0f * y2 * z2 - 6.0f * x2 * y2 + 2.0f * z2 * x2;
    const float k4 = x2 - y2 + z2;
    w = {q.x + 64.0f * x * y * z * (x2 - z2) * k4 * (x4 - 6.0f * x2 * z2 + z4) * k1 * k2,
         q.y + -16.0f * y2 * k3 * k4 * k4 + k1 * k1,
         q.z + -8.0f * y * k4 *
                   (x4 * x4 - 28.0f * x4 * x2 * z2 + 70.0f * x4 * z4 - 28.0f * x2 * z2 * z4 +
                    z4 * z4) *
                   k1 * k2};
    m = dot(w, w);
    if (m > 4.0f) break;
  }
  // d = 0.25 log(ms) sqrt(ms) / dz, ms = clamp_min(m, 1e-12)
  const float mc = fmaxf(m, 1e-12f);
  const float lg = 0.25f * logf(mc), sq = sqrtf(mc);
  const float g_num = g / dz;
  float g_dz = -g * (lg * sq) / (dz * dz);
  float g_m = m >= 1e-12f ? g_num * (0.25f / mc * sq + lg / (2.0f * sq)) : 0.0f;
  V3 g_w = zero3(), g_q = zero3();
  for (int it = live - 1; it >= 0; --it) {
    // the output of iteration `it`: w (m = w.w), dz; its input ws, ms, dzs
    g_w = g_w + w * (2.0f * g_m);
    g_q = g_q + g_w;  // w = q + ...
    const float x = ws[it].x, y = ws[it].y, z = ws[it].z;
    const float x2 = x * x, y2 = y * y, z2 = z * z;
    const float x4 = x2 * x2, y4 = y2 * y2, z4 = z2 * z2;
    const float k3 = x2 + z2;
    const float k3_2 = k3 * k3;
    const float k3_7 = (k3 * k3_2) * (k3_2 * k3_2);
    const float k2 = 1.0f / sqrtf(fmaxf(k3_7, 1e-20f));
    const float k1 = x4 + y4 + z4 - 6.0f * y2 * z2 - 6.0f * x2 * y2 + 2.0f * z2 * x2;
    const float k4 = x2 - y2 + z2;
    const float U = x2 - z2, A = x4 - 6.0f * x2 * z2 + z4;
    const float B = x4 * x4 - 28.0f * x4 * x2 * z2 + 70.0f * x4 * z4 - 28.0f * x2 * z2 * z4 +
                    z4 * z4;
    const float S = 64.0f * x * y * z;
    float gx2 = 0.0f, gy2 = 0.0f, gz2 = 0.0f, gx4 = 0.0f, gy4 = 0.0f, gz4 = 0.0f;
    float gx = 0.0f, gy = 0.0f, gz = 0.0f, gk1 = 0.0f, gk2 = 0.0f, gk3 = 0.0f, gk4 = 0.0f;
    // wx = q.x + S U k4 A k1 k2
    {
      const float t = g_w.x;
      const float gS = t * U * k4 * A * k1 * k2;
      gx += gS * 64.0f * y * z;
      gy += gS * 64.0f * x * z;
      gz += gS * 64.0f * x * y;
      const float gU = t * S * k4 * A * k1 * k2;
      gx2 += gU;
      gz2 -= gU;
      gk4 += t * S * U * A * k1 * k2;
      const float gA = t * S * U * k4 * k1 * k2;
      gx4 += gA;
      gz4 += gA;
      gx2 += -6.0f * z2 * gA;
      gz2 += -6.0f * x2 * gA;
      gk1 += t * S * U * k4 * A * k2;
      gk2 += t * S * U * k4 * A * k1;
    }
    // wy = q.y + -16 y2 k3 k4 k4 + k1 k1
    {
      const float t = g_w.y;
      gy2 += t * -16.0f * k3 * k4 * k4;
      gk3 += t * -16.0f * y2 * k4 * k4;
      gk4 += t * -16.0f * y2 * k3 * 2.0f * k4;
      gk1 += t * 2.0f * k1;
    }
    // wz = q.z + -8 y k4 B k1 k2
    {
      const float t = g_w.z;
      gy += t * -8.0f * k4 * B * k1 * k2;
      gk4 += t * -8.0f * y * B * k1 * k2;
      const float gB = t * -8.0f * y * k4 * k1 * k2;
      gx4 += gB * (2.0f * x4 - 28.0f * x2 * z2 + 70.0f * z4);
      gx2 += gB * (-28.0f * x4 * z2 - 28.0f * z2 * z4);
      gz2 += gB * (-28.0f * x4 * x2 - 28.0f * x2 * z4);
      gz4 += gB * (70.0f * x4 - 28.0f * x2 * z2 + 2.0f * z4);
      gk1 += t * -8.0f * y * k4 * B * k2;
      gk2 += t * -8.0f * y * k4 * B * k1;
    }
    // k2 = 1 / sqrt(max(k3^7, 1e-20)), k3^7 = (k3 k3_2)(k3_2 k3_2)
    if (k3_7 >= 1e-20f) {
      const float g7 = -gk2 * k2 * k2 / (2.0f * sqrtf(k3_7));
      const float ga = g7 * (k3_2 * k3_2), gb = g7 * (k3 * k3_2);
      const float gk3_2 = ga * k3 + gb * 2.0f * k3_2;
      gk3 += ga * k3_2 + gk3_2 * 2.0f * k3;
    }
    gx2 += gk3;
    gz2 += gk3;
    gx2 += gk4;
    gy2 -= gk4;
    gz2 += gk4;
    gx4 += gk1;
    gy4 += gk1;
    gz4 += gk1;
    gy2 += gk1 * (-6.0f * z2 - 6.0f * x2);
    gz2 += gk1 * (-6.0f * y2 + 2.0f * x2);
    gx2 += gk1 * (-6.0f * y2 + 2.0f * z2);
    gx2 += 2.0f * x2 * gx4;
    gy2 += 2.0f * y2 * gy4;
    gz2 += 2.0f * z2 * gz4;
    gx += 2.0f * x * gx2;
    gy += 2.0f * y * gy2;
    gz += 2.0f * z * gz2;
    // dz' = 8 sqrt(max(m^7, 1e-20)) dz + 1, m^7 = (m4 m2) m
    const float mi = ms[it], m2 = mi * mi, m4 = m2 * m2, m7 = m4 * m2 * mi;
    const float sq7 = sqrtf(fmaxf(m7, 1e-20f));
    float g_mi = 0.0f;
    if (m7 >= 1e-20f) {
      const float g7 = g_dz * 8.0f * dzs[it] / (2.0f * sq7);
      const float g42 = g7 * mi;
      const float g_m4 = g42 * m2;
      const float g_m2 = g42 * m4 + 2.0f * m2 * g_m4;
      g_mi = g7 * (m4 * m2) + 2.0f * mi * g_m2;
    }
    g_dz = g_dz * 8.0f * sq7;
    // the input: w = ws[it], m = ms[it] = ws[it].ws[it]
    g_w = {gx, gy, gz};
    g_m = g_mi;
    w = ws[it];
  }
  // iteration 0's input is q itself, m = q.q, dz = 1
  return g_q + g_w + q * (2.0f * g_m);
}

// ud_triangle(q, a, b, c) and ud_quad(q, a, b, c, d): the cotangent of q;
// those of the vertices in g_v.  _edge_dist2(edge, pv) first.
__device__ __forceinline__ void edge_dist2_bwd(V3 edge, V3 pv, float g, V3 &g_edge, V3 &g_pv) {
  const float ee = dot(edge, edge), num = dot(edge, pv);
  const float den = fmaxf(ee, 1e-12f);
  const float hr = num / den;
  const float h = fminf(fmaxf(hr, 0.0f), 1.0f);
  const V3 v = edge * h - pv;
  const V3 g_vv = v * (2.0f * g);
  const float g_h = dot(g_vv, edge);
  const float g_hr = (hr >= 0.0f && hr <= 1.0f) ? g_h : 0.0f;
  const float g_num = g_hr / den;
  const float g_ee = ee >= 1e-12f ? -g_hr * num / (den * den) : 0.0f;
  g_edge = g_edge + g_vv * h + pv * g_num + edge * (2.0f * g_ee);
  g_pv = g_pv - g_vv + edge * g_num;
}

// the face branch dn dn / max(nor.nor, 1e-12), dn = nor.pa, for its cotangent g
__device__ __forceinline__ void face_bwd(V3 nor, V3 pa, float g, V3 &g_nor, V3 &g_pa) {
  const float dn = dot(nor, pa), nn = dot(nor, nor);
  const float den = fmaxf(nn, 1e-12f);
  const float g_dn = 2.0f * dn * (g / den);
  const float g_nn = nn >= 1e-12f ? -g * dn * dn / (den * den) : 0.0f;
  g_nor = g_nor + pa * g_dn + nor * (2.0f * g_nn);
  g_pa = g_pa + nor * g_dn;
}

// d cross(a, b) for its cotangent g: a gets cross(b, g), b cross(g, a)
__device__ __forceinline__ void cross_bwd(V3 a, V3 b, V3 g, V3 &g_a, V3 &g_b) {
  g_a = g_a + cross(b, g);
  g_b = g_b + cross(g, a);
}

template <int N>
__device__ V3 polygon_bwd(V3 q, const V3 (&v)[N], float g, V3 (&g_v)[N]) {
  V3 e[N], pv[N], g_e[N], g_pv[N];
  for (int i = 0; i < N; ++i) {
    e[i] = v[(i + 1) % N] - v[i];  // ba, cb, (dc,) then the closing edge
    pv[i] = q - v[i];
    g_e[i] = g_pv[i] = zero3();
  }
  // the triangle's normal is cross(ba, ac), the quad's cross(ba, ad): the
  // closing edge in both
  const V3 nor = cross(e[0], e[N - 1]);
  float sgn = 0.0f;
  for (int i = 0; i < N; ++i) sgn += signf(dot(cross(e[i], nor), pv[i]));
  const bool edge_region = sgn < (float)(N - 1);
  float d2[N];
  for (int i = 0; i < N; ++i) d2[i] = edge_dist2(e[i], pv[i]);
  float val;
  if (edge_region) {
    val = N == 3 ? fminf(fminf(d2[0], d2[1]), d2[2]) : fminf(fminf(d2[0], d2[1]), fminf(d2[2], d2[N - 1]));
  } else {
    const float dn = dot(nor, pv[0]);
    val = dn * dn / fmaxf(dot(nor, nor), 1e-12f);
  }
  const float g_val = val > 0.0f ? g / (2.0f * sqrtf(val)) : 0.0f;
  if (edge_region) {
    float g_d[N];
    if (N == 3) {
      const float m1 = fminf(d2[0], d2[1]);
      const float g_m1 = g_val * dmin(m1, d2[2]);
      g_d[2] = g_val * dmin(d2[2], m1);
      g_d[0] = g_m1 * dmin(d2[0], d2[1]);
      g_d[1] = g_m1 * dmin(d2[1], d2[0]);
    } else {
      const float m1 = fminf(d2[0], d2[1]), m2 = fminf(d2[2], d2[N - 1]);
      const float g_m1 = g_val * dmin(m1, m2), g_m2 = g_val * dmin(m2, m1);
      g_d[0] = g_m1 * dmin(d2[0], d2[1]);
      g_d[1] = g_m1 * dmin(d2[1], d2[0]);
      g_d[2] = g_m2 * dmin(d2[2], d2[N - 1]);
      g_d[N - 1] = g_m2 * dmin(d2[N - 1], d2[2]);
    }
    for (int i = 0; i < N; ++i)
      if (g_d[i] != 0.0f) edge_dist2_bwd(e[i], pv[i], g_d[i], g_e[i], g_pv[i]);
  } else {
    V3 g_nor = zero3();
    face_bwd(nor, pv[0], g_val, g_nor, g_pv[0]);
    cross_bwd(e[0], e[N - 1], g_nor, g_e[0], g_e[N - 1]);
  }
  V3 g_q = zero3();
  for (int i = 0; i < N; ++i) {
    g_q = g_q + g_pv[i];
    g_v[i] = g_pv[i] * -1.0f - g_e[i] + g_e[(i + N - 1) % N];
  }
  return g_q;
}

// d sdf_entry_all / d(p, the row's pos, joker, aux) of SDF row `row` of
// shape `shape` at p, times g: returns the cotangent of p and adds the
// row's into G, only into the columns the shape reads
// (megakernel.bwd_columns keeps those).
template <class Acc>
__device__ V3 sdf_entry_all_bwd(const SceneSmem &s, int row, int shape, V3 p, float g,
                                const float *lut, int lut_n, const Acc &G) {
  const V3 q = p - s.p(row);
  const float *j = s.col(row, C_J0);
  V3 g_q;
  switch (shape) {
    case SDF_BOX:
      return sd_box_bwd(s, row, p, g, G);
    case SDF_ROUND_BOX:
      return round_box_bwd(s, row, p, g, G);
    case SDF_SPHERE:
      g_q = len3_bwd(q, g);
      G.add(row, C_J0, -g);
      break;
    case SDF_TRI_PRISM: {
      float g_h0, g_h1;
      g_q = tri_prism_bwd(q, j, g, g_h0, g_h1);
      G.add(row, C_J0, g_h0);
      G.add(row, C_J0 + 1, g_h1);
      break;
    }
    case SDF_CONE: {
      float g_c[3];
      g_q = cone_bwd(q, j, g, g_c);
      G.add3(row, C_J0, {g_c[0], g_c[1], g_c[2]});
      break;
    }
    case SDF_MENGER: {
      float g_box;
      g_q = menger_bwd(q, sdf_entry(s, row, SDF_BOX, p), g, g_box);
      G.add3(row, C_PX, g_q * -1.0f);
      return g_q + sd_box_bwd(s, row, p, g_box, G);  // adds the box's pos and joker
    }
    case SDF_MANDELBULB:
      g_q = mandelbulb_bwd(q, g);
      break;
    case SDF_ELLIPSOID: {
      float g_r[3];
      g_q = ellipsoid_bwd(q, j, g, g_r);
      G.add3(row, C_J0, {g_r[0], g_r[1], g_r[2]});
      break;
    }
    case SDF_CAPSULE: {
      V3 g_a, g_b;
      const V3 g_p = capsule_bwd(p, s.p(row), V3{j[0], j[1], j[2]}, g, g_a, g_b);
      G.add3(row, C_PX, g_a);
      G.add3(row, C_J0, g_b);
      G.add(row, C_J0 + 3, -g);
      return g_p;
    }
    case SDF_SNOWBALL:
      g_q = len3_bwd(q, g) + value_noise_bwd(lut, lut_n, q * 8.0f, -0.04f * g) * 8.0f;
      G.add(row, C_J0, -g);
      break;
    case SDF_SEA_BOX: {
      const float box = sdf_entry(s, row, SDF_BOX, p);
      const float sea = (q.x * 0.0f + q.y * -1.0f + q.z * 0.0f + j[3]) -
                        disp(q * 10.0f, 2.5f) * 0.07f - disp(q * 15.0f, 4.5f) * 0.03f;
      const float g_sea = -g * dmax(-sea, box), g_box = g * dmax(box, -sea);
      G.add(row, C_J0 + 3, g_sea);
      g_q = sea_bwd(q, g_sea);
      G.add3(row, C_PX, g_q * -1.0f);
      return g_q + sd_box_bwd(s, row, p, g_box, G);
    }
    case SDF_SIGGRAPH:
      g_q = siggraph_bwd(q, g);
      break;
    case SDF_TRIANGLE: {
      const float *ax = s.col(row, C_AUX);
      const V3 v[3] = {{ax[0], ax[1], ax[2]}, {ax[3], ax[4], ax[5]}, {ax[6], ax[7], ax[8]}};
      V3 g_v[3];
      g_q = polygon_bwd<3>(q, v, g, g_v);
      for (int i = 0; i < 3; ++i) G.add3(row, C_AUX + 3 * i, g_v[i]);
      break;
    }
    default: {  // SDF_QUAD
      const float *ax = s.col(row, C_AUX);
      const V3 v[4] = {{ax[0], ax[1], ax[2]}, {ax[3], ax[4], ax[5]}, {ax[6], ax[7], ax[8]},
                       {ax[9], ax[10], ax[11]}};
      V3 g_v[4];
      g_q = polygon_bwd<4>(q, v, g, g_v);
      for (int i = 0; i < 4; ++i) G.add3(row, C_AUX + 3 * i, g_v[i]);
      break;
    }
  }
  G.add3(row, C_PX, g_q * -1.0f);
  return g_q;
}

// The adjoint of sdf_map_all (the scene map of the whole SDF class) at p
// for its cotangent g: returns the cotangent of p and adds the rows' into
// G, the gradient split at ties as sdf_map_bwd<true> splits it.  Not
// inlined, as sdf_map_all is not.
template <class Acc>
__device__ __attribute__((noinline)) V3 sdf_map_all_bwd(const SceneSmem &s, const SdfScene &sd,
                                                        V3 p, float g, const float *lut, int lut_n,
                                                        const Acc &G) {
  float best = sdf_entry_all(s, sd.first, sd.shape[0], p, lut, lut_n);
  int k = 0, ties = 1;
  for (int i = 1; i < sd.count; ++i) {
    const float d = sdf_entry_all(s, sd.first + i, sd.shape[i], p, lut, lut_n);
    if (d < best) {
      best = d;
      k = i;
      ties = 1;
    } else if (d == best) {
      ++ties;
    }
  }
  if (ties == 1) return sdf_entry_all_bwd(s, sd.first + k, sd.shape[k], p, g, lut, lut_n, G);
  V3 gp = zero3();
  float gr = g;
  for (int i = sd.count - 1; i >= k; --i) {
    if (!(sdf_entry_all(s, sd.first + i, sd.shape[i], p, lut, lut_n) == best)) continue;
    --ties;
    const float gi = ties > 0 ? 0.5f * gr : gr;
    gp = gp + sdf_entry_all_bwd(s, sd.first + i, sd.shape[i], p, gi, lut, lut_n, G);
    if (ties == 0) break;
    gr = gr - gi;
  }
  return gp;
}

// The SDF rows' distance at p (sdf_map) times g.  kShapes = false (K7's
// ROUND_BOX copy): ROUND_BOX rows, the nearest entry's cotangents (the
// first on a tie, as the forward's winner).  kShapes = true (K2): BOX and ROUND_BOX rows, the
// gradient split at ties as the plain version's chain of torch.minimum
// splits it: the last of r tied entries takes half, the one before it a
// quarter, ..., the first two 1/2^(r-1) each.
template <bool kShapes = false, class Acc>
__device__ V3 sdf_map_bwd(const SceneSmem &s, const SdfScene &sd, V3 p, float g, const Acc &G) {
  int k;
  const float best = sdf_map(s, sd, p, k);
  if constexpr (!kShapes) {
    return round_box_bwd(s, sd.first + k, p, g, G);
  } else {
    auto entry_bwd = [&](int i, float gi) {
      return sd.shape[i] == SDF_ROUND_BOX ? round_box_bwd(s, sd.first + i, p, gi, G)
                                          : sd_box_bwd(s, sd.first + i, p, gi, G);
    };
    if (sd.count == 1) return entry_bwd(0, g);
    int ties = 0;
    for (int i = k; i < sd.count; ++i) ties += sdf_entry(s, sd.first + i, sd.shape[i], p) == best;
    V3 gp = zero3();
    float gr = g;
    for (int i = sd.count - 1; i >= k; --i) {
      if (!(sdf_entry(s, sd.first + i, sd.shape[i], p) == best)) continue;
      --ties;
      const float gi = ties > 0 ? 0.5f * gr : gr;
      gp = gp + entry_bwd(i, gi);
      if (ties == 0) break;
      gr = gr - gi;
    }
    return gp;
  }
}

// The scene map's adjoint at p for its cotangent g: sdf_map_bwd<kShapes>,
// or with kAll (the whole-SDF copies of K2 and K7) sdf_map_all_bwd with
// the value-noise LUT of a SNOWBALL.
template <bool kShapes, bool kAll, class Acc>
__device__ __forceinline__ V3 scene_map_bwd(const SceneSmem &s, const SdfScene &sd, V3 p, float g,
                                            const Acc &G, const float *lut, int lut_n) {
  if constexpr (kAll)
    return sdf_map_all_bwd(s, sd, p, g, lut, lut_n, G);
  else
    return sdf_map_bwd<kShapes>(s, sd, p, g, G);
}

// sdf_normal(p) = normalize(sum_i tap_i f(p + tap_i eps)) for its cotangent
// g_n: returns the cotangent of p.  kAll: the whole SDF class.
template <bool kShapes = false, bool kAll = false, class Acc>
__device__ V3 sdf_normal_bwd(const SceneSmem &s, const SdfScene &sd, V3 p, float eps, V3 g_n,
                             const Acc &G, const float *lut = nullptr, int lut_n = 0) {
  const V3 taps[4] = {{1.0f, -1.0f, -1.0f}, {-1.0f, -1.0f, 1.0f}, {-1.0f, 1.0f, -1.0f},
                      {1.0f, 1.0f, 1.0f}};
  V3 n = {0.0f, 0.0f, 0.0f};
  int k;
  for (int i = 0; i < 4; ++i)
    n = n + taps[i] * sdf_map<kAll>(s, sd, p + taps[i] * eps, k, lut, lut_n);
  const V3 g_raw = normalize_bwd(n, g_n);
  V3 g_p = zero3();
  for (int i = 0; i < 4; ++i)
    g_p = g_p + scene_map_bwd<kShapes, kAll>(s, sd, p + taps[i] * eps, dot(g_raw, taps[i]), G,
                                             lut, lut_n);
  return g_p;
}

// An SDF hit's t, reattached as in ops/sdf.march: the march runs without a
// gradient, and t = t* - (f(x*) - sg f(x*)) / sg(df/dt) at x* = o + d t*,
// with df/dt the central difference at x* along d (step eps, `two_eps` =
// f32(2 eps)), floored to +-0.05.  Adds the cotangents of o and d for the
// cotangent g_t of t.  kAll: the whole SDF class.
template <bool kShapes = false, bool kAll = false, class Acc>
__device__ void sdf_t_bwd(const SceneSmem &s, const SdfScene &sd, V3 o, V3 d, float t, float eps,
                          float two_eps, float g_t, V3 &g_o, V3 &g_d, const Acc &G,
                          const float *lut = nullptr, int lut_n = 0) {
  const V3 xs = o + d * t;
  int k;
  const float f_fwd = sdf_map<kAll>(s, sd, xs + d * eps, k, lut, lut_n);
  const float f_bwd = sdf_map<kAll>(s, sd, xs - d * eps, k, lut, lut_n);
  float dfdt = (f_fwd - f_bwd) / two_eps;
  if (fabsf(dfdt) < 0.05f) dfdt = dfdt < 0.0f ? -0.05f : 0.05f;
  const V3 g_xs = scene_map_bwd<kShapes, kAll>(s, sd, xs, -g_t / dfdt, G, lut, lut_n);
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

// The direction of a BSDF sample (bsdf_sample, whose result is `b`, at a
// hit of mesh `idx` with incoming direction d, oriented normal nl, clamped
// emission e, `inside`, draws u1, u2) for the cotangent gd of b.d: adds the
// cotangents of d, nl and the mesh's IOR (under refraction).  A diffuse
// sample is random_direction(nl); a glossy one normalize(e rand_dir +
// reflect(d, nl)) or normalize(e rand_dir + refract(d, nl, eta)), where the
// emission bends the direction detached, as in the plain version.  The
// IOR enters as max(|ior|, 1e-3), whose gradient passes at the floor.
// kMedium (K2's medium copy): under `spectral` a negative IOR enters as
// Cauchy's max(|ior| + 0.04 / max(lu^2, 1e-6), 1e-3) at the hero
// wavelength `hero_wl` (lu its micrometres), whose d/d ior is -1.
template <bool kMedium = false, class Acc>
__device__ __forceinline__ void bounce_dir_bwd(const SceneSmem &s, int idx, const Bounce &b, V3 d,
                                               V3 nl, V3 e, float inside, float u1, float u2,
                                               bool biased, V3 gd, V3 &g_d, V3 &g_nl,
                                               const Acc &G, bool spectral = false,
                                               float hero_wl = 0.0f) {
  if (!b.specular) {
    g_nl = g_nl + random_direction_bwd(nl, u1, u2, biased, gd);
    return;
  }
  const bool transmit = b.scat != 0;
  const V3 rand_dir = random_direction(nl, u1, u2, biased);
  V3 raw;
  float nt = 0.0f, nnt = 0.0f;
  bool cauchy = false;  // kMedium: the IOR is Cauchy's at the hero wavelength
  float nt_raw = 0.0f;
  if (transmit) {
    nt = fmaxf(fabsf(s.ior(idx)), 1e-3f);
    if constexpr (kMedium) {
      const float ior = s.ior(idx);
      if (spectral && ior < 0.0f) {
        const float lu = hero_wl * 0.001f;
        nt_raw = fabsf(ior) + 0.04f / fmaxf(lu * lu, 1e-6f);
        nt = fmaxf(nt_raw, 1e-3f);
        cauchy = true;
      }
    }
    nnt = inside > 0.0f ? IOR_AIR / nt : nt / IOR_AIR;
    bool tir;
    raw = refract(d, nl, nnt, tir);
  } else {
    raw = reflect(d, nl);
  }
  const V3 g_v = normalize_bwd(e * rand_dir + raw, gd);
  g_nl = g_nl + random_direction_bwd(nl, u1, u2, biased, e * g_v);
  if (transmit) {
    float g_eta = 0.0f;
    refract_bwd(d, nl, nnt, g_v, g_d, g_nl, g_eta);
    const float g_nt = inside > 0.0f ? -g_eta * IOR_AIR / (nt * nt) : g_eta / IOR_AIR;
    const float ior = s.ior(idx);
    if (cauchy) {
      if (nt_raw >= 1e-3f) G.add(idx, C_IOR, -g_nt);
    } else if (fabsf(ior) >= 1e-3f) {
      G.add(idx, C_IOR, g_nt * signf(ior));
    }
  } else {
    reflect_bwd(d, nl, g_v, g_d, g_nl);
  }
}

// sample_cubemap(d) for the cotangent g of its texel: the cotangent of d.
// The face is a discrete choice; within it the major axis |d_k| (floored
// at 1e-9) divides the two minor components, whose bilinear weights in
// the clamped texel grid carry the gradient (the clamps pass it at their
// bounds, as torch.clamp does).
__device__ V3 cubemap_bwd(const float *__restrict__ cube, int ch, int cw, V3 d, V3 g) {
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  int face, axis;
  float ma_raw, sc, tc;
  if (ax >= ay && ax >= az) {
    face = d.x > 0.0f ? 0 : 1;
    axis = 0;
    ma_raw = ax;
    sc = d.x > 0.0f ? -d.z : d.z;
    tc = -d.y;
  } else if (ay > ax && ay >= az) {
    face = d.y > 0.0f ? 2 : 3;
    axis = 1;
    ma_raw = ay;
    sc = d.x;
    tc = d.y > 0.0f ? d.z : -d.z;
  } else {
    face = d.z > 0.0f ? 4 : 5;
    axis = 2;
    ma_raw = az;
    sc = d.z > 0.0f ? d.x : -d.x;
    tc = -d.y;
  }
  const float ma = fmaxf(ma_raw, 1e-9f);
  const float u = 0.5f * (sc / ma + 1.0f), v = 0.5f * (tc / ma + 1.0f);
  const float xr = u * (float)cw - 0.5f, yr = v * (float)ch - 0.5f;
  const float xp = fminf(fmaxf(xr, 0.0f), (float)(cw - 1));
  const float yp = fminf(fmaxf(yr, 0.0f), (float)(ch - 1));
  const int x0 = (int)floorf(xp), y0 = (int)floorf(yp);
  const int x1 = x0 + 1 < cw ? x0 + 1 : cw - 1, y1 = y0 + 1 < ch ? y0 + 1 : ch - 1;
  const float fx = xp - (float)x0, fy = yp - (float)y0;
  const float *f = cube + (size_t)face * ch * cw * 3;
  auto texel = [&](int y, int x) -> V3 {
    const float *t = f + ((size_t)y * cw + x) * 3;
    return {__ldg(t), __ldg(t + 1), __ldg(t + 2)};
  };
  const V3 t00 = texel(y0, x0), t01 = texel(y0, x1), t10 = texel(y1, x0), t11 = texel(y1, x1);
  const float g_fx = dot(g, (t01 - t00) * (1.0f - fy) + (t11 - t10) * fy);
  const float g_fy = dot(g, (t10 * (1.0f - fx) + t11 * fx) - (t00 * (1.0f - fx) + t01 * fx));
  const float g_u = (xr >= 0.0f && xr <= (float)(cw - 1)) ? g_fx * (float)cw : 0.0f;
  const float g_v = (yr >= 0.0f && yr <= (float)(ch - 1)) ? g_fy * (float)ch : 0.0f;
  const float g_sc = 0.5f * g_u / ma, g_tc = 0.5f * g_v / ma;
  const float g_ma = ma_raw >= 1e-9f ? -(0.5f * g_u * sc + 0.5f * g_v * tc) / (ma * ma) : 0.0f;
  if (axis == 0) return {g_ma * signf(d.x), -g_tc, d.x > 0.0f ? -g_sc : g_sc};
  if (axis == 1) return {g_sc, g_ma * signf(d.y), d.y > 0.0f ? g_tc : -g_tc};
  return {d.z > 0.0f ? g_sc : -g_sc, -g_tc, g_ma * signf(d.z)};
}

// ------------------------------------------------------------ textures
// torch.div(a, b, rounding_mode="floor") on floats, ATen's rule: the
// gradient of torch.remainder(a, b) with respect to b is -that.
__device__ __forceinline__ float div_floor(float a, float b) {
  if (b == 0.0f) return a / b;
  const float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div -= 1.0f;
  if (div == 0.0f) return copysignf(0.0f, a / b);
  float fl = floorf(div);
  if (div - fl > 0.5f) fl += 1.0f;
  return fl;
}

// The UV of a hit at x (intersect.parse_hit: spherical from the world
// position on a sphere, else planar by the dominant axis of the normal n,
// a discrete choice) for the cotangents (g_u, g_v): the cotangent of x.
__device__ V3 uv_bwd(int mesh, V3 x, V3 n, float g_u, float g_v) {
  if (mesh == MESH_SPHERE) {
    // u = asin(clamp(y / rho, -0.999999, 0.999999)) / PI, v = atan2(z, x) / TWO_PI
    const float ss = dot(x, x);
    const float rho = sqrtf(fmaxf(ss, EPS));
    const float yr = x.y / rho;
    const float cl = fminf(fmaxf(yr, -0.999999f), 0.999999f);
    const float g_cl = (g_u / PI) / sqrtf(1.0f - cl * cl);
    const float g_yr = (yr >= -0.999999f && yr <= 0.999999f) ? g_cl : 0.0f;
    const float g_rho = -g_yr * x.y / (rho * rho);
    const float g_ss = ss >= EPS ? g_rho / (2.0f * rho) : 0.0f;
    const float g_th = g_v / TWO_PI;
    const float r2 = x.x * x.x + x.z * x.z;
    return {2.0f * x.x * g_ss - g_th * x.z / r2, g_yr / rho + 2.0f * x.y * g_ss,
            2.0f * x.z * g_ss + g_th * x.x / r2};
  }
  const float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
  if (ax > ay && ax > az) return {0.0f, -g_v, -g_u};  // (-z, -y)
  if (ay > ax && ay > az) return {g_u, 0.0f, g_v};    // (x, z)
  return {g_u, -g_v, 0.0f};                           // (x, -y)
}

// bilinear_wrap at (uu, vv) for the cotangent g of its four channels:
// the cotangents of uu and vv (the wrap and the cell index carry none).
__device__ void bilinear_wrap_bwd(const float *__restrict__ img, int h, int w, float uu, float vv,
                                  V4 g, float &g_u, float &g_v) {
  const float u = uu - floorf(uu), v = vv - floorf(vv);
  const float x = u * (float)w - 0.5f, y = v * (float)h - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int x0 = wrap((int)x0f, w), y0 = wrap((int)y0f, h);
  const int x1 = wrap(x0 + 1, w), y1 = wrap(y0 + 1, h);
  const float *t00 = img + ((size_t)y0 * w + x0) * 4, *t01 = img + ((size_t)y0 * w + x1) * 4;
  const float *t10 = img + ((size_t)y1 * w + x0) * 4, *t11 = img + ((size_t)y1 * w + x1) * 4;
  const float gk[4] = {g.x, g.y, g.z, g.w};
  float g_fx = 0.0f, g_fy = 0.0f;
  for (int k = 0; k < 4; ++k) {
    const float c00 = __ldg(t00 + k), c01 = __ldg(t01 + k);
    const float c10 = __ldg(t10 + k), c11 = __ldg(t11 + k);
    g_fx += gk[k] * ((c01 - c00) * (1.0f - fy) + (c11 - c10) * fy);
    g_fy += gk[k] * ((c10 * (1.0f - fx) + c11 * fx) - (c00 * (1.0f - fx) + c01 * fx));
  }
  g_u = g_fx * (float)w;
  g_v = g_fy * (float)h;
}

// d/df of the smoothstep weight f f (3 - 2 f) of the noise functions,
// 6 f (1 - f), in the form that keeps its precision where it vanishes
__device__ __forceinline__ float fade_bwd(float f) { return 6.0f * f * (1.0f - f); }

// gradient_noise(p) for its cotangent g: the cotangent of p (the hashed
// corner gradients are constant within a cell).
__device__ V3 gradient_noise_bwd(V3 p, float g) {
  const V3 i = {floorf(p.x), floorf(p.y), floorf(p.z)};
  const V3 f = p - i;
  const V3 u = {f.x * f.x * (3.0f - 2.0f * f.x), f.y * f.y * (3.0f - 2.0f * f.y),
                f.z * f.z * (3.0f - 2.0f * f.z)};
  V3 hs[8];
  float gv[8];
  for (int c = 0; c < 8; ++c) {  // corner c = (c & 1, c >> 1 & 1, c >> 2 & 1)
    const V3 off = {(float)(c & 1), (float)((c >> 1) & 1), (float)((c >> 2) & 1)};
    hs[c] = gradient_hash(i + off);
    gv[c] = dot(hs[c], f - off);
  }
  const float a = mix1(gv[0], gv[1], u.x), b = mix1(gv[2], gv[3], u.x);
  const float cc = mix1(gv[4], gv[5], u.x), dd = mix1(gv[6], gv[7], u.x);
  const float e1 = mix1(a, b, u.y), e2 = mix1(cc, dd, u.y);
  const float g_e1 = g * (1.0f - u.z), g_e2 = g * u.z;
  const float g_uz = g * (e2 - e1);
  const float g_lo[4] = {g_e1 * (1.0f - u.y), g_e1 * u.y, g_e2 * (1.0f - u.y), g_e2 * u.y};
  const float g_uy = g_e1 * (b - a) + g_e2 * (dd - cc);
  float g_ux = 0.0f;
  V3 g_f = zero3();
  for (int q = 0; q < 4; ++q) {
    g_ux += g_lo[q] * (gv[2 * q + 1] - gv[2 * q]);
    g_f = g_f + hs[2 * q] * (g_lo[q] * (1.0f - u.x)) + hs[2 * q + 1] * (g_lo[q] * u.x);
  }
  return g_f + V3{g_ux * fade_bwd(f.x), g_uy * fade_bwd(f.y), g_uz * fade_bwd(f.z)};
}

// value_noise(lut, x) for its cotangent g: the cotangent of x.
__device__ V3 value_noise_bwd(const float *__restrict__ lut, int n, V3 x, float g) {
  const V3 p = {floorf(x.x), floorf(x.y), floorf(x.z)};
  const V3 f0 = x - p;
  const V3 f = {f0.x * f0.x * (3.0f - 2.0f * f0.x), f0.y * f0.y * (3.0f - 2.0f * f0.y),
                f0.z * f0.z * (3.0f - 2.0f * f0.z)};
  const float u = (p.x + 37.0f * p.z) + f.x, v = (p.y + 17.0f * p.z) + f.y;
  const float x0f = floorf(u), y0f = floorf(v);
  const float fx = u - x0f, fy = v - y0f;
  const int x0 = wrap((int)x0f, n), y0 = wrap((int)y0f, n);
  const int x1 = wrap(x0 + 1, n), y1 = wrap(y0 + 1, n);
  float val[2], dfx[2], dfy[2];
  for (int ch = 0; ch < 2; ++ch) {  // channel 1 (g), then 0 (r)
    const int c = 1 - ch;
    const float c00 = __ldg(lut + ((size_t)y0 * n + x0) * 4 + c);
    const float c01 = __ldg(lut + ((size_t)y0 * n + x1) * 4 + c);
    const float c10 = __ldg(lut + ((size_t)y1 * n + x0) * 4 + c);
    const float c11 = __ldg(lut + ((size_t)y1 * n + x1) * 4 + c);
    const float top = c00 * (1.0f - fx) + c01 * fx, bot = c10 * (1.0f - fx) + c11 * fx;
    val[ch] = top * (1.0f - fy) + bot * fy;
    dfx[ch] = (c01 - c00) * (1.0f - fy) + (c11 - c10) * fy;
    dfy[ch] = bot - top;
  }
  // value = g_ch + (r_ch - g_ch) f.z
  const float g_g = g * (1.0f - f.z), g_r = g * f.z;
  return {(g_g * dfx[0] + g_r * dfx[1]) * fade_bwd(f0.x),
          (g_g * dfy[0] + g_r * dfy[1]) * fade_bwd(f0.y), g * (val[1] - val[0]) * fade_bwd(f0.z)};
}

// metal_fbm(lut, q) for its cotangent g: the cotangent of q.
__device__ V3 metal_fbm_bwd(const float *__restrict__ lut, int n, V3 q0, float g) {
  const V3 m = {-1.2f, 1.99f, -1.6f};
  const V3 q1 = m * q0 * 2.01f;
  const V3 q2 = m * q1 * 2.02f;
  const V3 g2 = value_noise_bwd(lut, n, q2, 0.125f * g);
  const V3 g1 = value_noise_bwd(lut, n, q1, 0.25f * g) + g2 * 2.02f * m;
  return value_noise_bwd(lut, n, q0, 0.5f * g) + g1 * 2.01f * m;
}

// get_texel of a hit of mesh `idx` (texture type t, mesh type `mesh`,
// params tp) at x with geometric normal n, for the cotangent g of its four
// channels: returns the cotangent of x and adds the params' (columns
// 26:30) into G.  An image texel reaches x through its UV; a CHECK or
// RIPPLE texel is piecewise constant in the UV, and its params reach it
// only through the divisor of torch.remainder (tp[2], tp[3]); the noise
// types reach x and tp[0:3] through scaled = tp[0:3] x.  A VORONOI
// texel's alpha is 0, so no blend reads it and it has no cotangent.
template <class Acc>
__device__ V3 texel_bwd(int idx, int t, int mesh, const float *tp, V3 x, V3 n,
                        const float *__restrict__ images, int img_h, int img_w,
                        const float *__restrict__ lut, int lut_n, V4 g, const Acc &G) {
  if (t < 0 || t > TEX_METAL || t == TEX_VORONOI) return zero3();
  const float g_val = g.x + g.y + g.z + g.w;
  if (t <= TEX_IMAGE3 || t == TEX_CHECK || t == TEX_RIPPLE) {
    float uu, vv;
    if (mesh == MESH_SPHERE) {
      const float rho = sqrtf(fmaxf(dot(x, x), EPS));
      const float phi = asinf(fminf(fmaxf(x.y / rho, -0.999999f), 0.999999f));
      uu = phi / PI;
      vv = atan2f(x.z, x.x) / TWO_PI;
    } else {
      const float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
      const bool x_dom = ax > ay && ax > az, y_dom = ay > ax && ay > az;
      uu = x_dom ? -x.z : x.x;
      vv = x_dom ? -x.y : (y_dom ? x.z : -x.y);
    }
    if (t <= TEX_IMAGE3) {
      float g_u, g_v;
      bilinear_wrap_bwd(images + (size_t)t * img_h * img_w * 4, img_h, img_w, uu, vv, g, g_u, g_v);
      return uv_bwd(mesh, x, n, g_u, g_v);
    }
    if (t == TEX_CHECK) {
      if (tp[2] >= 1e-6f)
        G.add(idx, C_TP + 2, -g_val * div_floor(floorf(tp[0] * uu) + floorf(tp[1] * vv),
                                                fmaxf(tp[2], 1e-6f)));
    } else {
      const float du = uu - tp[0], dv = vv - tp[1];
      if (tp[3] >= 1e-6f)
        G.add(idx, C_TP + 3, -g_val * div_floor(ceilf(sqrtf(du * du + dv * dv) * tp[2]),
                                                fmaxf(tp[3], 1e-6f)));
    }
    return zero3();
  }
  const V3 scaled = {tp[0] * x.x, tp[1] * x.y, tp[2] * x.z};
  V3 g_s;
  if (t == TEX_GRADIENT_NOISE) {
    // smoothstep(-0.7, 0.7, f): tt = clamp((f + 0.7) / 1.4, 0, 1), tt tt (3 - 2 tt)
    const float q = (gradient_noise(scaled) + 0.7f) / 1.4f;
    const float tt = fminf(fmaxf(q, 0.0f), 1.0f);
    const float g_q = (q >= 0.0f && q <= 1.0f) ? g_val * fade_bwd(tt) : 0.0f;
    g_s = gradient_noise_bwd(scaled, g_q / 1.4f);
  } else if (t == TEX_VALUE_NOISE) {
    g_s = value_noise_bwd(lut, lut_n, scaled, g_val);
  } else {
    g_s = metal_fbm_bwd(lut, lut_n, scaled, g_val);
  }
  G.add3(idx, C_TP, g_s * x);
  return g_s * V3{tp[0], tp[1], tp[2]};
}

// blended_color_emission of a hit of mesh `idx` at x (geometric normal n)
// for the cotangents g_c, g_e of the color and emission after their floor
// of 0.001: adds the scene's cotangents (color, emission, the texture's
// masks and params) and returns the cotangent of x (through the texel).
// The blend is mix(own, texel rgb * mask, alpha), as in the plain version.
// A mesh with no texture (NONE, -1) blends an alpha of 0 whatever its
// flags: its masks have no cotangent, and K2 keeps no column for them
// (megakernel.bwd_columns).
template <class Acc>
__device__ V3 blend_bwd(const TraceArgs &a, const SceneSmem &s, const PathSmem &ps, int idx, V3 x,
                        V3 n, V3 g_c, V3 g_e, const Acc &G) {
  const V3 c0 = s.c(idx), e0 = s.e(idx);
  const int bl = a.use_tex && ps.tex[idx] >= 0 ? ps.blend[idx] : 0;
  if (!bl) {
    G.add3(idx, C_CR, pass_ge(c0, 0.001f, g_c));
    G.add3(idx, C_ER, pass_ge(e0, 0.001f, g_e));
    return zero3();
  }
  const int tex = ps.tex[idx];
  const float *tp = s.col(idx, C_TP);
  const V4 t = get_texel(tex, s.mesh[idx], tp, x, n, a.images, a.img_h, a.img_w, a.noise,
                         a.noise_n);
  const V3 tc = {t.x, t.y, t.z};
  const float bc = (bl & 1) ? t.w : 0.0f, be = (bl & 2) ? t.w : 0.0f;
  const float *cmp = s.col(idx, C_CM), *emp = s.col(idx, C_EM);
  const V3 cm = {cmp[0], cmp[1], cmp[2]}, em = {emp[0], emp[1], emp[2]};
  const V3 gcb = pass_ge(c0 + (tc * cm - c0) * bc, 0.001f, g_c);
  const V3 geb = pass_ge(e0 + (tc * em - e0) * be, 0.001f, g_e);
  G.add3(idx, C_CR, gcb * (1.0f - bc));
  G.add3(idx, C_ER, geb * (1.0f - be));
  V3 g_tc = zero3();
  float g_w = 0.0f;
  if (bl & 1) {
    G.add3(idx, C_CM, gcb * tc * bc);
    g_tc = g_tc + gcb * cm * bc;
    g_w += dot(gcb, tc * cm - c0);
  }
  if (bl & 2) {
    G.add3(idx, C_EM, geb * tc * be);
    g_tc = g_tc + geb * em * be;
    g_w += dot(geb, tc * em - e0);
  }
  return texel_bwd(idx, tex, s.mesh[idx], tp, x, n, a.images, a.img_h, a.img_w, a.noise,
                   a.noise_n, V4{g_tc.x, g_tc.y, g_tc.z, g_w}, G);
}

// trace_common.cuh::medium_nee forward and adjoint in one pass (K2's
// medium copy): returns the in-scatter light at the medium event at x of a
// ray along d (RNG key h_depth) and adds the cotangents of x, d and the
// scene for its cotangent g_tot.  Per LIGHT-sphere slot: dl = pos - x and
// dist = sqrt(max(dl.dl, EPS)), cos_a_max from the radius (joker.x), the
// cone sample about dl / dist, the shadow ray's t to that sphere from
// x + dir vol_eps (isect_bwd: the hit must be the light), the solid angle
// 2 (1 - cos_a_max), the HG phase of dot(d, dir), the fog exp(-sigma_t t)
// and the light's table color and emission.  Whether the shadow ray
// reaches the light is a discrete choice.
template <bool kSdf, bool kAll, class Acc>
__device__ V3 medium_nee_bwd(const SceneSmem &s, const SdfScene &sd, const PackedScene &pk, V3 x,
                             V3 d, uint32_t h_depth, const MediumArgs &a, V3 g_tot, V3 &g_x,
                             V3 &g_d, const Acc &G) {
  V3 total = zero3();
  for (int slot = 0; slot < s.n_lights; ++slot) {
    const int li = s.lights[slot];
    if (li < 0 || s.mat[li] != MAT_LIGHT || s.mesh[li] != MESH_SPHERE) continue;
    const V3 dl = s.p(li) - x;
    const float dd = dot(dl, dl);
    const float dist = sqrtf(fmaxf(dd, EPS));
    const float r = s.j0(li);
    const float r2 = r * r;
    const float m2 = fmaxf(dist * dist, EPS);
    const float q = r2 / m2;
    const float qc = fminf(fmaxf(q, 0.0f), 1.0f);
    const float cos_a_max = safe_sqrt(1.0f - qc);
    const V3 w = {dl.x / dist, dl.y / dist, dl.z / dist};
    const float extent = 1.0f - cos_a_max;
    const uint32_t h = fold_step(fold_step(h_depth, (uint32_t)slot, 4u), S_VOL_NEE, 5u);
    const float u1 = u01(h), u2 = u01(pcg(h));
    const V3 dir = sample_cone(w, extent, u1, u2);
    const V3 so = x + dir * a.vol_eps;
    float ts;
    int hidx;
    intersect_packed<kSdf, kAll>(s, sd, pk, so, dir, a.eps, a.inf, ts, hidx,
                                 kAll ? a.noise : nullptr, kAll ? a.noise_n : 0);
    if (!(ts < a.inf) || hidx != li) continue;  // must hit this light
    const float omega = 2.0f * (1.0f - cos_a_max);
    const float cos_d = dot(d, dir);
    const float phase = hg_phase(cos_d, a.hg_1pg2, a.hg_2g, a.hg_1mg2);
    const float fog = expf(-a.sigma_t * ts);
    const float k = phase * fog * PI * omega;
    const V3 lc = s.c(li), le = s.e(li);
    total = total + lc * le * k;
    // contrib = c e (((phase fog) pi) omega)
    const V3 g_ce = g_tot * k;
    G.add3(li, C_CR, g_ce * le);
    G.add3(li, C_ER, g_ce * lc);
    const float g_k = dot(g_tot, lc * le);
    const float g_phase = g_k * omega * PI * fog;
    const float g_fog = g_k * omega * PI * phase;
    float g_cam = -2.0f * (g_k * (phase * fog * PI));
    const float g_cos = hg_phase_bwd(cos_d, a.hg_1pg2, a.hg_2g, a.hg_1mg2, g_phase);
    V3 g_dir = d * g_cos;
    g_d = g_d + dir * g_cos;
    // ts = t(so, dir) on the light, so = x + dir vol_eps
    V3 g_so = zero3();
    isect_bwd(s, li, so, dir, a.eps, g_fog * fog * -a.sigma_t, g_so, g_dir, G);
    g_x = g_x + g_so;
    g_dir = g_dir + g_so * a.vol_eps;
    // dir = sample_cone(dl / dist, 1 - cos_a_max, u1, u2)
    V3 g_w;
    float g_ext;
    sample_cone_bwd(w, extent, u1, u2, g_dir, g_w, g_ext);
    g_cam -= g_ext;
    // cos_a_max = safe_sqrt(1 - clamp(r^2 / max(dist^2, EPS), 0, 1))
    const float g_qc = (1.0f - qc) > 0.0f ? -g_cam / (2.0f * cos_a_max) : 0.0f;
    const float g_q = (q >= 0.0f && q <= 1.0f) ? g_qc : 0.0f;
    const float g_r2 = g_q / m2;
    float g_dist = dist * dist >= EPS ? 2.0f * dist * (-g_q * r2 / (m2 * m2)) : 0.0f;
    V3 g_dl = {g_w.x / dist, g_w.y / dist, g_w.z / dist};
    g_dist += -dot(g_w, dl) / (dist * dist);
    if (dd >= EPS) g_dl = g_dl + dl * (2.0f * (g_dist / (2.0f * dist)));
    G.add(li, C_J0, 2.0f * r * g_r2);
    G.add3(li, C_PX, g_dl);
    g_x = g_x - g_dl;
  }
  return total;
}

}  // namespace
