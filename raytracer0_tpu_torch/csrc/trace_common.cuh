// trace_common.cuh — device code shared by the forward megakernel K1
// (megakernel.cu) and its adjoint K2 (megakernel_bwd.cu): vec3 helpers, the
// counter RNG, the scene in shared memory, intersection, normals, direction
// sampling, the MIS pdfs, the procedural sky and sphere-light NEE.
//
// Both kernels compile these functions from this one copy with the same
// flags (no fast math, -fmad=false), so K2's replay of a bounce makes the
// same decisions, bit for bit, as K1 and as the plain PyTorch version
// (raytracer0_tpu_torch/render/integrator.py::trace).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float TWO_PI = 6.28318531f;
constexpr float ONE_OVER_PI = 0.31830989f;
// 1 / FOUR_PI rounded once from double, as the Python side computes it.
constexpr float INV_FOUR_PI = (float)(1.0 / 12.5663706);
constexpr float EPS = 1e-12f;

// scene table columns (raytracer0_tpu/ops/megakernel.py::_scene_table)
constexpr int NCOLS = 36;
constexpr int C_PX = 0, C_J0 = 3, C_CR = 7, C_ER = 10;

// raytracer0_tpu_torch/models/materials.py codes
constexpr int MESH_SPHERE = 0, MESH_PLANE = 1, MESH_BOX = 2;
constexpr int MAT_LIGHT = 0;
// raytracer0_tpu_torch/rng.py Stream codes
constexpr uint32_t S_BSDF_DIR = 3u, S_NEE_CONE = 5u;

struct TraceArgs {
  const float *table;      // [n_mesh, 36]
  const int32_t *mesh;     // [n_mesh] MeshType codes
  const int32_t *mat;      // [n_mesh] MatType codes
  const int32_t *lights;   // [n_lights] mesh index per light slot, -1 = none
  int n_mesh, n_lights;
  const float *ro, *rd;    // [n_pix, 3]
  const int64_t *pix;      // [n_pix] uint32 pixel ids
  float *out;              // [n_pix, 3]
  long long n_pix;
  uint32_t pass_idx, sample_idx;
  int max_bounces, max_diff, max_spec, max_scatter;
  float eps, inf;          // cfg.epsilon, cfg.infinity
  int sample_lights, use_mis, use_sky;
};

// ------------------------------------------------------------------ vec3
struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 vmax(V3 a, float s) { return {fmaxf(a.x, s), fmaxf(a.y, s), fmaxf(a.z, s)}; }

// vecmath.normalize: a * (1 / sqrt(max(|a|^2, EPS)))
__device__ __forceinline__ V3 normalize(V3 a) { return a * (1.0f / sqrtf(fmaxf(dot(a, a), EPS))); }
__device__ __forceinline__ float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }
// vecmath.safe_div: sign-preserving denominator floor
__device__ __forceinline__ float safe_div(float a, float b) {
  float mag = fmaxf(fabsf(b), EPS);
  return a / (b < 0.0f ? -mag : mag);
}
__device__ __forceinline__ float signf(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// ------------------------------------------------------------------ RNG
// raytracer0_tpu/rng.py: PCG-RXS-M-XS hash and the keyed fold, on uint32.
__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (x >> 22u) ^ x;
}
// One fold step: coordinate `c` at position `i` of fold(*coords).
__device__ __forceinline__ uint32_t fold_step(uint32_t h, uint32_t c, uint32_t i) {
  uint32_t k;
  switch (i % 5u) {
    case 0u: k = 0x9E3779B9u; break;
    case 1u: k = 0x85EBCA6Bu; break;
    case 2u: k = 0xC2B2AE35u; break;
    case 3u: k = 0x27D4EB2Fu; break;
    default: k = 0x165667B1u; break;
  }
  return pcg(h + c * k + i);
}
__device__ __forceinline__ float u01(uint32_t h) {
  return (float)(h >> 8u) * (1.0f / 16777216.0f);
}

// ------------------------------------------------------------------ scene
struct SceneSmem {
  const float *tab;
  const int *mesh, *mat, *lights;
  int n_mesh, n_lights;
  __device__ __forceinline__ V3 p(int i) const {
    const float *r = tab + i * NCOLS + C_PX;
    return {r[0], r[1], r[2]};
  }
  __device__ __forceinline__ float j0(int i) const { return tab[i * NCOLS + C_J0]; }
  __device__ __forceinline__ V3 c(int i) const {
    const float *r = tab + i * NCOLS + C_CR;
    return {r[0], r[1], r[2]};
  }
  __device__ __forceinline__ V3 e(int i) const {
    const float *r = tab + i * NCOLS + C_ER;
    return {r[0], r[1], r[2]};
  }
};

// Closest analytic hit (ops/intersect.py::analytic_min): first index of the
// smallest valid t, idx 0 and t = +inf when nothing is hit.
__device__ __forceinline__ void intersect(const SceneSmem &s, V3 o, V3 d, float eps,
                                          float &tmin, int &idx) {
  tmin = __int_as_float(0x7f800000);
  idx = 0;
  for (int i = 0; i < s.n_mesh; ++i) {
    V3 p = s.p(i);
    float j0 = s.j0(i);
    float t;
    bool valid;
    switch (s.mesh[i]) {
      case MESH_SPHERE: {
        V3 oc = o - p;
        float b = dot(oc, d);
        float c = dot(oc, oc) - j0 * j0;
        float disc = b * b - c;
        float sq = disc > 0.0f ? sqrtf(disc) : 0.0f;
        float t0 = -b - sq;
        float t1 = -b + sq;
        t = t0 > eps ? t0 : t1;
        valid = disc > 0.0f && t > eps;
        break;
      }
      case MESH_PLANE: {
        float denom = dot(p, d);
        t = safe_div(-j0 - dot(p, o), denom);
        valid = t > eps && fabsf(denom) > 1e-12f;
        break;
      }
      case MESH_BOX: {
        float half = j0 * 0.5f;
        float mx = safe_div(1.0f, d.x), my = safe_div(1.0f, d.y), mz = safe_div(1.0f, d.z);
        float nx = mx * (p.x - o.x), ny = my * (p.y - o.y), nz = mz * (p.z - o.z);
        float kx = fabsf(mx) * half, ky = fabsf(my) * half, kz = fabsf(mz) * half;
        float tn = fmaxf(fmaxf(nx - kx, ny - ky), nz - kz);
        float tf = fminf(fminf(nx + kx, ny + ky), nz + kz);
        t = tn > 0.0f ? tn : tf;
        valid = tn <= tf && tf >= 0.0f && t > eps;
        break;
      }
      default:
        valid = false;
        t = 0.0f;
        break;
    }
    // degenerate-mesh skip: joker.x == 0 placeholders
    if (valid && j0 != 0.0f && t < tmin) {
      tmin = t;
      idx = i;
    }
  }
}

// Geometric normal of mesh `idx` at `x` (ops/intersect.py::parse_hit).
__device__ __forceinline__ V3 normal_at(const SceneSmem &s, int idx, V3 x) {
  V3 p = s.p(idx);
  switch (s.mesh[idx]) {
    case MESH_SPHERE:
      return normalize(x - p);
    case MESH_PLANE:
      return normalize(p);
    default: {  // BOX: dominant penetration axis
      V3 hp = x - p;
      float half = s.j0(idx) * 0.5f;
      float dx = fabsf(hp.x) - half, dy = fabsf(hp.y) - half, dz = fabsf(hp.z) - half;
      V3 n = {signf(hp.x) * ((dx >= dy && dx >= dz) ? 1.0f : 0.0f),
              signf(hp.y) * ((dy >= dz && dy >= dx) ? 1.0f : 0.0f),
              signf(hp.z) * ((dz >= dx && dz >= dy) ? 1.0f : 0.0f)};
      return normalize(n);
    }
  }
}

// ------------------------------------------------------------------ sampling
// vecmath.onb: Duff et al. branch-free basis with the |n.z| ~ 1 guard.
__device__ __forceinline__ void onb(V3 n, V3 &u, V3 &v) {
  float sig = n.z < 0.0f ? -1.0f : 1.0f;
  float den = sig + n.z;
  float a = -1.0f / (fabsf(den) < EPS ? EPS : den);
  float b = n.x * n.y * a;
  u = {1.0f + sig * n.x * n.x * a, sig * b, -sig * n.x};
  v = {b, sig + n.y * n.y * a, -n.y};
  if (fabsf(n.z) > 0.99999f) {
    u = {1.0f, 0.0f, 0.0f};
    v = {0.0f, sig, 0.0f};
  }
}

// (cos(ang)*om)*u + (sin(ang)*om)*v + r_y*w, normalized (sampling._around).
__device__ __forceinline__ V3 around(V3 w, float u1, float om, float r_y) {
  V3 u, v;
  onb(w, u, v);
  float ang = u1 * TWO_PI;
  float ca = cosf(ang) * om, sa = sinf(ang) * om;
  return normalize(u * ca + v * sa + w * r_y);
}

// sampling.sample_biased with power 1: cosine-weighted hemisphere.
__device__ __forceinline__ V3 sample_biased(V3 w, float u1, float u2) {
  float r_y = sqrtf(fmaxf(u2, 1e-12f));
  return around(w, u1, safe_sqrt(1.0f - r_y * r_y), r_y);
}

// sampling.sample_cone: uniform in the cone of `extent = 1 - cos_max`.
__device__ __forceinline__ V3 sample_cone(V3 w, float extent, float u1, float u2) {
  float r_y = 1.0f - u2 * extent;
  return around(w, u1, safe_sqrt(1.0f - r_y * r_y), r_y);
}

// sampling.power_heuristic(1, f, 1, g)
__device__ __forceinline__ float power_heuristic(float f, float g) {
  float denom = f * f + g * g;
  return denom > 0.0f ? fmaxf(f * f, 0.0f) / fmaxf(denom, 1e-12f) : 0.0f;
}

// sampling.sphere_light_pdf
__device__ __forceinline__ float sphere_light_pdf(V3 lp, float r, V3 x) {
  V3 dv = lp - x;
  float d2 = dot(dv, dv);
  float r2 = r * r;
  float cos_max = safe_sqrt(1.0f - safe_div(r2, d2));
  float denom = 1.0f - cos_max;
  float pdf = 1.0f / fmaxf(TWO_PI * denom, 1e-12f);
  return (d2 <= r2 || denom < 1e-6f) ? 0.0f : pdf;
}

// sky.procedural_sky: the cosine palette.
__device__ __forceinline__ V3 procedural_sky(V3 d) {
  float h = fminf(fmaxf(d.y * 0.6f + 0.5f, 0.3f), 1.0f);
  return {0.5f + 0.5f * cosf(TWO_PI * (0.525f + 0.9f * h)),
          0.5f + 0.5f * cosf(TWO_PI * (0.408f + 0.97f * h)),
          0.5f + 0.5f * cosf(TWO_PI * (0.409f + 0.8f * h))};
}

// lighting.sample_lights_nee without the throughput factor: the sum over
// sphere-light slots of the cone-sampled, shadow-tested contribution.
__device__ V3 shade_nee(const SceneSmem &s, V3 x, V3 nl, uint32_t h_depth, float eps, float inf,
                        bool use_mis) {
  V3 total = {0.0f, 0.0f, 0.0f};
  for (int slot = 0; slot < s.n_lights; ++slot) {
    int li = s.lights[slot];
    if (li < 0) continue;  // sentinel slot: no light
    uint32_t h = fold_step(fold_step(h_depth, (uint32_t)slot, 4u), S_NEE_CONE, 5u);
    float u1 = u01(h), u2 = u01(pcg(h));
    V3 lp = s.p(li);
    float r = s.j0(li);
    V3 sw = lp - x;
    float d2 = dot(sw, sw);
    float cos_a_max = safe_sqrt(1.0f - fminf(fmaxf(safe_div(r * r, d2), 0.0f), 1.0f));
    V3 ldir = normalize(sw);
    V3 sr = sample_cone(ldir, 1.0f - cos_a_max, u1, u2);
    float ts;
    int hidx;
    intersect(s, x + nl * eps, sr, eps, ts, hidx);
    if (!(ts < inf) || s.mat[hidx] != MAT_LIGHT) continue;
    float cos_term = fmaxf(dot(sr, nl), 0.001f);
    float weight = 2.0f * (1.0f - cos_a_max);
    V3 contrib = vmax(s.c(hidx), 0.001f) * s.e(hidx) * (weight * cos_term);
    if (use_mis) {
      // weight applied only when the sample carries energy
      if (!(dot(contrib, contrib) > 1e-6f)) continue;
      float b_pdf = fmaxf(dot(ldir, nl), 0.0f) * ONE_OVER_PI;
      contrib = contrib * power_heuristic(sphere_light_pdf(lp, r, x), b_pdf);
    }
    total = total + contrib;
  }
  return total;
}

// Copy the scene table, the type codes and the light slots into shared
// memory (laid out table | mesh | mat | lights) and return a view of them.
// Every thread of the block must call it: it ends with __syncthreads().
__device__ __forceinline__ SceneSmem load_scene(const TraceArgs &a, float *smem) {
  float *s_tab = smem;
  int *s_mesh = reinterpret_cast<int *>(s_tab + a.n_mesh * NCOLS);
  int *s_mat = s_mesh + a.n_mesh;
  int *s_lights = s_mat + a.n_mesh;
  for (int i = threadIdx.x; i < a.n_mesh * NCOLS; i += blockDim.x) s_tab[i] = a.table[i];
  for (int i = threadIdx.x; i < a.n_mesh; i += blockDim.x) {
    s_mesh[i] = a.mesh[i];
    s_mat[i] = a.mat[i];
  }
  for (int i = threadIdx.x; i < a.n_lights; i += blockDim.x) s_lights[i] = a.lights[i];
  __syncthreads();
  return {s_tab, s_mesh, s_mat, s_lights, a.n_mesh, a.n_lights};
}

// Bytes of shared memory load_scene() fills.
__host__ __device__ inline size_t scene_smem_bytes(int n_mesh, int n_lights) {
  return sizeof(float) * n_mesh * NCOLS + sizeof(int) * (2 * n_mesh + n_lights);
}

// fold(pix, pass, sample): the key shared by every draw of pixel `p`.
__device__ __forceinline__ uint32_t pixel_hash(const TraceArgs &a, long long p) {
  return fold_step(fold_step(fold_step(0x5BD1E995u, (uint32_t)a.pix[p], 0u), a.pass_idx, 1u),
                   a.sample_idx, 2u);
}

}  // namespace
