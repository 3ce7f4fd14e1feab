// trace_common.cuh — device code shared by the forward megakernel K1
// (megakernel.cu), its adjoint K2 (megakernel_bwd.cu) and the fused ReSTIR
// pass (K4, gbuffer.cu, and K6v, restir_vertex.cu): vec3 helpers, the counter RNG, the scene in shared
// memory, intersection, normals, direction sampling, reflection, refraction
// and the Fresnel models, the MIS pdfs, the procedural sky, the cubemap
// fetch, sphere/directional-light NEE, the texel of a hit (image,
// UV-pattern and noise textures) and the SDF march.  The copies of K1 and
// K2 for the whole SDF class (kAll) also compile the 14 distances of
// ops/sdf.py, the texel of an SDF hit and SDF-light NEE; no other kernel
// instantiates them.
//
// The kernels compile these functions from this one copy with the same
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
constexpr int C_PX = 0, C_J0 = 3, C_CR = 7, C_ER = 10, C_IOR = 13, C_AUX = 14, C_TP = 26,
              C_CM = 30, C_EM = 33;

// raytracer0_tpu_torch/models/materials.py codes
constexpr int MESH_SPHERE = 0, MESH_PLANE = 1, MESH_BOX = 2, MESH_SDF = 3;
// SdfShape codes
constexpr int SDF_BOX = 0, SDF_ROUND_BOX = 1, SDF_SPHERE = 2, SDF_TRI_PRISM = 3, SDF_CONE = 4,
              SDF_MENGER = 5, SDF_MANDELBULB = 6, SDF_ELLIPSOID = 7, SDF_CAPSULE = 8,
              SDF_SNOWBALL = 9, SDF_SEA_BOX = 10, SDF_SIGGRAPH = 11, SDF_TRIANGLE = 12,
              SDF_QUAD = 13;
constexpr int MAT_LIGHT = 0, MAT_DIR_LIGHT = 1, MAT_DIFF = 2, MAT_SPEC = 3, MAT_REFR_FRESNEL = 4,
              MAT_REFR_SCHLICK = 5, MAT_COAT = 6;
constexpr int TEX_IMAGE3 = 3, TEX_VORONOI = 4, TEX_GRADIENT_NOISE = 5, TEX_VALUE_NOISE = 6,
              TEX_CHECK = 7, TEX_RIPPLE = 8, TEX_METAL = 9;
constexpr float PI = 3.14159265f;
// raytracer0_tpu_torch/rng.py Stream codes
constexpr uint32_t S_BSDF_DIR = 3u, S_BSDF_CHOICE = 4u, S_NEE_CONE = 5u, S_NEE_SDF_POINT = 6u,
                   S_ENV_DIR = 7u;
// the draws of K1's medium copy: the hero wavelength, the free path, the HG
// direction and the in-scatter NEE cone
constexpr uint32_t S_WAVELENGTH = 2u, S_VOL_FREEPATH = 8u, S_VOL_PHASE = 9u, S_VOL_NEE = 10u;
constexpr float FOUR_PI = 12.5663706f;
// nc in brdf (ops/bsdf.py IOR_AIR)
constexpr float IOR_AIR = 1.00029f;

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
  // K1 only (last, so K2's positional initialiser leaves them zero)
  const float *cubemap;    // [6, cube_h, cube_w, 3]
  int cube_h, cube_w;
  int use_cubemap, use_biased;
  const int32_t *tex;      // [n_mesh] TexType codes, -1 = none
  const int32_t *blend;    // [n_mesh] bit 0: texel into color, bit 1: into emission
  const float *images;     // [4, img_h, img_w, 4]
  int img_h, img_w;
  const float *noise;      // [noise_n, noise_n, 4] value-noise LUT
  int noise_n;
  int use_tex;             // bit 0: some mesh blends a texture; bit 1: a LIGHT mesh has one
  const int32_t *sdf;      // [n_sdf] SdfShape codes of the SDF rows
  int n_analytic, n_sdf;   // SDF rows follow the analytic ones
  int steps;               // cfg.marching_steps
  float fudge, t0;         // cfg.fudge_factor, f32(cfg.epsilon * 4)
};

// K1's medium copy's arguments: TraceArgs (whose layout the other kernels
// keep: K2 holds a copy on its stack), then the flags and the config
// constants formed on the host as the plain version forms them (in double,
// then f32).  The copy's device code reaches them from its TraceArgs
// through `medium_args`.
struct MediumArgs : TraceArgs {
  int use_spectral, use_volumetrics;
  float sigma_t;           // cfg.vol_sigma_t
  float vol_w;             // cfg.vol_sigma_s / cfg.vol_sigma_t
  float vol_eps;           // cfg.epsilon * 20: the in-scatter shadow ray's offset
  float hg_g;              // cfg.vol_g, the HG sampler's (float32 arithmetic on it)
  float hg_1pg2, hg_2g, hg_1mg2;  // 1 + g^2, 2 g, 1 - g^2: the HG phase's
};
// The MediumArgs of the medium copy, whose TraceArgs is always one.
__device__ __forceinline__ const MediumArgs &medium_args(const TraceArgs &a) {
  return static_cast<const MediumArgs &>(a);
}

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
  __device__ __forceinline__ float ior(int i) const { return tab[i * NCOLS + C_IOR]; }
  __device__ __forceinline__ const float *col(int i, int c) const { return tab + i * NCOLS + c; }
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

// ------------------------------------------------------------------ SDF
// ops/sdf.py for the BOX and ROUND_BOX shapes, operation for operation;
// kAll = true (K1's whole-SDF copy) evaluates every shape through
// sdf_map_all, after the textures below, and takes the value-noise LUT
// (`lut`, `lut_n`: a SNOWBALL's) as arguments that the other kernels leave
// at their defaults.
struct SdfScene {
  const int *shape;  // [count] SdfShape codes, in shared memory
  int first, count;  // first SDF row (the analytic rows come first), SDF rows
  int steps;         // marching steps
  float fudge, t0;   // step scale, start of the march
};

// Distance of SDF row `row` (sdf.sd_box / sdf.ud_round_box at p - pos).
__device__ __forceinline__ float sdf_entry(const SceneSmem &s, int row, int shape, V3 p) {
  const V3 q = p - s.p(row);
  const float *j = s.col(row, C_J0);
  const float dx = fabsf(q.x) - j[0], dy = fabsf(q.y) - j[1], dz = fabsf(q.z) - j[2];
  const V3 m = {fmaxf(dx, 0.0f), fmaxf(dy, 0.0f), fmaxf(dz, 0.0f)};
  const float len = sqrtf(fmaxf(dot(m, m), 0.0f));
  if (shape == SDF_ROUND_BOX) return len - j[3];
  return len + fminf(fmaxf(fmaxf(dx, dy), dz), 0.0f);
}

// The scene map of the whole SDF class: distance and ordinal.
struct SdfNear {
  float d;
  int k;
};
__device__ __attribute__((noinline)) SdfNear sdf_map_all(SceneSmem s, SdfScene sd, V3 p,
                                                         const float *lut, int lut_n);

// sdf.scene_map: the nearest entry's distance and ordinal (first on a tie).
template <bool kAll = false>
__device__ __forceinline__ float sdf_map(const SceneSmem &s, const SdfScene &sd, V3 p, int &k,
                                         const float *lut = nullptr, int lut_n = 0) {
  if constexpr (kAll) {
    const SdfNear r = sdf_map_all(s, sd, p, lut, lut_n);
    k = r.k;
    return r.d;
  }
  float best = sdf_entry(s, sd.first, sd.shape[0], p);
  k = 0;
  for (int i = 1; i < sd.count; ++i) {
    const float d = sdf_entry(s, sd.first + i, sd.shape[i], p);
    if (d < best) k = i;
    best = fminf(d, best);
  }
  return best;
}

// sdf.bound_radius of an SDF row with joker `j` and shape `shape`: the
// radius of the bounding sphere the march's gate tests.  kAll: every shape;
// one without a bound (capsule, prism, cone, sea box, SIGGRAPH, triangle,
// quad) has an infinite radius, which admits every ray: the plain
// version's march without a gate.
template <bool kAll = false>
__device__ __forceinline__ float sdf_gate_radius(const float *j, int shape) {
  const float norm3 = sqrtf(j[0] * j[0] + j[1] * j[1] + j[2] * j[2]);
  if constexpr (kAll) {
    switch (shape) {
      case SDF_BOX:
      case SDF_ROUND_BOX:
      case SDF_MENGER:  // a BOX's radius
        break;
      case SDF_SPHERE:
        return fabsf(j[0]) + 0.05f;
      case SDF_SNOWBALL:
        return fabsf(j[0]) + 0.15f;
      case SDF_MANDELBULB:
        return 2.5f;
      case SDF_ELLIPSOID:
        return fabsf(j[0]) + fabsf(j[1]) + fabsf(j[2]) + 0.05f;
      default:
        return __int_as_float(0x7f800000);
    }
  }
  return shape == SDF_ROUND_BOX ? norm3 * 1.05f + fabsf(j[3]) + 0.05f : norm3 * 1.05f + 0.05f;
}

// sdf.march_loop: sphere tracing from t0 up to `tl`, one thread per ray.
// A ray that enters no entry's bounding sphere within [0, tl] cannot
// converge there and is a miss; the loop stops as soon as the ray is
// within eps of a surface or past tl, which gives the plain version's t,
// since a lane that is done no longer moves.  Returns whether the ray hit
// (t <= tl), with its t and the ordinal of the entry nearest to it.
// `radius(i)` is the gate radius of the i-th SDF row.
template <bool kAll = false, class Radius>
__device__ __forceinline__ bool sdf_march_gated(const SceneSmem &s, const SdfScene &sd, V3 o, V3 d,
                                                float tl, float eps, float &t_out, int &k_out,
                                                Radius radius, const float *lut = nullptr,
                                                int lut_n = 0) {
  bool can_hit = false;
  for (int i = 0; i < sd.count; ++i) {
    const int row = sd.first + i;
    const float rb = radius(i);
    const V3 oc = o - s.p(row);
    const float b = dot(oc, d);
    const float cq = dot(oc, oc) - rb * rb;
    const float disc = b * b - cq;
    const float sq = safe_sqrt(disc);
    can_hit = can_hit || (disc > 0.0f && -b + sq > 0.0f && -b - sq < tl);
  }
  if (!can_hit) return false;
  float t = sd.t0;
  int k;
  bool done = fabsf(sdf_map<kAll>(s, sd, o + d * t, k, lut, lut_n)) < eps;
  for (int step = 0; step < sd.steps - 1 && !done; ++step) {
    const float h = fabsf(sdf_map<kAll>(s, sd, o + d * t, k, lut, lut_n));
    if (h < eps || t > tl)
      done = true;
    else
      t = t + h * sd.fudge;
  }
  sdf_map<kAll>(s, sd, o + d * t, k_out, lut, lut_n);  // the entry at the settled t
  t_out = t;
  return t <= tl;
}

// sdf_march_gated with each gate radius computed from the scene table.
__device__ __forceinline__ bool sdf_march(const SceneSmem &s, const SdfScene &sd, V3 o, V3 d,
                                          float tl, float eps, float &t_out, int &k_out) {
  return sdf_march_gated(s, sd, o, d, tl, eps, t_out, k_out, [&](int i) {
    return sdf_gate_radius(s.col(sd.first + i, C_J0), sd.shape[i]);
  });
}

// sdf.calc_normal: the tetrahedral 4-tap gradient.
template <bool kAll = false>
__device__ __forceinline__ V3 sdf_normal(const SceneSmem &s, const SdfScene &sd, V3 p, float eps,
                                         const float *lut = nullptr, int lut_n = 0) {
  const V3 taps[4] = {{1.0f, -1.0f, -1.0f}, {-1.0f, -1.0f, 1.0f}, {-1.0f, 1.0f, -1.0f},
                      {1.0f, 1.0f, 1.0f}};
  V3 n = {0.0f, 0.0f, 0.0f};
  int k;
  for (int i = 0; i < 4; ++i)
    n = n + taps[i] * sdf_map<kAll>(s, sd, p + taps[i] * eps, k, lut, lut_n);
  return normalize(n);
}

// intersect.intersect: the analytic hit, then the SDF march up to it (up to
// `inf` when nothing analytic is hit); the SDF wins where strictly nearer.
// Returns whether it won.  kSdf = false is the analytic intersection alone;
// kAll (K6v's whole-SDF copy) marches every shape through sdf_map_all with
// the value-noise LUT `lut` of a SNOWBALL, each gate radius from the table.
template <bool kSdf, bool kAll = false>
__device__ __forceinline__ bool intersect_scene(const SceneSmem &s, const SdfScene &sd, V3 o, V3 d,
                                                float eps, float inf, float &tmin, int &idx,
                                                const float *lut = nullptr, int lut_n = 0) {
  intersect(s, o, d, eps, tmin, idx);
  if constexpr (kSdf) {
    if (sd.count > 0) {
      const float tl = tmin < inf ? tmin : inf;
      float ts;
      int k;
      bool hit;
      if constexpr (kAll)
        hit = sdf_march_gated<true>(
            s, sd, o, d, tl, eps, ts, k,
            [&](int i) { return sdf_gate_radius<true>(s.col(sd.first + i, C_J0), sd.shape[i]); },
            lut, lut_n);
      else
        hit = sdf_march(s, sd, o, d, tl, eps, ts, k);
      if (hit && ts < tl) {
        tmin = ts;
        idx = sd.first + k;
        return true;
      }
    }
  }
  return false;
}

// ------------------------------------------------------------------ packed scan
// The scan of K1 and K4 (intersect_packed).  `intersect` above reads each
// mesh's type, switches on it and loads its pos and joker as four scalar
// loads from a 36-float row; K2, K5, K6v and K7 keep it.  Here the analytic
// meshes are copied once per block into shared memory grouped by type, one
// float4 record each: a sphere as (centre, radius^2), a plane as (normal,
// offset), a box as (centre, half size), each with its table row.  A mesh
// then costs one 128-bit broadcast load and no switch, and the ray's
// reciprocal direction is computed once per ray, not once per box.  Rows
// whose joker.x is 0 (placeholders) are left out, which is the skip
// `intersect` makes.  The SDF rows' gate radii are computed once too.
struct PackedScene {
  const float4 *base;  // the packed area: the record ends, then the records
  int n_mesh;
  // the ends of the sphere, plane and box records
  __device__ __forceinline__ int4 ends() const { return *reinterpret_cast<const int4 *>(base); }
  __device__ __forceinline__ float4 rec(int k) const { return base[1 + k]; }
  // the record's table row
  __device__ __forceinline__ int row(int k) const {
    return reinterpret_cast<const int *>(base + 1 + n_mesh)[k];
  }
  // the gate radius of the i-th SDF row (sdf_gate_radius)
  __device__ __forceinline__ float gate(int i) const {
    return reinterpret_cast<const float *>(base + 1 + n_mesh)[n_mesh + i];
  }
};

// Where the packed area starts after `before` bytes of shared memory (16
// bytes aligned), and the bytes up to its end: the record ends (an int4),
// a float4 record and a table row per mesh, a gate radius per SDF row.
// The scene table stays at the start of shared memory, where K1's other
// reads of it address it by constant offsets.
__host__ __device__ inline size_t packed_offset(size_t before) { return (before + 15) / 16 * 16; }
__host__ __device__ inline size_t packed_smem_bytes(size_t before, int n_mesh, int n_sdf) {
  return packed_offset(before) + sizeof(float) * (4 + 5 * n_mesh + n_sdf);
}

// Whether row i enters the packed scan: an analytic mesh that is not a
// placeholder.
__device__ __forceinline__ bool packable(const SceneSmem &s, int i) {
  return s.mesh[i] >= MESH_SPHERE && s.mesh[i] <= MESH_BOX && s.j0(i) != 0.0f;
}

// Pack the scene (in shared memory already, as load_path leaves it) into
// the packed area of dynamic shared memory `smem`, after `before` bytes.
// Every thread of the block must call it: it ends with __syncthreads().
template <bool kAll = false>
__device__ __forceinline__ PackedScene load_packed(const SceneSmem &s, const SdfScene &sd,
                                                   float *smem, size_t before) {
  float4 *area = reinterpret_cast<float4 *>(reinterpret_cast<char *>(smem) + packed_offset(before));
  float4 *rec = area + 1;
  int *row = reinterpret_cast<int *>(rec + s.n_mesh);
  float *gate = reinterpret_cast<float *>(row + s.n_mesh);
  int ns = 0, np = 0, nb = 0;  // every thread counts the records of each type
  for (int i = 0; i < s.n_mesh; ++i) {
    if (!packable(s, i)) continue;
    ns += s.mesh[i] == MESH_SPHERE;
    np += s.mesh[i] == MESH_PLANE;
    nb += s.mesh[i] == MESH_BOX;
  }
  for (int i = threadIdx.x; i < s.n_mesh; i += blockDim.x) {
    if (!packable(s, i)) continue;
    const int m = s.mesh[i];
    int k = m == MESH_SPHERE ? 0 : (m == MESH_PLANE ? ns : ns + np);
    for (int j = 0; j < i; ++j) k += s.mesh[j] == m && packable(s, j);  // table order within a type
    const V3 p = s.p(i);
    const float j0 = s.j0(i);
    rec[k] = make_float4(p.x, p.y, p.z,
                         m == MESH_SPHERE ? j0 * j0 : (m == MESH_PLANE ? j0 : j0 * 0.5f));
    row[k] = i;
  }
  if (threadIdx.x == 0) *reinterpret_cast<int4 *>(area) = make_int4(ns, ns + np, ns + np + nb, 0);
  for (int i = threadIdx.x; i < sd.count; i += blockDim.x)
    gate[i] = sdf_gate_radius<kAll>(s.col(sd.first + i, C_J0), sd.shape[i]);
  __syncthreads();
  return {area, s.n_mesh};
}

// `intersect` over the packed records: the same t per mesh, in the same
// operations, and the same winner, the first row of the smallest valid t:
// the scan goes by type, so a tie takes the lower row.
__device__ __forceinline__ void intersect_packed_analytic(const PackedScene &pk, V3 o, V3 d,
                                                          float eps, float &tmin, int &idx) {
  tmin = __int_as_float(0x7f800000);
  idx = 0;
  // a valid t is never NaN, so `t == tmin` is a true tie
  auto take = [&](int k, float t, bool valid) {
    if (valid && (t < tmin || (t == tmin && pk.row(k) < idx))) {
      tmin = t;
      idx = pk.row(k);
    }
  };
  const int4 end = pk.ends();
  #pragma unroll 1
  for (int k = 0; k < end.x; ++k) {
    const float4 r = pk.rec(k);
    const V3 oc = o - V3{r.x, r.y, r.z};
    const float b = dot(oc, d);
    const float c = dot(oc, oc) - r.w;
    const float disc = b * b - c;
    const float sq = disc > 0.0f ? sqrtf(disc) : 0.0f;
    const float t0 = -b - sq;
    const float t1 = -b + sq;
    const float t = t0 > eps ? t0 : t1;
    take(k, t, disc > 0.0f && t > eps);
  }
  #pragma unroll 1
  for (int k = end.x; k < end.y; ++k) {
    const float4 r = pk.rec(k);
    const V3 n = {r.x, r.y, r.z};
    const float denom = dot(n, d);
    const float t = safe_div(-r.w - dot(n, o), denom);
    take(k, t, t > eps && fabsf(denom) > 1e-12f);
  }
  if (end.y < end.z) {
    const V3 m = {safe_div(1.0f, d.x), safe_div(1.0f, d.y), safe_div(1.0f, d.z)};
    const V3 am = {fabsf(m.x), fabsf(m.y), fabsf(m.z)};
    #pragma unroll 1
    for (int k = end.y; k < end.z; ++k) {
      const float4 r = pk.rec(k);
      const float nx = m.x * (r.x - o.x), ny = m.y * (r.y - o.y), nz = m.z * (r.z - o.z);
      const float kx = am.x * r.w, ky = am.y * r.w, kz = am.z * r.w;
      const float tn = fmaxf(fmaxf(nx - kx, ny - ky), nz - kz);
      const float tf = fminf(fminf(nx + kx, ny + ky), nz + kz);
      const float t = tn > 0.0f ? tn : tf;
      take(k, t, tn <= tf && tf >= 0.0f && t > eps);
    }
  }
}

// intersect_scene over the packed records and gate radii (kAll: of every
// SDF shape).
template <bool kSdf, bool kAll = false>
__device__ __forceinline__ bool intersect_packed(const SceneSmem &s, const SdfScene &sd,
                                                 const PackedScene &pk, V3 o, V3 d, float eps,
                                                 float inf, float &tmin, int &idx,
                                                 const float *lut = nullptr, int lut_n = 0) {
  intersect_packed_analytic(pk, o, d, eps, tmin, idx);
  if constexpr (kSdf) {
    if (sd.count > 0) {
      const float tl = tmin < inf ? tmin : inf;
      float ts;
      int k;
      if (sdf_march_gated<kAll>(
              s, sd, o, d, tl, eps, ts, k, [&](int i) { return pk.gate(i); }, lut, lut_n) &&
          ts < tl) {
        tmin = ts;
        idx = sd.first + k;
        return true;
      }
    }
  }
  return false;
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

// sampling.random_direction: cosine-weighted, or the uniform hemisphere.
__device__ __forceinline__ V3 random_direction(V3 n, float u1, float u2, bool biased) {
  return biased ? sample_biased(n, u1, u2) : sample_cone(n, 1.0f, u1, u2);
}

// sampling.sample_hg: Henyey-Greenstein importance sampling about w, in
// float32 arithmetic on g; |g| < 1e-3 samples the uniform sphere.
__device__ __forceinline__ V3 sample_hg(V3 w, float g, float u1, float u2) {
  float cos_t;
  if (fabsf(g) < 1e-3f) {
    cos_t = 1.0f - 2.0f * u1;
  } else {
    const float sqr = (1.0f - g * g) / ((1.0f - g) + 2.0f * g * u1);
    cos_t = ((1.0f + g * g) - sqr * sqr) / (2.0f * g);
  }
  return around(w, u2, safe_sqrt(1.0f - cos_t * cos_t), cos_t);
}

// sampling.hg_phase with the host-formed constants 1 + g^2, 2 g, 1 - g^2.
__device__ __forceinline__ float hg_phase(float cos_theta, float one_p_g2, float two_g,
                                          float one_m_g2) {
  const float denom = fmaxf(one_p_g2 - two_g * cos_theta, 1e-6f);
  return one_m_g2 / (FOUR_PI * denom * sqrtf(denom));
}

// vecmath.reflect: d - 2 dot(d, n) n
__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return d - n * (2.0f * dot(d, n)); }

// vecmath.refract: GLSL refract, the zero vector and tir = true on total
// internal reflection.
__device__ __forceinline__ V3 refract(V3 d, V3 n, float eta, bool &tir) {
  float cos_i = dot(d, n);
  float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
  tir = k < 0.0f;
  if (tir) return {0.0f, 0.0f, 0.0f};
  return d * eta - n * (eta * cos_i + safe_sqrt(k));
}

// sampling.schlick: r0 + (1 - r0) c^5, with c^5 = c (c^2 c^2)
__device__ __forceinline__ float schlick(V3 d, V3 n, float nc, float nt) {
  float q = (nc - nt) / (nc + nt);
  float r0 = q * q;
  float c = fminf(fmaxf(1.0f + dot(n, d), 0.0f), 1.0f);
  float c2 = c * c;
  return r0 + (1.0f - r0) * (c * (c2 * c2));
}

// sampling.fresnel: unpolarized (Rs + Rp) / 2
__device__ __forceinline__ float fresnel(V3 d, V3 n, float nc, float nt, V3 refr) {
  float cos_i = dot(d, n);
  float cos_t = dot(n, refr);
  float rs = safe_div(nc * cos_i - nt * cos_t, nc * cos_i + nt * cos_t);
  float rp = safe_div(nc * cos_t - nt * cos_i, nc * cos_t + nt * cos_i);
  return fminf(fmaxf((rs * rs + rp * rp) * 0.5f, 0.0f), 1.0f);
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

// sky.sample_cubemap: face select (GL order +x, -x, +y, -y, +z, -z, with
// the plain version's ties), then a bilinear fetch from f32[6, ch, cw, 3] in
// device memory.  Software bilinear on purpose: the texture unit's filter
// keeps its weights in 8-bit fixed point.
__device__ __forceinline__ V3 sample_cubemap(const float *__restrict__ cube, int ch, int cw, V3 d) {
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  int face;
  float ma, sc, tc;
  if (ax >= ay && ax >= az) {
    face = d.x > 0.0f ? 0 : 1;
    ma = ax;
    sc = d.x > 0.0f ? -d.z : d.z;
    tc = -d.y;
  } else if (ay > ax && ay >= az) {
    face = d.y > 0.0f ? 2 : 3;
    ma = ay;
    sc = d.x;
    tc = d.y > 0.0f ? d.z : -d.z;
  } else {
    face = d.z > 0.0f ? 4 : 5;
    ma = az;
    sc = d.z > 0.0f ? d.x : -d.x;
    tc = -d.y;
  }
  ma = fmaxf(ma, 1e-9f);
  const float u = 0.5f * (sc / ma + 1.0f), v = 0.5f * (tc / ma + 1.0f);
  const float xp = fminf(fmaxf(u * (float)cw - 0.5f, 0.0f), (float)(cw - 1));
  const float yp = fminf(fmaxf(v * (float)ch - 0.5f, 0.0f), (float)(ch - 1));
  const int x0 = (int)floorf(xp), y0 = (int)floorf(yp);
  const int x1 = x0 + 1 < cw ? x0 + 1 : cw - 1, y1 = y0 + 1 < ch ? y0 + 1 : ch - 1;
  const float fx = xp - (float)x0, fy = yp - (float)y0;
  const float *f = cube + (size_t)face * ch * cw * 3;
  auto texel = [&](int y, int x) -> V3 {
    const float *t = f + ((size_t)y * cw + x) * 3;
    return {__ldg(t), __ldg(t + 1), __ldg(t + 2)};
  };
  return (texel(y0, x0) * (1.0f - fx) + texel(y0, x1) * fx) * (1.0f - fy) +
         (texel(y1, x0) * (1.0f - fx) + texel(y1, x1) * fx) * fy;
}

// ------------------------------------------------------------------ textures
// ops/textures.py and ops/noise.py, operation for operation.
struct V4 {
  float x, y, z, w;
};

// Non-negative integer wrap: torch.remainder of an int by a positive int.
__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

// torch.remainder of floats on CUDA (ATen): fmod, moved to the sign of b.
__device__ __forceinline__ float float_remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// textures.bilinear_wrap: GL REPEAT, u*w - 0.5, the flat row take, from
// f32[h, w, 4] in device memory through the read-only path.  Software
// bilinear on purpose, as for the cubemap.
__device__ __forceinline__ V4 bilinear_wrap(const float *__restrict__ img, int h, int w, float uu,
                                            float vv) {
  const float u = uu - floorf(uu), v = vv - floorf(vv);
  const float x = u * (float)w - 0.5f, y = v * (float)h - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int x0 = wrap((int)x0f, w), y0 = wrap((int)y0f, h);
  const int x1 = wrap(x0 + 1, w), y1 = wrap(y0 + 1, h);
  const float *t00 = img + ((size_t)y0 * w + x0) * 4, *t01 = img + ((size_t)y0 * w + x1) * 4;
  const float *t10 = img + ((size_t)y1 * w + x0) * 4, *t11 = img + ((size_t)y1 * w + x1) * 4;
  float r[4];
  for (int k = 0; k < 4; ++k)
    r[k] = (__ldg(t00 + k) * (1.0f - fx) + __ldg(t01 + k) * fx) * (1.0f - fy) +
           (__ldg(t10 + k) * (1.0f - fx) + __ldg(t11 + k) * fx) * fy;
  return {r[0], r[1], r[2], r[3]};
}

// noise._gradient_hash: iq's sin hash in [-1, 1]^3.
__device__ __forceinline__ V3 gradient_hash(V3 p) {
  const float d0 = p.x * 127.1f + p.y * 311.7f + p.z * 74.7f;
  const float d1 = p.x * 269.5f + p.y * 183.3f + p.z * 246.1f;
  const float d2 = p.x * 113.5f + p.y * 271.9f + p.z * 124.6f;
  const float s0 = sinf(d0) * 43758.5453f, s1 = sinf(d1) * 43758.5453f,
              s2 = sinf(d2) * 43758.5453f;
  return {-1.0f + 2.0f * (s0 - floorf(s0)), -1.0f + 2.0f * (s1 - floorf(s1)),
          -1.0f + 2.0f * (s2 - floorf(s2))};
}

__device__ __forceinline__ float mix1(float a, float b, float t) { return a + (b - a) * t; }

// noise.gradient_noise
__device__ __forceinline__ float gradient_noise(V3 p) {
  const V3 i = {floorf(p.x), floorf(p.y), floorf(p.z)};
  const V3 f = p - i;
  const V3 u = {f.x * f.x * (3.0f - 2.0f * f.x), f.y * f.y * (3.0f - 2.0f * f.y),
                f.z * f.z * (3.0f - 2.0f * f.z)};
  auto g = [&](float ox, float oy, float oz) {
    const V3 off = {ox, oy, oz};
    return dot(gradient_hash(i + off), f - off);
  };
  return mix1(mix1(mix1(g(0, 0, 0), g(1, 0, 0), u.x), mix1(g(0, 1, 0), g(1, 1, 0), u.x), u.y),
              mix1(mix1(g(0, 0, 1), g(1, 0, 1), u.x), mix1(g(0, 1, 1), g(1, 1, 1), u.x), u.y),
              u.z);
}

// noise.value_noise: channels 1 and 0 (the .yx swizzle) of the LUT,
// bilinear under REPEAT at z-sheared coordinates, lerped along z.
__device__ __forceinline__ float value_noise(const float *__restrict__ lut, int n, V3 x) {
  const V3 p = {floorf(x.x), floorf(x.y), floorf(x.z)};
  V3 f = x - p;
  f = {f.x * f.x * (3.0f - 2.0f * f.x), f.y * f.y * (3.0f - 2.0f * f.y),
       f.z * f.z * (3.0f - 2.0f * f.z)};
  const float u = (p.x + 37.0f * p.z) + f.x, v = (p.y + 17.0f * p.z) + f.y;
  const float x0f = floorf(u), y0f = floorf(v);
  const float fx = u - x0f, fy = v - y0f;
  const int x0 = wrap((int)x0f, n), y0 = wrap((int)y0f, n);
  const int x1 = wrap(x0 + 1, n), y1 = wrap(y0 + 1, n);
  auto fetch = [&](int ch) {
    const float c00 = __ldg(lut + ((size_t)y0 * n + x0) * 4 + ch);
    const float c01 = __ldg(lut + ((size_t)y0 * n + x1) * 4 + ch);
    const float c10 = __ldg(lut + ((size_t)y1 * n + x0) * 4 + ch);
    const float c11 = __ldg(lut + ((size_t)y1 * n + x1) * 4 + ch);
    return (c00 * (1.0f - fx) + c01 * fx) * (1.0f - fy) + (c10 * (1.0f - fx) + c11 * fx) * fy;
  };
  const float g = fetch(1), r = fetch(0);
  return g + (r - g) * f.z;
}

// noise.voronoi: (sqrt F1, sqrt F2, |cell id|) over the 3x3x3 cells, the
// jitter the LUT texel at (x + 3z, y + z).
__device__ __forceinline__ V4 voronoi(const float *__restrict__ lut, int n, V3 x) {
  const V3 p = {floorf(x.x), floorf(x.y), floorf(x.z)};
  const V3 f = x - p;
  float f1 = 100.0f, f2 = 100.0f, cid = 0.0f;
  for (int k = -1; k <= 1; ++k)
    for (int j = -1; j <= 1; ++j)
      for (int i = -1; i <= 1; ++i) {
        const V3 b = {(float)i, (float)j, (float)k};
        const V3 hx = p + b;
        const int tx = wrap((int)floorf(hx.x + 3.0f * hx.z), n);
        const int ty = wrap((int)floorf(hx.y + 1.0f * hx.z), n);
        const float *t = lut + ((size_t)ty * n + tx) * 4;
        const V3 r = (b - f) + V3{__ldg(t), __ldg(t + 1), __ldg(t + 2)};
        const float d = dot(r, r);
        const float new_id = fabsf(hx.x + hx.y * 57.0f + hx.z * 113.0f);
        const bool closer = d < f1;
        f2 = closer ? f1 : (d < f2 ? d : f2);
        cid = closer ? new_id : cid;
        f1 = closer ? d : f1;
      }
  return {sqrtf(f1), sqrtf(f2), cid, 0.0f};
}

// noise.metal_fbm: three octaves of value noise along (-1.2, 1.99, -1.6).
__device__ __forceinline__ float metal_fbm(const float *__restrict__ lut, int n, V3 q) {
  const V3 m = {-1.2f, 1.99f, -1.6f};
  float f = 0.5f * value_noise(lut, n, q);
  q = m * q * 2.01f;
  f = f + 0.25f * value_noise(lut, n, q);
  q = m * q * 2.02f;
  f = f + 0.125f * value_noise(lut, n, q);
  return f;
}

// ------------------------------------------------------------------ SDF shapes
// The distances of ops/sdf.py beyond BOX and ROUND_BOX, operation for
// operation (K1's whole-SDF copy).  Where a shape clamps or selects, a NaN
// argument gives NaN as torch.clamp, torch.maximum and torch.minimum do
// (fmaxf and fminf would drop it), so a Mandelbulb evaluated where its
// polynomial overflows gives the plain version's NaN.

__device__ __forceinline__ bool isnan_(float x) { return x != x; }
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}
// vecmath.length and safe_length
__device__ __forceinline__ float len3(V3 a) { return safe_sqrt(dot(a, a)); }
__device__ __forceinline__ float safe_len3(V3 a) { return sqrtf(max_nan(dot(a, a), EPS)); }
__device__ __forceinline__ float clamp01(float x) { return min_nan(max_nan(x, 0.0f), 1.0f); }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// sdf.sd_cone: (sin, cos, height) c about the y axis
__device__ __forceinline__ float sd_cone(V3 q, const float *c) {
  const float qx = safe_sqrt(q.x * q.x + q.z * q.z), qy = q.y;
  const float d1 = -qy - c[2];
  const float d2 = max_nan(qx * c[0] + qy * c[1], qy);
  const float m1 = max_nan(d1, 0.0f), m2 = max_nan(d2, 0.0f);
  return safe_sqrt(m1 * m1 + m2 * m2) + min_nan(max_nan(d1, d2), 0.0f);
}

// sdf.sd_tri_prism
__device__ __forceinline__ float sd_tri_prism(V3 q, const float *h) {
  return max_nan(fabsf(q.z) - h[1],
                 max_nan(fabsf(q.x) * 0.866025f + q.y * 0.5f, -q.y) - h[0] * 0.5f);
}

// sdf.sd_capsule from a to b, radius r, at the world point p
__device__ __forceinline__ float sd_capsule(V3 p, V3 a, V3 b, float r) {
  const V3 pa = p - a, ba = b - a;
  const float h = clamp01(dot(pa, ba) / max_nan(dot(ba, ba), 1e-12f));
  return len3(pa - ba * h) - r;
}

// sdf._edge_dist2: squared distance from pv to the segment 0 -> edge
__device__ __forceinline__ float edge_dist2(V3 edge, V3 pv) {
  const float h = clamp01(dot(edge, pv) / max_nan(dot(edge, edge), 1e-12f));
  const V3 v = edge * h - pv;
  return dot(v, v);
}

// sdf._face_or_edge: the edge distance in the edge region, else the plane's
__device__ __forceinline__ float face_or_edge(V3 nor, V3 pa, bool edge_region, float d_edge) {
  const float dn = dot(nor, pa);
  const float d_face = dn * dn / max_nan(dot(nor, nor), 1e-12f);
  return safe_sqrt(edge_region ? d_edge : d_face);
}

// sdf.ud_triangle and sdf.ud_quad, vertices relative to the row's pos
__device__ __forceinline__ float ud_triangle(V3 q, V3 a, V3 b, V3 c) {
  const V3 ba = b - a, pa = q - a, cb = c - b, pb = q - b, ac = a - c, pc = q - c;
  const V3 nor = cross(ba, ac);
  const bool edge = (signf(dot(cross(ba, nor), pa)) + signf(dot(cross(cb, nor), pb)) +
                     signf(dot(cross(ac, nor), pc))) < 2.0f;
  const float d_edge = min_nan(min_nan(edge_dist2(ba, pa), edge_dist2(cb, pb)), edge_dist2(ac, pc));
  return face_or_edge(nor, pa, edge, d_edge);
}
__device__ __forceinline__ float ud_quad(V3 q, V3 a, V3 b, V3 c, V3 d) {
  const V3 ba = b - a, pa = q - a, cb = c - b, pb = q - b, dc = d - c, pc = q - c, ad = a - d,
           pd = q - d;
  const V3 nor = cross(ba, ad);
  const bool edge = (signf(dot(cross(ba, nor), pa)) + signf(dot(cross(cb, nor), pb)) +
                     signf(dot(cross(dc, nor), pc)) + signf(dot(cross(ad, nor), pd))) < 3.0f;
  const float d_edge = min_nan(min_nan(edge_dist2(ba, pa), edge_dist2(cb, pb)),
                               min_nan(edge_dist2(dc, pc), edge_dist2(ad, pd)));
  return face_or_edge(nor, pa, edge, d_edge);
}

// sdf.disp at power 1 (torch.pow copies its base for an exponent of 1)
__device__ __forceinline__ float disp(V3 p, float phase) {
  return 0.5f + 0.5f * cosf(p.x + 1.5f * phase) * sinf(p.y + 2.0f * phase) *
                    sinf(p.z + 1.0f * phase);
}

// sdf.sd_sea_box: the box (its distance `box`) below a displaced sea plane
// at `level`
__device__ __forceinline__ float sd_sea_box(V3 q, float box, float level) {
  const float sea = (q.x * 0.0f + q.y * -1.0f + q.z * 0.0f + level) -
                    disp(q * 10.0f, 2.5f) * 0.07f - disp(q * 15.0f, 4.5f) * 0.03f;
  return max_nan(-sea, box);
}

// sdf.siggraph_obj; its axis (-2, 2, 1) / 3 rounded once in float32
__device__ __forceinline__ float siggraph_obj(V3 q) {
  const V3 ax = {-2.0f / 3.0f, 2.0f / 3.0f, 1.0f / 3.0f};
  const float d1 = dot(q, ax) - 0.1f;
  const float d2 = len3(q) - 1.0f;
  const V3 pc = q - V3{0.0f, -0.2f, -0.2f};
  const float d3 = len3(pc - ax * dot(pc, ax)) - 1.0f;
  return max_nan(max_nan(d1, d2), -d3);
}

// sdf.menger_sponge: 4 iterations carved from a box (its distance `box`)
__device__ __forceinline__ float menger_sponge(V3 q, float box) {
  float d = box;
  float sc = 1.0f;
  for (int it = 0; it < 4; ++it) {
    const V3 ps = q * sc;
    const V3 a = {float_remainder(ps.x, 2.0f) - 1.0f, float_remainder(ps.y, 2.0f) - 1.0f,
                  float_remainder(ps.z, 2.0f) - 1.0f};
    sc = sc * 3.0f;
    const V3 r = {fabsf(1.0f - 3.0f * fabsf(a.x)), fabsf(1.0f - 3.0f * fabsf(a.y)),
                  fabsf(1.0f - 3.0f * fabsf(a.z))};
    const float da = max_nan(r.x, r.y), db = max_nan(r.y, r.z), dc = max_nan(r.z, r.x);
    const float c = (min_nan(da, min_nan(db, dc)) - 1.0f) / sc;
    d = max_nan(c, d);
  }
  return d;
}

// sdf.mandelbulb: power 8, 3 iterations, the done-mask of the early break
__device__ __forceinline__ float mandelbulb(V3 q) {
  V3 w = q;
  float m = dot(w, w);
  float dz = 1.0f;
  bool done = false;
  for (int it = 0; it < 3; ++it) {
    const float m2 = m * m, m4 = m2 * m2;
    const float dz_new = 8.0f * sqrtf(max_nan(m4 * m2 * m, 1e-20f)) * dz + 1.0f;
    const float x = w.x, y = w.y, z = w.z;
    const float x2 = x * x, y2 = y * y, z2 = z * z;
    const float x4 = x2 * x2, y4 = y2 * y2, z4 = z2 * z2;
    const float k3 = x2 + z2;
    const float k3_2 = k3 * k3;
    const float k3_7 = (k3 * k3_2) * (k3_2 * k3_2);  // jnp's integer_pow(k3, 7)
    const float k2 = 1.0f / sqrtf(max_nan(k3_7, 1e-20f));
    const float k1 = x4 + y4 + z4 - 6.0f * y2 * z2 - 6.0f * x2 * y2 + 2.0f * z2 * x2;
    const float k4 = x2 - y2 + z2;
    const float wx = q.x + 64.0f * x * y * z * (x2 - z2) * k4 * (x4 - 6.0f * x2 * z2 + z4) * k1 * k2;
    const float wy = q.y + -16.0f * y2 * k3 * k4 * k4 + k1 * k1;
    const float wz = q.z + -8.0f * y * k4 *
                               (x4 * x4 - 28.0f * x4 * x2 * z2 + 70.0f * x4 * z4 -
                                28.0f * x2 * z2 * z4 + z4 * z4) *
                               k1 * k2;
    if (!done) {
      w = {wx, wy, wz};
      dz = dz_new;
      m = dot(w, w);
    }
    done = done || m > 4.0f;
  }
  const float ms = max_nan(m, 1e-12f);
  return 0.25f * logf(ms) * sqrtf(ms) / dz;
}

// sdf._entry_distance of SDF row `row` of shape `shape` at p.
__device__ __forceinline__ float sdf_entry_all(const SceneSmem &s, int row, int shape, V3 p,
                                               const float *lut, int lut_n) {
  const V3 pos = s.p(row);
  const V3 q = p - pos;
  const float *j = s.col(row, C_J0);
  const float *ax = s.col(row, C_AUX);
  switch (shape) {
    case SDF_BOX:
    case SDF_ROUND_BOX:
      return sdf_entry(s, row, shape, p);
    case SDF_SPHERE:
      return len3(q) - j[0];
    case SDF_TRI_PRISM:
      return sd_tri_prism(q, j);
    case SDF_CONE:
      return sd_cone(q, j);
    case SDF_MENGER:  // the box of half-extents joker.xyz (sdf.sd_box, BOX's row)
      return menger_sponge(q, sdf_entry(s, row, SDF_BOX, p));
    case SDF_MANDELBULB:
      return mandelbulb(q);
    case SDF_ELLIPSOID: {
      const V3 qr = {q.x / j[0], q.y / j[1], q.z / j[2]};
      return (safe_len3(qr) - 1.0f) * min_nan(min_nan(j[0], j[1]), j[2]);
    }
    case SDF_CAPSULE:
      return sd_capsule(p, pos, V3{j[0], j[1], j[2]}, j[3]);
    case SDF_SNOWBALL:
      return (len3(q) - j[0]) - value_noise(lut, lut_n, q * 8.0f) * 0.04f;
    case SDF_SEA_BOX:
      return sd_sea_box(q, sdf_entry(s, row, SDF_BOX, p), j[3]);
    case SDF_SIGGRAPH:
      return siggraph_obj(q);
    case SDF_TRIANGLE:
      return ud_triangle(q, V3{ax[0], ax[1], ax[2]}, V3{ax[3], ax[4], ax[5]},
                         V3{ax[6], ax[7], ax[8]});
    default:  // SDF_QUAD
      return ud_quad(q, V3{ax[0], ax[1], ax[2]}, V3{ax[3], ax[4], ax[5]}, V3{ax[6], ax[7], ax[8]},
                     V3{ax[9], ax[10], ax[11]});
  }
}

// sdf.scene_map over every shape: the first entry of the least distance,
// a NaN distance winning as torch.minimum lets it.  Not inlined: K1's
// whole-SDF copy calls it from each march and normal tap, and one copy of
// the 14 distances keeps the kernel's code (and nvcc's time) small.
__device__ __attribute__((noinline)) SdfNear sdf_map_all(SceneSmem s, SdfScene sd, V3 p,
                                                         const float *lut, int lut_n) {
  float best = sdf_entry_all(s, sd.first, sd.shape[0], p, lut, lut_n);
  int k = 0;
  for (int i = 1; i < sd.count; ++i) {
    const float d = sdf_entry_all(s, sd.first + i, sd.shape[i], p, lut, lut_n);
    if (d < best) k = i;
    best = min_nan(d, best);
  }
  return {best, k};
}

// textures.get_texel for a hit at `x` with geometric normal `n` of a mesh
// of texture type `t`, mesh type `mesh` and texture params `tp` (the UV of
// intersect.parse_hit for the image and pattern types).  No texture gives
// zeros.  Inlined: as a call it cost the bounce loop 96 registers against
// 80 inline, and was slower on every scene measured (PERF.md).
__device__ __forceinline__ V4 get_texel(int t, int mesh, const float *tp, V3 x, V3 n,
                                        const float *__restrict__ images, int img_h, int img_w,
                                        const float *__restrict__ lut, int lut_n) {
  if (t < 0 || t > TEX_METAL) return {0.0f, 0.0f, 0.0f, 0.0f};
  if (t <= TEX_IMAGE3 || t == TEX_CHECK || t == TEX_RIPPLE) {
    float uu, vv;
    if (mesh == MESH_SPHERE) {
      // spherical UV from the *world* hit position (the reference's quirk)
      const float rho = sqrtf(fmaxf(dot(x, x), EPS));
      const float phi = asinf(fminf(fmaxf(x.y / rho, -0.999999f), 0.999999f));
      uu = phi / PI;
      vv = atan2f(x.z, x.x) / TWO_PI;
    } else {  // planar by the dominant normal axis
      const float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
      const bool x_dom = ax > ay && ax > az, y_dom = ay > ax && ay > az;
      uu = x_dom ? -x.z : x.x;
      vv = x_dom ? -x.y : (y_dom ? x.z : -x.y);
    }
    if (t <= TEX_IMAGE3)
      return bilinear_wrap(images + (size_t)t * img_h * img_w * 4, img_h, img_w, uu, vv);
    float val;
    if (t == TEX_CHECK) {
      val = float_remainder(floorf(tp[0] * uu) + floorf(tp[1] * vv), fmaxf(tp[2], 1e-6f));
    } else {
      const float du = uu - tp[0], dv = vv - tp[1];
      val = float_remainder(ceilf(sqrtf(du * du + dv * dv) * tp[2]), fmaxf(tp[3], 1e-6f));
    }
    return {val, val, val, val};
  }
  const V3 scaled = {tp[0] * x.x, tp[1] * x.y, tp[2] * x.z};
  if (t == TEX_VORONOI) return voronoi(lut, lut_n, scaled);
  float val;
  if (t == TEX_GRADIENT_NOISE) {
    const float tt = fminf(fmaxf((gradient_noise(scaled) + 0.7f) / 1.4f, 0.0f), 1.0f);
    val = tt * tt * (3.0f - 2.0f * tt);  // smoothstep(-0.7, 0.7, f)
  } else if (t == TEX_VALUE_NOISE) {
    val = value_noise(lut, lut_n, scaled);
  } else {
    val = metal_fbm(lut, lut_n, scaled);
  }
  return {val, val, val, val};
}

// The color of a shadow ray's hit of LIGHT mesh `idx` at `hp` in a scene
// with textures: the mesh's color c with its texel blended in by the texel's
// alpha, whatever the mesh's blend flags (lighting.direct_light_slot, the
// reference's raytracer.glsl:1203); a shadow hit has no normal, so a
// planar UV is the (x, -y) one.
__device__ __forceinline__ V3 shadow_texel_color(const TraceArgs &a, const SceneSmem &s,
                                                 const int *tex, int idx, V3 hp, V3 c) {
  const V4 t = get_texel(tex[idx], s.mesh[idx], s.col(idx, C_TP), hp, V3{0.0f, 0.0f, 0.0f},
                         a.images, a.img_h, a.img_w, a.noise, a.noise_n);
  return c + (V3{t.x, t.y, t.z} - c) * t.w;
}

// lighting.sample_lights_nee without the throughput factor: the sum over
// light slots of the shadow-tested contribution.  A sphere light is sampled
// by a uniform cone; a directional light (its pos is the direction) is lit
// where the occlusion ray escapes, and under MIS its weight is 0 (its light
// pdf is 0), so it adds nothing; any other slot adds nothing.  kTex (a
// scene whose LIGHT meshes have textures, use_tex bit 1) blends the shadow
// hit's texel into its color (shadow_texel_color, from `a` and the texture
// codes `tex`); any other scene runs the code without it.  kAll (K1's
// whole-SDF copy) marches every SDF shape and samples an SDF light (a LIGHT
// SDF row) at a uniform point of its bounding ellipsoid, pos + direction *
// joker.xyz, unweighted, its MIS pdf the uniform sphere's 1/4pi.  kMedium
// (K1's medium copy) attenuates a sphere light's shadow ray by Beer-Lambert
// fog over its hit's distance under `a->use_volumetrics` (the SDF and
// directional lights' stay unfogged, as in the plain version).
template <bool kSdf, bool kTex, bool kAll = false, bool kMedium = false>
__device__ V3 shade_nee(const SceneSmem &s, const SdfScene &sd, const PackedScene &pk, V3 x, V3 nl,
                        uint32_t h_depth, float eps, float inf, bool use_mis, const TraceArgs *a,
                        const int *tex) {
  V3 total = {0.0f, 0.0f, 0.0f};
  for (int slot = 0; slot < s.n_lights; ++slot) {
    int li = s.lights[slot];
    if (li < 0) continue;  // sentinel slot: no light
    if (s.mat[li] == MAT_DIR_LIGHT) {
      if (use_mis) continue;
      V3 lp = s.p(li);
      float ts;
      int hidx;
      intersect_packed<kSdf, kAll>(s, sd, pk, x + nl * eps, normalize(lp), eps, inf, ts, hidx,
                                   kAll ? a->noise : nullptr, kAll ? a->noise_n : 0);
      if (ts < inf) continue;  // occluded
      total = total + s.c(li) * s.e(li) * fmaxf(dot(lp, nl), 0.001f);
      continue;
    }
    if constexpr (kAll) {
      if (s.mat[li] == MAT_LIGHT && s.mesh[li] == MESH_SDF) {
        // sampling.random_sphere_direction from the NEE_SDF_POINT stream
        const uint32_t h = fold_step(fold_step(h_depth, (uint32_t)slot, 4u), S_NEE_SDF_POINT, 5u);
        const float u1 = u01(h), u2 = u01(pcg(h));
        const float z = 1.0f - 2.0f * u1;
        const float r = safe_sqrt(1.0f - z * z);
        const float phi = TWO_PI * u2;
        const V3 lp = s.p(li);
        const float *j = s.col(li, C_J0);
        const V3 sr = normalize(lp + V3{r * cosf(phi), r * sinf(phi), z} * V3{j[0], j[1], j[2]} - x);
        float ts;
        int hidx;
        intersect_packed<kSdf, kAll>(s, sd, pk, x + nl * eps, sr, eps, inf, ts, hidx,
                                   kAll ? a->noise : nullptr, kAll ? a->noise_n : 0);
        if (!(ts < inf) || s.mat[hidx] != MAT_LIGHT) continue;
        V3 lc = s.c(hidx);
        if constexpr (kTex) lc = shadow_texel_color(*a, s, tex, hidx, x + nl * eps + sr * ts, lc);
        V3 contrib = vmax(lc, 0.001f) * s.e(hidx) * fmaxf(dot(sr, nl), 0.001f);
        if (use_mis) {
          if (!(dot(contrib, contrib) > 1e-6f)) continue;
          const float b_pdf = fmaxf(dot(normalize(lp - x), nl), 0.0f) * ONE_OVER_PI;
          contrib = contrib * power_heuristic(INV_FOUR_PI, b_pdf);
        }
        total = total + contrib;
        continue;
      }
    }
    if (s.mat[li] != MAT_LIGHT || s.mesh[li] != MESH_SPHERE) continue;
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
    intersect_packed<kSdf, kAll>(s, sd, pk, x + nl * eps, sr, eps, inf, ts, hidx,
                                   kAll ? a->noise : nullptr, kAll ? a->noise_n : 0);
    if (!(ts < inf) || s.mat[hidx] != MAT_LIGHT) continue;
    float cos_term = fmaxf(dot(sr, nl), 0.001f);
    float weight = 2.0f * (1.0f - cos_a_max);
    V3 lc = s.c(hidx);
    if constexpr (kTex) lc = shadow_texel_color(*a, s, tex, hidx, x + nl * eps + sr * ts, lc);
    float weight_t = weight * cos_term;
    if constexpr (kMedium) {
      const MediumArgs &m = medium_args(*a);
      if (m.use_volumetrics) weight_t = weight_t * expf(-m.sigma_t * ts);
    }
    V3 contrib = vmax(lc, 0.001f) * s.e(hidx) * weight_t;
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

// integrator._volumetric_nee without the throughput factor: the in-scatter
// light at the medium event at `x` of a ray along `d` (RNG key h_depth).  Per
// LIGHT-sphere slot a uniform cone toward the sphere from the VOL_NEE stream,
// a shadow ray from vol_eps along it that counts only where it hits that
// light, weighted by the HG phase, the fog over its length, pi and the cone's
// solid angle; the light's table color and emission, untextured.
template <bool kSdf, bool kAll>
__device__ V3 medium_nee(const SceneSmem &s, const SdfScene &sd, const PackedScene &pk, V3 x, V3 d,
                         uint32_t h_depth, const MediumArgs &a) {
  V3 total = {0.0f, 0.0f, 0.0f};
  for (int slot = 0; slot < s.n_lights; ++slot) {
    const int li = s.lights[slot];
    if (li < 0 || s.mat[li] != MAT_LIGHT || s.mesh[li] != MESH_SPHERE) continue;
    const V3 dl = s.p(li) - x;
    const float dist = sqrtf(fmaxf(dot(dl, dl), EPS));
    const float r = s.j0(li);
    const float r2 = r * r;
    const float cos_a_max =
        safe_sqrt(1.0f - fminf(fmaxf(r2 / fmaxf(dist * dist, EPS), 0.0f), 1.0f));
    const uint32_t h = fold_step(fold_step(h_depth, (uint32_t)slot, 4u), S_VOL_NEE, 5u);
    const V3 dir = sample_cone(V3{dl.x / dist, dl.y / dist, dl.z / dist}, 1.0f - cos_a_max,
                               u01(h), u01(pcg(h)));
    float ts;
    int hidx;
    intersect_packed<kSdf, kAll>(s, sd, pk, x + dir * a.vol_eps, dir, a.eps, a.inf, ts, hidx,
                                 kAll ? a.noise : nullptr, kAll ? a.noise_n : 0);
    if (!(ts < a.inf) || hidx != li) continue;  // must hit this light
    const float omega = 2.0f * (1.0f - cos_a_max);
    const float phase = hg_phase(dot(d, dir), a.hg_1pg2, a.hg_2g, a.hg_1mg2);
    const float t_fog = expf(-a.sigma_t * ts);
    total = total + s.c(li) * s.e(li) * (phase * t_fog * PI * omega);
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

// Occupancy of `kernel` at `threads` threads a block and `smem` bytes of
// dynamic shared memory (host code, for the launchers' *_occupancy exports):
// out = {blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// registers per thread, local memory (stack and spills) per thread in
// bytes}.  Returns the first CUDA error, or 0.
template <class K>
inline int kernel_occupancy(K kernel, int threads, size_t smem, int *out) {
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = blocks;
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return (int)e;
}

// fold(pix, pass, sample): the key shared by every draw of pixel `p`.
__device__ __forceinline__ uint32_t pixel_hash(const TraceArgs &a, long long p) {
  return fold_step(fold_step(fold_step(0x5BD1E995u, (uint32_t)a.pix[p], 0u), a.pass_idx, 1u),
                   a.sample_idx, 2u);
}

}  // namespace
