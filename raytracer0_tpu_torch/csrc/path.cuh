// path.cuh — the bounce loop of one path, shared by the forward megakernel K1
// (megakernel.cu) and the G-buffer kernel K4 (gbuffer.cu), the first stage
// of the ReSTIR pass K6; the adjoint K7 (restir_bwd.cu) replays it.
//
// `path_step` is one bounce of the plain version's `integrator.trace`, and
// `trace_path` drives it over one pixel's path:
// environment on a miss, the texel of the hit, emissive termination with the
// BSDF-side MIS weight, the BSDF dispatch, the cubemap gather ray, the
// direct light of a diffuse vertex, the luminance cutoff and the bounce caps.
// The kernels differ only in the direct light of a diffuse vertex, which the
// caller passes as a functor: K1 runs per-light NEE (`shade_nee`), K4
// records the vertex in the G-buffer and adds nothing (the reservoir-vertex
// kernel K6v runs the recorded vertices after it).  `kSdf` compiles the
// SDF march into the intersections; K1 and K4 build a copy without it for
// scenes without SDF meshes.  K1 runs one pixel per thread (trace_path);
// K4 keeps its lanes busy with new pixels as paths end
// (gbuffer.cu::regenerate_paths).  Both scan the scene through its packed
// records (intersect_packed).  `kAll` compiles K1's and K4's copies for the
// whole SDF class: every SDF shape, the texel of an SDF hit and (K1's)
// SDF-light NEE.  `kMedium` compiles K1's medium copy: the medium event
// before the miss test and Cauchy dispersion (K4 never instantiates it).

#pragma once

#include "trace_common.cuh"

namespace {

// One BSDF sample (ops/bsdf.py::sample) for a hit of material `mat`.  With
// kMedium (K1's medium copy) and `spectral`, a negative IOR is dispersive:
// Cauchy's IOR at the hero wavelength `hero_wl` with |ior| as A, for the
// refraction and the Schlick or Fresnel reflectance (COAT's too).
struct Bounce {
  V3 o, d, mult;   // next origin and direction, throughput multiplier
  bool specular;   // NEE and the gather ray skip specular bounces
  int dif, spec, scat;  // bounce-counter increments
};

template <bool kMedium = false>
__device__ __forceinline__ Bounce bsdf_sample(const SceneSmem &s, int idx, V3 x, V3 nl, V3 d, V3 c,
                                              V3 e, float inside, float u1, float u2, float uc,
                                              float eps, bool biased, bool spectral = false,
                                              float hero_wl = 0.0f) {
  const int mat = s.mat[idx];
  const V3 rand_dir = random_direction(nl, u1, u2, biased);
  Bounce b = {x + nl * eps, rand_dir, c, false, 1, 0, 0};  // DIFF
  if (mat == MAT_DIFF) return b;
  // emission doubles as glossiness: e >= 0.001, so a mirror keeps a little
  const V3 rough = e * rand_dir;
  const V3 refl = normalize(rough + reflect(d, nl));
  const V3 one = {1.0f, 1.0f, 1.0f};
  if (mat == MAT_SPEC) {
    b.d = refl;
    b.specular = true;
    b.dif = 0;
    b.spec = 1;
    return b;
  }
  float nt = fmaxf(fabsf(s.ior(idx)), 1e-3f);
  if constexpr (kMedium) {
    const float ior = s.ior(idx);
    if (spectral && ior < 0.0f) {  // spectral.cauchy_ior(hero_wl, |ior|)
      const float lu = hero_wl * 0.001f;
      nt = fmaxf(fabsf(ior) + 0.04f / fmaxf(lu * lu, 1e-6f), 1e-3f);
    }
  }
  if (mat == MAT_REFR_FRESNEL || mat == MAT_REFR_SCHLICK) {
    const float nnt = inside > 0.0f ? IOR_AIR / nt : nt / IOR_AIR;
    bool tir;
    const V3 tdir = normalize(rough + refract(d, nl, nnt, tir));
    const float re = mat == MAT_REFR_FRESNEL ? fresnel(d, nl, IOR_AIR, nt, tdir)
                                             : schlick(d, nl, IOR_AIR, nt);
    b.specular = true;
    b.dif = 0;
    if (tir || uc < re) {  // reflect
      b.d = refl;
      b.mult = one;
      b.spec = 1;
    } else {               // transmit: SCATTERING_EVENTS, as the reference counts it
      b.o = x - nl * eps;
      b.d = tdir;
      b.scat = 1;
    }
    return b;
  }
  // COAT: specular by Schlick, else diffuse
  if (uc < schlick(d, nl, IOR_AIR, nt)) {
    b.d = refl;
    b.mult = one;
    b.specular = true;
    b.dif = 0;
    b.spec = 1;
  }
  return b;
}

// What K1, K4, K6v, K7 and K2's wide copy keep in shared memory after
// load_scene()'s part (K2's Cornell copy reads load_scene()'s alone): the
// texture codes and blend flags of the meshes and the SDF rows' shapes.
struct PathSmem {
  const int *tex, *blend;
  SdfScene sd;
};

// Bytes of shared memory load_path() fills, load_scene()'s included.
__host__ __device__ inline size_t path_smem_bytes(int n_mesh, int n_lights, int n_sdf) {
  return scene_smem_bytes(n_mesh, n_lights) + sizeof(int) * (2 * n_mesh + n_sdf);
}

// Copy the scene, the texture codes and the SDF shapes into shared memory.
// Every thread of the block must call it: it ends with __syncthreads().
__device__ __forceinline__ PathSmem load_path(const TraceArgs &a, float *smem, SceneSmem &s) {
  int *s_tex = reinterpret_cast<int *>(smem) + scene_smem_bytes(a.n_mesh, a.n_lights) / sizeof(int);
  int *s_blend = s_tex + a.n_mesh;
  int *s_sdf = s_blend + a.n_mesh;
  for (int i = threadIdx.x; i < a.n_mesh; i += blockDim.x) {
    s_tex[i] = a.tex[i];
    s_blend[i] = a.blend[i];
  }
  for (int i = threadIdx.x; i < a.n_sdf; i += blockDim.x) s_sdf[i] = a.sdf[i];
  s = load_scene(a, smem);
  return {s_tex, s_blend, {s_sdf, a.n_analytic, a.n_sdf, a.steps, a.fudge, a.t0}};
}

// The color and emission of a hit on mesh `idx` at `x` (geometric normal
// `n`) before their floor of 0.001: the mesh's own, with its texel blended
// in by the texel's alpha where the mesh's flags ask for it
// (integrator.hit_color_emission).  K2 replays it (megakernel_bwd.cu).
__device__ __forceinline__ void blended_color_emission(const TraceArgs &a, const SceneSmem &s,
                                                       const PathSmem &ps, int idx, V3 x, V3 n,
                                                       V3 &c, V3 &e) {
  c = s.c(idx);
  e = s.e(idx);
  if (a.use_tex && ps.blend[idx]) {
    const V4 t = get_texel(ps.tex[idx], s.mesh[idx], s.col(idx, C_TP), x, n, a.images, a.img_h,
                           a.img_w, a.noise, a.noise_n);
    const V3 tc = {t.x, t.y, t.z};
    const float bc = (ps.blend[idx] & 1) ? t.w : 0.0f, be = (ps.blend[idx] & 2) ? t.w : 0.0f;
    const float *cm = s.col(idx, C_CM), *em = s.col(idx, C_EM);
    c = c + (tc * V3{cm[0], cm[1], cm[2]} - c) * bc;
    e = e + (tc * V3{em[0], em[1], em[2]} - e) * be;
  }
}

// A lane's path between two bounces: the state of trace_path's loop, so a
// path can be advanced one bounce at a time (path_step) and a lane can
// take a new pixel when its path ends (gbuffer.cu::regenerate_paths).
struct PathState {
  V3 o, d, mask, acc, prev_nl;
  bool specular;             // primary rays count as specular
  int ndif, nspec, nscat;    // bounce counters
  int depth;                 // the next bounce
  uint32_t h_pix;            // pixel_hash(a, p): every draw of the pixel keys on it
  long long p;               // the pixel
};

__device__ __forceinline__ PathState path_start(const TraceArgs &a, long long p) {
  PathState st;
  st.o = {a.ro[3 * p], a.ro[3 * p + 1], a.ro[3 * p + 2]};
  st.d = {a.rd[3 * p], a.rd[3 * p + 1], a.rd[3 * p + 2]};
  st.h_pix = pixel_hash(a, p);
  st.mask = {1.0f, 1.0f, 1.0f};
  st.acc = {0.0f, 0.0f, 0.0f};
  st.specular = true;
  st.prev_nl = {0.0f, 1.0f, 0.0f};
  st.ndif = st.nspec = st.nscat = 0;
  st.depth = 0;
  st.p = p;
  return st;
}

// Bounce `st.depth` of the path: returns whether the path goes on (the
// drivers stop it at the bounce budget), since every later bounce of an
// ended path would be a no-op.  At each diffuse
// vertex (hit point x, oriented normal nl, mesh idx, RNG key h_depth, the
// diffuse bounces before it ndif, bounce depth, throughput after the
// bounce mask_after) it adds direct(x, nl, idx, h_depth, ndif, depth,
// mask_after) * mask_after.  kMedium (K1's medium copy) adds the medium
// event of `a.use_volumetrics` before the miss test, so a ray that misses
// can scatter, and Cauchy dispersion under `a.use_spectral`.
template <bool kSdf, bool kAll = false, bool kMedium = false, class Direct>
__device__ __forceinline__ bool path_step(const TraceArgs &a, const SceneSmem &s,
                                          const PathSmem &ps, const PackedScene &pk,
                                          PathState &st, Direct &direct) {
  const V3 o = st.o, d = st.d, mask = st.mask;
  const int depth = st.depth;
  float tmin;
  int idx;
  // the value-noise LUT of a SNOWBALL, for the whole-SDF copy's scene map
  const float *lut = kAll ? a.noise : nullptr;
  const int lut_n = kAll ? a.noise_n : 0;
  const bool sdf_hit =
      intersect_packed<kSdf, kAll>(s, ps.sd, pk, o, d, a.eps, a.inf, tmin, idx, lut, lut_n);

  // ---- medium event: a free path shorter than the hit (or than `inf` on a
  // miss) scatters; the throughput takes sigma_s / sigma_t, the in-scatter
  // NEE adds with it, the path goes on along an HG direction (prev_nl and
  // the other counters stay, so the next light hit's MIS weight reads the
  // stale prev_nl) ----
  if constexpr (kMedium) {
    const MediumArgs &m = medium_args(a);
    if (m.use_volumetrics) {
      const uint32_t h_vol = fold_step(st.h_pix, (uint32_t)depth, 3u);
      const float scatter_d =
          -logf(fmaxf(u01(fold_step(h_vol, S_VOL_FREEPATH, 4u)), 1e-6f)) / m.sigma_t;
      if (scatter_d < fminf(a.inf, tmin)) {
        const V3 sp = o + d * scatter_d;
        st.mask = mask * m.vol_w;
        if (a.sample_lights && s.n_lights > 0)
          st.acc = st.acc + st.mask * medium_nee<kSdf, kAll>(s, ps.sd, pk, sp, d, h_vol, m);
        const uint32_t h_hg = fold_step(h_vol, S_VOL_PHASE, 4u);
        const V3 hg_dir = sample_hg(d, m.hg_g, u01(h_hg), u01(pcg(h_hg)));
        st.nscat += 1;
        st.specular = false;
        if (st.nscat >= a.max_scatter ||
            fmaxf(fmaxf(st.mask.x, st.mask.y), st.mask.z) < 0.01f)
          return false;
        st.o = sp;
        st.d = hg_dir;
        return true;
      }
    }
  }

  // ---- miss: environment, suppressed for non-specular paths under NEE ----
  if (!(tmin < a.inf)) {
    if (st.specular || !a.sample_lights) {
      if (a.use_cubemap)
        st.acc = st.acc + mask * sample_cubemap(a.cubemap, a.cube_h, a.cube_w, d);
      else if (a.use_sky)
        st.acc = st.acc + mask * procedural_sky(d);
    }
    return false;
  }

  V3 x = o + d * tmin;
  // an SDF hit's normal is the field's gradient; its texel (kAll: K1's and
  // K4's whole-SDF copies, the only ones that meet textured SDF rows) reads the UV
  // of its row's box normal, as intersect.parse_hit gives it
  V3 n = sdf_hit ? sdf_normal<kAll>(s, ps.sd, x, a.eps, lut, lut_n) : normal_at(s, idx, x);
  V3 c, e;
  blended_color_emission(a, s, ps, idx, x, kAll && sdf_hit ? normal_at(s, idx, x) : n, c, e);
  c = vmax(c, 0.001f);
  e = vmax(e, 0.001f);
  float inside = dot(d, n) > 0.0f ? -1.0f : 1.0f;

  // ---- emissive hit: BSDF-side MIS weight from prev_nl, terminate ----
  const int mat = s.mat[idx];
  if (mat == MAT_LIGHT) {
    float mis_w = 1.0f;
    if (a.use_mis && a.sample_lights && depth > 0 && !st.specular) {
      V3 light_dir = normalize(x - o);
      float l_pdf = s.mesh[idx] == MESH_SPHERE ? sphere_light_pdf(s.p(idx), s.j0(idx), o)
                                               : INV_FOUR_PI;
      float b_pdf = fmaxf(dot(light_dir, st.prev_nl), 0.0f) * ONE_OVER_PI;
      mis_w = power_heuristic(b_pdf, l_pdf);
    }
    st.acc = st.acc + mask * c * e * mis_w;
    return false;
  }

  // a DIR_LIGHT surface has no BSDF: the path ends
  if (mat == MAT_DIR_LIGHT) return false;

  // ---- BSDF sample ----
  const uint32_t h_depth = fold_step(st.h_pix, (uint32_t)depth, 3u);
  const uint32_t h_dir = fold_step(h_depth, S_BSDF_DIR, 4u);
  const V3 nl = n * inside;
  bool spectral = false;
  float hero_wl = 0.0f;  // spectral.sample_wavelength of the WAVELENGTH draw (no depth)
  if constexpr (kMedium) {
    spectral = medium_args(a).use_spectral != 0;
    hero_wl = u01(fold_step(st.h_pix, S_WAVELENGTH, 3u)) * 340.0f + 380.0f;
  }
  const Bounce b = bsdf_sample<kMedium>(s, idx, x, nl, d, c, e, inside, u01(h_dir),
                                        u01(pcg(h_dir)), u01(fold_step(h_depth, S_BSDF_CHOICE, 4u)),
                                        a.eps, a.use_biased, spectral, hero_wl);
  const V3 mask_after = mask * b.mult;

  if (!b.specular) {
    // ---- cubemap gather ray on the diffuse vertex ----
    if (a.use_cubemap) {
      const uint32_t h_env = fold_step(h_depth, S_ENV_DIR, 4u);
      const V3 env_dir = random_direction(nl, u01(h_env), u01(pcg(h_env)), a.use_biased);
      float te;
      int ie;
      intersect_packed<kSdf, kAll>(s, ps.sd, pk, x + nl * a.eps, env_dir, a.eps, a.inf, te, ie,
                                   lut, lut_n);
      if (!(te < a.inf))
        st.acc = st.acc + mask_after * sample_cubemap(a.cubemap, a.cube_h, a.cube_w, env_dir);
    }
    // ---- direct light on the diffuse vertex ----
    if (a.sample_lights)
      st.acc = st.acc + direct(x, nl, idx, h_depth, st.ndif, depth, mask_after) * mask_after;
  }

  // ---- commit ----
  st.o = b.o;
  st.d = b.d;
  st.mask = mask_after;
  st.specular = b.specular;
  st.prev_nl = nl;
  st.ndif += b.dif;
  st.nspec += b.spec;
  st.nscat += b.scat;

  // ---- luminance cutoff + per-type caps ----
  if (fmaxf(fmaxf(mask_after.x, mask_after.y), mask_after.z) < 0.01f || st.ndif >= a.max_diff ||
      st.nspec >= a.max_spec || st.nscat >= a.max_scatter)
    return false;
  return true;
}

// The radiance of pixel `p`'s path: path_step until the path ends, one
// pixel per thread (K1's driver).
template <bool kSdf, bool kAll = false, bool kMedium = false, class Direct>
__device__ __forceinline__ V3 trace_path(const TraceArgs &a, const SceneSmem &s, const PathSmem &ps,
                                         const PackedScene &pk, long long p, Direct &direct) {
  PathState st = path_start(a, p);
  for (int depth = 0; depth < a.max_bounces; ++depth) {
    st.depth = depth;
    if (!path_step<kSdf, kAll, kMedium>(a, s, ps, pk, st, direct)) break;
  }
  return st.acc;
}

}  // namespace
