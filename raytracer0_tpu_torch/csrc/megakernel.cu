// megakernel.cu — forward path-tracing megakernel K1 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
// raytracer0_tpu/ops/megakernel.py::_fwd_kernel_body (launched by `_forward`)
// and ::_env_kernel_body (launched by `_env_forward`, photographic cubemaps),
// for analytic SPHERE/PLANE/BOX meshes and every surface material: the BSDF
// dispatch over DIFF, SPEC, REFR_FRESNEL, REFR_SCHLICK and COAT (cosine or
// uniform hemisphere sampling), DIR_LIGHT surfaces that end a path, sphere-
// and directional-light NEE with optional power-heuristic MIS, the cubemap
// or procedural-sky environment, the cubemap gather ray on diffuse bounces,
// textures of all ten types blended into a hit's color and emission, the
// luminance cutoff and the per-type bounce caps.  It also replaces
// ::_imgtex_kernel_body (launched by `_imgtex_forward`, image textures) and
// ::_gloss_kernel_body (launched by `_gloss_launch`, image textures on the
// glossiness of a SPEC surface).
//
// The Pallas env kernel records a (weight, direction) pair per cubemap fetch
// and resolves the records afterwards with XLA gathers, because Mosaic has no
// per-lane gather.  Here each thread fetches its texels itself
// (trace_common.cuh::sample_cubemap): a 256x256 cubemap is 4.7 MB and stays in
// the 50 MB L2, and the records, and the second pass over them, are gone.
// The same holds for image textures: the Pallas imgtex kernel shades with a
// 0.5-gray placeholder texel and divides the true texel back in on the host,
// and the gloss split exports a record at each textured SPEC vertex and
// relaunches the path suffixes.  Here each thread fetches its own texel
// (trace_common.cuh::get_texel) before the emissive test and the BSDF
// sample, so the textured color, emission and glossiness enter the path
// where they are used, in one launch; the 1 MiB noise LUT is read from L2.
// Its plain PyTorch version is raytracer0_tpu_torch/render/integrator.py::trace;
// the kernel follows that function's operations in the same order, so on the
// same inputs the two agree to the last bit except where a libm call rounds
// differently.
//
// What bounds it: each pixel reads 28 bytes (ray origin, direction, id) and
// writes 12, plus the cubemap's texels, read from L2, so device memory is not
// the limit.  The time goes into a long, data-dependent loop per pixel: up to
// `max_bounces` bounces, each a scan over all meshes for the hit plus one
// shadow-ray scan per light and one gather-ray scan under a cubemap, with
// branches that diverge by material and as paths terminate at different
// depths.  The kernel is bound by instruction latency and warp divergence.
//
// What the design does about that:
//  * one thread per pixel, the whole bounce loop in registers (the state of
//    the JAX `_st0` carry: o, d, mask, acc, active, specular, prev_nl and the
//    three bounce counters) — no intermediate state goes to device memory;
//  * a thread leaves the loop as soon as its path ends.  The counter RNG keys
//    on (pixel, pass, sample, depth, ...), so this is exact, and a warp stops
//    when its last live path stops;
//  * the scene table f32[n_mesh, 36] (the JAX `_scene_table` columns), the
//    mesh and material codes and the light slots are loaded once per block
//    into shared memory; every thread of a warp reads the same entry, which
//    shared memory broadcasts;
//  * mesh and material types are dispatched at run time by a `switch` over
//    the codes.  All threads of a warp test the same mesh at the same time,
//    so the switch itself does not diverge, and one binary serves every
//    scene of the class.
//
// Numerics: built without fast math and with FMA contraction off
// (-fmad=false), so divisions, square roots and the order of every sum match
// the plain version; branches that hinge on near-ties (u < p, t < tmin) then
// flip only where a transcendental rounds differently.
//
// The device functions it shares with its adjoint K2 live in trace_common.cuh.

#include "trace_common.cuh"

namespace {

constexpr int THREADS = 128;

// One BSDF sample (ops/bsdf.py::sample) for a hit of material `mat`.
struct Bounce {
  V3 o, d, mult;   // next origin and direction, throughput multiplier
  bool specular;   // NEE and the gather ray skip specular bounces
  int dif, spec, scat;  // bounce-counter increments
};

__device__ __forceinline__ Bounce bsdf_sample(const SceneSmem &s, int idx, V3 x, V3 nl, V3 d, V3 c,
                                              V3 e, float inside, float u1, float u2, float uc,
                                              float eps, bool biased) {
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
  const float nt = fmaxf(fabsf(s.ior(idx)), 1e-3f);
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

// The texture codes and blend flags of the meshes, in shared memory after
// what load_scene() fills (K1 only, so K2's view of the scene is unchanged).
struct TexCodes {
  const int *tex, *blend;
};

// Copy the texture codes into shared memory.  It does not synchronise: call
// it before load_scene(), whose __syncthreads() covers both.
__device__ __forceinline__ TexCodes load_tex_codes(const TraceArgs &a, float *smem) {
  int *s_tex = reinterpret_cast<int *>(smem) + scene_smem_bytes(a.n_mesh, a.n_lights) / sizeof(int);
  int *s_blend = s_tex + a.n_mesh;
  for (int i = threadIdx.x; i < a.n_mesh; i += blockDim.x) {
    s_tex[i] = a.tex[i];
    s_blend[i] = a.blend[i];
  }
  return {s_tex, s_blend};
}

__global__ void __launch_bounds__(THREADS) fwd_kernel(TraceArgs a) {
  extern __shared__ float smem[];
  const TexCodes tx = load_tex_codes(a, smem);
  const SceneSmem s = load_scene(a, smem);
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.n_pix) return;  // ragged edge

  V3 o = {a.ro[3 * p], a.ro[3 * p + 1], a.ro[3 * p + 2]};
  V3 d = {a.rd[3 * p], a.rd[3 * p + 1], a.rd[3 * p + 2]};
  const uint32_t h_pix = pixel_hash(a, p);

  V3 mask = {1.0f, 1.0f, 1.0f};
  V3 acc = {0.0f, 0.0f, 0.0f};
  bool specular = true;  // primary rays count as specular
  V3 prev_nl = {0.0f, 1.0f, 0.0f};
  int ndif = 0, nspec = 0, nscat = 0;

  // A path leaves the loop when it ends: every later bounce would be a no-op.
  for (int depth = 0; depth < a.max_bounces; ++depth) {
    float tmin;
    int idx;
    intersect(s, o, d, a.eps, tmin, idx);

    // ---- miss: environment, suppressed for non-specular paths under NEE ----
    if (!(tmin < a.inf)) {
      if (specular || !a.sample_lights) {
        if (a.use_cubemap)
          acc = acc + mask * sample_cubemap(a.cubemap, a.cube_h, a.cube_w, d);
        else if (a.use_sky)
          acc = acc + mask * procedural_sky(d);
      }
      break;
    }

    V3 x = o + d * tmin;
    V3 n = normal_at(s, idx, x);
    V3 c = s.c(idx);
    V3 e = s.e(idx);
    // ---- textured color / emission: the texel's alpha blends it in ----
    if (a.use_tex && tx.blend[idx]) {
      const V4 t = get_texel(tx.tex[idx], s.mesh[idx], s.col(idx, C_TP), x, n, a.images, a.img_h,
                             a.img_w, a.noise, a.noise_n);
      const V3 tc = {t.x, t.y, t.z};
      const float bc = (tx.blend[idx] & 1) ? t.w : 0.0f, be = (tx.blend[idx] & 2) ? t.w : 0.0f;
      const float *cm = s.col(idx, C_CM), *em = s.col(idx, C_EM);
      c = c + (tc * V3{cm[0], cm[1], cm[2]} - c) * bc;
      e = e + (tc * V3{em[0], em[1], em[2]} - e) * be;
    }
    c = vmax(c, 0.001f);
    e = vmax(e, 0.001f);
    float inside = dot(d, n) > 0.0f ? -1.0f : 1.0f;

    // ---- emissive hit: BSDF-side MIS weight from prev_nl, terminate ----
    const int mat = s.mat[idx];
    if (mat == MAT_LIGHT) {
      float mis_w = 1.0f;
      if (a.use_mis && a.sample_lights && depth > 0 && !specular) {
        V3 light_dir = normalize(x - o);
        float l_pdf = s.mesh[idx] == MESH_SPHERE ? sphere_light_pdf(s.p(idx), s.j0(idx), o)
                                                 : INV_FOUR_PI;
        float b_pdf = fmaxf(dot(light_dir, prev_nl), 0.0f) * ONE_OVER_PI;
        mis_w = power_heuristic(b_pdf, l_pdf);
      }
      acc = acc + mask * c * e * mis_w;
      break;
    }

    // a DIR_LIGHT surface has no BSDF: the path ends
    if (mat == MAT_DIR_LIGHT) break;

    // ---- BSDF sample ----
    const uint32_t h_depth = fold_step(h_pix, (uint32_t)depth, 3u);
    const uint32_t h_dir = fold_step(h_depth, S_BSDF_DIR, 4u);
    const V3 nl = n * inside;
    const Bounce b = bsdf_sample(s, idx, x, nl, d, c, e, inside, u01(h_dir), u01(pcg(h_dir)),
                                 u01(fold_step(h_depth, S_BSDF_CHOICE, 4u)), a.eps, a.use_biased);
    const V3 mask_after = mask * b.mult;

    if (!b.specular) {
      // ---- cubemap gather ray on the diffuse vertex ----
      if (a.use_cubemap) {
        const uint32_t h_env = fold_step(h_depth, S_ENV_DIR, 4u);
        const V3 env_dir = random_direction(nl, u01(h_env), u01(pcg(h_env)), a.use_biased);
        float te;
        int ie;
        intersect(s, x + nl * a.eps, env_dir, a.eps, te, ie);
        if (!(te < a.inf))
          acc = acc + mask_after * sample_cubemap(a.cubemap, a.cube_h, a.cube_w, env_dir);
      }
      // ---- NEE on the diffuse vertex ----
      if (a.sample_lights)
        acc = acc + shade_nee(s, x, nl, h_depth, a.eps, a.inf, a.use_mis) * mask_after;
    }

    // ---- commit ----
    o = b.o;
    d = b.d;
    mask = mask_after;
    specular = b.specular;
    prev_nl = nl;
    ndif += b.dif;
    nspec += b.spec;
    nscat += b.scat;

    // ---- luminance cutoff + per-type caps ----
    if (fmaxf(fmaxf(mask.x, mask.y), mask.z) < 0.01f || ndif >= a.max_diff ||
        nspec >= a.max_spec || nscat >= a.max_scatter)
      break;
  }

  a.out[3 * p] = acc.x;
  a.out[3 * p + 1] = acc.y;
  a.out[3 * p + 2] = acc.z;
}

}  // namespace

// Launch K1 on `stream`; returns cudaGetLastError() of the launch.
extern "C" int rt0_trace_forward(const float *table, const int32_t *mesh, const int32_t *mat,
                                 int n_mesh, const int32_t *lights, int n_lights, const float *ro,
                                 const float *rd, const int64_t *pix, float *out, long long n_pix,
                                 unsigned pass_idx, unsigned sample_idx, int max_bounces,
                                 int max_diff, int max_spec, int max_scatter, float eps,
                                 float inf, int sample_lights, int use_mis, int use_sky,
                                 const float *cubemap, int cube_h, int cube_w, int use_cubemap,
                                 int use_biased, const int32_t *tex, const int32_t *blend,
                                 const float *images, int img_h, int img_w, const float *noise,
                                 int noise_n, int use_tex, void *stream) {
  TraceArgs a = {table,   mesh,   mat,         lights,     n_mesh,      n_lights,
                 ro,      rd,     pix,         out,        n_pix,       pass_idx,
                 sample_idx, max_bounces, max_diff, max_spec, max_scatter, eps,
                 inf,     sample_lights, use_mis, use_sky, cubemap, cube_h, cube_w,
                 use_cubemap, use_biased, tex, blend, images, img_h, img_w, noise, noise_n,
                 use_tex};
  if (n_pix <= 0) return 0;
  const size_t smem = scene_smem_bytes(n_mesh, n_lights) + sizeof(int) * 2 * n_mesh;
  const unsigned blocks = (unsigned)((n_pix + THREADS - 1) / THREADS);
  fwd_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
