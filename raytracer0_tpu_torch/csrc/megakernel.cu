// megakernel.cu — forward path-tracing megakernel K1 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
// raytracer0_tpu/ops/megakernel.py::_fwd_kernel_body (launched by `_forward`)
// and ::_env_kernel_body (launched by `_env_forward`, photographic cubemaps),
// for analytic SPHERE/PLANE/BOX meshes, BOX and ROUND_BOX SDF meshes and
// every surface material: the BSDF
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
//    when its last live path stops.  K4 hands ended lanes new pixels
//    (gbuffer.cu::regenerate_paths); K1 does not: its paths end nearly
//    together (98.5 % of a warp's lanes busy per bounce on Cornell), and
//    regeneration only added a drain (PERF.md's ablation);
//  * __launch_bounds__(128, 8): 8 blocks per SM hold K1 to 64 registers
//    against 80-118 and spill 148-346 bytes, which stay in L1; it was
//    faster than 6 or 7 blocks on every preset measured;
//  * the scene table f32[n_mesh, 36] (the JAX `_scene_table` columns), the
//    mesh and material codes and the light slots are loaded once per block
//    into shared memory; every thread of a warp reads the same entry, which
//    shared memory broadcasts;
//  * every ray, shadow rays included, scans the analytic meshes through
//    their packed float4 records, grouped by type
//    (trace_common.cuh::intersect_packed): one 128-bit broadcast load per
//    mesh, no switch, the ray's reciprocal direction once per ray and the
//    SDF gate radii once per block.  Material types are dispatched at run
//    time over the codes; one binary serves every scene of the class.
//
// Numerics: built without fast math and with FMA contraction off
// (-fmad=false), so divisions, square roots and the order of every sum match
// the plain version; branches that hinge on near-ties (u < p, t < tmin) then
// flip only where a transcendental rounds differently.
//
// SDF meshes are sphere-traced per thread (trace_common.cuh::sdf_march) with
// the plain version's bounding-sphere gate, step rule and final
// re-evaluation.  The Pallas kernel marches a block of lanes in chunks of 16
// fixed steps with an all-lanes-done test between chunks; here each thread
// stops on its own, which gives the same t (a lane that is done no longer
// moves).  The march is compiled into a second copy of the kernel that the
// launcher runs only for scenes with SDF rows, so other scenes run the same
// code as before.
//
// Spectral transport and the homogeneous medium (the hero wavelength, Cauchy
// dispersion, the medium event with its in-scatter NEE and Henyey-Greenstein
// direction, Beer-Lambert fog on sphere-light shadow rays: the Pallas
// `_build_bounce` under use_spectral and use_volumetrics) are compiled into a
// copy of their own, `fwd_kernel_medium`, which the launcher runs whenever
// either flag is on and the other copies never see.  It is built on the
// whole-SDF copy with the shadow hit's texel, which runs the same operations
// as the other copies on analytic, BOX/ROUND_BOX and untextured scenes, so
// one copy serves K1's whole class.  The medium adds to each bounce a free
// path (a log) and, where a path scatters, one shadow-ray scan per LIGHT
// sphere: on the reference's preset 8, whose box is open at the front, rays
// that leave it scatter instead of ending, so the paths run longer and the
// kernel stays bound by latency and divergence, not by memory.  The hero
// wavelength's RGB weight is applied after the launch
// (ops/megakernel.trace_forward), as the JAX `trace_forward` does.
//
// The device functions it shares with its adjoint K2 live in trace_common.cuh;
// its bounce loop, shared with the G-buffer kernel K4, in path.cuh.

#include "path.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;  // __launch_bounds__: 64 registers

// Per-light NEE (trace_common.cuh::shade_nee) as trace_path's direct light;
// kMedium: with the medium copy's fog on sphere-light shadow rays.
template <bool kSdf, bool kTex, bool kAll, bool kMedium = false>
struct Nee {
  const SceneSmem &s;
  const PathSmem &ps;
  const PackedScene &pk;
  const TraceArgs &a;
  __device__ __forceinline__ V3 operator()(V3 x, V3 nl, int, uint32_t h_depth, int, int,
                                           V3) const {
    return shade_nee<kSdf, kTex, kAll, kMedium>(s, ps.sd, pk, x, nl, h_depth, a.eps, a.inf,
                                                a.use_mis, &a, ps.tex);
  }
};

// kSdf: the SDF march; kTex: a scene whose LIGHT meshes have textures,
// whose NEE blends the shadow hit's texel (any other scene runs the code
// without it: the blend's branch cost a textured scene's K1 8-10 % though
// no light there had a texture, k1_device_time.py on an H100); kAll (with
// kSdf): the whole SDF class, every shape of ops/sdf.py (the 14 distances of
// the Pallas `_sdf_distance`), the texel of an SDF hit and SDF-light NEE
// (the NEE_SDF_POINT draw of `_build_bounce`), a copy of its own so the
// scenes of BOX and ROUND_BOX rows run the code they ran before.
template <bool kSdf, bool kTex, bool kAll>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) fwd_kernel(TraceArgs a) {
  extern __shared__ __align__(16) float smem[];
  SceneSmem s;
  const PathSmem ps = load_path(a, smem, s);
  const PackedScene pk =
      load_packed<kAll>(s, ps.sd, smem, path_smem_bytes(a.n_mesh, a.n_lights, a.n_sdf));
  Nee<kSdf, kTex, kAll> nee = {s, ps, pk, a};
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.n_pix) return;  // ragged edge
  const V3 acc = trace_path<kSdf, kAll>(a, s, ps, pk, p, nee);
  a.out[3 * p] = acc.x;
  a.out[3 * p + 1] = acc.y;
  a.out[3 * p + 2] = acc.z;
}

// K1's medium copy: hero-wavelength spectral transport and the homogeneous
// medium (the Pallas `_build_bounce`'s `_hero_wavelength`, its medium event
// with `_sample_hg` and `_hg_phase` and in-scatter NEE, the fog on NEE
// shadow rays and Cauchy dispersion), each under its run-time flag, over
// K1's whole class: it is built on the whole-SDF copy with the shadow hit's
// texel, which renders analytic and untextured scenes with the same
// operations as the other copies, so one copy serves every scene under
// `use_spectral` or `use_volumetrics` and the other copies compile what
// they did.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) fwd_kernel_medium(MediumArgs a) {
  extern __shared__ __align__(16) float smem[];
  SceneSmem s;
  const PathSmem ps = load_path(a, smem, s);
  const PackedScene pk =
      load_packed<true>(s, ps.sd, smem, path_smem_bytes(a.n_mesh, a.n_lights, a.n_sdf));
  Nee<true, true, true, true> nee = {s, ps, pk, a};
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.n_pix) return;  // ragged edge
  const V3 acc = trace_path<true, true, true>(a, s, ps, pk, p, nee);
  a.out[3 * p] = acc.x;
  a.out[3 * p + 1] = acc.y;
  a.out[3 * p + 2] = acc.z;
}

// The copy of K1 for a scene with SDF rows (`sdf`), with textured LIGHT
// meshes (`tex`) and with SDF rows outside BOX and ROUND_BOX, textured or
// lit (`all`, which implies `sdf`).
inline void (*fwd_copy(bool sdf, bool tex, bool all))(TraceArgs) {
  if (all) return tex ? fwd_kernel<true, true, true> : fwd_kernel<true, false, true>;
  if (tex) return sdf ? fwd_kernel<true, true, false> : fwd_kernel<false, true, false>;
  return sdf ? fwd_kernel<true, false, false> : fwd_kernel<false, false, false>;
}

}  // namespace

// Launch K1 on `stream`; returns cudaGetLastError() of the launch.  A scene
// without SDF rows runs the copy of the kernel built without the march, a
// scene without textured LIGHT meshes (use_tex bit 1) the copy without the
// shadow hit's texel, a scene whose SDF rows go beyond BOX and ROUND_BOX,
// untextured and unlit (use_tex bit 2), the whole-SDF copy; spectral
// transport or the medium (use_spectral, use_volumetrics) the medium copy,
// with the medium's constants formed on the host (MediumArgs).
extern "C" int rt0_trace_forward(const float *table, const int32_t *mesh, const int32_t *mat,
                                 int n_mesh, const int32_t *lights, int n_lights, const float *ro,
                                 const float *rd, const int64_t *pix, float *out, long long n_pix,
                                 unsigned pass_idx, unsigned sample_idx, int max_bounces,
                                 int max_diff, int max_spec, int max_scatter, float eps,
                                 float inf, int sample_lights, int use_mis, int use_sky,
                                 const float *cubemap, int cube_h, int cube_w, int use_cubemap,
                                 int use_biased, const int32_t *tex, const int32_t *blend,
                                 const float *images, int img_h, int img_w, const float *noise,
                                 int noise_n, int use_tex, const int32_t *sdf, int n_analytic,
                                 int n_sdf, int steps, float fudge, float t0, int use_spectral,
                                 int use_volumetrics, float sigma_t, float vol_w, float vol_eps,
                                 float hg_g, float hg_1pg2, float hg_2g, float hg_1mg2,
                                 void *stream) {
  TraceArgs a = {table,   mesh,   mat,         lights,     n_mesh,      n_lights,
                 ro,      rd,     pix,         out,        n_pix,       pass_idx,
                 sample_idx, max_bounces, max_diff, max_spec, max_scatter, eps,
                 inf,     sample_lights, use_mis, use_sky, cubemap, cube_h, cube_w,
                 use_cubemap, use_biased, tex, blend, images, img_h, img_w, noise, noise_n,
                 use_tex, sdf, n_analytic, n_sdf, steps, fudge, t0};
  if (n_pix <= 0) return 0;
  const size_t smem = packed_smem_bytes(path_smem_bytes(n_mesh, n_lights, n_sdf), n_mesh, n_sdf);
  const unsigned blocks = (unsigned)((n_pix + THREADS - 1) / THREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_spectral || use_volumetrics) {
    MediumArgs m;
    static_cast<TraceArgs &>(m) = a;
    m.use_spectral = use_spectral;
    m.use_volumetrics = use_volumetrics;
    m.sigma_t = sigma_t;
    m.vol_w = vol_w;
    m.vol_eps = vol_eps;
    m.hg_g = hg_g;
    m.hg_1pg2 = hg_1pg2;
    m.hg_2g = hg_2g;
    m.hg_1mg2 = hg_1mg2;
    fwd_kernel_medium<<<blocks, THREADS, smem, st>>>(m);
    return (int)cudaGetLastError();
  }
  void (*kern)(TraceArgs) = fwd_copy(n_sdf > 0, (use_tex & 2) != 0, (use_tex & 4) != 0);
  kern<<<blocks, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// K1's occupancy at `threads` threads and `smem` bytes of dynamic shared
// memory (trace_common.cuh::kernel_occupancy) of the copy `flags` names:
// bit 0 the SDF march, bit 1 the shadow hit's texel, bit 2 the whole SDF
// class, bit 3 the medium copy.
extern "C" int rt0_trace_forward_occupancy(int flags, int threads, long long smem, int *out) {
  if (flags & 8) return kernel_occupancy(fwd_kernel_medium, threads, (size_t)smem, out);
  return kernel_occupancy(fwd_copy((flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0),
                          threads, (size_t)smem, out);
}
