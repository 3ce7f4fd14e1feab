// megakernel.cu — forward path-tracing megakernel K1 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// raytracer0_tpu/ops/megakernel.py::_fwd_kernel_body (launched by `_forward`),
// for the Cornell class: analytic SPHERE/PLANE/BOX meshes, DIFF and LIGHT
// materials, sphere-light NEE with optional power-heuristic MIS, the
// procedural sky, the luminance cutoff and the per-type bounce caps.
// Its plain PyTorch version is raytracer0_tpu_torch/render/integrator.py::trace;
// the kernel follows that function's operations in the same order, so on the
// same inputs the two agree to the last bit except where a libm call rounds
// differently.
//
// What bounds it: each pixel reads 28 bytes (ray origin, direction, id) and
// writes 12, so device memory is not the limit.  The time goes into a long,
// data-dependent loop per pixel: up to `max_bounces` bounces, each a scan over
// all meshes for the hit plus one shadow-ray scan per light, with branches
// that diverge as paths terminate at different depths.  The kernel is bound
// by instruction latency and warp divergence.
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

__global__ void __launch_bounds__(THREADS) fwd_kernel(TraceArgs a) {
  extern __shared__ float smem[];
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

    // ---- miss: sky, suppressed for non-specular paths under NEE ----
    if (!(tmin < a.inf)) {
      if (a.use_sky && (specular || !a.sample_lights)) acc = acc + mask * procedural_sky(d);
      break;
    }

    V3 x = o + d * tmin;
    V3 n = normal_at(s, idx, x);
    V3 c = vmax(s.c(idx), 0.001f);
    V3 e = vmax(s.e(idx), 0.001f);
    float inside = dot(d, n) > 0.0f ? -1.0f : 1.0f;

    // ---- emissive hit: BSDF-side MIS weight from prev_nl, terminate ----
    if (s.mat[idx] == MAT_LIGHT) {
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

    // ---- DIFF bounce: cosine-weighted about the oriented normal ----
    const uint32_t h_depth = fold_step(h_pix, (uint32_t)depth, 3u);
    const uint32_t h_dir = fold_step(h_depth, S_BSDF_DIR, 4u);
    V3 nl = n * inside;
    V3 new_d = sample_biased(nl, u01(h_dir), u01(pcg(h_dir)));
    V3 mask_after = mask * c;

    // ---- NEE on the diffuse vertex ----
    if (a.sample_lights) acc = acc + shade_nee(s, x, nl, h_depth, a.eps, a.inf, a.use_mis) * mask_after;

    // ---- commit ----
    o = x + nl * a.eps;
    d = new_d;
    mask = mask_after;
    specular = false;
    prev_nl = nl;
    ndif += 1;

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
                                 void *stream) {
  TraceArgs a = {table,   mesh,   mat,         lights,     n_mesh,      n_lights,
                 ro,      rd,     pix,         out,        n_pix,       pass_idx,
                 sample_idx, max_bounces, max_diff, max_spec, max_scatter, eps,
                 inf,     sample_lights, use_mis, use_sky};
  if (n_pix <= 0) return 0;
  const size_t smem = scene_smem_bytes(n_mesh, n_lights);
  const unsigned blocks = (unsigned)((n_pix + THREADS - 1) / THREADS);
  fwd_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
