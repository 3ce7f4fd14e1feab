// restir.cu — the fused ReSTIR forward kernel K6 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// raytracer0_tpu/ops/megakernel.py::_fused_restir_kernel_body (launched by
// `_fused_restir_fwd_impl`): the path trace of K1 with the reservoir
// pipeline of a diffuse vertex (`_build_restir_vertex`: candidate
// generation, temporal reuse, spatial reuse, finalize and shade) in place of
// per-light NEE, in one launch.  Its outputs are the radiance f32[n_pix, 3]
// and the new back reservoirs of the pass (the last diffuse vertex's, as the
// reference's g_final_reservoir overwrite): light_pos, light_color,
// weight_sum, m, w, age and light_index.  Its plain PyTorch version is
// raytracer0_tpu_torch/ops/restir.py::render_sample (integrator.trace with
// restir.make_sampler's hook); the kernel follows its operations in order.
//
// The bounce loop is K1's (path.cuh::trace_path); the reservoir vertex
// (restir.cuh::RestirVertex, shared with the adjoint K7) is the loop's
// direct-light functor.
//
// What the TPU kernel does that this one does not: Mosaic cannot gather, so
// the Pallas kernel reads its spatial taps from a copy of the back grid
// pre-rolled by the 8 Poisson offsets ([8, 5, H, W], built by `roll_taps`
// in XLA before every launch), and selects a light's data by chained
// compares over the slots.  Here a thread reads each tap at (row + dy,
// col + dx) directly, rejected by the in-bounds test where it leaves the
// image; its own history at its own pixel; and a light slot's position,
// color·emission and radius from a table in shared memory by index.  The
// target function p̂ is evaluated for the slot that each step needs rather
// than for every slot up front.
//
// What bounds it: each pixel reads 28 bytes of rays and id, 3 x 20 bytes of
// reservoirs at its own pixel and up to 8 x 20 bytes of spatial taps (the
// taps of neighbouring threads overlap and come from L2), and writes 12 + 44
// bytes.  The work is K1's bounce loop plus, at each diffuse vertex, up to
// 16 candidates, 2 temporal and 8 spatial combines, and two shadow rays
// (visibility, shading), each a scan over the meshes and an SDF march: like
// K1 it is bound by instruction latency and divergence, not by memory.
// The reservoir carry (5 values) stays in registers; one thread per pixel.
//
// Numerics: no fast math, no FMA contraction; the f32 constants the plain
// version derives in Python doubles (epsilon * 2, epsilon * 10, 0.95 * 0.8)
// arrive from the wrapper or are written as the double product cast once.
//
// ANIMATED accumulation (`animated`): the temporal fade takes a further 0.85
// and spatial taps older than 2 passes are rejected, as the Pallas kernel
// does; the scene arrives animated to the pass's time.

#include "restir.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) restir_kernel(TraceArgs a, RestirArgs ra) {
  extern __shared__ float smem[];
  // the light-slot table follows what load_path() fills
  float *slots = smem + path_smem_bytes(a.n_mesh, a.n_lights, a.n_sdf) / sizeof(float);
  load_slots(a, slots);
  SceneSmem s;
  const PathSmem ps = load_path(a, smem, s);  // synchronises the block
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.n_pix) return;  // ragged edge

  const uint32_t id = (uint32_t)a.pix[p];
  RestirVertex v = {s, ps.sd, a, ra, slots, (int)(id / (uint32_t)ra.width),
                    (int)(id % (uint32_t)ra.width), {0.0f, 0.0f, 0.0f, 0.0f, -1}};
  const V3 acc = trace_path<true>(a, s, ps, p, v);
  a.out[3 * p] = acc.x;
  a.out[3 * p + 1] = acc.y;
  a.out[3 * p + 2] = acc.z;
  const bool held = v.r.idx >= 0 && v.r.idx < a.n_lights;
  const V3 lp = held ? v.slot_pos(v.r.idx) : V3{0.0f, 0.0f, 0.0f};
  const V3 lc = held ? v.slot_col(v.r.idx) : V3{0.0f, 0.0f, 0.0f};
  ra.pos[3 * p] = lp.x;
  ra.pos[3 * p + 1] = lp.y;
  ra.pos[3 * p + 2] = lp.z;
  ra.col[3 * p] = lc.x;
  ra.col[3 * p + 1] = lc.y;
  ra.col[3 * p + 2] = lc.z;
  ra.ws[p] = v.r.ws;
  ra.m[p] = v.r.m;
  ra.w[p] = v.r.w;
  ra.age[p] = v.r.age;
  ra.idx[p] = v.r.idx;
}

}  // namespace

// Launch K6 on `stream`; returns cudaGetLastError() of the launch.  The
// arguments up to `t0` are K1's (rt0_trace_forward); `res_in` holds the 15
// input grids (back, hist1, hist2; each ws, m, w, age, light_index) and
// `res_out` the 7 outputs (light_pos, light_color, ws, m, w, age,
// light_index), all device pointers; `taps` (host memory) the 8 spatial
// taps' (row, column) offsets.
extern "C" int rt0_restir_forward(const float *table, const int32_t *mesh, const int32_t *mat,
                                  int n_mesh, const int32_t *lights, int n_lights, const float *ro,
                                  const float *rd, const int64_t *pix, float *out, long long n_pix,
                                  unsigned pass_idx, unsigned sample_idx, int max_bounces,
                                  int max_diff, int max_spec, int max_scatter, float eps,
                                  float inf, int sample_lights, int use_mis, int use_sky,
                                  const float *cubemap, int cube_h, int cube_w, int use_cubemap,
                                  int use_biased, const int32_t *tex, const int32_t *blend,
                                  const float *images, int img_h, int img_w, const float *noise,
                                  int noise_n, int use_tex, const int32_t *sdf, int n_analytic,
                                  int n_sdf, int steps, float fudge, float t0,
                                  const void *const *res_in, void *const *res_out,
                                  const int32_t *taps, int height, int width, int n_cand,
                                  int n_spatial, float eps2, float eps10, int animated,
                                  void *stream) {
  TraceArgs a = {table,   mesh,   mat,         lights,     n_mesh,      n_lights,
                 ro,      rd,     pix,         out,        n_pix,       pass_idx,
                 sample_idx, max_bounces, max_diff, max_spec, max_scatter, eps,
                 inf,     sample_lights, use_mis, use_sky, cubemap, cube_h, cube_w,
                 use_cubemap, use_biased, tex, blend, images, img_h, img_w, noise, noise_n,
                 use_tex, sdf, n_analytic, n_sdf, steps, fudge, t0};
  const RestirArgs ra = restir_args(res_in, res_out, taps, height, width, n_cand, n_spatial,
                                    eps2, eps10, animated);
  if (n_pix <= 0) return 0;
  const size_t smem = path_smem_bytes(n_mesh, n_lights, n_sdf) + sizeof(float) * NSLOT * n_lights;
  const unsigned blocks = (unsigned)((n_pix + THREADS - 1) / THREADS);
  restir_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a, ra);
  return (int)cudaGetLastError();
}

// K6's occupancy at `threads` threads and `smem` bytes of dynamic shared
// memory (trace_common.cuh::kernel_occupancy; `sdf` unused).
extern "C" int rt0_restir_forward_occupancy(int sdf, int threads, long long smem, int *out) {
  (void)sdf;
  return kernel_occupancy(restir_kernel, threads, (size_t)smem, out);
}
