// restir_vertex.cu — the reservoir-vertex kernel K6v for Hopper (sm_90a),
// the second stage of the ReSTIR pass after the G-buffer kernel K4.
//
// Replaces, with K4 before it, the Pallas TPU kernel
// raytracer0_tpu/ops/megakernel.py::_fused_restir_kernel_body (launched by
// `_fused_restir_fwd_impl` at :2989), and takes over the XLA reservoir
// phases of the JAX `restir.render_sample_fast`
// (raytracer0_tpu/ops/restir.py:689: `reservoir_direct`, :436, per G-buffer
// slot, with the shadow rays of `cast_rays`).  One thread per pixel loops
// over the pixel's G-buffer slots k = 0 .. slots-1 in order; at each valid
// slot it rebuilds the vertex's RNG key from the pixel and the slot's depth,
// as trace_path does, runs the reservoir vertex (restir.cuh::RestirVertexT)
// and keeps the last valid slot's reservoir.  Its plain PyTorch versions are
// raytracer0_tpu_torch/ops/restir.py::render_sample (the fused form) and
// raytracer0_tpu_torch/ops/restir_split.py::render_sample_split with the
// plain G-buffer and caster (the split form); it follows their operations
// in order.
//
// Two forms, chosen at compile time:
//  - fused (K6's route): rad = (0 + Σ_k out_k · mask_k) + rad, over K4's
//    radiance `rad`: the sum K6's bounce loop made, since K6's class has no
//    cubemap gather ray between vertices and K4's radiance is exactly the
//    path's final term (the environment, or the emissive hit with its MIS
//    weight).  The new reservoirs' light data is the slot table's, by index.
//  - split (restir_split.render_sample_fast): each reservoir carries its
//    light data (restir.cuh's header), the history is read at the ad-hoc
//    reprojected pixel with `adhoc`, and sum = (sum + rad) + Σ_k out_k ·
//    mask_k over the running sum of the pass's samples; the shadow rays run
//    in-kernel through intersect_scene, the intersection the ray-cast kernel
//    K5 runs.  The new reservoirs carry their light data.
//
// What bounds it: per vertex 9-16 candidates, 2 temporal and 4-8 spatial
// combines and two shadow rays, each a scan over the meshes and in SDF
// scenes a march; a pixel reads 45 bytes per slot of G-buffer, 3 x 20 (split:
// 3 x 44) bytes of its own reservoirs and up to 8 taps from L2, and writes 56
// bytes.  Like K1 it is bound by instruction latency and divergence.  What
// the design does about it: inside K6 the vertex ran inside the bounce loop,
// so a warp ran it whenever any lane stood at a diffuse vertex at that
// depth (62.6 % of its lane slots useful on restir_demo) with the whole
// bounce state live; here a warp's lanes take their slots in step (96.5 %
// of the (pixel, slot) pairs are valid there) and no bounce state is live.
// A scene whose SDF rows go beyond BOX and ROUND_BOX, or are textured
// (use_tex bit 2, megakernel.whole_sdf), runs the whole-SDF copy of either
// form (kAll), whose shadow rays march every shape; the other scenes run
// the copies they ran before.  Numerics: no fast math, no FMA contraction.

#include "restir.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_VERTEX_SLOTS = 32;  // K4's MAX_GBUF_SLOTS

struct VertexArgs {
  const float *pos, *nl, *mask;  // [slots, n_pix, 3], K4's G-buffer
  const int32_t *idx, *depth;    // [slots, n_pix]
  const uint8_t *valid;          // [slots, n_pix]
  float *sum;                    // [n_pix, 3], the split form's running sum
  int slots;
};

__device__ __forceinline__ V3 load3(const float *src, long long q) {
  return {src[3 * q], src[3 * q + 1], src[3 * q + 2]};
}

__device__ __forceinline__ void store3(float *dst, long long q, V3 v) {
  dst[3 * q] = v.x;
  dst[3 * q + 1] = v.y;
  dst[3 * q + 2] = v.z;
}

template <bool kSplit, bool kAll>
__global__ void __launch_bounds__(THREADS)
    restir_vertex_kernel(TraceArgs a, RestirArgs ra, VertexArgs g) {
  extern __shared__ float smem[];
  // the light-slot table follows what load_path() fills
  float *slots = smem + path_smem_bytes(a.n_mesh, a.n_lights, a.n_sdf) / sizeof(float);
  load_slots(a, slots);
  SceneSmem s;
  const PathSmem ps = load_path(a, smem, s);  // synchronises the block
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.n_pix) return;  // ragged edge

  using Vertex = RestirVertexT<kSplit, kAll>;
  const uint32_t id = (uint32_t)a.pix[p];
  Vertex v = {s, ps.sd, a, ra, slots, (int)(id / (uint32_t)ra.width),
              (int)(id % (uint32_t)ra.width), Vertex::empty()};
  typename Vertex::R kept = Vertex::empty();  // the last valid slot's reservoir
  const uint32_t h_pix = pixel_hash(a, p);
  V3 direct = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < g.slots; ++k) {
    const long long q = (long long)k * a.n_pix + p;
    if (!g.valid[q]) continue;
    const uint32_t h_depth = fold_step(h_pix, (uint32_t)g.depth[q], 3u);
    NoTape none;
    const V3 out = v.run(load3(g.pos, q), load3(g.nl, q), g.idx[q], h_depth, none);
    direct = direct + out * load3(g.mask, q);
    kept = v.r;
  }

  const V3 rad = load3(a.out, p);  // K4's
  if constexpr (kSplit) {
    store3(g.sum, p, (load3(g.sum, p) + rad) + direct);
    store3(ra.pos, p, kept.pos);
    store3(ra.col, p, kept.col);
  } else {
    store3(a.out, p, direct + rad);
    const bool held = v.in_range(kept.idx);
    store3(ra.pos, p, held ? v.slot_pos(kept.idx) : V3{0.0f, 0.0f, 0.0f});
    store3(ra.col, p, held ? v.slot_col(kept.idx) : V3{0.0f, 0.0f, 0.0f});
  }
  ra.ws[p] = kept.ws;
  ra.m[p] = kept.m;
  ra.w[p] = kept.w;
  ra.age[p] = kept.age;
  ra.idx[p] = kept.idx;
}

// The copy of K6v `flags` names: bit 0 the split form, bit 1 the whole SDF
// class.
inline void (*vertex_copy(int flags))(TraceArgs, RestirArgs, VertexArgs) {
  if (flags & 2)
    return (flags & 1) ? restir_vertex_kernel<true, true> : restir_vertex_kernel<false, true>;
  return (flags & 1) ? restir_vertex_kernel<true, false> : restir_vertex_kernel<false, false>;
}

}  // namespace

// Launch K6v on `stream`; returns cudaGetLastError() of the launch.  The
// arguments up to `t0` are K1's, as K4 took them (rt0_gbuffer_forward; `ro`
// and `rd` unread, `out` K4's radiance, which the fused form overwrites with
// its own); `res_in` holds the 15 input grids (back, hist1, hist2; each
// ws, m, w, age, light_index) and, in the split form, 6 more (back, hist1,
// hist2; each light_pos, light_color); `res_out` the 7 outputs (light_pos,
// light_color, ws, m, w, age, light_index), all device pointers; `taps`
// (host memory) the 8 spatial taps' (row, column) offsets; then K4's
// G-buffer, the running sum (split form, else null), the slot count, the
// form and the ad-hoc reprojection (split form only).  A scene whose SDF
// rows go beyond BOX and ROUND_BOX, untextured and unlit (use_tex bit 2),
// runs the form's whole-SDF copy.
extern "C" int rt0_restir_vertex(const float *table, const int32_t *mesh, const int32_t *mat,
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
                                 const float *gpos, const float *gnl, const float *gmask,
                                 const int32_t *gidx, const int32_t *gdepth,
                                 const uint8_t *gvalid, float *sum, int slots, int split,
                                 int adhoc, void *stream) {
  if (slots < 0 || slots > MAX_VERTEX_SLOTS) return (int)cudaErrorInvalidValue;
  TraceArgs a = {table,   mesh,   mat,         lights,     n_mesh,      n_lights,
                 ro,      rd,     pix,         out,        n_pix,       pass_idx,
                 sample_idx, max_bounces, max_diff, max_spec, max_scatter, eps,
                 inf,     sample_lights, use_mis, use_sky, cubemap, cube_h, cube_w,
                 use_cubemap, use_biased, tex, blend, images, img_h, img_w, noise, noise_n,
                 use_tex, sdf, n_analytic, n_sdf, steps, fudge, t0};
  RestirArgs ra = restir_args(res_in, res_out, taps, height, width, n_cand, n_spatial, eps2,
                              eps10, animated);
  if (split) {
    ResIn *grids[3] = {&ra.back, &ra.hist[0], &ra.hist[1]};
    for (int k = 0; k < 3; ++k) {
      grids[k]->pos = static_cast<const float *>(res_in[15 + 2 * k]);
      grids[k]->col = static_cast<const float *>(res_in[16 + 2 * k]);
    }
    ra.adhoc = adhoc;
  }
  const VertexArgs g = {gpos, gnl, gmask, gidx, gdepth, gvalid, sum, slots};
  if (n_pix <= 0) return 0;
  const size_t smem = path_smem_bytes(n_mesh, n_lights, n_sdf) + sizeof(float) * NSLOT * n_lights;
  const unsigned blocks = (unsigned)((n_pix + THREADS - 1) / THREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*kern)(TraceArgs, RestirArgs, VertexArgs) =
      vertex_copy((split ? 1 : 0) | ((use_tex & 4) ? 2 : 0));
  kern<<<blocks, THREADS, smem, st>>>(a, ra, g);
  return (int)cudaGetLastError();
}

// K6v's occupancy at `threads` threads and `smem` bytes of dynamic shared
// memory (trace_common.cuh::kernel_occupancy) of the copy `flags` names:
// bit 0 the split form, bit 1 the whole SDF class.
extern "C" int rt0_restir_vertex_occupancy(int flags, int threads, long long smem, int *out) {
  return kernel_occupancy(vertex_copy(flags), threads, (size_t)smem, out);
}
