// gbuffer.cu — the G-buffer forward kernel K4 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// raytracer0_tpu/ops/megakernel.py::_gbuf_kernel_body (launched by
// `trace_forward_gbuffer`): K1's bounce loop without the direct light of
// diffuse vertices, which instead records each lane's k-th diffuse vertex
// (k < slots) in G-buffer slot k for the reservoir phases that follow it
// (raytracer0_tpu_torch/ops/restir_split.py::render_sample_fast).  Its
// outputs are the radiance f32[n_pix, 3] (environment, emissive hits with
// their MIS weight, the cubemap gather ray; no NEE) and per slot the hit
// position, oriented normal and throughput after the bounce f32[slots,
// n_pix, 3], the mesh index and bounce depth int32[slots, n_pix] and a valid
// flag uint8[slots, n_pix].  A slot no vertex wrote reads zeros, mesh 0,
// depth -1 and not valid.  Its plain PyTorch version is
// raytracer0_tpu_torch/render/integrator.py::trace with `gbuffer_slots`; the
// kernel follows its operations in order, so the two agree bit for bit.
//
// The bounce is K1's (path.cuh::path_step); the G-buffer writer is its
// direct-light functor and adds nothing to the radiance.
//
// What the TPU kernel does that this one does not: Mosaic has no per-lane
// scatter and masked stores cost the same at any width, so the Pallas kernel
// keeps 12 float32 planes per slot (the index and depth round-tripped
// through float32) and writes all 12 under one mask per bounce.  Here a
// thread writes its own vertex's record when it reaches it, with the index
// and depth as integers, and fills the slots it never reached at the end.
//
// What bounds it: K1's loop without the shadow rays of NEE: a pixel reads 28
// bytes of rays and id and writes 12 bytes of radiance plus 45 bytes per
// slot it fills; the work is the bounce loop, bound like K1 by instruction
// latency and divergence.  Its paths end at very different depths (on
// `restir_demo` 2 to 12 bounces, 4.4 on average), so one pixel per thread
// left a third of a warp's lanes idle per bounce.  The design: persistent
// warps that regenerate paths (regenerate_paths).  The launch has
// as many blocks as stay resident (its caller passes the grid); a lane
// whose path ends writes that pixel's radiance and the slots it never
// reached; once 16 of a warp's lanes are idle (REFILL_MIN; a refill
// costs the warp a round trip to the counter and a divergent branch, so
// refilling at every ended path was slower), they take the next pixels from
// a launch-wide ticket counter (one atomicAdd per warp's refill) and start
// their paths.  The counter RNG keys on the pixel, so the bits do not
// depend on which lane traces it; the last block to finish resets the
// counter.  The meshes are scanned through their packed records
// (trace_common.cuh::intersect_packed).  A scene whose SDF rows go beyond
// BOX and ROUND_BOX, or are textured (use_tex bit 2, megakernel.whole_sdf),
// runs the whole-SDF copy (kAll), as K1 does: every shape's distance in one
// `noinline` scene map (trace_common.cuh::sdf_map_all) and an SDF hit's
// texel at its row's box normal; the other scenes run the copies they ran
// before.  __launch_bounds__(128, 6) holds it
// to 80 registers, 6 blocks per SM against 5 at 96 (20-28 bytes spilled),
// which was faster (PERF.md's ablation).  Numerics: no fast math, no FMA
// contraction.

#include "path.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 6;       // __launch_bounds__: 80 registers
constexpr int REFILL_MIN = 16;      // idle lanes at which a warp refills
constexpr int MAX_GBUF_SLOTS = 32;  // slots a lane's bit mask can track

struct GbufArgs {
  float *pos, *nl, *mask;  // [slots, n_pix, 3]
  int32_t *idx, *depth;    // [slots, n_pix]
  uint8_t *valid;          // [slots, n_pix]
  int slots;
};

__device__ __forceinline__ void store3(float *dst, long long q, V3 v) {
  dst[3 * q] = v.x;
  dst[3 * q + 1] = v.y;
  dst[3 * q + 2] = v.z;
}

// The direct-light functor of K4: records the k-th diffuse vertex in slot k
// and adds no light (0 * throughput, which is finite, leaves the sum as it
// is).
struct GbufWriter {
  const GbufArgs &g;
  long long p, n_pix;
  uint32_t written;  // bit k: slot k holds this lane's vertex
  __device__ __forceinline__ V3 operator()(V3 x, V3 nl, int idx, uint32_t, int ndif, int depth,
                                           V3 mask) {
    if (ndif < g.slots) {
      const long long q = (long long)ndif * n_pix + p;
      store3(g.pos, q, x);
      store3(g.nl, q, nl);
      store3(g.mask, q, mask);
      g.idx[q] = idx;
      g.depth[q] = depth;
      g.valid[q] = 1;
      written |= 1u << ndif;
    }
    return {0.0f, 0.0f, 0.0f};
  }
};

// A lane of K4: its G-buffer writer, and what it stores when a path ends:
// the pixel's radiance, and zeros, mesh 0, depth -1 and not valid in the
// slots the path never reached.
struct GbufLane {
  const TraceArgs &a;
  GbufWriter direct;
  __device__ __forceinline__ void start(long long p) {
    direct.p = p;
    direct.written = 0u;
  }
  __device__ __forceinline__ void finish(V3 acc) {
    const long long p = direct.p;
    const GbufArgs &g = direct.g;
    a.out[3 * p] = acc.x;
    a.out[3 * p + 1] = acc.y;
    a.out[3 * p + 2] = acc.z;
    const V3 zero = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < g.slots; ++k) {
      if ((direct.written >> k) & 1u) continue;
      const long long q = (long long)k * a.n_pix + p;
      store3(g.pos, q, zero);
      store3(g.nl, q, zero);
      store3(g.mask, q, zero);
      g.idx[q] = 0;
      g.depth[q] = -1;
      g.valid[q] = 0;
    }
  }
};

// The next pixel of a launch-wide queue (tickets[0]): the lanes of a warp
// that refill together draw their tickets with one atomicAdd, the leader's,
// and each takes the next in lane order.
__device__ __forceinline__ long long next_ticket(unsigned *tickets) {
  const unsigned act = __activemask();
  const int lane = (int)(threadIdx.x & 31u);
  const int leader = __ffs(act) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(tickets, (unsigned)__popc(act));
  base = __shfl_sync(act, base, leader);
  return (long long)base + __popc(act & ((1u << lane) - 1u));
}

// Regenerating paths: a lane whose path has ended hands it to
// `lane.finish`; once REFILL_MIN of the warp's lanes are idle (or none is
// live) they take the next pixels from the launch-wide ticket counter
// `tickets[0]` and start their paths, so a warp's lanes stay busy until the
// queue is empty instead of waiting for the warp's longest path.  The
// counter RNG keys on the pixel, so a pixel's bits do not depend on which
// lane traces it.  The last block to finish resets the counter and the
// block count `tickets[1]` for the next launch, so a launch needs no host
// call to clear them.  Every thread of the block must call it: it ends
// with __syncthreads().
template <bool kSdf, bool kAll>
__device__ __forceinline__ void regenerate_paths(const TraceArgs &a, const SceneSmem &s,
                                                 const PathSmem &ps, const PackedScene &pk,
                                                 unsigned *tickets, GbufLane &lane) {
  PathState st;
  bool live = false;
  long long p = -1;
  for (;;) {
    const unsigned act = __activemask(), idle = __ballot_sync(act, !live);
    if (!live && (__popc(idle) >= REFILL_MIN || idle == act)) {
      if (p >= 0) lane.finish(st.acc);
      p = next_ticket(tickets);
      if (p >= a.n_pix) break;
      st = path_start(a, p);
      lane.start(p);
      live = a.max_bounces > 0;
    }
    if (live)
      live = path_step<kSdf, kAll>(a, s, ps, pk, st, lane.direct) && ++st.depth < a.max_bounces;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(tickets + 1, 1u) == gridDim.x - 1) {  // every other block is done
      atomicExch(tickets, 0u);
      atomicExch(tickets + 1, 0u);
    }
  }
}

// kSdf: the SDF march; kAll (with kSdf): the whole SDF class.
template <bool kSdf, bool kAll>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gbuf_kernel(TraceArgs a, GbufArgs g, unsigned *tickets) {
  extern __shared__ __align__(16) float smem[];
  SceneSmem s;
  const PathSmem ps = load_path(a, smem, s);
  const PackedScene pk =
      load_packed<kAll>(s, ps.sd, smem, path_smem_bytes(a.n_mesh, a.n_lights, a.n_sdf));
  GbufLane lane = {a, {g, -1, a.n_pix, 0u}};
  regenerate_paths<kSdf, kAll>(a, s, ps, pk, tickets, lane);
}

// The copy of K4 `flags` names: bit 0 the SDF march, bit 1 the whole SDF
// class (which implies the march).
inline void (*gbuf_copy(int flags))(TraceArgs, GbufArgs, unsigned *) {
  if (flags & 2) return gbuf_kernel<true, true>;
  return (flags & 1) ? gbuf_kernel<true, false> : gbuf_kernel<false, false>;
}

}  // namespace

// Launch K4 on `stream`; returns cudaGetLastError() of the launch.  The
// arguments up to `t0` are K1's (rt0_trace_forward); then the G-buffer's
// device pointers and its slot count, the grid (the blocks that stay
// resident, rt0_gbuffer_forward_occupancy times the SMs; no more blocks
// than the image needs run) and the ticket counter: two zeroed uint32 on
// the device, which the launch leaves zeroed, of this launch alone while it
// runs.  A scene without SDF rows runs the copy of the kernel built
// without the march, a scene whose SDF rows go beyond BOX and ROUND_BOX,
// untextured and unlit (use_tex bit 2), the whole-SDF copy.
extern "C" int rt0_gbuffer_forward(const float *table, const int32_t *mesh, const int32_t *mat,
                                   int n_mesh, const int32_t *lights, int n_lights,
                                   const float *ro, const float *rd, const int64_t *pix,
                                   float *out, long long n_pix, unsigned pass_idx,
                                   unsigned sample_idx, int max_bounces, int max_diff,
                                   int max_spec, int max_scatter, float eps, float inf,
                                   int sample_lights, int use_mis, int use_sky,
                                   const float *cubemap, int cube_h, int cube_w, int use_cubemap,
                                   int use_biased, const int32_t *tex, const int32_t *blend,
                                   const float *images, int img_h, int img_w, const float *noise,
                                   int noise_n, int use_tex, const int32_t *sdf, int n_analytic,
                                   int n_sdf, int steps, float fudge, float t0, float *pos,
                                   float *nl, float *mask, int32_t *idx, int32_t *depth,
                                   uint8_t *valid, int slots, int grid, unsigned *tickets,
                                   void *stream) {
  if (slots < 0 || slots > MAX_GBUF_SLOTS || grid <= 0 || n_pix > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  TraceArgs a = {table,   mesh,   mat,         lights,     n_mesh,      n_lights,
                 ro,      rd,     pix,         out,        n_pix,       pass_idx,
                 sample_idx, max_bounces, max_diff, max_spec, max_scatter, eps,
                 inf,     sample_lights, use_mis, use_sky, cubemap, cube_h, cube_w,
                 use_cubemap, use_biased, tex, blend, images, img_h, img_w, noise, noise_n,
                 use_tex, sdf, n_analytic, n_sdf, steps, fudge, t0};
  const GbufArgs g = {pos, nl, mask, idx, depth, valid, slots};
  if (n_pix <= 0) return 0;
  const size_t smem = packed_smem_bytes(path_smem_bytes(n_mesh, n_lights, n_sdf), n_mesh, n_sdf);
  const long long cover = (n_pix + THREADS - 1) / THREADS;  // blocks of one pixel a thread
  const unsigned blocks = (unsigned)(grid > cover ? cover : grid);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*kern)(TraceArgs, GbufArgs, unsigned *) =
      gbuf_copy(int(n_sdf > 0) | ((use_tex & 4) ? 2 : 0));
  kern<<<blocks, THREADS, smem, st>>>(a, g, tickets);
  return (int)cudaGetLastError();
}

// K4's occupancy at `threads` threads and `smem` bytes of dynamic shared
// memory (trace_common.cuh::kernel_occupancy) of the copy `flags` names:
// bit 0 the SDF march, bit 1 the whole SDF class.
extern "C" int rt0_gbuffer_forward_occupancy(int flags, int threads, long long smem, int *out) {
  return kernel_occupancy(gbuf_copy(flags), threads, (size_t)smem, out);
}
