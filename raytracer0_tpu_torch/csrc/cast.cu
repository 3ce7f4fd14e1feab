// cast.cu — the ray-cast kernel K5 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// raytracer0_tpu/ops/megakernel.py::_cast_kernel_body (launched by
// `cast_rays`): the nearest hit of each ray over the analytic meshes and the
// SDF meshes, for the shadow rays of the reservoir phases on the split
// ReSTIR path (raytracer0_tpu_torch/ops/restir_split.py).  Its outputs are
// t f32[n] and the mesh index int32[n]; on a miss t = cfg.infinity and the
// index is 0, the conventions of the plain version,
// raytracer0_tpu_torch/ops/intersect.py::intersect with need_normal=False,
// which it follows operation for operation (trace_common.cuh::
// intersect_scene, the intersection K1 runs), so the two agree bit for bit.
//
// What the TPU kernel does that this one does not: it tiles rays into 8x128
// blocks and reads the scene table from SMEM; here one thread casts one ray
// of any batch shape, and the table, the type codes and the SDF shapes sit
// in shared memory, read by every thread of a warp at once.
//
// What bounds it: a ray reads 24 bytes and writes 8, so 32 bytes a ray over
// the memory; its work is a scan over the meshes plus, in scenes with SDF
// meshes, the march (up to cfg.marching_steps evaluations of every SDF
// entry), which for a few meshes takes longer than its bytes.  Two copies:
// with the march for scenes with SDF rows, without it for the others.
// Numerics: no fast math, no FMA contraction.

#include "trace_common.cuh"

namespace {

constexpr int THREADS = 128;

struct CastArgs {
  const float *ro, *rd;  // [n, 3]
  float *t;              // [n]
  int32_t *idx;          // [n]
  long long n;
  float eps, inf;        // cfg.epsilon, cfg.infinity
};

template <bool kSdf>
__global__ void __launch_bounds__(THREADS) cast_kernel(TraceArgs a, SdfScene sd, CastArgs c) {
  extern __shared__ float smem[];
  int *s_sdf = reinterpret_cast<int *>(smem) + scene_smem_bytes(a.n_mesh, 0) / sizeof(int);
  for (int i = threadIdx.x; i < sd.count; i += blockDim.x) s_sdf[i] = sd.shape[i];
  const SceneSmem s = load_scene(a, smem);  // synchronises the block
  sd.shape = s_sdf;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= c.n) return;  // ragged edge
  const V3 o = {c.ro[3 * p], c.ro[3 * p + 1], c.ro[3 * p + 2]};
  const V3 d = {c.rd[3 * p], c.rd[3 * p + 1], c.rd[3 * p + 2]};
  float t;
  int idx;
  intersect_scene<kSdf>(s, sd, o, d, c.eps, c.inf, t, idx);
  const bool missed = !(t < c.inf);
  c.t[p] = missed ? c.inf : t;
  c.idx[p] = missed ? 0 : idx;
}

}  // namespace

// Launch K5 on `stream` for `n` rays; returns cudaGetLastError() of the
// launch.  `table` f32[n_mesh, 36], `mesh` and `mat` int32[n_mesh] and `sdf`
// int32[n_sdf] (the SDF rows' shapes) are device pointers, as are the rays
// and the outputs.  A scene without SDF rows runs the copy built without the
// march.
extern "C" int rt0_cast_rays(const float *table, const int32_t *mesh, const int32_t *mat,
                             int n_mesh, const int32_t *sdf, int n_analytic, int n_sdf, int steps,
                             float fudge, float t0, const float *ro, const float *rd, float *t,
                             int32_t *idx, long long n, float eps, float inf, void *stream) {
  TraceArgs a = {};
  a.table = table;
  a.mesh = mesh;
  a.mat = mat;
  a.n_mesh = n_mesh;
  const SdfScene sd = {sdf, n_analytic, n_sdf, steps, fudge, t0};
  const CastArgs c = {ro, rd, t, idx, n, eps, inf};
  if (n <= 0) return 0;
  const size_t smem = scene_smem_bytes(n_mesh, 0) + sizeof(int) * n_sdf;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_sdf > 0)
    cast_kernel<true><<<blocks, THREADS, smem, st>>>(a, sd, c);
  else
    cast_kernel<false><<<blocks, THREADS, smem, st>>>(a, sd, c);
  return (int)cudaGetLastError();
}

// K5's occupancy at `threads` threads and `smem` bytes of dynamic shared
// memory (trace_common.cuh::kernel_occupancy; the copy with the SDF march when `sdf` is set).
extern "C" int rt0_cast_rays_occupancy(int sdf, int threads, long long smem, int *out) {
  return sdf ? kernel_occupancy(cast_kernel<true>, threads, (size_t)smem, out)
             : kernel_occupancy(cast_kernel<false>, threads, (size_t)smem, out);
}
