// megakernel_bwd.cu — K2, the adjoint of the forward megakernel K1, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// raytracer0_tpu/ops/megakernel.py::_bwd_slotted_kernel_body (launched by
// `_backward`), and computes the same outputs as its whole-trace twin
// `_bwd_kernel_body` (RT0_BWD_SLOTTED=0), for K1's Cornell class.  Given
// K1's inputs and the cotangent ct f32[n_pix, 3] of its radiance it returns
// d_table f32[n_mesh, 36] and d_ro, d_rd f32[n_pix, 3]: the gradients that
// torch.autograd gives through the plain version
// (raytracer0_tpu_torch/render/integrator.py::trace).  CUDA has no autodiff,
// so the adjoint of each step of a bounce is written out by hand, below and
// in adjoint.cuh (shared with K7).
//
// Scheme: the per-slot stash of the Pallas kernel, one thread per pixel.
//  * forward sweep: run K1's bounce loop without NEE and without the
//    accumulator (neither changes the carry) and stash, for every slot the
//    path runs, the carry entering it (o, d, mask, prev_nl) and the hit its
//    ray found (t, idx): 14 words.  The accumulator needs no stash (its
//    cotangent is ct at every slot), nor do the integer counters (no
//    cotangent), and `specular` is (depth == 0) in this class.  A path runs
//    at most min(max_bounces, max_diff + 1) slots.
//  * reverse sweep: newest slot first, recompute the slot from its stash
//    (normal, BSDF sample, NEE shadow rays: the counter RNG replays every
//    draw exactly; the slot's own ray is not scanned again) and run its
//    hand-derived adjoint, chaining the carry cotangents back to the
//    primary ray.
// Discrete decisions (winner index, shadow-ray hit, `inside`, validity, the
// MIS energy gate, cutoff and caps) carry no gradient, as `torch.where`
// gives in the plain version.  Ties follow the plain version's autograd:
// clamp and clamp_min pass the gradient at the bound, amax/amin split it
// evenly between tied slabs.
//
// The d_table reduction across pixels is deterministic.  The 10 table
// columns with a cotangent (pos 0:3, joker.x 3, color 7:10, emission 10:13)
// are summed per mesh into columns of accumulators in shared memory:
//  * a column per thread while 3 blocks of such columns fit an SM's shared
//    memory (bwd_layout: up to 14 meshes on an H100, Cornell's 8 among
//    them); a thread adds into its own column;
//  * a column per warp beyond that (many meshes): an add groups the warp's
//    active lanes by mesh (__match_any_sync), sums each group's values over
//    a fixed tree of lane ranks with shuffles, and the group's lowest lane
//    adds the sum into its warp's column with a shared-memory atomicAdd.
//    No fixed point, so cotangents of any scale survive.
// The block sums its columns in order into a per-block partial, and a
// second kernel sums the partials in block order with a fixed tree.  With
// a column per thread two runs on the same inputs give the same bits by
// construction.  With a column per warp the lanes that reach one add
// together sum in a fixed order, but lanes of one warp on divergent paths
// (a light's C_PX from the NEE of one lane and from the emissive hit of
// another) add to the same entry in the order the warp scheduler runs the
// paths: the atomic keeps every add, and the bits repeat as far as that
// order repeats, which the card tests check on two launches.
//
// What bounds it: like K1, instruction latency and divergence, not memory.
// A pixel reads 40 bytes and writes 24; the work is the scan of every ran
// slot's ray (forward sweep) and of its shadow rays (reverse sweep), plus
// an adjoint about twice a bounce's arithmetic, with branches that diverge
// per pixel.  What the design does about that (PERF.md's K2 ablation):
//  * every ray scans the analytic meshes through K1's packed float4
//    records (trace_common.cuh::intersect_packed_analytic), with the same
//    winner, so the bits do not change;
//  * the reverse sweep takes each slot's hit from the stash instead of
//    scanning its ray a second time;
//  * a column per warp takes 32 times less shared memory than a column per
//    thread, so a scene of many meshes keeps 128-thread blocks and 8 blocks
//    per SM (47 meshes: 15,788 B a block, where a column per thread left one
//    block of 64 threads per SM); on a few meshes the group sums cost more
//    than the columns save, so those keep a column per thread;
//  * __launch_bounds__ budgets: 4 blocks per SM (128 registers, no spill)
//    with a column per thread, 8 (64 registers, the spills stay in L1) with
//    a column per warp.  The stash (14 words a slot) lives in local memory,
//    which the L1 cache serves.

#include <type_traits>

#include "adjoint.cuh"

namespace {

constexpr int MAX_SLOTS = 16;   // stash depth; the wrapper checks the bound
constexpr int ST = 12;          // stashed floats per slot: o, d, mask, prev_nl
constexpr int BWD_THREADS = 128;
constexpr int RED_THREADS = 256;
// __launch_bounds__ blocks per SM of the copies with a column per thread
// (4: 127 registers, no spill) and per warp (8: 64 registers)
constexpr int MIN_BLOCKS_THREAD_COLS = 4;
constexpr int MIN_BLOCKS_WARP_COLS = 8;
// the fewest blocks per SM at which K2 keeps a column per thread: at 3
// blocks it ran 4 % faster than a column per warp on 11 meshes and 3.5 %
// slower on 14, at 2 blocks 25-34 % slower (15, 16 meshes; PERF.md's K2
// ablation), so the two copies cross inside the 3-block band
constexpr int THREAD_COLS_FEWEST_BLOCKS = 3;

// cotangent columns kept per mesh (pos 0:3, joker.x 3, color 7:10,
// emission 10:13), and the scene-table column of each
constexpr int NG = 10;
__host__ __device__ constexpr int table_col_of(int g) { return g < 4 ? g : g + 3; }
__device__ __forceinline__ int acc_col_of(int col) { return col < 4 ? col : col - 3; }

struct BwdArgs {
  TraceArgs t;           // K1's arguments (t.out unused)
  const float *ct;       // [n_pix, 3] cotangent of the radiance
  float *d_ro, *d_rd;    // [n_pix, 3]
  float *partials;       // [n_blocks, n_mesh, NG]
};

// Sum v[0:N] over the lanes of `grp` (a group of the warp's active lanes,
// each calling with the same grp): the group's lowest lane ends with the
// sums.  A fixed tree over the lanes' ranks in the group: at step `off` the
// member of rank r (r a multiple of 2 off) adds the partial of rank r + off,
// so the order of the adds depends on the group alone.
template <int N>
__device__ __forceinline__ void group_sum(unsigned grp, float (&v)[N]) {
  const int lane = (int)(threadIdx.x & 31u);
  const unsigned below = grp & ((1u << lane) - 1u);
  const int r = __popc(below), n = __popc(grp);
  unsigned above = grp & ~below & ~(1u << lane);  // ranks r + 1, r + 2, ... by lane
  for (int off = 1; off < n; off <<= 1) {
    const int src = above ? __ffs(above) - 1 : lane;  // the lane of rank r + off
    const bool take = (r & (2 * off - 1)) == 0 && r + off < n;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float x = __shfl_sync(grp, v[k], src);
      if (take) v[k] += x;
    }
    for (int i = 0; i < off; ++i) above &= above - 1u;  // on to rank r + 2 off
  }
}

// This warp's column of the block's cotangent accumulators; `col` is a
// scene-table column (adjoint.cuh).  The add is atomic because lanes of
// the warp on another divergent path may add to the same entry meanwhile.
struct WarpAcc {
  float *g;  // entry (mesh, k) at g[mesh * NG + k]
  template <int N>
  __device__ __forceinline__ void put(int mesh, int col, float (&v)[N]) const {
    const unsigned grp = __match_any_sync(__activemask(), mesh);
    group_sum<N>(grp, v);
    const int lane = (int)(threadIdx.x & 31u);
    if ((grp & ((1u << lane) - 1u)) == 0u) {  // the group's lowest lane
      float *e = g + mesh * NG + acc_col_of(col);
#pragma unroll
      for (int k = 0; k < N; ++k) atomicAdd(e + k, v[k]);
    }
  }
  __device__ __forceinline__ void add(int mesh, int col, float v) const {
    float w[1] = {v};
    put<1>(mesh, col, w);
  }
  __device__ __forceinline__ void add3(int mesh, int col, V3 v) const {
    float w[3] = {v.x, v.y, v.z};
    put<3>(mesh, col, w);
  }
};

// This thread's column of the block's cotangent accumulators; `col` is a
// scene-table column (adjoint.cuh).
struct ThreadAcc {
  float *g;     // entry e at g[e * stride]
  int stride;   // blockDim.x
  __device__ __forceinline__ void add(int mesh, int col, float v) const {
    g[(mesh * NG + acc_col_of(col)) * stride] += v;
  }
  __device__ __forceinline__ void add3(int mesh, int col, V3 v) const {
    add(mesh, col, v.x);
    add(mesh, col + 1, v.y);
    add(mesh, col + 2, v.z);
  }
};

// shade_nee forward and adjoint in one pass: returns the NEE total (before
// the throughput factor) and adds the cotangents of x, nl and the scene for
// the cotangent g_tot of that total.
template <class Acc>
__device__ V3 shade_nee_bwd(const SceneSmem &s, const PackedScene &pk, V3 x, V3 nl,
                            uint32_t h_depth, float eps, float inf, bool use_mis, V3 g_tot,
                            V3 &g_x, V3 &g_nl, const Acc &G) {
  V3 total = zero3();
  for (int slot = 0; slot < s.n_lights; ++slot) {
    int li = s.lights[slot];
    if (li < 0) continue;  // sentinel slot: no light
    uint32_t h = fold_step(fold_step(h_depth, (uint32_t)slot, 4u), S_NEE_CONE, 5u);
    float u1 = u01(h), u2 = u01(pcg(h));
    V3 lp = s.p(li);
    float r = s.j0(li);
    V3 sw = lp - x;
    float d2 = dot(sw, sw);
    float q = safe_div(r * r, d2);
    float qc = fminf(fmaxf(q, 0.0f), 1.0f);
    float cos_a_max = safe_sqrt(1.0f - qc);
    V3 ldir = normalize(sw);
    float extent = 1.0f - cos_a_max;
    V3 sr = sample_cone(ldir, extent, u1, u2);
    float ts;
    int hidx;
    intersect_packed_analytic(pk, x + nl * eps, sr, eps, ts, hidx);
    if (!(ts < inf) || s.mat[hidx] != MAT_LIGHT) continue;
    float cos_raw = dot(sr, nl);
    float cos_term = fmaxf(cos_raw, 0.001f);
    float weight = 2.0f * (1.0f - cos_a_max);
    V3 lc_raw = s.c(hidx);
    V3 lc = vmax(lc_raw, 0.001f);
    V3 le = s.e(hidx);
    float sc = weight * cos_term;
    V3 contrib = lc * le * sc;
    V3 g_c = g_tot;  // cotangent of contrib
    V3 g_ldir = zero3();
    if (use_mis) {
      if (!(dot(contrib, contrib) > 1e-6f)) continue;
      float b_cos = dot(ldir, nl);
      float b_pdf = fmaxf(b_cos, 0.0f) * ONE_OVER_PI;
      float l_pdf = sphere_light_pdf(lp, r, x);
      float w = power_heuristic(l_pdf, b_pdf);
      float g_w = dot(g_c, contrib);
      contrib = contrib * w;
      g_c = g_c * w;
      float g_l, g_b;
      power_heuristic_bwd(l_pdf, b_pdf, g_w, g_l, g_b);
      if (b_cos >= 0.0f) {
        float gb = g_b * ONE_OVER_PI;
        g_ldir = nl * gb;
        g_nl = g_nl + ldir * gb;
      }
      V3 g_lp, g_xp;
      float g_r;
      sphere_light_pdf_bwd(lp, r, x, g_l, g_lp, g_r, g_xp);
      G.add3(li, C_PX, g_lp);
      G.add(li, C_J0, g_r);
      g_x = g_x + g_xp;
    }
    total = total + contrib;

    // contrib = max(c, 0.001) * e * (weight * cos_term)
    G.add3(hidx, C_CR, pass_ge(lc_raw, 0.001f, g_c * le * sc));
    G.add3(hidx, C_ER, g_c * lc * sc);
    float g_sc = dot(g_c, lc * le);
    float g_cos = g_sc * weight;
    V3 g_sr = zero3();
    if (cos_raw >= 0.001f) {
      g_sr = nl * g_cos;
      g_nl = g_nl + sr * g_cos;
    }
    V3 g_ld2;
    float g_ext;
    sample_cone_bwd(ldir, extent, u1, u2, g_sr, g_ld2, g_ext);
    g_ldir = g_ldir + g_ld2;
    // weight = 2 (1 - cos_a_max), extent = 1 - cos_a_max
    float g_cam = -2.0f * (g_sc * cos_term) - g_ext;
    float g_qc = (1.0f - qc) > 0.0f ? -g_cam / (2.0f * cos_a_max) : 0.0f;
    float g_q = (q >= 0.0f && q <= 1.0f) ? g_qc : 0.0f;
    float g_r2, g_d2;
    safe_div_bwd(r * r, d2, g_q, g_r2, g_d2);
    G.add(li, C_J0, 2.0f * r * g_r2);
    V3 g_sw = sw * (2.0f * g_d2) + normalize_bwd(sw, g_ldir);
    G.add3(li, C_PX, g_sw);
    g_x = g_x - g_sw;
  }
  return total;
}

// Adjoint of slot `depth` of K1's loop.  In: the carry entering the slot
// (o, d, mask, prev_nl), the hit (t, idx) of its ray and, in g_*, the
// cotangents of the carry leaving it (zero for the last slot).  Out: g_*
// hold the cotangents of the carry entering it; the scene's cotangents are
// added into G.
template <class Acc>
__device__ void slot_bwd(const SceneSmem &s, const PackedScene &pk, const TraceArgs &a, int depth,
                         uint32_t h_pix, V3 o, V3 d, V3 mask, V3 prev_nl, float t, int idx, V3 ct,
                         V3 &g_o, V3 &g_d, V3 &g_mask, V3 &g_pnl, const Acc &G) {
  const bool specular = depth == 0;  // only primary rays are specular in this class
  const V3 go_out = g_o, gd_out = g_d, gm_out = g_mask, gp_out = g_pnl;
  g_o = g_d = g_mask = g_pnl = zero3();

  // ---- miss: acc += mask * sky(d) ----
  if (!(t < a.inf)) {
    if (a.use_sky && (specular || !a.sample_lights)) {
      g_mask = ct * procedural_sky(d);
      g_d.y = sky_bwd(d, ct * mask);
    }
    return;
  }

  V3 x = o + d * t;
  V3 c_raw = s.c(idx);
  V3 c = vmax(c_raw, 0.001f);
  V3 g_x = zero3();

  if (s.mat[idx] == MAT_LIGHT) {
    // ---- emissive hit: acc += mask * c * e * mis_w ----
    V3 e_raw = s.e(idx);
    V3 e = vmax(e_raw, 0.001f);
    const bool mis = a.use_mis && a.sample_lights && depth > 0 && !specular;
    float mis_w = 1.0f, l_pdf = 0.0f, b_pdf = 0.0f, b_cos = 0.0f;
    V3 light_dir = zero3();
    if (mis) {
      light_dir = normalize(x - o);
      l_pdf = s.mesh[idx] == MESH_SPHERE ? sphere_light_pdf(s.p(idx), s.j0(idx), o) : INV_FOUR_PI;
      b_cos = dot(light_dir, prev_nl);
      b_pdf = fmaxf(b_cos, 0.0f) * ONE_OVER_PI;
      mis_w = power_heuristic(b_pdf, l_pdf);
    }
    g_mask = ct * c * e * mis_w;
    G.add3(idx, C_CR, pass_ge(c_raw, 0.001f, ct * mask * e * mis_w));
    G.add3(idx, C_ER, pass_ge(e_raw, 0.001f, ct * mask * c * mis_w));
    if (mis) {
      float g_b, g_l;
      power_heuristic_bwd(b_pdf, l_pdf, dot(ct, mask * c * e), g_b, g_l);
      if (b_cos >= 0.0f) {
        float gc = g_b * ONE_OVER_PI;
        g_pnl = light_dir * gc;
        V3 g_xo = normalize_bwd(x - o, prev_nl * gc);
        g_x = g_x + g_xo;
        g_o = g_o - g_xo;
      }
      if (s.mesh[idx] == MESH_SPHERE) {
        V3 g_lp, g_op;
        float g_r;
        sphere_light_pdf_bwd(s.p(idx), s.j0(idx), o, g_l, g_lp, g_r, g_op);
        G.add3(idx, C_PX, g_lp);
        G.add(idx, C_J0, g_r);
        g_o = g_o + g_op;
      }
    }
  } else {
    // ---- DIFF bounce: o' = x + nl eps, d' = sample_biased(nl), mask' = mask c,
    //      prev_nl' = nl, acc += nee(x, nl) * mask' ----
    V3 n = normal_at(s, idx, x);
    float inside = dot(d, n) > 0.0f ? -1.0f : 1.0f;
    const uint32_t h_depth = fold_step(h_pix, (uint32_t)depth, 3u);
    const uint32_t h_dir = fold_step(h_depth, S_BSDF_DIR, 4u);
    V3 nl = n * inside;
    V3 mask_after = mask * c;

    g_x = go_out;
    V3 g_nl = go_out * a.eps + gp_out + sample_biased_bwd(nl, u01(h_dir), u01(pcg(h_dir)), gd_out);
    V3 g_ma = gm_out;
    if (a.sample_lights) {
      V3 total = shade_nee_bwd(s, pk, x, nl, h_depth, a.eps, a.inf, a.use_mis, ct * mask_after,
                               g_x, g_nl, G);
      g_ma = g_ma + ct * total;
    }
    g_mask = g_ma * c;
    G.add3(idx, C_CR, pass_ge(c_raw, 0.001f, g_ma * mask));
    normal_bwd(s, idx, x, g_nl * inside, g_x, G);
  }

  // ---- x = o + d t(o, d, scene) ----
  g_o = g_o + g_x;
  g_d = g_d + g_x * t;
  isect_bwd(s, idx, o, d, a.eps, dot(g_x, d), g_o, g_d, G);
}

// Where K2's cotangent columns start in dynamic shared memory (bytes): after
// the scene (load_scene) and its packed records (load_packed, no SDF rows).
__host__ __device__ inline size_t bwd_columns_offset(int n_mesh, int n_lights) {
  return packed_smem_bytes(scene_smem_bytes(n_mesh, n_lights), n_mesh, 0);
}

// Dynamic shared memory of one K2 block: the scene, its packed records and
// `columns` columns of NG cotangent accumulators per mesh.
__host__ __device__ inline size_t bwd_smem_bytes(int n_mesh, int n_lights, int columns) {
  return bwd_columns_offset(n_mesh, n_lights) + sizeof(float) * n_mesh * NG * columns;
}

// kWarpCols: a column per warp (WarpAcc), else per thread (ThreadAcc).
template <bool kWarpCols>
__global__ void __launch_bounds__(BWD_THREADS, kWarpCols ? MIN_BLOCKS_WARP_COLS
                                                         : MIN_BLOCKS_THREAD_COLS)
    bwd_kernel(BwdArgs b) {
  const TraceArgs &a = b.t;
  extern __shared__ __align__(16) float smem[];
  const SceneSmem s = load_scene(a, smem);
  float *gsm = smem + bwd_columns_offset(a.n_mesh, a.n_lights) / sizeof(float);
  const int n_g = a.n_mesh * NG;
  const int n_cols = kWarpCols ? (blockDim.x + warpSize - 1) / warpSize : blockDim.x;
  for (int e = threadIdx.x; e < n_cols * n_g; e += blockDim.x) gsm[e] = 0.0f;
  using Acc = typename std::conditional<kWarpCols, WarpAcc, ThreadAcc>::type;
  Acc G;
  if constexpr (kWarpCols)
    G = {gsm + (threadIdx.x / warpSize) * n_g};
  else
    G = {gsm + threadIdx.x, (int)blockDim.x};
  const SdfScene no_sdf = {nullptr, a.n_mesh, 0, 0, 0.0f, 0.0f};
  const PackedScene pk = load_packed(s, no_sdf, smem, scene_smem_bytes(a.n_mesh, a.n_lights));

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < a.n_pix) {  // ragged edge: idle threads still join the block sum
    V3 o = {a.ro[3 * p], a.ro[3 * p + 1], a.ro[3 * p + 2]};
    V3 d = {a.rd[3 * p], a.rd[3 * p + 1], a.rd[3 * p + 2]};
    const uint32_t h_pix = pixel_hash(a, p);

    // ---- forward sweep: K1's carry updates, stashing each slot's input and hit ----
    float st[MAX_SLOTS * ST];
    float st_t[MAX_SLOTS];
    int st_idx[MAX_SLOTS];
    V3 mask = {1.0f, 1.0f, 1.0f};
    V3 prev_nl = {0.0f, 1.0f, 0.0f};
    int ndif = 0, nspec = 0, nscat = 0, n_run = 0;
    for (int depth = 0; depth < a.max_bounces && depth < MAX_SLOTS; ++depth) {
      float *sk = st + depth * ST;
      sk[0] = o.x, sk[1] = o.y, sk[2] = o.z, sk[3] = d.x, sk[4] = d.y, sk[5] = d.z;
      sk[6] = mask.x, sk[7] = mask.y, sk[8] = mask.z;
      sk[9] = prev_nl.x, sk[10] = prev_nl.y, sk[11] = prev_nl.z;
      n_run = depth + 1;

      float tmin;
      int idx;
      intersect_packed_analytic(pk, o, d, a.eps, tmin, idx);
      st_t[depth] = tmin;
      st_idx[depth] = idx;
      if (!(tmin < a.inf) || s.mat[idx] == MAT_LIGHT) break;  // miss or emissive hit ends the path
      V3 x = o + d * tmin;
      V3 n = normal_at(s, idx, x);
      V3 c = vmax(s.c(idx), 0.001f);
      float inside = dot(d, n) > 0.0f ? -1.0f : 1.0f;
      const uint32_t h_dir = fold_step(fold_step(h_pix, (uint32_t)depth, 3u), S_BSDF_DIR, 4u);
      V3 nl = n * inside;
      V3 new_d = sample_biased(nl, u01(h_dir), u01(pcg(h_dir)));
      o = x + nl * a.eps;
      d = new_d;
      mask = mask * c;
      prev_nl = nl;
      ndif += 1;
      if (fmaxf(fmaxf(mask.x, mask.y), mask.z) < 0.01f || ndif >= a.max_diff ||
          nspec >= a.max_spec || nscat >= a.max_scatter)
        break;
    }

    // ---- reverse sweep: newest slot first ----
    const V3 ct = {b.ct[3 * p], b.ct[3 * p + 1], b.ct[3 * p + 2]};
    V3 g_o = zero3(), g_d = zero3(), g_mask = zero3(), g_pnl = zero3();
    for (int k = n_run - 1; k >= 0; --k) {
      const float *sk = st + k * ST;
      slot_bwd(s, pk, a, k, h_pix, {sk[0], sk[1], sk[2]}, {sk[3], sk[4], sk[5]},
               {sk[6], sk[7], sk[8]}, {sk[9], sk[10], sk[11]}, st_t[k], st_idx[k], ct, g_o, g_d,
               g_mask, g_pnl, G);
    }
    b.d_ro[3 * p] = g_o.x;
    b.d_ro[3 * p + 1] = g_o.y;
    b.d_ro[3 * p + 2] = g_o.z;
    b.d_rd[3 * p] = g_d.x;
    b.d_rd[3 * p + 1] = g_d.y;
    b.d_rd[3 * p + 2] = g_d.z;
  }

  // ---- this block's partial of d_table, its columns summed in order ----
  __syncthreads();
  for (int e = threadIdx.x; e < n_g; e += blockDim.x) {
    float sum = 0.0f;
    for (int c = 0; c < n_cols; ++c) sum += kWarpCols ? gsm[c * n_g + e] : gsm[e * n_cols + c];
    b.partials[(size_t)blockIdx.x * n_g + e] = sum;
  }
}

// d_table[entry] = sum over blocks of the partials, in a fixed order: one
// block per table entry, a strided sum per thread, then a fixed tree.
__global__ void __launch_bounds__(RED_THREADS)
    reduce_kernel(const float *partials, int n_blocks, int n_mesh, float *d_table) {
  __shared__ float red[RED_THREADS];
  const int entry = blockIdx.x;
  const int mesh = entry / NCOLS, col = entry % NCOLS;
  int g = -1;
  for (int k = 0; k < NG; ++k)
    if (table_col_of(k) == col) g = k;
  float sum = 0.0f;
  if (g >= 0)
    for (int blk = threadIdx.x; blk < n_blocks; blk += RED_THREADS)
      sum += partials[(size_t)blk * n_mesh * NG + mesh * NG + g];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) d_table[entry] = red[0];
}

// K2's layout of a block of `threads` threads on the current device: a
// column of cotangent accumulators per thread while
// THREAD_COLS_FEWEST_BLOCKS blocks of them (each with the shared memory the
// runtime reserves per block) fit one SM's shared memory; a column per warp
// beyond (warp_cols).  `smem` is the block's dynamic shared memory.
// Returns the first CUDA error of the device queries, or 0.
inline int bwd_layout(int n_mesh, int n_lights, int threads, bool &warp_cols, size_t &smem) {
  int dev = 0, lanes = 32, per_sm = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&lanes, cudaDevAttrWarpSize, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return (int)e;
  smem = bwd_smem_bytes(n_mesh, n_lights, threads);
  warp_cols = (size_t)THREAD_COLS_FEWEST_BLOCKS * (smem + (size_t)reserved) > (size_t)per_sm;
  if (warp_cols) smem = bwd_smem_bytes(n_mesh, n_lights, (threads + lanes - 1) / lanes);
  return 0;
}

}  // namespace

// Launch K2 on `stream`: the adjoint kernel, then the reduction of its
// per-block partials [ceil(n_pix / threads), n_mesh, 10] into d_table.
// Returns the first CUDA error of the two launches, or 0.
extern "C" int rt0_trace_backward(const float *table, const int32_t *mesh, const int32_t *mat,
                                  int n_mesh, const int32_t *lights, int n_lights,
                                  const float *ro, const float *rd, const int64_t *pix,
                                  const float *ct, float *d_ro, float *d_rd, float *partials,
                                  float *d_table, long long n_pix, unsigned pass_idx,
                                  unsigned sample_idx, int max_bounces, int max_diff,
                                  int max_spec, int max_scatter, float eps, float inf,
                                  int sample_lights, int use_mis, int use_sky, int threads,
                                  void *stream) {
  if (threads <= 0 || threads > BWD_THREADS || n_mesh <= 0) return (int)cudaErrorInvalidValue;
  TraceArgs t = {table,       mesh,       mat,       lights,   n_mesh,      n_lights,
                 ro,          rd,         pix,       nullptr,  n_pix,       pass_idx,
                 sample_idx,  max_bounces, max_diff, max_spec, max_scatter, eps,
                 inf,         sample_lights, use_mis, use_sky};
  BwdArgs b = {t, ct, d_ro, d_rd, partials};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = n_pix > 0 ? (unsigned)((n_pix + threads - 1) / threads) : 0u;
  if (blocks > 0) {
    bool warp_cols = false;
    size_t smem = 0;
    int rc = bwd_layout(n_mesh, n_lights, threads, warp_cols, smem);
    if (rc != 0) return rc;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
      e = warp_cols ? cudaFuncSetAttribute(bwd_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                    : cudaFuncSetAttribute(bwd_kernel<false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (warp_cols)
      bwd_kernel<true><<<blocks, threads, smem, st>>>(b);
    else
      bwd_kernel<false><<<blocks, threads, smem, st>>>(b);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  reduce_kernel<<<n_mesh * NCOLS, RED_THREADS, 0, st>>>(partials, (int)blocks, n_mesh, d_table);
  return (int)cudaGetLastError();
}

// K2's layout for a block of `threads` threads on the current device
// (bwd_layout): out[0] is 1 with a column of accumulators per warp, 0 per
// thread, out[1] the block's dynamic shared memory in bytes.
extern "C" int rt0_trace_backward_layout(int n_mesh, int n_lights, int threads,
                                         long long *out) {
  bool warp_cols = false;
  size_t smem = 0;
  const int rc = bwd_layout(n_mesh, n_lights, threads, warp_cols, smem);
  out[0] = warp_cols ? 1 : 0;
  out[1] = (long long)smem;
  return rc;
}

// K2's occupancy at `threads` threads and `smem` bytes of dynamic shared
// memory (trace_common.cuh::kernel_occupancy): the copy with a column per
// warp when `warp_cols` is set.
extern "C" int rt0_trace_backward_occupancy(int warp_cols, int threads, long long smem,
                                            int *out) {
  return warp_cols ? kernel_occupancy(bwd_kernel<true>, threads, (size_t)smem, out)
                   : kernel_occupancy(bwd_kernel<false>, threads, (size_t)smem, out);
}
