// megakernel_bwd.cu — K2, the adjoint of the forward megakernel K1, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// raytracer0_tpu/ops/megakernel.py::_bwd_slotted_kernel_body (launched by
// `_backward`), and computes the same outputs as its whole-trace twin
// `_bwd_kernel_body` (RT0_BWD_SLOTTED=0), over K1's whole class without
// ReSTIR: every surface material, sphere, directional and SDF-bound
// lights, cosine and uniform sampling, SDF meshes of all 14 shapes, the
// cubemap or the procedural sky, textures of all ten types on analytic
// and SDF meshes, hero-wavelength spectral transport and the homogeneous
// medium.  Given K1's inputs and
// the cotangent ct f32[n_pix, 3] of its radiance it returns d_table
// f32[n_mesh, 36] and d_ro, d_rd f32[n_pix, 3]: the gradients that
// torch.autograd gives through the plain version
// (raytracer0_tpu_torch/render/integrator.py::trace).  The texel arrays
// (images, noise LUT, cubemap) get none: the wrapper refuses a gradient
// w.r.t. them.  CUDA has no autodiff, so the adjoint of each step of a
// bounce is written out by hand, below and in adjoint.cuh (shared with K7).
//
// Four copies, each a template instance for a column of accumulators per
// thread and per warp:
//  * the Cornell copy (bwd_kernel, slot_bwd): analytic DIFF and LIGHT
//    meshes, sphere-light slots, no texture, the procedural sky, cosine
//    sampling, and the 10 table columns that have a cotangent there (pos
//    0:3, joker.x 3, color 7:10, emission 10:13).  Its code is the code K2
//    had before the wide copy came.
//  * the wide copy (bwd_wide_kernel, wide_slot_bwd) for the rest, with the
//    scene's set of columns (a mask the wrapper picks, megakernel.
//    bwd_columns, mapped to accumulators in shared memory): Cornell's, and
//    joker 4:7 under SDF rows, the IOR under refraction, the texture
//    params, color mask and emission mask where textures are used.
//  * the whole-SDF copy (bwd_wide_kernel<., true>, wide_slot_bwd<true>)
//    for the scenes K1 runs its whole-SDF copy on (use_tex bit 2): every
//    SDF shape through adjoint.cuh::sdf_map_all_bwd (the adjoints of the
//    14 distances, a `noinline` call as K1's scene map is), the texel of
//    an SDF hit at the UV of its row's box normal, SDF-light NEE
//    (sdf_light_bwd), and the aux columns of TRIANGLE and QUAD rows.  The
//    Cornell and wide copies compile none of it.
//  * the medium copy (bwd_wide_kernel<., true, true>) for every scene of
//    K1's class under use_spectral or use_volumetrics, as K1's medium copy
//    serves them: the whole-SDF copy plus the hero wavelength and Cauchy's
//    IOR (adjoint.cuh::bounce_dir_bwd<true>), the medium event with its
//    in-scatter NEE (medium_nee_bwd) and HG continuation (sample_hg_bwd),
//    and the fog on sphere-light shadow rays (shade_nee_bwd<., ., true>),
//    whose shadow ray's t then carries a cotangent.  Its stash is the
//    whole-SDF copy's: the reverse sweep decides a slot's medium event
//    again from its free-path draw and the stashed t.
// The whole-SDF copy and the medium copy are libraries of their own
// (megakernel_bwd_sdf.cu and megakernel_bwd_medium.cu: this file with
// RT0_K2_WHOLE_SDF or RT0_K2_MEDIUM set), so that nvcc compiles them beside
// the library of the other two copies; each library's launcher refuses the
// copies it does not hold, and the medium copy's takes the medium's
// constants (MediumArgs) as K1's launcher does.
//
// Scheme: the per-slot stash of the Pallas kernel, one thread per pixel.
//  * forward sweep: run K1's bounce loop without NEE, the gather ray and
//    the accumulator (none changes the carry) and stash, for every slot
//    the path runs, the carry entering it (o, d, mask, prev_nl; the wide
//    copy also the `specular` flag, which in the Cornell class is
//    depth == 0) and the hit its ray found (t, idx).  The accumulator
//    needs no stash (its cotangent is ct at every slot), nor do the integer
//    counters (no cotangent).  A path runs at most megakernel.bwd_slots
//    slots: on the Cornell copy each slot that goes on is a diffuse bounce,
//    elsewhere it adds one to one of three capped counters.
//  * reverse sweep: newest slot first, recompute the slot from its stash
//    (normal, texel, BSDF sample, NEE shadow rays and the gather ray: the
//    counter RNG replays every draw exactly; the slot's own ray is not
//    scanned again) and run its hand-derived adjoint, chaining the carry
//    cotangents back to the primary ray.  An SDF hit's t is reattached
//    implicitly, as ops/sdf.march does, and its normal is the tetrahedral
//    one's adjoint.
// Discrete decisions (winner index, shadow-ray hit, `inside`, validity,
// the Fresnel and Schlick choices, the cubemap face, texel cells, the MIS
// energy gate, cutoff and caps) carry no gradient, as `torch.where` gives
// in the plain version.  Ties follow the plain version's autograd: clamp
// and clamp_min pass the gradient at the bound, amax/amin and the SDF
// scene map's torch.minimum split it between tied values.  The emission of
// a glossy surface bends its direction detached, as in the plain version.
//
// The d_table reduction across pixels is deterministic.  The columns are
// summed per mesh into columns of accumulators in shared memory:
//  * a column per thread while 3 blocks of such columns fit an SM's shared
//    memory (bwd_layout: up to 14 meshes on an H100 at Cornell's 10
//    columns); a thread adds into its own column;
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
// slot's ray (forward sweep) and of its shadow and gather rays (reverse
// sweep), plus an adjoint about twice a bounce's arithmetic, with branches
// that diverge per pixel.  What the design does about that (PERF.md's K2
// ablation):
//  * every ray scans the analytic meshes through K1's packed float4
//    records (trace_common.cuh::intersect_packed), with the same winner, so
//    the bits do not change; SDF rows are marched behind K1's gate;
//  * the reverse sweep takes each slot's hit from the stash instead of
//    scanning its ray a second time;
//  * a column per warp takes 32 times less shared memory than a column per
//    thread, so a scene of many meshes keeps 128-thread blocks and 8 blocks
//    per SM (47 meshes: 15,788 B a block, where a column per thread left one
//    block of 64 threads per SM); on a few meshes the group sums cost more
//    than the columns save, so those keep a column per thread;
//  * the wide copy keeps the scene's columns, not all 24 a scene may have,
//    so the switch between the layouts follows the scene;
//  * __launch_bounds__ budgets: 4 blocks per SM (128 registers) with a
//    column per thread, 8 (64 registers, the spills stay in L1) with a
//    column per warp.  The stash (14 or 15 words a slot) lives in local
//    memory, which the L1 cache serves.

#include <cassert>
#include <type_traits>

#include "adjoint.cuh"

// 1 in megakernel_bwd_sdf.cu: this library holds the whole-SDF copy alone
#ifndef RT0_K2_WHOLE_SDF
#define RT0_K2_WHOLE_SDF 0
#endif
// 1 in megakernel_bwd_medium.cu: this library holds the medium copy alone,
// and its launcher takes the medium's constants
#ifndef RT0_K2_MEDIUM
#define RT0_K2_MEDIUM 0
#endif

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

// the Cornell copy's cotangent columns per mesh (pos 0:3, joker.x 3,
// color 7:10, emission 10:13), as a mask of scene-table columns
constexpr int NG = 10;
constexpr unsigned long long CORNELL_COLS = 0x1F8Full;
__device__ __forceinline__ int acc_col_of(int col) { return col < 4 ? col : col - 3; }

// The columns of `cols` (a mask of scene-table columns) below `col`: the
// accumulator of column `col` when it is in the mask.
__host__ __device__ inline int cols_below(unsigned long long cols, int col) {
  int k = 0;
  for (int j = 0; j < col; ++j) k += (int)((cols >> j) & 1ull);
  return k;
}

// The cotangent columns a copy of K2 keeps per mesh: the Cornell copy's
// fixed 10, or (the wide copy) the scene's set, a map from table column to
// accumulator in shared memory (megakernel.bwd_columns picks it).
struct CornellCols {
  __device__ __forceinline__ int n() const { return NG; }
  __device__ __forceinline__ int of(int col) const { return acc_col_of(col); }
};
struct SceneCols {
  const int *map;  // [NCOLS]: the accumulator of each table column the scene keeps, else -1
  int count;
  __device__ __forceinline__ int n() const { return count; }
  __device__ __forceinline__ int of(int col) const {
#ifndef __CUDA_ARCH__
    assert(map[col] >= 0);  // the host build checks that every add has its column
#endif
    return map[col];
  }
};

template <class T>
struct BwdArgsT {
  T t;                     // K1's arguments (t.out unused)
  const float *ct;         // [n_pix, 3] cotangent of the radiance
  float *d_ro, *d_rd;      // [n_pix, 3]
  float *partials;         // [n_blocks, n_mesh, ng]
  unsigned long long cols; // the scene-table columns kept, ng of them
  int ng;
};
using BwdArgs = BwdArgsT<TraceArgs>;
// the medium copy's: K1's arguments with the medium's constants
// (MediumArgs), passed to that copy alone, so the other copies' TraceArgs
// and stacks keep their size
using BwdMediumArgs = BwdArgsT<MediumArgs>;

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
template <class Cols>
struct WarpAcc {
  float *g;   // entry (mesh, k) at g[mesh * cols.n() + k]
  Cols cols;
  template <int N>
  __device__ __forceinline__ void put(int mesh, int col, float (&v)[N]) const {
    const unsigned grp = __match_any_sync(__activemask(), mesh);
    group_sum<N>(grp, v);
    const int lane = (int)(threadIdx.x & 31u);
    if ((grp & ((1u << lane) - 1u)) == 0u) {  // the group's lowest lane
      float *e = g + mesh * cols.n() + cols.of(col);
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
template <class Cols>
struct ThreadAcc {
  float *g;     // entry e at g[e * stride]
  int stride;   // blockDim.x
  Cols cols;
  __device__ __forceinline__ void add(int mesh, int col, float v) const {
    g[(mesh * cols.n() + cols.of(col)) * stride] += v;
  }
  __device__ __forceinline__ void add3(int mesh, int col, V3 v) const {
    add(mesh, col, v.x);
    add(mesh, col + 1, v.y);
    add(mesh, col + 2, v.z);
  }
};

// One SDF-light sample of shade_nee (K1's NEE_SDF_POINT branch,
// lighting.direct_light_slot's "sdf" kind) from slot `slot`, the LIGHT SDF
// row `li`, at (x, nl): a shadow ray toward pos + dir * joker.xyz, dir a
// uniform direction, its contribution max(c, 0.001) e max(dot(sr, nl),
// 0.001) where it hits a LIGHT mesh, weighted under MIS against the cosine
// pdf of normalize(pos - x) with the uniform sphere's 1/4pi.  Returns the
// contribution and adds the cotangents of x, nl and the scene for its
// cotangent g_c: through the direction, the light's pos and joker.xyz, and
// where the scene's LIGHT meshes have textures (use_tex bit 1) the texel
// at the shadow hit, whose point carries the hit's t (the SDF march's
// implicit t, or the analytic one).  The shadow hit is a discrete choice.
template <class Acc>
__device__ V3 sdf_light_bwd(const TraceArgs &a, const SceneSmem &s, const SdfScene &sd,
                            const PackedScene &pk, const int *tex, int slot, int li, V3 x, V3 nl,
                            uint32_t h_depth, float eps, float inf, bool use_mis, V3 g_c,
                            V3 &g_x, V3 &g_nl, const Acc &G) {
  const uint32_t h = fold_step(fold_step(h_depth, (uint32_t)slot, 4u), S_NEE_SDF_POINT, 5u);
  const float u1 = u01(h), u2 = u01(pcg(h));
  const float z = 1.0f - 2.0f * u1;
  const float r = safe_sqrt(1.0f - z * z);
  const float phi = TWO_PI * u2;
  const V3 lp = s.p(li);
  const float *j = s.col(li, C_J0);
  const V3 dir = V3{r * cosf(phi), r * sinf(phi), z};
  const V3 lv = lp + dir * V3{j[0], j[1], j[2]} - x;
  const V3 sr = normalize(lv);
  const V3 so = x + nl * eps;
  float ts;
  int hidx;
  const bool sdf_shadow =
      intersect_packed<true, true>(s, sd, pk, so, sr, eps, inf, ts, hidx, a.noise, a.noise_n);
  if (!(ts < inf) || s.mat[hidx] != MAT_LIGHT) return zero3();
  const bool textured = (a.use_tex & 2) != 0;
  const V3 c0 = s.c(hidx);
  V3 lc_raw = c0;
  V4 tx = {0.0f, 0.0f, 0.0f, 0.0f};
  if (textured) {
    tx = get_texel(tex[hidx], s.mesh[hidx], s.col(hidx, C_TP), so + sr * ts, zero3(), a.images,
                   a.img_h, a.img_w, a.noise, a.noise_n);
    lc_raw = lc_raw + (V3{tx.x, tx.y, tx.z} - lc_raw) * tx.w;
  }
  const V3 lc = vmax(lc_raw, 0.001f), le = s.e(hidx);
  const float cos_raw = dot(sr, nl);
  const float cos_term = fmaxf(cos_raw, 0.001f);
  V3 contrib = lc * le * cos_term;
  if (use_mis) {
    if (!(dot(contrib, contrib) > 1e-6f)) return zero3();
    const V3 sw = lp - x;
    const V3 ldir = normalize(sw);
    const float b_cos = dot(ldir, nl);
    const float b_pdf = fmaxf(b_cos, 0.0f) * ONE_OVER_PI;
    const float w = power_heuristic(INV_FOUR_PI, b_pdf);
    const float g_w = dot(g_c, contrib);
    contrib = contrib * w;
    g_c = g_c * w;
    float g_l, g_b;
    power_heuristic_bwd(INV_FOUR_PI, b_pdf, g_w, g_l, g_b);
    if (b_cos >= 0.0f) {
      const float gb = g_b * ONE_OVER_PI;
      g_nl = g_nl + ldir * gb;
      const V3 g_sw = normalize_bwd(sw, nl * gb);
      G.add3(li, C_PX, g_sw);
      g_x = g_x - g_sw;
    }
  }
  // contrib = max(c', 0.001) e max(dot(sr, nl), 0.001)
  const V3 g_lr = pass_ge(lc_raw, 0.001f, g_c * le * cos_term);
  G.add3(hidx, C_ER, g_c * lc * cos_term);
  V3 g_sr = zero3();
  const float g_cos = dot(g_c, lc * le);
  if (cos_raw >= 0.001f) {
    g_sr = nl * g_cos;
    g_nl = g_nl + sr * g_cos;
  }
  if (!textured) {
    G.add3(hidx, C_CR, g_lr);
  } else {
    // c' = c + (texel - c) alpha, the texel at hp = so + sr ts(so, sr, scene)
    G.add3(hidx, C_CR, g_lr * (1.0f - tx.w));
    const V3 g_hp = texel_bwd(hidx, tex[hidx], s.mesh[hidx], s.col(hidx, C_TP), so + sr * ts,
                              zero3(), a.images, a.img_h, a.img_w, a.noise, a.noise_n,
                              V4{g_lr.x * tx.w, g_lr.y * tx.w, g_lr.z * tx.w,
                                 dot(g_lr, V3{tx.x, tx.y, tx.z} - c0)}, G);
    V3 g_so = g_hp;
    g_sr = g_sr + g_hp * ts;
    const float g_ts = dot(g_hp, sr);
    if (sdf_shadow)
      sdf_t_bwd<true, true>(s, sd, so, sr, ts, eps, 2.0f * eps, g_ts, g_so, g_sr, G, a.noise,
                            a.noise_n);
    else
      isect_bwd(s, hidx, so, sr, eps, g_ts, g_so, g_sr, G);
    g_x = g_x + g_so;
    g_nl = g_nl + g_so * eps;
  }
  // sr = normalize(pos + dir joker.xyz - x)
  const V3 g_lv = normalize_bwd(lv, g_sr);
  G.add3(li, C_PX, g_lv);
  G.add3(li, C_J0, g_lv * dir);
  g_x = g_x - g_lv;
  return contrib;
}

// shade_nee forward and adjoint in one pass: returns the NEE total (before
// the throughput factor) and adds the cotangents of x, nl and the scene for
// the cotangent g_tot of that total.  The wide copy (kWide) also lights by
// directional slots (none under MIS, whose weight for them is 0), skips
// slots of any other kind, marches the SDF rows and, where LIGHT meshes
// have textures, blends the shadow hit's texel into its color
// (trace_common.cuh::shadow_texel_color), as K1 does; the Cornell copy
// compiles those parts out.  The whole-SDF copy (kAll) marches every SDF
// shape and samples SDF-bound lights (shade_nee's NEE_SDF_POINT branch).
// The medium copy (kMedium, with kAll) fogs a sphere light's shadow ray by
// exp(-sigma_t ts) under use_volumetrics, so its t carries a cotangent
// (through the analytic intersection or the SDF march's implicit t).
template <bool kWide, bool kAll, bool kMedium = false, class Acc>
__device__ V3 shade_nee_bwd(const TraceArgs &a, const SceneSmem &s, const SdfScene &sd,
                            const PackedScene &pk, const int *tex, V3 x, V3 nl, uint32_t h_depth,
                            float eps, float inf, bool use_mis, V3 g_tot, V3 &g_x, V3 &g_nl,
                            const Acc &G) {
  // the value-noise LUT of a SNOWBALL, for the whole-SDF copy's scene map
  const float *lut = kAll ? a.noise : nullptr;
  const int lut_n = kAll ? a.noise_n : 0;
  V3 total = zero3();
  for (int slot = 0; slot < s.n_lights; ++slot) {
    int li = s.lights[slot];
    if (li < 0) continue;  // sentinel slot: no light
    if constexpr (kWide) {
      if (s.mat[li] == MAT_DIR_LIGHT) {
        if (use_mis) continue;
        // c e max(dot(lp, nl), 0.001) where the occlusion ray escapes
        const V3 lp = s.p(li);
        float ts;
        int hidx;
        intersect_packed<true, kAll>(s, sd, pk, x + nl * eps, normalize(lp), eps, inf, ts, hidx,
                                     lut, lut_n);
        if (ts < inf) continue;
        const V3 lc = s.c(li), le = s.e(li);
        const float cos_raw = dot(lp, nl);
        const float cos_term = fmaxf(cos_raw, 0.001f);
        total = total + lc * le * cos_term;
        G.add3(li, C_CR, g_tot * le * cos_term);
        G.add3(li, C_ER, g_tot * lc * cos_term);
        if (cos_raw >= 0.001f) {
          const float g_cos = dot(g_tot, lc * le);
          G.add3(li, C_PX, nl * g_cos);
          g_nl = g_nl + lp * g_cos;
        }
        continue;
      }
      if constexpr (kAll) {
        if (s.mat[li] == MAT_LIGHT && s.mesh[li] == MESH_SDF) {
          total = total + sdf_light_bwd(a, s, sd, pk, tex, slot, li, x, nl, h_depth, eps, inf,
                                        use_mis, g_tot, g_x, g_nl, G);
          continue;
        }
      }
      if (s.mat[li] != MAT_LIGHT || s.mesh[li] != MESH_SPHERE) continue;
    }
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
    bool sdf_shadow = false;
    if constexpr (kWide)
      sdf_shadow = intersect_packed<true, kAll>(s, sd, pk, x + nl * eps, sr, eps, inf, ts, hidx,
                                                lut, lut_n);
    else
      intersect_packed_analytic(pk, x + nl * eps, sr, eps, ts, hidx);
    if (!(ts < inf) || s.mat[hidx] != MAT_LIGHT) continue;
    float cos_raw = dot(sr, nl);
    float cos_term = fmaxf(cos_raw, 0.001f);
    float weight = 2.0f * (1.0f - cos_a_max);
    float fog = 1.0f;  // kMedium: Beer-Lambert fog over the shadow ray
    if constexpr (kMedium) {
      if (medium_args(a).use_volumetrics) fog = expf(-medium_args(a).sigma_t * ts);
    }
    V3 lc_raw = s.c(hidx);
    // in a scene with textured lights the shadow hit's texel blends into its
    // color (trace_common.cuh::shadow_texel_color)
    bool textured = false;
    V4 tx = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (kWide) {
      textured = (a.use_tex & 2) != 0;
      if (textured) {
        tx = get_texel(tex[hidx], s.mesh[hidx], s.col(hidx, C_TP), x + nl * eps + sr * ts,
                       zero3(), a.images, a.img_h, a.img_w, a.noise, a.noise_n);
        lc_raw = lc_raw + (V3{tx.x, tx.y, tx.z} - lc_raw) * tx.w;
      }
    }
    V3 lc = vmax(lc_raw, 0.001f);
    V3 le = s.e(hidx);
    float sc = weight * cos_term;
    if constexpr (kMedium) sc = sc * fog;
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

    // contrib = max(c, 0.001) * e * (weight * cos_term) (* fog)
    V3 g_sr = zero3();
    float g_ts_fog = 0.0f;  // kMedium: the cotangent of ts through the fog
    if constexpr (kMedium) {
      if (medium_args(a).use_volumetrics)
        g_ts_fog = dot(g_c, lc * le) * (weight * cos_term) * fog * -medium_args(a).sigma_t;
    }
    if (!textured) {
      G.add3(hidx, C_CR, pass_ge(lc_raw, 0.001f, g_c * le * sc));
      if constexpr (kMedium) {
        if (g_ts_fog != 0.0f) {
          const V3 so = x + nl * eps;
          V3 g_so = zero3();
          if (sdf_shadow)
            sdf_t_bwd<true, kAll>(s, sd, so, sr, ts, eps, 2.0f * eps, g_ts_fog, g_so, g_sr, G, lut,
                                  lut_n);
          else
            isect_bwd(s, hidx, so, sr, eps, g_ts_fog, g_so, g_sr, G);
          g_x = g_x + g_so;
          g_nl = g_nl + g_so * eps;
        }
      }
    } else {
      // c' = c + (texel - c) alpha, the texel at hp = so + sr ts(so, sr, scene)
      const V3 g_lr = pass_ge(lc_raw, 0.001f, g_c * le * sc);
      const V3 c0 = s.c(hidx), trgb = {tx.x, tx.y, tx.z};
      G.add3(hidx, C_CR, g_lr * (1.0f - tx.w));
      const V3 so = x + nl * eps;
      const V3 g_hp = texel_bwd(hidx, tex[hidx], s.mesh[hidx], s.col(hidx, C_TP), so + sr * ts,
                                zero3(), a.images, a.img_h, a.img_w, a.noise, a.noise_n,
                                V4{g_lr.x * tx.w, g_lr.y * tx.w, g_lr.z * tx.w,
                                   dot(g_lr, trgb - c0)}, G);
      V3 g_so = g_hp;
      g_sr = g_hp * ts;
      float g_ts = dot(g_hp, sr);
      if constexpr (kMedium) g_ts += g_ts_fog;
      if (sdf_shadow)
        sdf_t_bwd<true, kAll>(s, sd, so, sr, ts, eps, 2.0f * eps, g_ts, g_so, g_sr, G, lut, lut_n);
      else
        isect_bwd(s, hidx, so, sr, eps, g_ts, g_so, g_sr, G);
      g_x = g_x + g_so;
      g_nl = g_nl + g_so * eps;
    }
    G.add3(hidx, C_ER, g_c * lc * sc);
    float g_sc = dot(g_c, lc * le);
    if constexpr (kMedium) g_sc = g_sc * fog;  // the cotangent of weight * cos_term
    float g_cos = g_sc * weight;
    if (cos_raw >= 0.001f) {
      g_sr = (kMedium || textured) ? g_sr + nl * g_cos : nl * g_cos;
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
      const SdfScene no_sdf = {};
      V3 total = shade_nee_bwd<false, false>(a, s, no_sdf, pk, nullptr, x, nl, h_depth, a.eps, a.inf,
                                      a.use_mis, ct * mask_after, g_x, g_nl, G);
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

// Stashed floats per slot of the wide copy: o, d, mask, prev_nl, specular.
constexpr int STW = 13;

// Adjoint of slot `depth` of K1's loop in the wide copy (path.cuh::
// path_step over K1's whole non-ReSTIR class).  In: the stashed carry
// entering the slot `sk`, the hit (t, idx) of its ray and, in g_*, the
// cotangents of the carry leaving it.  Out: g_* hold the cotangents of the
// carry entering it; the scene's are added into G.  kAll (the whole-SDF
// copy): every SDF shape, the texel of an SDF hit at the UV of its row's
// box normal (path_step's), SDF-light NEE.  kMedium (the medium copy, with
// kAll): the slot's medium event, decided again from its free-path draw
// and the stashed t, whose adjoint is that of sp = o + d s, mask' = mask
// sigma_s / sigma_t, the in-scatter NEE at sp (medium_nee_bwd) and the HG
// direction about d (prev_nl passes through, as the forward leaves it
// stale); else the surface bounce with Cauchy's IOR under use_spectral and
// the fog on sphere-light NEE.
template <bool kAll, bool kMedium = false, class Acc>
__device__ void wide_slot_bwd(const SceneSmem &s, const PathSmem &ps, const PackedScene &pk,
                              const TraceArgs &a, int depth, uint32_t h_pix, const float *sk,
                              float t, int idx, V3 ct, V3 &g_o, V3 &g_d, V3 &g_mask, V3 &g_pnl,
                              const Acc &G) {
  const V3 o = {sk[0], sk[1], sk[2]}, d = {sk[3], sk[4], sk[5]};
  const V3 mask = {sk[6], sk[7], sk[8]}, prev_nl = {sk[9], sk[10], sk[11]};
  const bool specular = sk[12] != 0.0f;
  const V3 go_out = g_o, gd_out = g_d, gm_out = g_mask, gp_out = g_pnl;
  g_o = g_d = g_mask = g_pnl = zero3();

  // ---- medium event: sp = o + d s, mask' = mask w, acc += mask' nee(sp),
  //      d' = hg(d), prev_nl' = prev_nl ----
  if constexpr (kMedium) {
    const MediumArgs &m = medium_args(a);
    if (m.use_volumetrics) {
      const uint32_t h_vol = fold_step(h_pix, (uint32_t)depth, 3u);
      const float scatter_d =
          -logf(fmaxf(u01(fold_step(h_vol, S_VOL_FREEPATH, 4u)), 1e-6f)) / m.sigma_t;
      if (scatter_d < fminf(a.inf, t)) {
        const V3 sp = o + d * scatter_d;
        V3 g_sp = go_out, g_ms = gm_out;
        if (a.sample_lights && s.n_lights > 0) {
          const V3 total = medium_nee_bwd<true, kAll>(s, ps.sd, pk, sp, d, h_vol, m,
                                                      ct * (mask * m.vol_w), g_sp, g_d, G);
          g_ms = g_ms + ct * total;
        }
        const uint32_t h_hg = fold_step(h_vol, S_VOL_PHASE, 4u);
        g_d = g_d + sample_hg_bwd(d, m.hg_g, u01(h_hg), u01(pcg(h_hg)), gd_out);
        g_mask = g_ms * m.vol_w;
        g_pnl = gp_out;
        g_o = g_sp;
        g_d = g_d + g_sp * scatter_d;
        return;
      }
    }
  }

  // ---- miss: acc += mask * environment(d) ----
  if (!(t < a.inf)) {
    if (specular || !a.sample_lights) {
      if (a.use_cubemap) {
        g_mask = ct * sample_cubemap(a.cubemap, a.cube_h, a.cube_w, d);
        g_d = cubemap_bwd(a.cubemap, a.cube_h, a.cube_w, d, ct * mask);
      } else if (a.use_sky) {
        g_mask = ct * procedural_sky(d);
        g_d.y = sky_bwd(d, ct * mask);
      }
    }
    return;
  }
  const int mat = s.mat[idx];
  if (mat == MAT_DIR_LIGHT) return;  // the path ends without a contribution

  const float *lut = kAll ? a.noise : nullptr;  // a SNOWBALL's value noise
  const int lut_n = kAll ? a.noise_n : 0;
  const bool sdf_hit = idx >= ps.sd.first;  // the SDF rows follow the analytic ones
  const V3 x = o + d * t;
  const V3 n = sdf_hit ? sdf_normal<kAll>(s, ps.sd, x, a.eps, lut, lut_n) : normal_at(s, idx, x);
  // the normal whose dominant axis picks a texel's planar UV: an SDF hit's
  // row's box normal in the whole-SDF copy, as in path_step (piecewise
  // constant in x, so it carries no gradient)
  const V3 n_tex = kAll && sdf_hit ? normal_at(s, idx, x) : n;
  V3 c, e;
  blended_color_emission(a, s, ps, idx, x, n_tex, c, e);
  c = vmax(c, 0.001f);
  e = vmax(e, 0.001f);
  V3 g_x = zero3(), g_c = zero3(), g_e = zero3();

  if (mat == MAT_LIGHT) {
    // ---- emissive hit: acc += mask * c * e * mis_w ----
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
    g_c = ct * mask * e * mis_w;
    g_e = ct * mask * c * mis_w;
    if (mis) {
      float g_b, g_l;
      power_heuristic_bwd(b_pdf, l_pdf, dot(ct, mask * c * e), g_b, g_l);
      if (b_cos >= 0.0f) {
        const float gc = g_b * ONE_OVER_PI;
        g_pnl = light_dir * gc;
        const V3 g_xo = normalize_bwd(x - o, prev_nl * gc);
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
    g_x = g_x + blend_bwd(a, s, ps, idx, x, n_tex, g_c, g_e, G);
  } else {
    // ---- a BSDF bounce: o', d' = bsdf_sample(...), mask' = mask mult,
    //      prev_nl' = nl; at a diffuse vertex the gather ray and NEE ----
    const float inside = dot(d, n) > 0.0f ? -1.0f : 1.0f;
    const uint32_t h_depth = fold_step(h_pix, (uint32_t)depth, 3u);
    const uint32_t h_dir = fold_step(h_depth, S_BSDF_DIR, 4u);
    const float u1 = u01(h_dir), u2 = u01(pcg(h_dir));
    const V3 nl = n * inside;
    bool spectral = false;
    float hero_wl = 0.0f;  // the WAVELENGTH draw (no depth), as path_step draws it
    if constexpr (kMedium) {
      spectral = medium_args(a).use_spectral != 0;
      hero_wl = u01(fold_step(h_pix, S_WAVELENGTH, 3u)) * 340.0f + 380.0f;
    }
    const Bounce b = bsdf_sample<kMedium>(s, idx, x, nl, d, c, e, inside, u1, u2,
                                          u01(fold_step(h_depth, S_BSDF_CHOICE, 4u)), a.eps,
                                          a.use_biased, spectral, hero_wl);
    const V3 mask_after = mask * b.mult;
    const bool transmit = b.scat != 0;

    g_x = go_out;
    V3 g_nl = gp_out + go_out * (transmit ? -a.eps : a.eps);
    V3 g_ma = gm_out;
    bounce_dir_bwd<kMedium>(s, idx, b, d, nl, e, inside, u1, u2, a.use_biased, gd_out, g_d, g_nl,
                            G, spectral, hero_wl);
    if (!b.specular) {
      if (a.use_cubemap) {
        // the gather ray: acc += mask' * cubemap(env_dir) where it escapes
        const uint32_t h_env = fold_step(h_depth, S_ENV_DIR, 4u);
        const float eu1 = u01(h_env), eu2 = u01(pcg(h_env));
        const V3 env_dir = random_direction(nl, eu1, eu2, a.use_biased);
        float te;
        int ie;
        intersect_packed<true, kAll>(s, ps.sd, pk, x + nl * a.eps, env_dir, a.eps, a.inf, te, ie,
                                     lut, lut_n);
        if (!(te < a.inf)) {
          g_ma = g_ma + ct * sample_cubemap(a.cubemap, a.cube_h, a.cube_w, env_dir);
          g_nl = g_nl + random_direction_bwd(nl, eu1, eu2, a.use_biased,
                                             cubemap_bwd(a.cubemap, a.cube_h, a.cube_w, env_dir,
                                                         ct * mask_after));
        }
      }
      if (a.sample_lights) {
        const V3 total = shade_nee_bwd<true, kAll, kMedium>(a, s, ps.sd, pk, ps.tex, x, nl, h_depth,
                                                            a.eps, a.inf, a.use_mis,
                                                            ct * mask_after, g_x, g_nl, G);
        g_ma = g_ma + ct * total;
      }
    }
    g_mask = g_ma * b.mult;
    const bool attenuates = mat == MAT_DIFF || mat == MAT_SPEC || transmit ||
                            (mat == MAT_COAT && !b.specular);
    if (attenuates) g_c = g_ma * mask;
    g_x = g_x + blend_bwd(a, s, ps, idx, x, n_tex, g_c, g_e, G);
    const V3 g_n = g_nl * inside;
    if (sdf_hit)
      g_x = g_x + sdf_normal_bwd<true, kAll>(s, ps.sd, x, a.eps, g_n, G, lut, lut_n);
    else
      normal_bwd(s, idx, x, g_n, g_x, G);
  }

  // ---- x = o + d t(o, d, scene) ----
  g_o = g_o + g_x;
  g_d = g_d + g_x * t;
  const float g_t = dot(g_x, d);
  if (sdf_hit)
    sdf_t_bwd<true, kAll>(s, ps.sd, o, d, t, a.eps, 2.0f * a.eps, g_t, g_o, g_d, G, lut, lut_n);
  else
    isect_bwd(s, idx, o, d, a.eps, g_t, g_o, g_d, G);
}

// Where K2's cotangent columns start in dynamic shared memory (bytes).  The
// Cornell copy: after the scene (load_scene) and its packed records
// (load_packed, no SDF rows).  The wide copy: after the scene with its
// texture codes, blend flags and SDF shapes (load_path), its packed records
// with the SDF gates, and the column map (NCOLS ints).
__host__ __device__ inline size_t bwd_columns_offset(int n_mesh, int n_lights, int n_sdf,
                                                     bool wide) {
  if (!wide) return packed_smem_bytes(scene_smem_bytes(n_mesh, n_lights), n_mesh, 0);
  return packed_smem_bytes(path_smem_bytes(n_mesh, n_lights, n_sdf), n_mesh, n_sdf) +
         sizeof(int) * NCOLS;
}

// Dynamic shared memory of one K2 block: bwd_columns_offset, then
// `columns` columns of `ng` cotangent accumulators per mesh.
__host__ __device__ inline size_t bwd_smem_bytes(int n_mesh, int n_lights, int n_sdf, bool wide,
                                                 int ng, int columns) {
  return bwd_columns_offset(n_mesh, n_lights, n_sdf, wide) +
         sizeof(float) * n_mesh * ng * columns;
}

// kWarpCols: a column per warp (WarpAcc), else per thread (ThreadAcc).
template <bool kWarpCols>
__global__ void __launch_bounds__(BWD_THREADS, kWarpCols ? MIN_BLOCKS_WARP_COLS
                                                         : MIN_BLOCKS_THREAD_COLS)
    bwd_kernel(BwdArgs b) {
  const TraceArgs &a = b.t;
  extern __shared__ __align__(16) float smem[];
  const SceneSmem s = load_scene(a, smem);
  float *gsm = smem + bwd_columns_offset(a.n_mesh, a.n_lights, 0, false) / sizeof(float);
  const int n_g = a.n_mesh * NG;
  const int n_cols = kWarpCols ? (blockDim.x + warpSize - 1) / warpSize : blockDim.x;
  for (int e = threadIdx.x; e < n_cols * n_g; e += blockDim.x) gsm[e] = 0.0f;
  using Acc = typename std::conditional<kWarpCols, WarpAcc<CornellCols>,
                                        ThreadAcc<CornellCols>>::type;
  Acc G;
  if constexpr (kWarpCols)
    G = {gsm + (threadIdx.x / warpSize) * n_g, {}};
  else
    G = {gsm + threadIdx.x, (int)blockDim.x, {}};
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

// The wide copy: K1's whole non-ReSTIR class (every material, directional
// lights, uniform sampling, the cubemap, textures, BOX and ROUND_BOX SDF
// rows), with the scene's column set; kAll, the whole-SDF copy, adds every
// SDF shape, textured SDF rows and SDF lights, as K1's whole-SDF copy does;
// kMedium (with kAll), the medium copy, adds hero-wavelength spectral
// transport and the homogeneous medium under their run-time flags, as K1's
// medium copy does: the forward sweep runs the medium event before the miss
// test (a ray that misses can scatter) and stashes nothing more, since the
// reverse sweep decides the event again from the RNG and the stashed t.
template <bool kWarpCols, bool kAll, bool kMedium = false>
__global__ void __launch_bounds__(BWD_THREADS, kWarpCols ? MIN_BLOCKS_WARP_COLS
                                                         : MIN_BLOCKS_THREAD_COLS)
    bwd_wide_kernel(typename std::conditional<kMedium, BwdMediumArgs, BwdArgs>::type b) {
  const TraceArgs &a = b.t;
  extern __shared__ __align__(16) float smem[];
  SceneSmem s;
  const PathSmem ps = load_path(a, smem, s);
  const size_t path_bytes = path_smem_bytes(a.n_mesh, a.n_lights, a.n_sdf);
  int *map = reinterpret_cast<int *>(smem) +
             packed_smem_bytes(path_bytes, a.n_mesh, a.n_sdf) / sizeof(int);
  float *gsm = smem + bwd_columns_offset(a.n_mesh, a.n_lights, a.n_sdf, true) / sizeof(float);
  for (int c = threadIdx.x; c < NCOLS; c += blockDim.x)
    map[c] = ((b.cols >> c) & 1ull) ? cols_below(b.cols, c) : -1;
  const int n_g = a.n_mesh * b.ng;
  const int n_cols = kWarpCols ? (blockDim.x + warpSize - 1) / warpSize : blockDim.x;
  for (int e = threadIdx.x; e < n_cols * n_g; e += blockDim.x) gsm[e] = 0.0f;
  using Acc = typename std::conditional<kWarpCols, WarpAcc<SceneCols>,
                                        ThreadAcc<SceneCols>>::type;
  const SceneCols cols = {map, b.ng};
  Acc G;
  if constexpr (kWarpCols)
    G = {gsm + (threadIdx.x / warpSize) * n_g, cols};
  else
    G = {gsm + threadIdx.x, (int)blockDim.x, cols};
  const PackedScene pk = load_packed<kAll>(s, ps.sd, smem, path_bytes);  // synchronises the block
  const float *lut = kAll ? a.noise : nullptr;  // a SNOWBALL's value noise
  const int lut_n = kAll ? a.noise_n : 0;

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < a.n_pix) {  // ragged edge: idle threads still join the block sum
    V3 o = {a.ro[3 * p], a.ro[3 * p + 1], a.ro[3 * p + 2]};
    V3 d = {a.rd[3 * p], a.rd[3 * p + 1], a.rd[3 * p + 2]};
    const uint32_t h_pix = pixel_hash(a, p);

    // ---- forward sweep: K1's carry updates (path_step without the
    //      accumulator), stashing each slot's input and hit ----
    float st[MAX_SLOTS * STW];
    float st_t[MAX_SLOTS];
    int st_idx[MAX_SLOTS];
    V3 mask = {1.0f, 1.0f, 1.0f};
    V3 prev_nl = {0.0f, 1.0f, 0.0f};
    bool specular = true;
    int ndif = 0, nspec = 0, nscat = 0, n_run = 0;
    // kMedium: the hero wavelength (the WAVELENGTH draw, no depth)
    const float hero_wl = kMedium ? u01(fold_step(h_pix, S_WAVELENGTH, 3u)) * 340.0f + 380.0f : 0.0f;
    for (int depth = 0; depth < a.max_bounces && depth < MAX_SLOTS; ++depth) {
      float *sk = st + depth * STW;
      sk[0] = o.x, sk[1] = o.y, sk[2] = o.z, sk[3] = d.x, sk[4] = d.y, sk[5] = d.z;
      sk[6] = mask.x, sk[7] = mask.y, sk[8] = mask.z;
      sk[9] = prev_nl.x, sk[10] = prev_nl.y, sk[11] = prev_nl.z;
      sk[12] = specular ? 1.0f : 0.0f;
      n_run = depth + 1;

      float tmin;
      int idx;
      const bool sdf_hit = intersect_packed<true, kAll>(s, ps.sd, pk, o, d, a.eps, a.inf, tmin, idx,
                                                        lut, lut_n);
      st_t[depth] = tmin;
      st_idx[depth] = idx;
      if constexpr (kMedium) {
        // the medium event (path_step's): a free path shorter than the hit
        // scatters along an HG direction; prev_nl stays
        const MediumArgs &m = medium_args(a);
        if (m.use_volumetrics) {
          const uint32_t h_vol = fold_step(h_pix, (uint32_t)depth, 3u);
          const float scatter_d =
              -logf(fmaxf(u01(fold_step(h_vol, S_VOL_FREEPATH, 4u)), 1e-6f)) / m.sigma_t;
          if (scatter_d < fminf(a.inf, tmin)) {
            mask = mask * m.vol_w;
            nscat += 1;
            specular = false;
            if (nscat >= a.max_scatter || fmaxf(fmaxf(mask.x, mask.y), mask.z) < 0.01f) break;
            const uint32_t h_hg = fold_step(h_vol, S_VOL_PHASE, 4u);
            const V3 hg_dir = sample_hg(d, m.hg_g, u01(h_hg), u01(pcg(h_hg)));
            o = o + d * scatter_d;
            d = hg_dir;
            continue;
          }
        }
      }
      // a miss, an emissive or a DIR_LIGHT hit ends the path
      if (!(tmin < a.inf) || s.mat[idx] == MAT_LIGHT || s.mat[idx] == MAT_DIR_LIGHT) break;
      const V3 x = o + d * tmin;
      const V3 n = sdf_hit ? sdf_normal<kAll>(s, ps.sd, x, a.eps, lut, lut_n) : normal_at(s, idx, x);
      V3 c, e;
      blended_color_emission(a, s, ps, idx, x, kAll && sdf_hit ? normal_at(s, idx, x) : n, c, e);
      c = vmax(c, 0.001f);
      e = vmax(e, 0.001f);
      const float inside = dot(d, n) > 0.0f ? -1.0f : 1.0f;
      const uint32_t h_depth = fold_step(h_pix, (uint32_t)depth, 3u);
      const uint32_t h_dir = fold_step(h_depth, S_BSDF_DIR, 4u);
      const V3 nl = n * inside;
      const Bounce bb = bsdf_sample<kMedium>(
          s, idx, x, nl, d, c, e, inside, u01(h_dir), u01(pcg(h_dir)),
          u01(fold_step(h_depth, S_BSDF_CHOICE, 4u)), a.eps, a.use_biased,
          kMedium && medium_args(a).use_spectral != 0, hero_wl);
      o = bb.o;
      d = bb.d;
      mask = mask * bb.mult;
      specular = bb.specular;
      prev_nl = nl;
      ndif += bb.dif;
      nspec += bb.spec;
      nscat += bb.scat;
      if (fmaxf(fmaxf(mask.x, mask.y), mask.z) < 0.01f || ndif >= a.max_diff ||
          nspec >= a.max_spec || nscat >= a.max_scatter)
        break;
    }

    // ---- reverse sweep: newest slot first ----
    const V3 ct = {b.ct[3 * p], b.ct[3 * p + 1], b.ct[3 * p + 2]};
    V3 g_o = zero3(), g_d = zero3(), g_mask = zero3(), g_pnl = zero3();
    for (int k = n_run - 1; k >= 0; --k)
      wide_slot_bwd<kAll, kMedium>(s, ps, pk, a, k, h_pix, st + k * STW, st_t[k], st_idx[k], ct,
                                   g_o, g_d, g_mask, g_pnl, G);
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
// block per table entry, a strided sum per thread, then a fixed tree.  A
// column outside `cols` (the ng columns kept) is 0.
__global__ void __launch_bounds__(RED_THREADS)
    reduce_kernel(const float *partials, int n_blocks, int n_mesh, unsigned long long cols,
                  int ng, float *d_table) {
  __shared__ float red[RED_THREADS];
  const int entry = blockIdx.x;
  const int mesh = entry / NCOLS, col = entry % NCOLS;
  float sum = 0.0f;
  if ((cols >> col) & 1ull) {
    const int g = cols_below(cols, col);
    for (int blk = threadIdx.x; blk < n_blocks; blk += RED_THREADS)
      sum += partials[(size_t)blk * n_mesh * ng + mesh * ng + g];
  }
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) d_table[entry] = red[0];
}

// The column count of a column mask.
inline int count_cols(unsigned long long cols) { return cols_below(cols, 64); }

// K2's layout of a block of `threads` threads on the current device, for
// a scene of n_mesh meshes (n_sdf of them SDF rows) and n_lights light
// slots, the copy `wide` and its `ng` columns a mesh: a column of
// cotangent accumulators per thread while THREAD_COLS_FEWEST_BLOCKS blocks
// of them (each with the shared memory the runtime reserves per block) fit
// one SM's shared memory; a column per warp beyond (warp_cols).  `smem`
// is the block's dynamic shared memory.  Returns the first CUDA error of
// the device queries, or 0.
inline int bwd_layout(int n_mesh, int n_lights, int n_sdf, bool wide, int ng, int threads,
                      bool &warp_cols, size_t &smem) {
  int dev = 0, lanes = 32, per_sm = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&lanes, cudaDevAttrWarpSize, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return (int)e;
  smem = bwd_smem_bytes(n_mesh, n_lights, n_sdf, wide, ng, threads);
  warp_cols = (size_t)THREAD_COLS_FEWEST_BLOCKS * (smem + (size_t)reserved) > (size_t)per_sm;
  if (warp_cols) smem = bwd_smem_bytes(n_mesh, n_lights, n_sdf, wide, ng, (threads + lanes - 1) / lanes);
  return 0;
}

#if RT0_K2_MEDIUM
// The medium copy, a column per warp (`warp_cols`) or per thread.
inline void (*bwd_medium_copy(bool warp_cols))(BwdMediumArgs) {
  return warp_cols ? bwd_wide_kernel<true, true, true> : bwd_wide_kernel<false, true, true>;
}
#else
// The copy of K2 for `wide`, a column per warp (`warp_cols`) and the whole
// SDF class (`all`, which implies `wide`), or nullptr where this library
// does not hold it (RT0_K2_WHOLE_SDF).
inline void (*bwd_copy(bool wide, bool warp_cols, bool all))(BwdArgs) {
  if (all != (RT0_K2_WHOLE_SDF != 0)) return nullptr;
#if RT0_K2_WHOLE_SDF
  (void)wide;
  return warp_cols ? bwd_wide_kernel<true, true> : bwd_wide_kernel<false, true>;
#else
  if (wide) return warp_cols ? bwd_wide_kernel<true, false> : bwd_wide_kernel<false, false>;
  return warp_cols ? bwd_kernel<true> : bwd_kernel<false>;
#endif
}
#endif

// Launch the copy `kern` with `b` on `st` (`blocks` blocks of `threads`
// threads, `smem` bytes of dynamic shared memory), then the reduction of
// its per-block partials into d_table.  Returns the first CUDA error of the
// two launches, or 0.
template <class Args>
inline int launch_backward(void (*kern)(Args), const Args &b, unsigned blocks, int threads,
                           size_t smem, float *d_table, cudaStream_t st) {
  if (blocks > 0) {
    if (kern == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<blocks, threads, smem, st>>>(b);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int n = b.t.n_mesh, n_entries = n * NCOLS;
  reduce_kernel<<<n_entries, RED_THREADS, 0, st>>>(b.partials, (int)blocks, n, b.cols, b.ng, d_table);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K2 on `stream`: the adjoint kernel, then the reduction of its
// per-block partials [ceil(n_pix / threads), n_mesh, ng] into d_table.
// The arguments up to `t0` are K1's (rt0_trace_forward; `out` unused).
// `cols` is the mask of scene-table columns with a cotangent: the Cornell
// copy's 10 (CORNELL_COLS) with `wide` 0, the scene's set with `wide` 1
// (megakernel.bwd_columns); every other column of d_table is 0.  The
// medium copy's library (RT0_K2_MEDIUM) takes K1's medium arguments after
// `threads` (rt0_trace_forward's, megakernel.medium_args) and runs the
// medium copy on any scene of K1's class (`wide` 1).  Returns the first
// CUDA error of the two launches, or 0.
extern "C" int rt0_trace_backward(
    const float *table, const int32_t *mesh, const int32_t *mat, int n_mesh,
    const int32_t *lights, int n_lights, const float *ro, const float *rd, const int64_t *pix,
    float *out, long long n_pix, unsigned pass_idx, unsigned sample_idx, int max_bounces,
    int max_diff, int max_spec, int max_scatter, float eps, float inf, int sample_lights,
    int use_mis, int use_sky, const float *cubemap, int cube_h, int cube_w, int use_cubemap,
    int use_biased, const int32_t *tex, const int32_t *blend, const float *images, int img_h,
    int img_w, const float *noise, int noise_n, int use_tex, const int32_t *sdf, int n_analytic,
    int n_sdf, int steps, float fudge, float t0, const float *ct, float *d_ro, float *d_rd,
    float *partials, float *d_table, unsigned long long cols, int wide, int threads,
#if RT0_K2_MEDIUM
    int use_spectral, int use_volumetrics, float sigma_t, float vol_w, float vol_eps, float hg_g,
    float hg_1pg2, float hg_2g, float hg_1mg2,
#endif
    void *stream) {
  const int ng = count_cols(cols);
  if (threads <= 0 || threads > BWD_THREADS || n_mesh <= 0 || (cols >> NCOLS) != 0ull ||
      (!wide && cols != CORNELL_COLS) || (RT0_K2_MEDIUM && !wide))
    return (int)cudaErrorInvalidValue;
  (void)out;
  TraceArgs t = {table,   mesh,   mat,         lights,     n_mesh,      n_lights,
                 ro,      rd,     pix,         nullptr,    n_pix,       pass_idx,
                 sample_idx, max_bounces, max_diff, max_spec, max_scatter, eps,
                 inf,     sample_lights, use_mis, use_sky, cubemap, cube_h, cube_w,
                 use_cubemap, use_biased, tex, blend, images, img_h, img_w, noise, noise_n,
                 use_tex, sdf, n_analytic, n_sdf, steps, fudge, t0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = n_pix > 0 ? (unsigned)((n_pix + threads - 1) / threads) : 0u;
  bool warp_cols = false;
  size_t smem = 0;
  if (blocks > 0) {
    const int rc = bwd_layout(n_mesh, n_lights, n_sdf, wide != 0, ng, threads, warp_cols, smem);
    if (rc != 0) return rc;
  }
#if RT0_K2_MEDIUM
  BwdMediumArgs b = {};
  static_cast<TraceArgs &>(b.t) = t;
  b.t.use_spectral = use_spectral;
  b.t.use_volumetrics = use_volumetrics;
  b.t.sigma_t = sigma_t;
  b.t.vol_w = vol_w;
  b.t.vol_eps = vol_eps;
  b.t.hg_g = hg_g;
  b.t.hg_1pg2 = hg_1pg2;
  b.t.hg_2g = hg_2g;
  b.t.hg_1mg2 = hg_1mg2;
  b.ct = ct;
  b.d_ro = d_ro;
  b.d_rd = d_rd;
  b.partials = partials;
  b.cols = cols;
  b.ng = ng;
  return launch_backward(bwd_medium_copy(warp_cols), b, blocks, threads, smem, d_table, st);
#else
  const BwdArgs b = {t, ct, d_ro, d_rd, partials, cols, ng};
  return launch_backward(bwd_copy(wide != 0, warp_cols, wide != 0 && (use_tex & 4) != 0), b,
                         blocks, threads, smem, d_table, st);
#endif
}

// K2's layout for a block of `threads` threads on the current device
// (bwd_layout, for the column mask `cols` of copy `wide`): out[0] is 1
// with a column of accumulators per warp, 0 per thread, out[1] the block's
// dynamic shared memory in bytes.
extern "C" int rt0_trace_backward_layout(int n_mesh, int n_lights, int n_sdf,
                                         unsigned long long cols, int wide, int threads,
                                         long long *out) {
  bool warp_cols = false;
  size_t smem = 0;
  const int rc = bwd_layout(n_mesh, n_lights, n_sdf, wide != 0, count_cols(cols), threads,
                            warp_cols, smem);
  out[0] = warp_cols ? 1 : 0;
  out[1] = (long long)smem;
  return rc;
}

// K2's occupancy at `threads` threads and `smem` bytes of dynamic shared
// memory (trace_common.cuh::kernel_occupancy) of the copy `flags` names:
// bit 0 a column per warp, bit 1 the wide copy, bit 2 the whole-SDF copy,
// bit 3 the medium copy (its library's alone).
extern "C" int rt0_trace_backward_occupancy(int flags, int threads, long long smem, int *out) {
#if RT0_K2_MEDIUM
  if (!(flags & 8)) return (int)cudaErrorInvalidValue;
  return kernel_occupancy(bwd_medium_copy((flags & 1) != 0), threads, (size_t)smem, out);
#else
  void (*kern)(BwdArgs) = bwd_copy((flags & 6) != 0, (flags & 1) != 0, (flags & 4) != 0);
  if (kern == nullptr || (flags & 8)) return (int)cudaErrorInvalidValue;
  return kernel_occupancy(kern, threads, (size_t)smem, out);
#endif
}
