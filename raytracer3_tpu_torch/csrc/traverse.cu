// Closest-hit (K1), any-hit (K2), treelet segment-grid (K3) and two-level
// TLAS->BLAS (K4) traversal of wide cluster BVHs, each also in a counting
// form (K5).
//
// Replaces: raytracer3_tpu/ops/pallas/traverse_kernel.py, function `_kernel`
//   - as launched by `packet_intersect` (any_hit=False and any_hit=True,
//     single-level tables): K1 and K2, `traverse_kernel<false|true>`;
//   - as launched by `packet_intersect_segments` (seg=True, with its
//     mixed_hit and seg_cull options), driven by ops/treelets.py: K3,
//     `segment_kernel<false|true>`;
//   - as launched by `packet_intersect` with an `inst_table` (two_level=True,
//     both hit kinds), via ops/tlas.two_level_backend: K4,
//     `tlas_kernel<false|true>`;
//   - with stats=True in both launchers (the counters of `_kernel`): K5,
//     `traverse_stats_kernel`, `segment_stats_kernel` and
//     `tlas_stats_kernel<false|true>`. The reference counts per packet (its
//     packet shares one stack); here each thread counts its own ray: node
//     pops, leaf pops, slab tests, Moller-Trumbore tests, and K3's steps
//     traversed or K4's instance hops, written as int32 [N, 5]. The counting
//     sits in the one traversal loop under `if constexpr (Stats)`, and the
//     stats kernels are kernels of their own, so the production kernels
//     compile to the same SASS as before (raytracer3_tpu_torch/tools/
//     kernel_ab.py).
// Same tables, same row layout (pack_tables_host, build_treelets_host,
// build_two_level):
//   node row    : cmin 3w | cmax 3w | codes w | pad   (code >= 0 internal
//                 node, -1 empty, <= -2 cluster -code-2; in a TLAS the
//                 leaf code -(num_clusters + instance)-2)
//   cluster row : L x (v0 e1 e2) | L triangle ids | cluster AABB | pad
//   inst row    : world->object 3x4 (row-major [R|t]) | BLAS root | pad
// Same per-ray results: the nearest (t, u, v, prim) in (t_min, t_cap), or
// for any-hit the first accepted triangle. A ray with t_cap = 0 is parked.
//
// What bounds it on an H100: not the card's peaks. K5's counts put every
// kernel on the operation side of its least time (float32 operations of
// the visits over 67 TFLOP/s; the bytes side, rays and tables once over
// 3.35 TB/s, is 2-10x smaller), and the kernels run 14-35x above that
// (PERF.md): per ray a sorted bounce pops ~6-15 nodes and ~2-6 leaves and
// does ~75-190 slab and ~23-45 triangle tests, at SIMT efficiency ~0.6
// (0.8-0.9 on tiled primaries). What holds them there is latency: every pop reads one
// node row or cluster row whose address came from the previous pop, and
// the 32 rays of a warp walk different paths. The 19k-triangle atrium's
// tables (~1.3 MB) and the 300k-triangle atrium's treelet tables (~27 MB)
// stay resident in the 50 MB L2.
//
// What this design does about it: one thread per ray, 128-thread blocks, a
// per-thread stack of codes in local memory, rows read in place through the
// read-only path. The wavefront coherence-sorts rays before each launch
// (render/wavefront.sorted_trace, or the treelet driver's own sort) and
// tiles primaries, so neighbouring threads mostly walk the same nodes and
// their row loads coalesce in L1.
//
// K3 keeps the reference's segment grid as the rays' order and metadata,
// not as its schedule: a segment (sublanes x 128 rays) spans whole blocks,
// and each thread walks its segment's candidate steps in order. It skips a
// step when its group's bit in seg_gmask is clear (sentinel slots carry 0),
// when it is an any-hit lane already resolved, or (step_cull) when its own
// best t is at or below the step's entry distance — the per-ray form of the
// reference's per-segment max test, with the same results. Otherwise it
// runs the shared traversal loop over treelet seg_list[s, e]'s rows,
// carrying best t. Flagged lanes (anyhit_row > 0.5) and any-hit lanes retire
// on their first accepted hit with t = 0. Shared-memory treelets and
// persistent threads are later work.
//
// K4 walks the TLAS with the same loop (instantiated with TwoLevel); at an
// instance leaf the thread maps its ray into the instance's object space and
// runs the single-level loop over the instance's BLAS on the stack above its
// TLAS entries, recording the instance with every hit it accepts. The
// reference restores world-space rays when a TLAS entry pops after a pushed
// BLAS subtree; one thread per ray keeps the world ray in registers instead.
// On top of K1's cost an instance hop reads one 128-byte instance row and
// does 18 multiplies, 15 adds and the clamped inverse; the instanced
// atrium's two-level tables (20.6 MB) stay in L2 like the single-level ones.
// The node test stays written out inside the loop: moved into a helper
// function it made K1 and K4 measurably slower on the H100 at the same
// register count and stack frame (PERF.md).
//
// The arithmetic repeats the reference's operation order; build with
// --fmad=false so no multiply-add is contracted and the kernels agree with
// their plain PyTorch versions (ops/traverse_kernel.py).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlock = 128;
constexpr int kStackCap = 128;  // the wrappers check the tree needs no more
constexpr int kMaxWidth = 16;

// jnp.minimum / jnp.maximum semantics: a NaN operand propagates (fminf and
// fmaxf would drop it), so a NaN ray misses every box in both versions.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
// 1 / where(|a| < 1e-12, 1e-12, a): the clamp drops the sign, as the
// reference does.
__device__ __forceinline__ float clamped_inv(float a) {
  return 1.0f / (fabsf(a) < 1e-12f ? 1e-12f : a);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ orig,
                                        const float* __restrict__ dir,
                                        size_t i) {
  Ray r;
  r.ox = orig[3 * i];
  r.oy = orig[3 * i + 1];
  r.oz = orig[3 * i + 2];
  r.dx = dir[3 * i];
  r.dy = dir[3 * i + 1];
  r.dz = dir[3 * i + 2];
  r.ix = clamped_inv(r.dx);
  r.iy = clamped_inv(r.dy);
  r.iz = clamped_inv(r.dz);
  return r;
}

struct Best {
  float t, u, v;
  int id, inst;
};

// K5: one ray's visit counts, kept by the Stats instantiations only and
// written as int32 [N, 5] in launch order: node pops, leaf (cluster) pops,
// slab tests (real slots of popped nodes), Moller-Trumbore tests (real
// triangle slots reached, the retiring hit included), and K3's steps
// traversed or K4's instance hops.
struct Counts {
  int node, leaf, slab, tri, extra;
};

__device__ __forceinline__ void store_counts(int* __restrict__ out, size_t i,
                                             const Counts& c) {
  int* row = out + 5 * i;
  row[0] = c.node;
  row[1] = c.leaf;
  row[2] = c.slab;
  row[3] = c.tri;
  row[4] = c.extra;
}

// One traversal of one tree from node `root` on stack[0, cap), updating `b`
// with every accepted hit nearer than b.t and recording `inst` with it.
// The tree is a whole scene, one treelet or one instance's BLAS; with
// TwoLevel it is a TLAS, whose leaves are instances (code
// -(num_clusters + instance) - 2): there the ray is mapped through the
// instance's world->object 3x4 (inst row lanes 0..11, the reference's
// operation order) with the clamped inverse of the new direction, and the
// instance's BLAS (root in lane 12) is walked with the same Best on the
// stack above the TLAS entries; t is affine-invariant. With `retire`, the
// first accepted hit ends the traversal; returns whether that happened.
// With Stats, `*c` counts the visits (the counting sits inside the one loop
// under `if constexpr`, so the other instantiations compile as before).
template <bool AnyHit, bool TwoLevel, bool Stats = false>
__device__ __forceinline__ bool traverse(
    const Ray& r, const float* __restrict__ nodes, int node_row,
    const float* __restrict__ clusters, int cluster_row, int width,
    int leaf_size, float t_min, bool retire, int root, int inst, int* stack,
    int cap, Best& b, const float* __restrict__ insts = nullptr,
    int inst_row = 0, int num_clusters = 0, Counts* c = nullptr) {
  int sp = 0;
  stack[sp++] = root;
  while (sp > 0) {
    const int entry = stack[--sp];
    if (entry >= 0) {
      if constexpr (Stats) ++c->node;
      // Internal node: slab-test every real slot against this ray.
      const float* row = nodes + static_cast<size_t>(entry) * node_row;
      float keys[kMaxWidth];
      int codes[kMaxWidth];
      int cnt = 0;
      for (int s = 0; s < width; ++s) {
        const float code = __ldg(row + 6 * width + s);
        if (!(fabsf(code + 1.0f) > 0.25f)) continue;  // empty slot
        if constexpr (Stats) ++c->slab;
        const float t0x = (__ldg(row + 3 * s + 0) - r.ox) * r.ix;
        const float t0y = (__ldg(row + 3 * s + 1) - r.oy) * r.iy;
        const float t0z = (__ldg(row + 3 * s + 2) - r.oz) * r.iz;
        const float t1x = (__ldg(row + 3 * width + 3 * s + 0) - r.ox) * r.ix;
        const float t1y = (__ldg(row + 3 * width + 3 * s + 1) - r.oy) * r.iy;
        const float t1z = (__ldg(row + 3 * width + 3 * s + 2) - r.oz) * r.iz;
        const float tn = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                                 max_nan(min_nan(t0z, t1z), t_min));
        const float tf = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)),
                                 min_nan(max_nan(t0z, t1z), b.t));
        // The reference's group key is tn where tn <= tf, else inf, and a
        // child is taken iff its key < inf.
        if (!(tn <= tf) || isinf(tn)) continue;
        if (AnyHit) {
          // Any-hit needs no ordering: push in slot order.
          if (sp < cap) stack[sp++] = static_cast<int>(code);
          continue;
        }
        // Keep keys[0..cnt) sorted far-first; among equal keys the later
        // slot goes first, so pops come out near-first in slot order.
        int k = cnt++;
        while (k > 0 && keys[k - 1] <= tn) {
          keys[k] = keys[k - 1];
          codes[k] = codes[k - 1];
          --k;
        }
        keys[k] = tn;
        codes[k] = static_cast<int>(code);
      }
      for (int k = 0; k < cnt; ++k) {
        if (sp < cap) stack[sp++] = codes[k];
      }
    } else if constexpr (TwoLevel) {
      if constexpr (Stats) ++c->extra;
      const int k = -entry - 2 - num_clusters;
      const float* m = insts + static_cast<size_t>(k) * inst_row;
      const float m0 = __ldg(m + 0), m1 = __ldg(m + 1), m2 = __ldg(m + 2), m3 = __ldg(m + 3);
      const float m4 = __ldg(m + 4), m5 = __ldg(m + 5), m6 = __ldg(m + 6), m7 = __ldg(m + 7);
      const float m8 = __ldg(m + 8), m9 = __ldg(m + 9), m10 = __ldg(m + 10), m11 = __ldg(m + 11);
      Ray o;
      o.ox = m0 * r.ox + m1 * r.oy + m2 * r.oz + m3;
      o.oy = m4 * r.ox + m5 * r.oy + m6 * r.oz + m7;
      o.oz = m8 * r.ox + m9 * r.oy + m10 * r.oz + m11;
      o.dx = m0 * r.dx + m1 * r.dy + m2 * r.dz;
      o.dy = m4 * r.dx + m5 * r.dy + m6 * r.dz;
      o.dz = m8 * r.dx + m9 * r.dy + m10 * r.dz;
      o.ix = clamped_inv(o.dx);
      o.iy = clamped_inv(o.dy);
      o.iz = clamped_inv(o.dz);
      if (traverse<AnyHit, false, Stats>(o, nodes, node_row, clusters,
                                         cluster_row, width, leaf_size, t_min,
                                         retire, static_cast<int>(__ldg(m + 12)),
                                         k, stack + sp, cap - sp, b, nullptr, 0,
                                         0, c)) {
        return true;
      }
    } else {
      if constexpr (Stats) ++c->leaf;
      // Leaf: Moller-Trumbore on the packed (v0, e1, e2) of cluster -entry-2.
      const float* crow = clusters + static_cast<size_t>(-entry - 2) * cluster_row;
      for (int j = 0; j < leaf_size; ++j) {
        const float tid = __ldg(crow + 9 * leaf_size + j);
        if (!(tid >= 0.0f)) continue;  // padding slot
        if constexpr (Stats) ++c->tri;
        const float* tri = crow + 9 * j;
        const float v0x = __ldg(tri + 0), v0y = __ldg(tri + 1), v0z = __ldg(tri + 2);
        const float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4), e1z = __ldg(tri + 5);
        const float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7), e2z = __ldg(tri + 8);
        const float px = r.dy * e2z - r.dz * e2y;
        const float py = r.dz * e2x - r.dx * e2z;
        const float pz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool det_ok = fabsf(det) > 1e-9f;
        const float inv_det = det_ok ? 1.0f / det : 0.0f;
        const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
        const float uu = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool ok = det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                        tt > t_min && tt < b.t;
        if (!ok) continue;
        b.t = tt;
        b.u = uu;
        b.v = vv;
        b.id = static_cast<int>(tid);
        b.inst = inst;
        if (retire) return true;  // the first accepted hit ends the walk
      }
    }
  }
  return false;
}

template <bool AnyHit>
__global__ void __launch_bounds__(kBlock) traverse_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, int n,
    const float* __restrict__ nodes, int node_row,
    const float* __restrict__ clusters, int cluster_row,
    int width, int leaf_size, float t_min,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_prim) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(orig, dir, i);
  Best b{t_cap[i], 0.0f, 0.0f, -1, -1};
  int stack[kStackCap];
  traverse<AnyHit, false>(r, nodes, node_row, clusters, cluster_row, width,
                          leaf_size, t_min, AnyHit, 0, -1, stack, kStackCap, b);
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_prim[i] = b.id;
}

template <bool AnyHit>
__global__ void __launch_bounds__(kBlock) segment_kernel(
    const int* __restrict__ seg_list, const float* __restrict__ seg_entry,
    const int* __restrict__ seg_gmask, int n_steps, int n_words,
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, const float* __restrict__ anyhit_row,
    long long n,
    const float* __restrict__ nodes, int max_nodes, int node_row,
    const float* __restrict__ clusters, int max_clusters, int cluster_row,
    int width, int leaf_size, float t_min, int seg_rays, int group_rays,
    int step_cull, float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(n)) return;
  const size_t s = i / seg_rays;  // < S: n is a whole number of segments
  const int g = static_cast<int>((i % seg_rays) / group_rays);
  const int word = g >> 5, bit = g & 31;
  const Ray r = load_ray(orig, dir, i);
  const float cap = t_cap[i];
  const bool flagged = AnyHit || (anyhit_row != nullptr && anyhit_row[i] > 0.5f);
  Best b{cap, 0.0f, 0.0f, -1, -1};
  int stack[kStackCap];
  if (!(AnyHit && cap <= t_min)) {  // an any-hit lane capped at t_min is resolved
    for (int e = 0; e < n_steps; ++e) {
      const size_t se = s * n_steps + e;
      // Skip on the group mask, never on the id: sentinel slots repeat a
      // real treelet id with mask 0.
      if (!((__ldg(seg_gmask + se * n_words + word) >> bit) & 1)) continue;
      if (step_cull && e > 0 && !(b.t > __ldg(seg_entry + se))) continue;
      const size_t tid = static_cast<size_t>(__ldg(seg_list + se));
      const bool retired = traverse<AnyHit, false>(
          r, nodes + tid * max_nodes * node_row, node_row,
          clusters + tid * max_clusters * cluster_row, cluster_row, width,
          leaf_size, t_min, flagged, 0, -1, stack, kStackCap, b);
      if (retired) {
        b.t = 0.0f;
        break;
      }
    }
  }
  const size_t nn = static_cast<size_t>(n);
  out[i] = b.t;
  out[nn + i] = b.u;
  out[2 * nn + i] = b.v;
  out[3 * nn + i] = static_cast<float>(b.id);
}

// K4. The TLAS occupies node rows [0, tlas_nodes) with its root at 0; its
// leaves are instances (code -(num_clusters + inst) - 2). At a TLAS leaf
// the thread maps its ray through the instance's world->object 3x4
// (inst row lanes 0..11, the reference's operation order), takes the
// clamped inverse of the new direction, and walks the instance's BLAS from
// the root in lane 12 on the stack above its own TLAS entries, carrying
// the same Best (t is affine-invariant). Back in the TLAS it goes on with
// the world-space ray.
template <bool AnyHit>
__global__ void __launch_bounds__(kBlock) tlas_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, int n,
    const float* __restrict__ nodes, int node_row,
    const float* __restrict__ clusters, int cluster_row,
    int width, int leaf_size, float t_min,
    const float* __restrict__ insts, int inst_row, int num_clusters,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_prim,
    int* __restrict__ out_inst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(orig, dir, i);
  Best b{t_cap[i], 0.0f, 0.0f, -1, -1};
  int stack[kStackCap];
  traverse<AnyHit, true>(r, nodes, node_row, clusters, cluster_row, width,
                         leaf_size, t_min, AnyHit, 0, -1, stack, kStackCap, b,
                         insts, inst_row, num_clusters);
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_prim[i] = b.id;
  out_inst[i] = b.inst;
}

// K5: the same three kernels counting each ray's visits into out_stats
// [N, 5]. They are kernels of their own, so that the production kernels
// above keep their code.
template <bool AnyHit>
__global__ void __launch_bounds__(kBlock) traverse_stats_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, int n,
    const float* __restrict__ nodes, int node_row,
    const float* __restrict__ clusters, int cluster_row,
    int width, int leaf_size, float t_min,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_prim,
    int* __restrict__ out_stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(orig, dir, i);
  Best b{t_cap[i], 0.0f, 0.0f, -1, -1};
  Counts c{};
  int stack[kStackCap];
  traverse<AnyHit, false, true>(r, nodes, node_row, clusters, cluster_row,
                                width, leaf_size, t_min, AnyHit, 0, -1, stack,
                                kStackCap, b, nullptr, 0, 0, &c);
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_prim[i] = b.id;
  store_counts(out_stats, i, c);
}

template <bool AnyHit>
__global__ void __launch_bounds__(kBlock) segment_stats_kernel(
    const int* __restrict__ seg_list, const float* __restrict__ seg_entry,
    const int* __restrict__ seg_gmask, int n_steps, int n_words,
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, const float* __restrict__ anyhit_row,
    long long n,
    const float* __restrict__ nodes, int max_nodes, int node_row,
    const float* __restrict__ clusters, int max_clusters, int cluster_row,
    int width, int leaf_size, float t_min, int seg_rays, int group_rays,
    int step_cull, float* __restrict__ out, int* __restrict__ out_stats) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(n)) return;
  const size_t s = i / seg_rays;
  const int g = static_cast<int>((i % seg_rays) / group_rays);
  const int word = g >> 5, bit = g & 31;
  const Ray r = load_ray(orig, dir, i);
  const float cap = t_cap[i];
  const bool flagged = AnyHit || (anyhit_row != nullptr && anyhit_row[i] > 0.5f);
  Best b{cap, 0.0f, 0.0f, -1, -1};
  Counts c{};
  int stack[kStackCap];
  if (!(AnyHit && cap <= t_min)) {
    for (int e = 0; e < n_steps; ++e) {
      const size_t se = s * n_steps + e;
      if (!((__ldg(seg_gmask + se * n_words + word) >> bit) & 1)) continue;
      if (step_cull && e > 0 && !(b.t > __ldg(seg_entry + se))) continue;
      const size_t tid = static_cast<size_t>(__ldg(seg_list + se));
      ++c.extra;  // a step traversed
      const bool retired = traverse<AnyHit, false, true>(
          r, nodes + tid * max_nodes * node_row, node_row,
          clusters + tid * max_clusters * cluster_row, cluster_row, width,
          leaf_size, t_min, flagged, 0, -1, stack, kStackCap, b, nullptr, 0, 0,
          &c);
      if (retired) {
        b.t = 0.0f;
        break;
      }
    }
  }
  const size_t nn = static_cast<size_t>(n);
  out[i] = b.t;
  out[nn + i] = b.u;
  out[2 * nn + i] = b.v;
  out[3 * nn + i] = static_cast<float>(b.id);
  store_counts(out_stats, i, c);
}

template <bool AnyHit>
__global__ void __launch_bounds__(kBlock) tlas_stats_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, int n,
    const float* __restrict__ nodes, int node_row,
    const float* __restrict__ clusters, int cluster_row,
    int width, int leaf_size, float t_min,
    const float* __restrict__ insts, int inst_row, int num_clusters,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_prim,
    int* __restrict__ out_inst, int* __restrict__ out_stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(orig, dir, i);
  Best b{t_cap[i], 0.0f, 0.0f, -1, -1};
  Counts c{};
  int stack[kStackCap];
  traverse<AnyHit, true, true>(r, nodes, node_row, clusters, cluster_row,
                               width, leaf_size, t_min, AnyHit, 0, -1, stack,
                               kStackCap, b, insts, inst_row, num_clusters, &c);
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_prim[i] = b.id;
  out_inst[i] = b.inst;
  store_counts(out_stats, i, c);
}

template <bool AnyHit>
int launch(const float* orig, const float* dir, const float* t_cap, int n,
           const float* nodes, int node_row, const float* clusters,
           int cluster_row, int width, int leaf_size, float t_min,
           float* out_t, float* out_u, float* out_v, int* out_prim,
           int* out_stats, void* stream) {
  if (width < 1 || width > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_stats != nullptr) {
      traverse_stats_kernel<AnyHit><<<grid, kBlock, 0, st>>>(
          orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
          leaf_size, t_min, out_t, out_u, out_v, out_prim, out_stats);
    } else {
      traverse_kernel<AnyHit><<<grid, kBlock, 0, st>>>(
          orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
          leaf_size, t_min, out_t, out_u, out_v, out_prim);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool AnyHit>
int launch_tlas(const float* orig, const float* dir, const float* t_cap, int n,
                const float* nodes, int node_row, const float* clusters,
                int cluster_row, int width, int leaf_size, float t_min,
                const float* insts, int inst_row, int num_clusters,
                float* out_t, float* out_u, float* out_v, int* out_prim,
                int* out_inst, int* out_stats, void* stream) {
  if (width < 1 || width > kMaxWidth || inst_row < 13) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_stats != nullptr) {
      tlas_stats_kernel<AnyHit><<<grid, kBlock, 0, st>>>(
          orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
          leaf_size, t_min, insts, inst_row, num_clusters, out_t, out_u, out_v,
          out_prim, out_inst, out_stats);
    } else {
      tlas_kernel<AnyHit><<<grid, kBlock, 0, st>>>(
          orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
          leaf_size, t_min, insts, inst_row, num_clusters, out_t, out_u, out_v,
          out_prim, out_inst);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1/K2 (and their K5 form when out_stats, int32 [n, 5], is not null).
extern "C" int rt3_traverse_closest(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, float* out_t, float* out_u,
    float* out_v, int* out_prim, int* out_stats, void* stream) {
  return launch<false>(orig, dir, t_cap, n, nodes, node_row, clusters,
                       cluster_row, width, leaf_size, t_min, out_t, out_u,
                       out_v, out_prim, out_stats, stream);
}

extern "C" int rt3_traverse_any(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, float* out_t, float* out_u,
    float* out_v, int* out_prim, int* out_stats, void* stream) {
  return launch<true>(orig, dir, t_cap, n, nodes, node_row, clusters,
                      cluster_row, width, leaf_size, t_min, out_t, out_u,
                      out_v, out_prim, out_stats, stream);
}

// K4, closest and any hit. out_inst holds the hit instance, -1 on a miss;
// out_stats as for K1/K2.
extern "C" int rt3_traverse_tlas_closest(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, const float* insts, int inst_row,
    int num_clusters, float* out_t, float* out_u, float* out_v, int* out_prim,
    int* out_inst, int* out_stats, void* stream) {
  return launch_tlas<false>(orig, dir, t_cap, n, nodes, node_row, clusters,
                            cluster_row, width, leaf_size, t_min, insts,
                            inst_row, num_clusters, out_t, out_u, out_v,
                            out_prim, out_inst, out_stats, stream);
}

extern "C" int rt3_traverse_tlas_any(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, const float* insts, int inst_row,
    int num_clusters, float* out_t, float* out_u, float* out_v, int* out_prim,
    int* out_inst, int* out_stats, void* stream) {
  return launch_tlas<true>(orig, dir, t_cap, n, nodes, node_row, clusters,
                           cluster_row, width, leaf_size, t_min, insts,
                           inst_row, num_clusters, out_t, out_u, out_v,
                           out_prim, out_inst, out_stats, stream);
}

// K3. out is [4, n]: rows t, u, v, prim id as float. anyhit_row may be null;
// out_stats as for K1/K2.
extern "C" int rt3_traverse_segments(
    int any_hit, const int* seg_list, const float* seg_entry,
    const int* seg_gmask, int n_steps, int n_words, const float* orig,
    const float* dir, const float* t_cap, const float* anyhit_row,
    long long n, const float* nodes, int max_nodes, int node_row,
    const float* clusters, int max_clusters, int cluster_row, int width,
    int leaf_size, float t_min, int seg_rays, int group_rays, int step_cull,
    float* out, int* out_stats, void* stream) {
  if (width < 1 || width > kMaxWidth || seg_rays < kBlock ||
      seg_rays % kBlock != 0 || group_rays < 1 || seg_rays % group_rays != 0 ||
      (seg_rays / group_rays) > 32 * n_words || n % seg_rays != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const long long blocks = (n + kBlock - 1) / kBlock;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned grid = static_cast<unsigned>(blocks);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_stats != nullptr && any_hit) {
      segment_stats_kernel<true><<<grid, kBlock, 0, st>>>(
          seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
          anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
          cluster_row, width, leaf_size, t_min, seg_rays, group_rays,
          step_cull, out, out_stats);
    } else if (out_stats != nullptr) {
      segment_stats_kernel<false><<<grid, kBlock, 0, st>>>(
          seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
          anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
          cluster_row, width, leaf_size, t_min, seg_rays, group_rays,
          step_cull, out, out_stats);
    } else if (any_hit) {
      segment_kernel<true><<<grid, kBlock, 0, st>>>(
          seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
          anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
          cluster_row, width, leaf_size, t_min, seg_rays, group_rays,
          step_cull, out);
    } else {
      segment_kernel<false><<<grid, kBlock, 0, st>>>(
          seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
          anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
          cluster_row, width, leaf_size, t_min, seg_rays, group_rays,
          step_cull, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
