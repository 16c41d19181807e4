// Closest-hit (K1), any-hit (K2) and treelet segment-grid (K3) traversal of
// wide cluster BVHs.
//
// Replaces: raytracer3_tpu/ops/pallas/traverse_kernel.py, function `_kernel`
//   - as launched by `packet_intersect` (any_hit=False and any_hit=True,
//     single-level tables): K1 and K2, `traverse_kernel<false|true>`;
//   - as launched by `packet_intersect_segments` (seg=True, with its
//     mixed_hit and seg_cull options), driven by ops/treelets.py: K3,
//     `segment_kernel<false|true>`.
// Same tables, same row layout (pack_tables_host, build_treelets_host):
//   node row    : cmin 3w | cmax 3w | codes w | pad   (code >= 0 internal
//                 node, -1 empty, <= -2 cluster -code-2)
//   cluster row : L x (v0 e1 e2) | L triangle ids | cluster AABB | pad
// Same per-ray results: the nearest (t, u, v, prim) in (t_min, t_cap), or
// for any-hit the first accepted triangle. A ray with t_cap = 0 is parked.
//
// What bounds it on an H100: dependent loads — every pop reads one node row
// (16 slab tests) or one cluster row (12 or 24 Moller-Trumbore tests) whose
// address came from the previous pop — and warp divergence, since the 32
// rays of a warp walk different paths. Not bandwidth: the 19k-triangle
// atrium's tables are ~1.3 MB, and the 300k-triangle atrium's stacked
// treelet tables (5 treelets, leaf 24) ~27 MB; both stay resident in the
// 50 MB L2.
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
  int id;
};

// One traversal of one tree (a whole scene, or one treelet) from its root,
// updating `b` with every accepted hit nearer than b.t. AnyHit pushes
// children in slot order instead of near-first. With `retire`, the first
// accepted hit ends the traversal; returns whether that happened.
template <bool AnyHit>
__device__ __forceinline__ bool traverse(
    const Ray& r, const float* __restrict__ nodes, int node_row,
    const float* __restrict__ clusters, int cluster_row, int width,
    int leaf_size, float t_min, bool retire, int* stack, Best& b) {
  int sp = 0;
  stack[sp++] = 0;  // root
  while (sp > 0) {
    const int entry = stack[--sp];
    if (entry >= 0) {
      // Internal node: slab-test every real slot against this ray.
      const float* row = nodes + static_cast<size_t>(entry) * node_row;
      float keys[kMaxWidth];
      int codes[kMaxWidth];
      int cnt = 0;
      for (int s = 0; s < width; ++s) {
        const float code = __ldg(row + 6 * width + s);
        if (!(fabsf(code + 1.0f) > 0.25f)) continue;  // empty slot
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
          if (sp < kStackCap) stack[sp++] = static_cast<int>(code);
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
        if (sp < kStackCap) stack[sp++] = codes[k];
      }
    } else {
      // Leaf: Moller-Trumbore on the packed (v0, e1, e2) of cluster -entry-2.
      const float* crow = clusters + static_cast<size_t>(-entry - 2) * cluster_row;
      for (int j = 0; j < leaf_size; ++j) {
        const float tid = __ldg(crow + 9 * leaf_size + j);
        if (!(tid >= 0.0f)) continue;  // padding slot
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
  Best b{t_cap[i], 0.0f, 0.0f, -1};
  int stack[kStackCap];
  traverse<AnyHit>(r, nodes, node_row, clusters, cluster_row, width, leaf_size,
                   t_min, AnyHit, stack, b);
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
  Best b{cap, 0.0f, 0.0f, -1};
  int stack[kStackCap];
  if (!(AnyHit && cap <= t_min)) {  // an any-hit lane capped at t_min is resolved
    for (int e = 0; e < n_steps; ++e) {
      const size_t se = s * n_steps + e;
      // Skip on the group mask, never on the id: sentinel slots repeat a
      // real treelet id with mask 0.
      if (!((__ldg(seg_gmask + se * n_words + word) >> bit) & 1)) continue;
      if (step_cull && e > 0 && !(b.t > __ldg(seg_entry + se))) continue;
      const size_t tid = static_cast<size_t>(__ldg(seg_list + se));
      const bool retired = traverse<AnyHit>(
          r, nodes + tid * max_nodes * node_row, node_row,
          clusters + tid * max_clusters * cluster_row, cluster_row, width,
          leaf_size, t_min, flagged, stack, b);
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

template <bool AnyHit>
int launch(const float* orig, const float* dir, const float* t_cap, int n,
           const float* nodes, int node_row, const float* clusters,
           int cluster_row, int width, int leaf_size, float t_min,
           float* out_t, float* out_u, float* out_v, int* out_prim,
           void* stream) {
  if (width < 1 || width > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    traverse_kernel<AnyHit><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
        leaf_size, t_min, out_t, out_u, out_v, out_prim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt3_traverse_closest(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, float* out_t, float* out_u,
    float* out_v, int* out_prim, void* stream) {
  return launch<false>(orig, dir, t_cap, n, nodes, node_row, clusters,
                       cluster_row, width, leaf_size, t_min, out_t, out_u,
                       out_v, out_prim, stream);
}

extern "C" int rt3_traverse_any(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, float* out_t, float* out_u,
    float* out_v, int* out_prim, void* stream) {
  return launch<true>(orig, dir, t_cap, n, nodes, node_row, clusters,
                      cluster_row, width, leaf_size, t_min, out_t, out_u,
                      out_v, out_prim, stream);
}

// K3. out is [4, n]: rows t, u, v, prim id as float. anyhit_row may be null.
extern "C" int rt3_traverse_segments(
    int any_hit, const int* seg_list, const float* seg_entry,
    const int* seg_gmask, int n_steps, int n_words, const float* orig,
    const float* dir, const float* t_cap, const float* anyhit_row,
    long long n, const float* nodes, int max_nodes, int node_row,
    const float* clusters, int max_clusters, int cluster_row, int width,
    int leaf_size, float t_min, int seg_rays, int group_rays, int step_cull,
    float* out, void* stream) {
  if (width < 1 || width > kMaxWidth || seg_rays < kBlock ||
      seg_rays % kBlock != 0 || group_rays < 1 || seg_rays % group_rays != 0 ||
      (seg_rays / group_rays) > 32 * n_words || n % seg_rays != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const long long blocks = (n + kBlock - 1) / kBlock;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (any_hit) {
      segment_kernel<true><<<static_cast<unsigned>(blocks), kBlock, 0, st>>>(
          seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
          anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
          cluster_row, width, leaf_size, t_min, seg_rays, group_rays,
          step_cull, out);
    } else {
      segment_kernel<false><<<static_cast<unsigned>(blocks), kBlock, 0, st>>>(
          seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
          anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
          cluster_row, width, leaf_size, t_min, seg_rays, group_rays,
          step_cull, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
