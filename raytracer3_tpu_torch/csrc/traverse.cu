// Closest-hit (K1) and any-hit (K2) traversal of the wide cluster BVH.
//
// Replaces: raytracer3_tpu/ops/pallas/traverse_kernel.py, function `_kernel`
// as launched by `packet_intersect` (any_hit=False and any_hit=True, single-
// level tables). Same tables, same row layout (pack_tables_host):
//   node row    : cmin 3w | cmax 3w | codes w | pad   (code >= 0 internal
//                 node, -1 empty, <= -2 cluster -code-2)
//   cluster row : L x (v0 e1 e2) | L triangle ids | cluster AABB | pad
// Same per-ray results: the nearest (t, u, v, prim) in (t_min, t_cap), or
// for any-hit the first accepted triangle. A ray with t_cap = 0 is parked.
//
// What bounds it on an H100: dependent loads — every pop reads one node row
// (16 slab tests) or one cluster row (12 Moller-Trumbore tests) whose address
// came from the previous pop — and warp divergence, since the 32 rays of a
// warp walk different paths. Not bandwidth: the 19k-triangle atrium's tables
// are ~1.3 MB and stay resident in the 50 MB L2.
//
// What this design does about it: one thread per ray, 128-thread blocks, a
// per-thread stack of codes in local memory, rows read in place through the
// read-only path. The wavefront coherence-sorts rays before each launch
// (render/wavefront.sorted_trace) and tiles primaries, so neighbouring
// threads mostly walk the same nodes and their row loads coalesce in L1.
// Wider nodes in shared memory, persistent threads and treelets are later work.
//
// The arithmetic repeats the reference's operation order; build with
// --fmad=false so no multiply-add is contracted and the kernel agrees with
// the plain PyTorch version (ops/traverse_kernel.packet_intersect_plain).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kStackCap = 128;  // the wrapper checks the tree needs no more
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
  const float ox = orig[3 * i], oy = orig[3 * i + 1], oz = orig[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float ix = clamped_inv(dx), iy = clamped_inv(dy), iz = clamped_inv(dz);

  float best_t = t_cap[i];
  float best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;

  int stack[kStackCap];
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
        const float t0x = (__ldg(row + 3 * s + 0) - ox) * ix;
        const float t0y = (__ldg(row + 3 * s + 1) - oy) * iy;
        const float t0z = (__ldg(row + 3 * s + 2) - oz) * iz;
        const float t1x = (__ldg(row + 3 * width + 3 * s + 0) - ox) * ix;
        const float t1y = (__ldg(row + 3 * width + 3 * s + 1) - oy) * iy;
        const float t1z = (__ldg(row + 3 * width + 3 * s + 2) - oz) * iz;
        const float tn = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                                 max_nan(min_nan(t0z, t1z), t_min));
        const float tf = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)),
                                 min_nan(max_nan(t0z, t1z), best_t));
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
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool det_ok = fabsf(det) > 1e-9f;
        const float inv_det = det_ok ? 1.0f / det : 0.0f;
        const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
        const float uu = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float vv = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool ok = det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                        tt > t_min && tt < best_t;
        if (!ok) continue;
        best_t = tt;
        best_u = uu;
        best_v = vv;
        best_id = static_cast<int>(tid);
        if (AnyHit) {
          sp = 0;  // retire on the first accepted hit
          break;
        }
      }
    }
  }
  out_t[i] = best_t;
  out_u[i] = best_u;
  out_v[i] = best_v;
  out_prim[i] = best_id;
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
