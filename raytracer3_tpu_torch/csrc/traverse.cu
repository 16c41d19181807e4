// Closest-hit (K1), any-hit (K2), treelet segment-grid (K3) and two-level
// TLAS->BLAS (K4) traversal of wide cluster BVHs, each also in a counting
// form (K5).
//
// Replaces: raytracer3_tpu/ops/pallas/traverse_kernel.py, function `_kernel`
//   - as launched by `packet_intersect` (any_hit=False and any_hit=True,
//     single-level tables): K1 and K2, at the shape `packet_backend` builds
//     (width 16, leaf 12) `traverse_walk_kernel<W, L>` and
//     `traverse_walk_any_kernel<W, L>`, else `traverse_kernel<false|true,
//     Cap>`;
//   - as launched by `packet_intersect_segments` (seg=True, with its
//     mixed_hit and seg_cull options), driven by ops/treelets.py: K3, at the
//     shapes the backends build (width 16, leaf 12 or 24)
//     `segment_walk_kernel<W, L>` for closest hits and
//     `segment_walk_any_kernel<W, L>` for any hits, else
//     `segment_kernel<false|true, Cap>`;
//   - as launched by `packet_intersect` with an `inst_table` (two_level=True,
//     both hit kinds), via ops/tlas.two_level_backend: K4, at width 16 and
//     leaf 12 `tlas_walk_kernel<W, L>` and `tlas_walk_any_kernel<W, L>`,
//     else `tlas_kernel<false|true, Cap>`;
//   - with stats=True in both launchers (the counters of `_kernel`): K5,
//     `traverse_stats_kernel`, `segment_stats_kernel`,
//     `tlas_stats_kernel<false|true, Cap>` and the walk kernels' `Stats`
//     forms.
//     The reference counts per packet (its packet shares one stack); here
//     each thread counts its own ray: node pops, leaf pops, slab tests,
//     Moller-Trumbore tests, and K3's steps traversed or K4's instance hops,
//     written as int32 [N, 5]. The general loop's counting sits in that loop
//     under `if constexpr (Stats)`, in kernels of their own, so that the
//     production kernels of the general loop keep their SASS from version
//     to version (raytracer3_tpu_torch/tools/kernel_ab.py).
// Beside them, `pass_mark_kernel<I>` (end of file): an empty one-thread
// kernel that marks a boundary of a frame graph's pass order on the device.
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
// Two loops. The general loop (`traverse<AnyHit, TwoLevel, Stats>`) takes
// width and leaf size at run time and serves every kernel at any other
// table shape. The walks serve K1/K2, K3 and K4 at the shapes they are
// compiled for: `walk_closest<W, L, ...>` the closest hits, `walk_any<W, L,
// ...>` the any hits. The wrapper picks the loop from the tables
// (ops/traverse_kernel.py, `trace_loop`), and the entry points of the walks
// refuse any other shape. Each walk makes the same pops, tests and accepts
// per ray as the general loop, in the same order with the same floats:
// outputs and K5's counts are equal to the bit (chip_smoke.py holds them so
// on every ray set of K1/K2, K3 and K4, the CPU tests through
// csrc/host_shim.h).
//
// The stack. Each table set carries its worst-case stack need, computed on
// the host from the node codes when it is packed (the most, over
// root-to-leaf paths, of the real children less one per node, plus one;
// two-level: the TLAS's and the deepest BLAS's together, the walk's marker
// included), and every entry point takes it. The walks hold kStackCap
// entries and refuse more; the general loop's kernels take the stack size
// as a template constant, and their entry points launch the kStackCap
// instantiation where the need fits it, the kDeepStackCap one up to that,
// and refuse a larger need. The reference sizes its stack from the depth
// alone, (width - 1) * depth + 1 + depth, which at width 16 passes 128 at
// depth 8; the need from the codes is far smaller on the trees the builds
// make.
//
// The general loop: one thread per ray, 128-thread blocks, a per-thread
// stack of codes in local memory, rows read in place through the read-only
// path four bytes at a time, children insertion-sorted in two local arrays.
// The wavefront coherence-sorts rays before each launch
// (render/wavefront.sorted_trace, or the treelet driver's own sort) and
// tiles primaries, so neighbouring threads mostly walk the same nodes.
//
// K3 keeps the reference's segment grid as the rays' order and metadata,
// not as its schedule: a segment (sublanes x 128 rays) spans whole blocks,
// and each thread walks its segment's candidate steps in order. It skips a
// step when its group's bit in seg_gmask is clear (sentinel slots carry 0),
// when it is an any-hit lane already resolved, or (step_cull) when its own
// best t is at or below the step's entry distance — the per-ray form of the
// reference's per-segment max test, with the same results. Otherwise it
// runs the traversal loop over treelet seg_list[s, e]'s rows, carrying best
// t. Flagged lanes (anyhit_row > 0.5) and any-hit lanes retire on their
// first accepted hit with t = 0.
//
// K4 walks the TLAS with the same loop; at an instance leaf the thread maps
// its ray through the instance's world->object 3x4 (the reference's
// operation order, then the clamped inverse of the new direction) and walks
// the instance's BLAS, recording the instance with every hit it accepts; t
// is affine-invariant. The general loop does so by a nested call on the
// stack above its TLAS entries, with the world-space ray kept in registers.
//
// The closest-hit walk. What bounded the general loop on an H100 (NVIDIA
// H100 80GB HBM3, 700.00 W; the times are chip_smoke.py's, both loops on
// the same rays in one run; PERF.md has the record): K5's counts put every
// kernel on the operation side of its least time, and the general loop ran
// 23-25x above it on sorted bounces (K3 33.1 ms, K4 40.7 ms for 14.7M and
// 14.4M rays) at 55-56 registers and a 640/768-byte stack frame. Per node it
// runs 16 slot iterations one after the other, each with a four-byte load
// of the code, a branch, and six four-byte loads of the box: ~112 load
// instructions and ~30 dependent round trips per node, with lanes parting
// at every `continue`. What the walk does about it:
//   - 16-byte row loads (28 per node instead of 112, 3 per triangle instead
//     of 10) with width and leaf size as template constants. A first form
//     ranked the children by compares over 16 key registers in a fully
//     unrolled loop and prefetched the next chunk's boxes: over 100
//     registers, and slower than the general loop. The unrolled rank (up to
//     16 x 15 compares a node whenever any lane of the warp takes the slot)
//     and NaN-aware min/max cost more instructions than the loads saved, at
//     half the occupancy. Load instructions were not what bound the loop.
//   - fminf/fmaxf for the slab test (one instruction each; the NaN cases
//     settled once per ray), keys written to memory as they are computed and
//     ranked in loops over the taken bits only (most nodes take one or two
//     children), codes and ids reduced to bit masks at once and read again
//     where a child is pushed or a hit accepted, no prefetch, three words
//     per triangle instead of a group's nine: 60-64 registers, a 576-byte
//     stack frame (the stack and the 16 keys), no spills, and 1.45-1.78x
//     faster than the general loop in the same run (K3 sorted bounce 33.1
//     -> 20.6 ms, tiled primaries 15.8 -> 9.0; K4 40.7 -> 27.9 and 20.8 ->
//     13.9). Every cut of registers on the way there paid.
//   - While-while (an inner loop that pops and expands nodes until a leaf
//     comes up) against one pop of either kind per iteration: a few percent.
//     K5's SIMT efficiency (0.61-0.62 on sorted bounces) is a function of
//     the per-ray counts and cannot move.
//   - K4 as one flat loop with a marker on the stack (kLeaveInstance) and
//     the world-space ray read again at the marker's pop, not the nested
//     call: the node and leaf code exists once, TLAS and BLAS lanes of a
//     warp run it together, and nine registers of world ray are free during
//     the BLAS walk (62 registers against what would not fit in 64). The
//     marker costs one stack entry per hop more than the nested call.
//   - K3 reads a segment's steps once per block into shared memory.
//   - K1 is the same walk over one single-level tree from row 0 with
//     nothing retiring: K4's walk without instances. K2 is `walk_any` over
//     that tree; a ray capped at or below t_min is walked all the same, as
//     the general loop walks it, so that K5's counts stay equal.
//
// The any-hit walk. The any-hit launches of K3 and K4 (the frames' NEE
// shadow batch, and the tail of shadow rays and escape probes) ran the
// general loop 26-43x above their operation-side bound. `walk_any` is
// `walk_closest` without the child order: an any-hit answer is whether some
// triangle lies in (t_min, cap), which the visit order does not change, so
// the general loop pushes the taken children in slot order and the walk
// does the same from its `taken` bits, with no keys, no rank and no key
// array in the frame (the stack alone). The first accepted hit returns at
// once, in whatever space the ray is. Same row loads, NaN test, loop shape
// and marker as `walk_closest`, in functions and kernels of their own so
// that the closest walk's machine code stays as it was. On the H100 above,
// against the general loop on the same rays in one run: K3 any 1.74-1.76x
// faster, K4 any 1.84-1.88x (sorted shadow batches and the frame-ordered
// tail), at 61-64 registers and a 512-byte frame, no spills: without the
// keys the walk still fills the 64-register allocation. Sorting the tail
// first did not pay: render/wavefront.py traces it in the frame's order.
//
// Tried once on the card and dropped, none of them kept as an option: the
// stack's top 16 or 32 entries in shared memory, the keys in shared instead
// of local memory, the stack's top entry in a register, 64- and 256-thread
// blocks (each within run-to-run spread once registers were down); a rolled
// chunk loop, register caps below 56 (spills) and prefetching the next
// chunk (24 registers more), each slower. For K1/K2, the node rows staged
// in shared memory where they fit one block's (the headline table's 342
// rows: their 28 read words at an odd stride of 464 bytes, 159 KB, copied
// with 16-byte loads by one persistent 1,024-thread block per SM whose warps
// took 32 rays at a time from a ticket; 50-55 registers, no spills): on the
// H100 above, in two runs, 0.94-0.95x the walk's speed on the NEE shadow
// set, 1.01-1.02x on sorted bounces, 0.98-1.00x on tiled primaries, where
// 1.10x on both sets was the bar. The walk finds those rows in L1 already;
// staging trades L1 hits for shared loads, and the 159 KB come out of the
// SM's memory that L1 would otherwise hold cluster rows and stacks in. What still holds the walk 15-16x
// above its bound on sorted bounces (7x on tiled primaries): lanes idle in
// diverged warps (SIMT 0.62), --fmad=false and the non-arithmetic
// instructions around each test, and the 448 bytes a lane moves through L1
// per node visit, which for a warp on 32 different rows is as many L1 cycles
// as the tests take to issue. Fewer bytes per visit (quantised boxes) is
// the next lever.
//
// The arithmetic repeats the reference's operation order; build with
// --fmad=false so no multiply-add is contracted and the kernels agree with
// their plain PyTorch versions (ops/traverse_kernel.py).

#ifdef RT3_HOST_SHIM
#include "host_shim.h"  // g++ build for the CPU tests: one thread at a time
#else
#include <cuda_runtime.h>
#endif

#include <cstddef>
#include <utility>

namespace {

constexpr int kBlock = 128;
// Stack entries of a thread. Every entry point takes the tables' worst-case
// need (ops/traverse_kernel.py, `tree_stack_need`, computed when the tables
// are packed) and refuses what its kernels cannot hold: the walks hold
// kStackCap, the general loop has an instantiation for each of the two.
constexpr int kStackCap = 128;
constexpr int kDeepStackCap = 512;
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

template <bool AnyHit, int Cap>
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
  int stack[Cap];
  traverse<AnyHit, false>(r, nodes, node_row, clusters, cluster_row, width,
                          leaf_size, t_min, AnyHit, 0, -1, stack, Cap, b);
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_prim[i] = b.id;
}

template <bool AnyHit, int Cap>
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
  int stack[Cap];
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
          leaf_size, t_min, flagged, 0, -1, stack, Cap, b);
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
template <bool AnyHit, int Cap>
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
  int stack[Cap];
  traverse<AnyHit, true>(r, nodes, node_row, clusters, cluster_row, width,
                         leaf_size, t_min, AnyHit, 0, -1, stack, Cap, b,
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
template <bool AnyHit, int Cap>
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
  int stack[Cap];
  traverse<AnyHit, false, true>(r, nodes, node_row, clusters, cluster_row,
                                width, leaf_size, t_min, AnyHit, 0, -1, stack,
                                Cap, b, nullptr, 0, 0, &c);
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_prim[i] = b.id;
  store_counts(out_stats, i, c);
}

template <bool AnyHit, int Cap>
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
  int stack[Cap];
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
          leaf_size, t_min, flagged, 0, -1, stack, Cap, b, nullptr, 0, 0,
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

template <bool AnyHit, int Cap>
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
  int stack[Cap];
  traverse<AnyHit, true, true>(r, nodes, node_row, clusters, cluster_row,
                               width, leaf_size, t_min, AnyHit, 0, -1, stack,
                               Cap, b, insts, inst_row, num_clusters, &c);
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_prim[i] = b.id;
  out_inst[i] = b.inst;
  store_counts(out_stats, i, c);
}

// ---------------------------------------------------------------------------
// The closest-hit walk of K1, K3 and K4 (header note, "The closest-hit walk").
// ---------------------------------------------------------------------------

// 128-thread blocks, and a register allocation that lets eight of them share
// an SM (64 registers a thread): header note, "Tried and dropped".
constexpr int kWalkBlock = 128;
constexpr int kWalkMinBlocks = 8;
// Pushed under an instance's BLAS root: its pop takes the ray back to world
// space. No child code has this value (-code - 2 would not fit an int).
constexpr int kLeaveInstance = -2147483647 - 1;

// The general loop's min_nan and max_nan propagate a NaN operand, so a ray
// with a NaN in its origin, inverse direction, cap or t_min fails every slab
// test. The walk tests slabs with fminf and fmaxf, which drop a NaN, and
// asks this once per ray (and per instance hop) instead.
__device__ __forceinline__ bool has_nan(const Ray& r, float best_t, float t_min) {
  return !(r.ox == r.ox && r.oy == r.oy && r.oz == r.oz && r.ix == r.ix &&
           r.iy == r.iy && r.iz == r.iz && best_t == best_t && t_min == t_min);
}

__device__ __forceinline__ bool real_slot(float code) {
  return fabsf(code + 1.0f) > 0.25f;
}

// One child's key: its entry distance where the ray enters the box before
// it leaves it and before best t, else -inf. The general loop's floats in
// its order, with the card's one-instruction fminf/fmaxf in place of
// min_nan/max_nan: the two differ only on a NaN operand, which the caller
// has ruled out (has_nan), and in the sign of a zero, which no compare
// below can see.
__device__ __forceinline__ float child_key(const Ray& r, float t_min, float best_t,
                                           float nx, float ny, float nz,
                                           float xx, float xy, float xz) {
  const float t0x = (nx - r.ox) * r.ix;
  const float t0y = (ny - r.oy) * r.iy;
  const float t0z = (nz - r.oz) * r.iz;
  const float t1x = (xx - r.ox) * r.ix;
  const float t1y = (xy - r.oy) * r.iy;
  const float t1z = (xz - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fmaxf(fminf(t0z, t1z), t_min));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fminf(fmaxf(t0z, t1z), best_t));
  return (!(tn <= tf) || isinf(tn)) ? -INFINITY : tn;
}

// Closest-hit traversal of one tree from node `root`, for tables of width W
// and leaf size L known when the kernel is compiled. Per ray it makes the
// pops, tests and accepts of traverse<false, TwoLevel> in the same order
// with the same floats, so hits and K5's counts are equal to the bit; what
// differs is how the warp gets there (header note).
//   - A node row is read as 16-byte words: four words of codes, reduced at
//     once to one bit per real slot, then per chunk of four slots three
//     words of mins and three of maxes; a chunk of four empty slots is
//     skipped before its boxes are read. The chunk loop is unrolled.
//   - A taken child's place on the stack is its rank among the taken ones:
//     before it go the children with a larger key and, among equal keys,
//     the later slots. That is the general loop's insertion order written as
//     a total order. The 16 keys go to `keys` (local memory) as they are
//     computed; the rank loops run over the set bits of `taken` only, and a
//     taken child's code is read again from the row (an L1 hit).
//   - Nodes are popped and expanded in an inner loop until a leaf (or an
//     instance, or the stack's end) comes up, and only then is the leaf
//     tested (while-while).
//   - A leaf's ids are read as L/4 words and reduced to one bit per
//     triangle; each real triangle then reads the three words that hold
//     its nine floats (a word shared with its neighbour is read twice),
//     which keeps 12 floats live instead of a group's 36. The loop over
//     groups of four stays rolled. An accepted hit reads its id again.
//   - With TwoLevel the walk is one flat loop over TLAS and BLAS rows: an
//     instance leaf (cluster index >= num_clusters) maps the ray into object
//     space in place, pushes kLeaveInstance and the BLAS root, and the
//     marker's pop loads the world-space ray again from the ray arrays.
// With `retire` the first accepted hit ends the walk; returns whether that
// happened.
template <int W, int L, bool TwoLevel, bool Stats>
__device__ __forceinline__ bool walk_closest(
    Ray r, const float* __restrict__ orig, const float* __restrict__ dir,
    size_t ray, const float4* __restrict__ nodes, int node_row4,
    const float4* __restrict__ clusters, int cluster_row4, float t_min,
    bool retire, int root, int* stack, Best& b,
    const float4* __restrict__ insts, int inst_row4, int num_clusters,
    Counts* c) {
  static_assert(W % 4 == 0 && W <= kMaxWidth && L % 4 == 0 && L <= 32,
                "rows are read four slots at a time, validity kept as bits");
  bool blind = has_nan(r, b.t, t_min);
  float keys[W];
  int sp = 0;
  int inst = -1;
  stack[sp++] = root;
  while (true) {
    // Nodes: pop and expand until something that is not a node comes up.
    int entry;
    while (true) {
      if (sp == 0) return false;
      entry = stack[--sp];
      if (entry < 0) break;
      if constexpr (Stats) ++c->node;
      const float4* row = nodes + static_cast<size_t>(entry) * node_row4;
      unsigned real = 0;
#pragma unroll
      for (int ch = 0; ch < W / 4; ++ch) {
        const float4 cd = __ldg(row + 6 * W / 4 + ch);
        real |= (unsigned(real_slot(cd.x)) | unsigned(real_slot(cd.y)) << 1 |
                 unsigned(real_slot(cd.z)) << 2 | unsigned(real_slot(cd.w)) << 3)
                << (4 * ch);
      }
      if constexpr (Stats) c->slab += __popc(real);
      unsigned taken = 0;
#pragma unroll
      for (int ch = 0; ch < W / 4; ++ch) {
        // Chunk 0 always holds a child, so its boxes are asked for together
        // with the codes; a later chunk only once its codes show a real slot.
        if (ch > 0 && ((real >> (4 * ch)) & 15u) == 0) continue;
        // Mins of slots 4ch..4ch+3 are 12 contiguous floats, maxes too.
        const float4 n0 = __ldg(row + 3 * ch), n1 = __ldg(row + 3 * ch + 1), n2 = __ldg(row + 3 * ch + 2);
        const float4 x0 = __ldg(row + 3 * W / 4 + 3 * ch), x1 = __ldg(row + 3 * W / 4 + 3 * ch + 1),
                     x2 = __ldg(row + 3 * W / 4 + 3 * ch + 2);
        const float k0 = child_key(r, t_min, b.t, n0.x, n0.y, n0.z, x0.x, x0.y, x0.z);
        const float k1 = child_key(r, t_min, b.t, n0.w, n1.x, n1.y, x0.w, x1.x, x1.y);
        const float k2 = child_key(r, t_min, b.t, n1.z, n1.w, n2.x, x1.z, x1.w, x2.x);
        const float k3 = child_key(r, t_min, b.t, n2.y, n2.z, n2.w, x2.y, x2.z, x2.w);
        keys[4 * ch + 0] = k0;
        keys[4 * ch + 1] = k1;
        keys[4 * ch + 2] = k2;
        keys[4 * ch + 3] = k3;
        taken |= (unsigned(k0 > -INFINITY) | unsigned(k1 > -INFINITY) << 1 |
                  unsigned(k2 > -INFINITY) << 2 | unsigned(k3 > -INFINITY) << 3)
                 << (4 * ch);
      }
      taken &= real;
      if (blind) taken = 0;
      // Far-first pushes, later slots first among equal keys.
      const float* code_of = reinterpret_cast<const float*>(row) + 6 * W;
      for (unsigned m = taken; m != 0; m &= m - 1) {
        const int s = __ffs(m) - 1;
        const float ks = keys[s];
        int rank = 0;
        for (unsigned q = taken & ~(1u << s); q != 0; q &= q - 1) {
          const int j = __ffs(q) - 1;
          const float kj = keys[j];
          rank += int(j < s ? kj > ks : kj >= ks);
        }
        if (sp + rank < kStackCap) stack[sp + rank] = static_cast<int>(__ldg(code_of + s));
      }
      sp += __popc(taken);
      if (sp > kStackCap) sp = kStackCap;
    }

    if constexpr (TwoLevel) {
      if (entry == kLeaveInstance) {
        r = load_ray(orig, dir, ray);
        blind = has_nan(r, b.t, t_min);
        inst = -1;
        continue;
      }
      const int k = -entry - 2 - num_clusters;
      if (k >= 0) {
        if constexpr (Stats) ++c->extra;
        // The BLAS is walked on the stack above the TLAS entries, as in the
        // general loop, with the marker under its root: two entries. A
        // stack too full for them passes the instance by before the ray is
        // touched, so the TLAS entries left are still walked in world
        // space. The wrapper never lets it come to that (closest_loop).
        if (sp + 2 > kStackCap) continue;
        const float4* m = insts + static_cast<size_t>(k) * inst_row4;
        const float4 ma = __ldg(m), mb = __ldg(m + 1), mc = __ldg(m + 2), md = __ldg(m + 3);
        Ray o;
        o.ox = ma.x * r.ox + ma.y * r.oy + ma.z * r.oz + ma.w;
        o.oy = mb.x * r.ox + mb.y * r.oy + mb.z * r.oz + mb.w;
        o.oz = mc.x * r.ox + mc.y * r.oy + mc.z * r.oz + mc.w;
        o.dx = ma.x * r.dx + ma.y * r.dy + ma.z * r.dz;
        o.dy = mb.x * r.dx + mb.y * r.dy + mb.z * r.dz;
        o.dz = mc.x * r.dx + mc.y * r.dy + mc.z * r.dz;
        o.ix = clamped_inv(o.dx);
        o.iy = clamped_inv(o.dy);
        o.iz = clamped_inv(o.dz);
        r = o;
        blind = has_nan(r, b.t, t_min);
        inst = k;
        stack[sp++] = kLeaveInstance;
        stack[sp++] = static_cast<int>(md.x);
        continue;
      }
    }

    // Leaf: Moller-Trumbore on the triangles of cluster -entry-2.
    if constexpr (Stats) ++c->leaf;
    const float4* crow = clusters + static_cast<size_t>(-entry - 2) * cluster_row4;
    const float* id_of = reinterpret_cast<const float*>(crow) + 9 * L;
    unsigned valid = 0;
#pragma unroll
    for (int g = 0; g < L / 4; ++g) {
      const float4 id4 = __ldg(crow + 9 * L / 4 + g);
      valid |= (unsigned(id4.x >= 0.0f) | unsigned(id4.y >= 0.0f) << 1 |
                unsigned(id4.z >= 0.0f) << 2 | unsigned(id4.w >= 0.0f) << 3)
               << (4 * g);
    }
    for (int g = 0; g < L / 4; ++g) {
      if (((valid >> (4 * g)) & 15u) == 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!((valid >> (4 * g + j)) & 1u)) continue;  // padding slot
        if constexpr (Stats) ++c->tri;
        // Triangle j's nine floats start 9j floats into the group: inside
        // the three words from word 9j/4 on, 9j%4 floats in.
        float words[12];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 w4 = __ldg(crow + 9 * g + (9 * j) / 4 + q);
          words[4 * q + 0] = w4.x;
          words[4 * q + 1] = w4.y;
          words[4 * q + 2] = w4.z;
          words[4 * q + 3] = w4.w;
        }
        const float* f = words + (9 * j) % 4;
        const float v0x = f[0], v0y = f[1], v0z = f[2];
        const float e1x = f[3], e1y = f[4], e1z = f[5];
        const float e2x = f[6], e2y = f[7], e2z = f[8];
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
        b.id = static_cast<int>(__ldg(id_of + 4 * g + j));
        b.inst = inst;
        if (retire) return true;  // the first accepted hit ends the walk
      }
    }
  }
}

// K3 closest on the walk. A block lies in one group of one segment (the
// launcher checks seg_rays and group_rays against the block size), so the
// segment's steps are read once per block into shared memory: treelet id,
// entry distance, and the block's bit of the group mask.
template <int W, int L, bool Stats>
__global__ void __launch_bounds__(kWalkBlock, kWalkMinBlocks) segment_walk_kernel(
    const int* __restrict__ seg_list, const float* __restrict__ seg_entry,
    const int* __restrict__ seg_gmask, int n_steps, int n_words,
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, const float* __restrict__ anyhit_row,
    long long n,
    const float4* __restrict__ nodes, int max_nodes, int node_row4,
    const float4* __restrict__ clusters, int max_clusters, int cluster_row4,
    float t_min, int seg_rays, int group_rays, int step_cull,
    float* __restrict__ out, int* __restrict__ out_stats) {
#ifdef RT3_HOST_SHIM
  int* steps = rt3_shim_dynamic_smem();
#else
  extern __shared__ int steps[];
#endif
  int* step_tid = steps;
  float* step_entry = reinterpret_cast<float*>(steps + n_steps);
  int* step_on = steps + 2 * n_steps;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x;
  const size_t s = first / seg_rays;  // < S: n is a whole number of segments
  const int g = static_cast<int>((first % seg_rays) / group_rays);
  for (int e = threadIdx.x; e < n_steps; e += blockDim.x) {
    const size_t se = s * n_steps + e;
    step_tid[e] = __ldg(seg_list + se);
    step_entry[e] = __ldg(seg_entry + se);
    // Sentinel slots repeat a real treelet id with mask 0: skip on the mask.
    step_on[e] = (__ldg(seg_gmask + se * n_words + (g >> 5)) >> (g & 31)) & 1;
  }
  __syncthreads();
  const size_t i = first + threadIdx.x;  // < n: a segment is whole blocks
  const Ray r = load_ray(orig, dir, i);
  const bool flagged = anyhit_row != nullptr && anyhit_row[i] > 0.5f;
  Best b{t_cap[i], 0.0f, 0.0f, -1, -1};
  Counts c{};
  int stack[kStackCap];
  for (int e = 0; e < n_steps; ++e) {
    if (!step_on[e]) continue;
    if (step_cull && e > 0 && !(b.t > step_entry[e])) continue;
    const size_t tid = static_cast<size_t>(step_tid[e]);
    if constexpr (Stats) ++c.extra;  // a step traversed
    const bool retired = walk_closest<W, L, false, Stats>(
        r, orig, dir, i, nodes + tid * max_nodes * node_row4, node_row4,
        clusters + tid * max_clusters * cluster_row4, cluster_row4, t_min,
        flagged, 0, stack, b, nullptr, 0, 0, &c);
    if (retired) {
      b.t = 0.0f;
      break;
    }
  }
  const size_t nn = static_cast<size_t>(n);
  out[i] = b.t;
  out[nn + i] = b.u;
  out[2 * nn + i] = b.v;
  out[3 * nn + i] = static_cast<float>(b.id);
  if constexpr (Stats) store_counts(out_stats, i, c);
}

// K4 closest on the walk: one flat loop over TLAS and BLAS rows.
template <int W, int L, bool Stats>
__global__ void __launch_bounds__(kWalkBlock, kWalkMinBlocks) tlas_walk_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, int n,
    const float4* __restrict__ nodes, int node_row4,
    const float4* __restrict__ clusters, int cluster_row4, float t_min,
    const float4* __restrict__ insts, int inst_row4, int num_clusters,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_prim,
    int* __restrict__ out_inst, int* __restrict__ out_stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(orig, dir, i);
  Best b{t_cap[i], 0.0f, 0.0f, -1, -1};
  Counts c{};
  int stack[kStackCap];
  walk_closest<W, L, true, Stats>(r, orig, dir, i, nodes, node_row4, clusters,
                                  cluster_row4, t_min, false, 0, stack, b, insts,
                                  inst_row4, num_clusters, &c);
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_prim[i] = b.id;
  out_inst[i] = b.inst;
  if constexpr (Stats) store_counts(out_stats, i, c);
}

// ---------------------------------------------------------------------------
// The any-hit walk of K2, K3 and K4 (header note, "The any-hit walk").
// ---------------------------------------------------------------------------

// Any-hit traversal of one tree from node `root`, for tables of width W and
// leaf size L known when the kernel is compiled: returns whether a hit was
// accepted, and then `b` holds it. Per ray it makes the pops, tests and
// accepts of traverse<true, TwoLevel> in the same order with the same
// floats. It is walk_closest without the child order: a node's taken
// children are pushed in slot order, as the general loop pushes them, so
// there are no keys and no rank. The row loads, the NaN test, the
// while-while shape and the flat TLAS/BLAS loop with its marker are
// walk_closest's. The first accepted hit ends the walk where it is found:
// the ray is not taken back to world space.
template <int W, int L, bool TwoLevel, bool Stats>
__device__ __forceinline__ bool walk_any(
    Ray r, const float* __restrict__ orig, const float* __restrict__ dir,
    size_t ray, const float4* __restrict__ nodes, int node_row4,
    const float4* __restrict__ clusters, int cluster_row4, float t_min,
    int root, int* stack, Best& b, const float4* __restrict__ insts,
    int inst_row4, int num_clusters, Counts* c) {
  static_assert(W % 4 == 0 && W <= kMaxWidth && L % 4 == 0 && L <= 32,
                "rows are read four slots at a time, validity kept as bits");
  bool blind = has_nan(r, b.t, t_min);
  int sp = 0;
  int inst = -1;
  stack[sp++] = root;
  while (true) {
    // Nodes: pop and expand until something that is not a node comes up.
    int entry;
    while (true) {
      if (sp == 0) return false;
      entry = stack[--sp];
      if (entry < 0) break;
      if constexpr (Stats) ++c->node;
      const float4* row = nodes + static_cast<size_t>(entry) * node_row4;
      unsigned real = 0;
#pragma unroll
      for (int ch = 0; ch < W / 4; ++ch) {
        const float4 cd = __ldg(row + 6 * W / 4 + ch);
        real |= (unsigned(real_slot(cd.x)) | unsigned(real_slot(cd.y)) << 1 |
                 unsigned(real_slot(cd.z)) << 2 | unsigned(real_slot(cd.w)) << 3)
                << (4 * ch);
      }
      if constexpr (Stats) c->slab += __popc(real);
      unsigned taken = 0;
#pragma unroll
      for (int ch = 0; ch < W / 4; ++ch) {
        if (ch > 0 && ((real >> (4 * ch)) & 15u) == 0) continue;
        const float4 n0 = __ldg(row + 3 * ch), n1 = __ldg(row + 3 * ch + 1), n2 = __ldg(row + 3 * ch + 2);
        const float4 x0 = __ldg(row + 3 * W / 4 + 3 * ch), x1 = __ldg(row + 3 * W / 4 + 3 * ch + 1),
                     x2 = __ldg(row + 3 * W / 4 + 3 * ch + 2);
        taken |= (unsigned(child_key(r, t_min, b.t, n0.x, n0.y, n0.z, x0.x, x0.y, x0.z) > -INFINITY) |
                  unsigned(child_key(r, t_min, b.t, n0.w, n1.x, n1.y, x0.w, x1.x, x1.y) > -INFINITY) << 1 |
                  unsigned(child_key(r, t_min, b.t, n1.z, n1.w, n2.x, x1.z, x1.w, x2.x) > -INFINITY) << 2 |
                  unsigned(child_key(r, t_min, b.t, n2.y, n2.z, n2.w, x2.y, x2.z, x2.w) > -INFINITY) << 3)
                 << (4 * ch);
      }
      taken &= real;
      if (blind) taken = 0;
      // Slot order: the last taken slot is popped first.
      const float* code_of = reinterpret_cast<const float*>(row) + 6 * W;
      for (unsigned m = taken; m != 0; m &= m - 1) {
        if (sp < kStackCap) stack[sp++] = static_cast<int>(__ldg(code_of + __ffs(m) - 1));
      }
    }

    if constexpr (TwoLevel) {
      if (entry == kLeaveInstance) {
        r = load_ray(orig, dir, ray);
        blind = has_nan(r, b.t, t_min);
        inst = -1;
        continue;
      }
      const int k = -entry - 2 - num_clusters;
      if (k >= 0) {
        if constexpr (Stats) ++c->extra;
        // As in walk_closest: no room for the marker and the BLAS root, no
        // hop (the wrapper never lets it come to that).
        if (sp + 2 > kStackCap) continue;
        const float4* m = insts + static_cast<size_t>(k) * inst_row4;
        const float4 ma = __ldg(m), mb = __ldg(m + 1), mc = __ldg(m + 2), md = __ldg(m + 3);
        Ray o;
        o.ox = ma.x * r.ox + ma.y * r.oy + ma.z * r.oz + ma.w;
        o.oy = mb.x * r.ox + mb.y * r.oy + mb.z * r.oz + mb.w;
        o.oz = mc.x * r.ox + mc.y * r.oy + mc.z * r.oz + mc.w;
        o.dx = ma.x * r.dx + ma.y * r.dy + ma.z * r.dz;
        o.dy = mb.x * r.dx + mb.y * r.dy + mb.z * r.dz;
        o.dz = mc.x * r.dx + mc.y * r.dy + mc.z * r.dz;
        o.ix = clamped_inv(o.dx);
        o.iy = clamped_inv(o.dy);
        o.iz = clamped_inv(o.dz);
        r = o;
        blind = has_nan(r, b.t, t_min);
        inst = k;
        stack[sp++] = kLeaveInstance;
        stack[sp++] = static_cast<int>(md.x);
        continue;
      }
    }

    // Leaf: Moller-Trumbore on the triangles of cluster -entry-2, as in
    // walk_closest; the first accepted one ends the walk.
    if constexpr (Stats) ++c->leaf;
    const float4* crow = clusters + static_cast<size_t>(-entry - 2) * cluster_row4;
    const float* id_of = reinterpret_cast<const float*>(crow) + 9 * L;
    unsigned valid = 0;
#pragma unroll
    for (int g = 0; g < L / 4; ++g) {
      const float4 id4 = __ldg(crow + 9 * L / 4 + g);
      valid |= (unsigned(id4.x >= 0.0f) | unsigned(id4.y >= 0.0f) << 1 |
                unsigned(id4.z >= 0.0f) << 2 | unsigned(id4.w >= 0.0f) << 3)
               << (4 * g);
    }
    for (int g = 0; g < L / 4; ++g) {
      if (((valid >> (4 * g)) & 15u) == 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!((valid >> (4 * g + j)) & 1u)) continue;  // padding slot
        if constexpr (Stats) ++c->tri;
        float words[12];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 w4 = __ldg(crow + 9 * g + (9 * j) / 4 + q);
          words[4 * q + 0] = w4.x;
          words[4 * q + 1] = w4.y;
          words[4 * q + 2] = w4.z;
          words[4 * q + 3] = w4.w;
        }
        const float* f = words + (9 * j) % 4;
        const float v0x = f[0], v0y = f[1], v0z = f[2];
        const float e1x = f[3], e1y = f[4], e1z = f[5];
        const float e2x = f[6], e2y = f[7], e2z = f[8];
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
        if (det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > t_min && tt < b.t) {
          b.t = tt;
          b.u = uu;
          b.v = vv;
          b.id = static_cast<int>(__ldg(id_of + 4 * g + j));
          b.inst = inst;
          return true;
        }
      }
    }
  }
}

// K3 any on the walk: segment_kernel<true>'s rules (every lane retires on
// its first accepted hit and writes t = 0; a lane capped at or below t_min
// is resolved without a walk; step_cull tests the cap) with the segment's
// steps in shared memory as in segment_walk_kernel.
template <int W, int L, bool Stats>
__global__ void __launch_bounds__(kWalkBlock, kWalkMinBlocks) segment_walk_any_kernel(
    const int* __restrict__ seg_list, const float* __restrict__ seg_entry,
    const int* __restrict__ seg_gmask, int n_steps, int n_words,
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, long long n,
    const float4* __restrict__ nodes, int max_nodes, int node_row4,
    const float4* __restrict__ clusters, int max_clusters, int cluster_row4,
    float t_min, int seg_rays, int group_rays, int step_cull,
    float* __restrict__ out, int* __restrict__ out_stats) {
#ifdef RT3_HOST_SHIM
  int* steps = rt3_shim_dynamic_smem();
#else
  extern __shared__ int steps[];
#endif
  int* step_tid = steps;
  float* step_entry = reinterpret_cast<float*>(steps + n_steps);
  int* step_on = steps + 2 * n_steps;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x;
  const size_t s = first / seg_rays;
  const int g = static_cast<int>((first % seg_rays) / group_rays);
  for (int e = threadIdx.x; e < n_steps; e += blockDim.x) {
    const size_t se = s * n_steps + e;
    step_tid[e] = __ldg(seg_list + se);
    step_entry[e] = __ldg(seg_entry + se);
    step_on[e] = (__ldg(seg_gmask + se * n_words + (g >> 5)) >> (g & 31)) & 1;
  }
  __syncthreads();
  const size_t i = first + threadIdx.x;
  Best b{t_cap[i], 0.0f, 0.0f, -1, -1};
  Counts c{};
  if (!(b.t <= t_min)) {
    const Ray r = load_ray(orig, dir, i);
    int stack[kStackCap];
    for (int e = 0; e < n_steps; ++e) {
      if (!step_on[e]) continue;
      if (step_cull && e > 0 && !(b.t > step_entry[e])) continue;
      const size_t tid = static_cast<size_t>(step_tid[e]);
      if constexpr (Stats) ++c.extra;  // a step traversed
      if (walk_any<W, L, false, Stats>(r, orig, dir, i, nodes + tid * max_nodes * node_row4, node_row4,
                                       clusters + tid * max_clusters * cluster_row4, cluster_row4,
                                       t_min, 0, stack, b, nullptr, 0, 0, &c)) {
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
  if constexpr (Stats) store_counts(out_stats, i, c);
}

// K4 any on the walk: one flat loop over TLAS and BLAS rows; t, u, v, prim
// and instance of the first accepted hit, as tlas_kernel<true> writes them.
template <int W, int L, bool Stats>
__global__ void __launch_bounds__(kWalkBlock, kWalkMinBlocks) tlas_walk_any_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, int n,
    const float4* __restrict__ nodes, int node_row4,
    const float4* __restrict__ clusters, int cluster_row4, float t_min,
    const float4* __restrict__ insts, int inst_row4, int num_clusters,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_prim,
    int* __restrict__ out_inst, int* __restrict__ out_stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Best b{t_cap[i], 0.0f, 0.0f, -1, -1};
  Counts c{};
  int stack[kStackCap];
  walk_any<W, L, true, Stats>(load_ray(orig, dir, i), orig, dir, i, nodes, node_row4, clusters,
                              cluster_row4, t_min, 0, stack, b, insts, inst_row4, num_clusters, &c);
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_prim[i] = b.id;
  out_inst[i] = b.inst;
  if constexpr (Stats) store_counts(out_stats, i, c);
}

// ---------------------------------------------------------------------------
// K1 and K2 on the walk: one single-level tree from row 0, as
// traverse_kernel<false|true> walks it (header note, "The closest-hit walk").
// ---------------------------------------------------------------------------

// K1 closest: nothing retires; t, u, v, prim of the nearest accepted hit.
template <int W, int L, bool Stats>
__global__ void __launch_bounds__(kWalkBlock, kWalkMinBlocks) traverse_walk_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, int n,
    const float4* __restrict__ nodes, int node_row4,
    const float4* __restrict__ clusters, int cluster_row4, float t_min,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_prim,
    int* __restrict__ out_stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Best b{t_cap[i], 0.0f, 0.0f, -1, -1};
  Counts c{};
  int stack[kStackCap];
  walk_closest<W, L, false, Stats>(load_ray(orig, dir, i), orig, dir, i, nodes, node_row4, clusters,
                                   cluster_row4, t_min, false, 0, stack, b, nullptr, 0, 0, &c);
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_prim[i] = b.id;
  if constexpr (Stats) store_counts(out_stats, i, c);
}

// K2 any: the first accepted hit, as traverse_kernel<true> writes it (its t,
// not 0). A ray capped at or below t_min is walked as the general loop walks
// it: its boxes are tested and no triangle can be accepted.
template <int W, int L, bool Stats>
__global__ void __launch_bounds__(kWalkBlock, kWalkMinBlocks) traverse_walk_any_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, int n,
    const float4* __restrict__ nodes, int node_row4,
    const float4* __restrict__ clusters, int cluster_row4, float t_min,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_prim,
    int* __restrict__ out_stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Best b{t_cap[i], 0.0f, 0.0f, -1, -1};
  Counts c{};
  int stack[kStackCap];
  walk_any<W, L, false, Stats>(load_ray(orig, dir, i), orig, dir, i, nodes, node_row4, clusters,
                               cluster_row4, t_min, 0, stack, b, nullptr, 0, 0, &c);
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_prim[i] = b.id;
  if constexpr (Stats) store_counts(out_stats, i, c);
}

// Launch `kern` on `stream`; the host shim runs its threads one after the
// other instead.
template <typename... P, typename... A>
void launch_kernel(void (*kern)(P...), unsigned grid, unsigned block,
                   size_t shared_bytes, cudaStream_t stream, A... args) {
#ifdef RT3_HOST_SHIM
  rt3_shim_launch(kern, grid, block, shared_bytes, args...);
#else
  kern<<<grid, block, shared_bytes, stream>>>(args...);
#endif
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

template <int W, int L, bool AnyHit>
int launch_segment_walk(
    const int* seg_list, const float* seg_entry, const int* seg_gmask,
    int n_steps, int n_words, const float* orig, const float* dir,
    const float* t_cap, const float* anyhit_row, long long n,
    const float* nodes, int max_nodes, int node_row, const float* clusters,
    int max_clusters, int cluster_row, float t_min, int seg_rays,
    int group_rays, int step_cull, float* out, int* out_stats, void* stream) {
  const unsigned grid = static_cast<unsigned>(n / kWalkBlock);
  const size_t shared_bytes = 3 * sizeof(int) * static_cast<size_t>(n_steps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
  const float4* clusters4 = reinterpret_cast<const float4*>(clusters);
  // The any-hit kernel reads no anyhit_row: every lane retires.
  if constexpr (AnyHit) {
    const auto kern = out_stats != nullptr ? segment_walk_any_kernel<W, L, true>
                                           : segment_walk_any_kernel<W, L, false>;
    launch_kernel(kern, grid, kWalkBlock, shared_bytes, st, seg_list, seg_entry, seg_gmask,
                  n_steps, n_words, orig, dir, t_cap, n, nodes4, max_nodes, node_row / 4,
                  clusters4, max_clusters, cluster_row / 4, t_min, seg_rays, group_rays,
                  step_cull, out, out_stats);
  } else {
    const auto kern = out_stats != nullptr ? segment_walk_kernel<W, L, true>
                                           : segment_walk_kernel<W, L, false>;
    launch_kernel(kern, grid, kWalkBlock, shared_bytes, st, seg_list, seg_entry, seg_gmask,
                  n_steps, n_words, orig, dir, t_cap, anyhit_row, n, nodes4, max_nodes,
                  node_row / 4, clusters4, max_clusters, cluster_row / 4, t_min, seg_rays,
                  group_rays, step_cull, out, out_stats);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int W, int L, bool AnyHit>
int launch_tlas_walk(const float* orig, const float* dir, const float* t_cap, int n,
                     const float* nodes, int node_row, const float* clusters,
                     int cluster_row, float t_min, const float* insts, int inst_row,
                     int num_clusters, float* out_t, float* out_u, float* out_v,
                     int* out_prim, int* out_inst, int* out_stats, void* stream) {
  const unsigned grid = static_cast<unsigned>((n + kWalkBlock - 1) / kWalkBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  decltype(&tlas_walk_kernel<W, L, false>) kern;
  if constexpr (AnyHit) {
    kern = out_stats != nullptr ? tlas_walk_any_kernel<W, L, true> : tlas_walk_any_kernel<W, L, false>;
  } else {
    kern = out_stats != nullptr ? tlas_walk_kernel<W, L, true> : tlas_walk_kernel<W, L, false>;
  }
  launch_kernel(kern, grid, kWalkBlock, 0, st, orig, dir, t_cap, n,
                reinterpret_cast<const float4*>(nodes), node_row / 4,
                reinterpret_cast<const float4*>(clusters), cluster_row / 4, t_min,
                reinterpret_cast<const float4*>(insts), inst_row / 4, num_clusters, out_t,
                out_u, out_v, out_prim, out_inst, out_stats);
  return static_cast<int>(cudaGetLastError());
}

template <int W, int L, bool AnyHit>
int launch_packet_walk(const float* orig, const float* dir, const float* t_cap, int n,
                       const float* nodes, int node_row, const float* clusters, int cluster_row,
                       float t_min, float* out_t, float* out_u, float* out_v, int* out_prim,
                       int* out_stats, void* stream) {
  const unsigned grid = static_cast<unsigned>((n + kWalkBlock - 1) / kWalkBlock);
  decltype(&traverse_walk_kernel<W, L, false>) kern;
  if constexpr (AnyHit) {
    kern = out_stats != nullptr ? traverse_walk_any_kernel<W, L, true> : traverse_walk_any_kernel<W, L, false>;
  } else {
    kern = out_stats != nullptr ? traverse_walk_kernel<W, L, true> : traverse_walk_kernel<W, L, false>;
  }
  launch_kernel(kern, grid, kWalkBlock, 0, static_cast<cudaStream_t>(stream), orig, dir, t_cap, n,
                reinterpret_cast<const float4*>(nodes), node_row / 4,
                reinterpret_cast<const float4*>(clusters), cluster_row / 4, t_min, out_t, out_u,
                out_v, out_prim, out_stats);
  return static_cast<int>(cudaGetLastError());
}

// The general loop on a stack of Cap entries (kStackCap or kDeepStackCap).
template <bool AnyHit, int Cap>
int launch(const float* orig, const float* dir, const float* t_cap, int n,
           const float* nodes, int node_row, const float* clusters,
           int cluster_row, int width, int leaf_size, float t_min,
           float* out_t, float* out_u, float* out_v, int* out_prim,
           int* out_stats, void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_stats != nullptr) {
      launch_kernel(traverse_stats_kernel<AnyHit, Cap>, grid, kBlock, 0, st,
          orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
          leaf_size, t_min, out_t, out_u, out_v, out_prim, out_stats);
    } else {
      launch_kernel(traverse_kernel<AnyHit, Cap>, grid, kBlock, 0, st,
          orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
          leaf_size, t_min, out_t, out_u, out_v, out_prim);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool AnyHit, int Cap>
int launch_tlas(const float* orig, const float* dir, const float* t_cap, int n,
                const float* nodes, int node_row, const float* clusters,
                int cluster_row, int width, int leaf_size, float t_min,
                const float* insts, int inst_row, int num_clusters,
                float* out_t, float* out_u, float* out_v, int* out_prim,
                int* out_inst, int* out_stats, void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_stats != nullptr) {
      launch_kernel(tlas_stats_kernel<AnyHit, Cap>, grid, kBlock, 0, st,
          orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
          leaf_size, t_min, insts, inst_row, num_clusters, out_t, out_u, out_v,
          out_prim, out_inst, out_stats);
    } else {
      launch_kernel(tlas_kernel<AnyHit, Cap>, grid, kBlock, 0, st,
          orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
          leaf_size, t_min, insts, inst_row, num_clusters, out_t, out_u, out_v,
          out_prim, out_inst);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <int Cap>
int launch_segments(
    int any_hit, const int* seg_list, const float* seg_entry,
    const int* seg_gmask, int n_steps, int n_words, const float* orig,
    const float* dir, const float* t_cap, const float* anyhit_row,
    long long n, const float* nodes, int max_nodes, int node_row,
    const float* clusters, int max_clusters, int cluster_row, int width,
    int leaf_size, float t_min, int seg_rays, int group_rays, int step_cull,
    float* out, int* out_stats, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kBlock - 1) / kBlock;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned grid = static_cast<unsigned>(blocks);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_stats != nullptr && any_hit) {
      launch_kernel(segment_stats_kernel<true, Cap>, grid, kBlock, 0, st,
          seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
          anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
          cluster_row, width, leaf_size, t_min, seg_rays, group_rays,
          step_cull, out, out_stats);
    } else if (out_stats != nullptr) {
      launch_kernel(segment_stats_kernel<false, Cap>, grid, kBlock, 0, st,
          seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
          anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
          cluster_row, width, leaf_size, t_min, seg_rays, group_rays,
          step_cull, out, out_stats);
    } else if (any_hit) {
      launch_kernel(segment_kernel<true, Cap>, grid, kBlock, 0, st,
          seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
          anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
          cluster_row, width, leaf_size, t_min, seg_rays, group_rays,
          step_cull, out);
    } else {
      launch_kernel(segment_kernel<false, Cap>, grid, kBlock, 0, st,
          seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
          anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
          cluster_row, width, leaf_size, t_min, seg_rays, group_rays,
          step_cull, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// What the general loop's entry points accept of the tables' stack need.
bool general_need_ok(int stack_need) {
  return stack_need >= 1 && stack_need <= kDeepStackCap;
}

// What the walk kernels' 16-byte loads and block layout assume of a K3
// launch, and the stack they hold.
bool segment_walk_ok(int n_steps, int n_words, long long n, const float* nodes,
                     int node_row, const float* clusters, int cluster_row,
                     int seg_rays, int group_rays, int stack_need) {
  return seg_rays >= kWalkBlock && seg_rays % kWalkBlock == 0 && group_rays >= 1 &&
         group_rays % kWalkBlock == 0 && seg_rays % group_rays == 0 &&
         (seg_rays / group_rays) <= 32 * n_words && n % seg_rays == 0 &&
         n / kWalkBlock <= 0x7fffffffLL && n_steps >= 0 && n_steps <= 4096 &&
         node_row % 4 == 0 && cluster_row % 4 == 0 && aligned16(nodes) &&
         aligned16(clusters) && stack_need >= 1 && stack_need <= kStackCap;
}

bool tlas_walk_ok(int width, int leaf_size, const float* nodes, int node_row,
                  const float* clusters, int cluster_row, const float* insts,
                  int inst_row, int stack_need) {
  return width == 16 && leaf_size == 12 && inst_row >= 16 && inst_row % 4 == 0 &&
         node_row % 4 == 0 && cluster_row % 4 == 0 && aligned16(nodes) &&
         aligned16(clusters) && aligned16(insts) && stack_need >= 1 &&
         stack_need <= kStackCap;
}

// What the K1/K2 walk kernels assume of a launch and the stack they hold.
bool packet_walk_ok(int width, int leaf_size, const float* nodes, int node_row,
                    const float* clusters, int cluster_row, int stack_need) {
  return width == 16 && leaf_size == 12 && node_row % 4 == 0 && cluster_row % 4 == 0 &&
         aligned16(nodes) && aligned16(clusters) && stack_need >= 1 && stack_need <= kStackCap;
}

template <bool AnyHit>
int walk_packet(const float* orig, const float* dir, const float* t_cap, int n,
                const float* nodes, int node_row, const float* clusters, int cluster_row,
                int width, int leaf_size, float t_min, int stack_need, float* out_t,
                float* out_u, float* out_v, int* out_prim, int* out_stats, void* stream) {
  if (!packet_walk_ok(width, leaf_size, nodes, node_row, clusters, cluster_row, stack_need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  return launch_packet_walk<16, 12, AnyHit>(orig, dir, t_cap, n, nodes, node_row, clusters,
                                            cluster_row, t_min, out_t, out_u, out_v, out_prim,
                                            out_stats, stream);
}

template <bool AnyHit>
int walk_segments(
    const int* seg_list, const float* seg_entry, const int* seg_gmask,
    int n_steps, int n_words, const float* orig, const float* dir,
    const float* t_cap, const float* anyhit_row, long long n,
    const float* nodes, int max_nodes, int node_row, const float* clusters,
    int max_clusters, int cluster_row, int width, int leaf_size, float t_min,
    int seg_rays, int group_rays, int step_cull, int stack_need, float* out,
    int* out_stats, void* stream) {
  if (!segment_walk_ok(n_steps, n_words, n, nodes, node_row, clusters, cluster_row,
                       seg_rays, group_rays, stack_need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  if (width == 16 && leaf_size == 12) {
    return launch_segment_walk<16, 12, AnyHit>(
        seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
        anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
        cluster_row, t_min, seg_rays, group_rays, step_cull, out, out_stats,
        stream);
  }
  if (width == 16 && leaf_size == 24) {
    return launch_segment_walk<16, 24, AnyHit>(
        seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
        anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters,
        cluster_row, t_min, seg_rays, group_rays, step_cull, out, out_stats,
        stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool AnyHit>
int walk_tlas(const float* orig, const float* dir, const float* t_cap, int n,
              const float* nodes, int node_row, const float* clusters, int cluster_row,
              int width, int leaf_size, float t_min, const float* insts, int inst_row,
              int num_clusters, int stack_need, float* out_t, float* out_u, float* out_v,
              int* out_prim, int* out_inst, int* out_stats, void* stream) {
  if (!tlas_walk_ok(width, leaf_size, nodes, node_row, clusters, cluster_row, insts,
                    inst_row, stack_need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  return launch_tlas_walk<16, 12, AnyHit>(orig, dir, t_cap, n, nodes, node_row, clusters,
                                          cluster_row, t_min, insts, inst_row, num_clusters,
                                          out_t, out_u, out_v, out_prim, out_inst, out_stats,
                                          stream);
}

}  // namespace

// Every entry point takes `stack_need`, the tables' worst-case stack need
// (two-level tables: with the walk's marker), and refuses tables whose
// need its kernels cannot hold. The general loop's entry points launch the
// kStackCap instantiation where the need fits it, else the kDeepStackCap
// one, and refuse a need above that.

// K1/K2 (and their K5 form when out_stats, int32 [n, 5], is not null).
extern "C" int rt3_traverse_closest(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, int stack_need, float* out_t,
    float* out_u, float* out_v, int* out_prim, int* out_stats, void* stream) {
  if (width < 1 || width > kMaxWidth || !general_need_ok(stack_need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto fn = stack_need > kStackCap ? launch<false, kDeepStackCap> : launch<false, kStackCap>;
  return fn(orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
            leaf_size, t_min, out_t, out_u, out_v, out_prim, out_stats, stream);
}

extern "C" int rt3_traverse_any(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, int stack_need, float* out_t,
    float* out_u, float* out_v, int* out_prim, int* out_stats, void* stream) {
  if (width < 1 || width > kMaxWidth || !general_need_ok(stack_need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto fn = stack_need > kStackCap ? launch<true, kDeepStackCap> : launch<true, kStackCap>;
  return fn(orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
            leaf_size, t_min, out_t, out_u, out_v, out_prim, out_stats, stream);
}

// K4 on the general loop, closest and any hit. out_inst holds the hit
// instance, -1 on a miss; out_stats as for K1/K2.
extern "C" int rt3_traverse_tlas_closest(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, const float* insts, int inst_row,
    int num_clusters, int stack_need, float* out_t, float* out_u, float* out_v,
    int* out_prim, int* out_inst, int* out_stats, void* stream) {
  if (width < 1 || width > kMaxWidth || inst_row < 13 || !general_need_ok(stack_need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto fn = stack_need > kStackCap ? launch_tlas<false, kDeepStackCap>
                                         : launch_tlas<false, kStackCap>;
  return fn(orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width, leaf_size,
            t_min, insts, inst_row, num_clusters, out_t, out_u, out_v, out_prim, out_inst,
            out_stats, stream);
}

extern "C" int rt3_traverse_tlas_any(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, const float* insts, int inst_row,
    int num_clusters, int stack_need, float* out_t, float* out_u, float* out_v,
    int* out_prim, int* out_inst, int* out_stats, void* stream) {
  if (width < 1 || width > kMaxWidth || inst_row < 13 || !general_need_ok(stack_need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto fn = stack_need > kStackCap ? launch_tlas<true, kDeepStackCap>
                                         : launch_tlas<true, kStackCap>;
  return fn(orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width, leaf_size,
            t_min, insts, inst_row, num_clusters, out_t, out_u, out_v, out_prim, out_inst,
            out_stats, stream);
}

// K3 on the general loop. out is [4, n]: rows t, u, v, prim id as float.
// anyhit_row may be null; out_stats as for K1/K2.
extern "C" int rt3_traverse_segments(
    int any_hit, const int* seg_list, const float* seg_entry,
    const int* seg_gmask, int n_steps, int n_words, const float* orig,
    const float* dir, const float* t_cap, const float* anyhit_row,
    long long n, const float* nodes, int max_nodes, int node_row,
    const float* clusters, int max_clusters, int cluster_row, int width,
    int leaf_size, float t_min, int seg_rays, int group_rays, int step_cull,
    int stack_need, float* out, int* out_stats, void* stream) {
  if (width < 1 || width > kMaxWidth || seg_rays < kBlock ||
      seg_rays % kBlock != 0 || group_rays < 1 || seg_rays % group_rays != 0 ||
      (seg_rays / group_rays) > 32 * n_words || n % seg_rays != 0 ||
      !general_need_ok(stack_need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto fn = stack_need > kStackCap ? launch_segments<kDeepStackCap>
                                         : launch_segments<kStackCap>;
  return fn(any_hit, seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir, t_cap,
            anyhit_row, n, nodes, max_nodes, node_row, clusters, max_clusters, cluster_row,
            width, leaf_size, t_min, seg_rays, group_rays, step_cull, out, out_stats, stream);
}

// K3 on the walk (segment_walk_kernel, segment_walk_any_kernel), for the
// shapes it is compiled for: width 16 with leaf size 12 or 24. Any other
// shape, a row length that is not whole 16-byte words, a table that does
// not start on one, a group that is not whole blocks or a stack need above
// kStackCap is refused: the caller chooses between these entry points and
// rt3_traverse_segments, which keeps the general loop. Arguments as
// rt3_traverse_segments without any_hit; the any-hit one reads no
// anyhit_row.
extern "C" int rt3_walk_segments_closest(
    const int* seg_list, const float* seg_entry, const int* seg_gmask,
    int n_steps, int n_words, const float* orig, const float* dir,
    const float* t_cap, const float* anyhit_row, long long n,
    const float* nodes, int max_nodes, int node_row, const float* clusters,
    int max_clusters, int cluster_row, int width, int leaf_size, float t_min,
    int seg_rays, int group_rays, int step_cull, int stack_need, float* out,
    int* out_stats, void* stream) {
  return walk_segments<false>(seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir,
                              t_cap, anyhit_row, n, nodes, max_nodes, node_row, clusters,
                              max_clusters, cluster_row, width, leaf_size, t_min, seg_rays,
                              group_rays, step_cull, stack_need, out, out_stats, stream);
}

extern "C" int rt3_walk_segments_any(
    const int* seg_list, const float* seg_entry, const int* seg_gmask,
    int n_steps, int n_words, const float* orig, const float* dir,
    const float* t_cap, const float* anyhit_row, long long n,
    const float* nodes, int max_nodes, int node_row, const float* clusters,
    int max_clusters, int cluster_row, int width, int leaf_size, float t_min,
    int seg_rays, int group_rays, int step_cull, int stack_need, float* out,
    int* out_stats, void* stream) {
  return walk_segments<true>(seg_list, seg_entry, seg_gmask, n_steps, n_words, orig, dir,
                             t_cap, anyhit_row, n, nodes, max_nodes, node_row, clusters,
                             max_clusters, cluster_row, width, leaf_size, t_min, seg_rays,
                             group_rays, step_cull, stack_need, out, out_stats, stream);
}

// K4 on the walk (tlas_walk_kernel, tlas_walk_any_kernel): width 16, leaf
// size 12; other shapes, unaligned tables and a stack need above kStackCap
// are refused as above. Arguments as rt3_traverse_tlas_closest, which keeps
// the general loop.
extern "C" int rt3_walk_tlas_closest(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, const float* insts, int inst_row,
    int num_clusters, int stack_need, float* out_t, float* out_u, float* out_v,
    int* out_prim, int* out_inst, int* out_stats, void* stream) {
  return walk_tlas<false>(orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
                          leaf_size, t_min, insts, inst_row, num_clusters, stack_need, out_t,
                          out_u, out_v, out_prim, out_inst, out_stats, stream);
}

extern "C" int rt3_walk_tlas_any(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, const float* insts, int inst_row,
    int num_clusters, int stack_need, float* out_t, float* out_u, float* out_v,
    int* out_prim, int* out_inst, int* out_stats, void* stream) {
  return walk_tlas<true>(orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
                         leaf_size, t_min, insts, inst_row, num_clusters, stack_need, out_t,
                         out_u, out_v, out_prim, out_inst, out_stats, stream);
}

// K1/K2 on the walk (traverse_walk_kernel, traverse_walk_any_kernel): width
// 16, leaf size 12; other shapes, unaligned tables and a stack need above
// kStackCap are refused as above. Arguments as rt3_traverse_closest, which
// keeps the general loop.
extern "C" int rt3_walk_closest(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, int stack_need, float* out_t,
    float* out_u, float* out_v, int* out_prim, int* out_stats, void* stream) {
  return walk_packet<false>(orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
                            leaf_size, t_min, stack_need, out_t, out_u, out_v, out_prim, out_stats,
                            stream);
}

extern "C" int rt3_walk_any(
    const float* orig, const float* dir, const float* t_cap, int n,
    const float* nodes, int node_row, const float* clusters, int cluster_row,
    int width, int leaf_size, float t_min, int stack_need, float* out_t,
    float* out_u, float* out_v, int* out_prim, int* out_stats, void* stream) {
  return walk_packet<true>(orig, dir, t_cap, n, nodes, node_row, clusters, cluster_row, width,
                           leaf_size, t_min, stack_need, out_t, out_u, out_v, out_prim, out_stats,
                           stream);
}

// Pass markers (graph/graph.py): boundary I of a frame graph's baked pass
// order is launched before pass I, and boundary len(order) after the last
// pass, on the frame's stream, so that a captured graph carries them and
// every replay puts them in a device trace between its passes' kernels. The
// boundary is in the kernel's name; the kernel does nothing.
namespace {

constexpr int kPassMarks = 16;

template <int I>
__global__ void pass_mark_kernel() {}

template <int... I>
int launch_pass_mark(int boundary, cudaStream_t stream, std::integer_sequence<int, I...>) {
  static void (*const kernels[])() = {pass_mark_kernel<I>...};
  launch_kernel(kernels[boundary], 1, 1, 0, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Boundary 0 <= boundary < kPassMarks; another is refused.
extern "C" int rt3_pass_mark(int boundary, void* stream) {
  if (boundary < 0 || boundary >= kPassMarks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_pass_mark(boundary, static_cast<cudaStream_t>(stream),
                          std::make_integer_sequence<int, kPassMarks>{});
}
