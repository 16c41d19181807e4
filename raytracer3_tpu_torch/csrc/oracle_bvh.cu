// The reference's device loops, closest and any hit: the LBVH build (A, B),
// the LBVH walk (C), the cluster-BVH walk (D), the wide-BVH walk (E) and the
// per-ray work of K3's rounds driver around its sort and K3 (F1, F2).
//
// Replaces the reference's `jax.lax.while_loop`s, which XLA compiles into
// the device program of a jitted step (no Pallas: the reference leaves them
// to XLA):
//   A `lbvh_topology_kernel`     raytracer3_tpu/ops/bvh.py:108, :120, :139
//                                (range direction and length, split)
//   B `lbvh_fit_kernel`          raytracer3_tpu/ops/bvh.py:183 (the fit)
//   C `lbvh_walk_kernel<Any>`    raytracer3_tpu/ops/traverse.py:132
//   D `cluster_walk_kernel<Any, Cap>`  raytracer3_tpu/ops/cluster_bvh.py:451
//   E `wide_walk_kernel<Any>`    raytracer3_tpu/ops/wide_bvh.py:284
//   F1 `rounds_pick_kernel`, F2 `rounds_merge_kernel`
//                                raytracer3_tpu/ops/treelets.py:891, the body
//                                of the rounds loop (its sort, segment
//                                metadata and K3 launch stay outside)
// Their plain versions are the eager loops of ops/bvh.py
// (`build_lbvh_aabbs_plain`), ops/traverse.py (`bvh_intersect_plain`),
// ops/cluster_bvh.py (`cbvh_intersect_plain`), ops/wide_bvh.py
// (`wbvh_intersect_plain`) and ops/treelets.py
// (`treelet_intersect_rounds_plain`), which read a flag on the host every
// turn or round and so cannot run inside a captured CUDA graph; these
// kernels read nothing back, so every backend of the port runs as a
// compiled frame. The rounds driver on the card (`treelets.rounds_on_device`)
// runs the reference's bound, `max_rounds or K` rounds, every one: after a
// round in which no ray has a candidate, F1 finds none again, every K3
// step has group mask 0 and F2 takes nothing, so the extra rounds change no
// output and no count. Wrappers: ops/oracle_kernels.py.
//
// Every output equals the plain version's to the bit (the tests under
// csrc/host_shim.h, chip_smoke.py on the card):
//   - A evaluates the plain loops' δ(i, j) on the same int64 Morton keys in
//     the same order, one thread per internal node: the vectorised loops
//     become per-thread loops that stop on the same conditions.
//   - B is the fixed point of the plain fit: each internal box is the
//     IEEE 754-2019 minimum / maximum over its subtree (a NaN operand gives
//     the canonical quiet NaN, -0 is below +0), which is associative and
//     commutative, so the order the threads arrive in cannot show.
//   - C, D and E keep the plain walks' visit order, stack edges and
//     operation order per ray; F1 and F2 do the plain round's elementwise
//     work per ray in its order; the source builds with --fmad=false, so no
//     multiply-add is contracted, as PyTorch's separate elementwise kernels
//     contract none.
//
// What bounds A-D on an H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's
// lbvh512_phase, T = 524,288 padded triangles, 262,144 rays; PERF.md).
// A is integer work, ~10 δ evaluations a node, each two dependent loads of
// 8-byte keys that neighbouring threads share: 0.043 ms against a 0.0038 ms
// bytes bound, latency-bound. B is a scattered climb: each level reads two
// child boxes the other thread wrote, through L2 (__ldcg) after an atomic,
// and half the threads stop at each level: 0.149 ms (its counter memset
// included) against 0.011 ms. C is one thread per ray with a 64-entry stack
// in local memory and node rows read in place, ~40 node and ~2.5 leaf pops
// a ray: 0.27-0.39 ms, tens of times above its bound (the larger of those
// pops' operations and the rows they read, each once; PERF.md). D tests and
// sorts all 8 children of every popped node: 1.38-1.55 ms, 43-67x above its
// operation-side bound. E is D's shape over the collapsed LBVH's f32 boxes
// and 4-triangle leaves; F1 and F2 are one pass each over the rays (PERF.md
// has their times).
// The walks are kept simple and right: the walks of traverse.cu (16-byte
// row loads, fixed widths, children ranked over the taken bits only) are
// the models for making them fast.
//
// The cluster walk's stack holds max(32, 7·depth + 1) entries with a
// clamped pointer, the plain version's; `Cap` is the array the kernel
// compiles (128, or 512 past it), and the entry point refuses an entry
// count beyond 512 (a tree deeper than 73 levels, which the build refuses
// at 64). The wide walk's holds the reference's 48.

#ifdef RT3_HOST_SHIM
#include "host_shim.h"  // g++ build for the CPU tests: one thread at a time
#else
#include <cuda_runtime.h>
#endif

#include <cstddef>

namespace {

constexpr int kBlock = 128;
constexpr int kLbvhStack = 64;  // ops/traverse.py STACK_DEPTH
constexpr int kClusterStackCap = 128;
constexpr int kClusterDeepStackCap = 512;
constexpr int kWideStack = 48;  // ops/wide_bvh.py STACK_DEPTH
constexpr int kWideMax = 8;     // the widest wide node the walk takes (ops/wide_bvh.py WIDTH)
constexpr int kLeafCountBits = 4;  // a wide leaf code's count field

// torch.minimum / torch.maximum as the walks' slab tests use them: a NaN
// operand propagates (fminf would drop it), so a NaN ray misses every box.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// IEEE 754-2019 minimum / maximum, the build's (ops/bvh.py `ieee_minimum`):
// NaN in, canonical NaN out; -0 is below +0.
__device__ __forceinline__ float canonical_nan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float min_ieee(float a, float b) {
  if (a != a || b != b) return canonical_nan();
  if (a < b) return a;
  if (b < a) return b;
  return __float_as_int(a) < 0 ? a : b;
}
__device__ __forceinline__ float max_ieee(float a, float b) {
  if (a != a || b != b) return canonical_nan();
  if (a > b) return a;
  if (b > a) return b;
  return __float_as_int(a) < 0 ? b : a;
}

// 1 / where(|a| < 1e-12, 1e-12, a).
__device__ __forceinline__ float clamped(float a) { return fabsf(a) < 1e-12f ? 1e-12f : a; }

struct Vec {
  float x, y, z;
};

__device__ __forceinline__ Vec load3(const float* p) { return Vec{p[0], p[1], p[2]}; }
__device__ __forceinline__ Vec sub(Vec a, Vec b) { return Vec{a.x - b.x, a.y - b.y, a.z - b.z}; }
// mathx.cross and mathx.dot, term by term.
__device__ __forceinline__ Vec cross(Vec a, Vec b) {
  return Vec{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float dot(Vec a, Vec b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

struct Best {
  float t, u, v;
  int id;
};

// intersect.ray_aabb: (t_near, hit) of the slab test, NaN-propagating.
__device__ __forceinline__ bool slab(Vec o, Vec inv, const float* bmin, const float* bmax,
                                     float t_min, float t_max, float* t_near) {
  const float ax = (bmin[0] - o.x) * inv.x, bx = (bmax[0] - o.x) * inv.x;
  const float ay = (bmin[1] - o.y) * inv.y, by = (bmax[1] - o.y) * inv.y;
  const float az = (bmin[2] - o.z) * inv.z, bz = (bmax[2] - o.z) * inv.z;
  const float tn = max_nan(max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)), min_nan(az, bz)), t_min);
  const float tf = min_nan(min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)), max_nan(az, bz)), t_max);
  *t_near = tn;
  return tn <= tf;
}

// Moller-Trumbore over (v0, e1, e2) in intersect.ray_triangle's order
// (the LBVH, eps 1e-7) or cbvh_intersect's (the cluster rows, eps 1e-9):
// (t, u, v), and whether the ray hits in (t_min, t_max).
__device__ __forceinline__ bool triangle(Vec o, Vec d, Vec v0, Vec e1, Vec e2, float eps, float t_min,
                                         float* t, float* u, float* v, float t_max) {
  const Vec p = cross(d, e2);
  const float det = dot(e1, p);
  const bool ok = fabsf(det) > eps;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const Vec tv = sub(o, v0);
  const float uu = dot(tv, p) * inv_det;
  const Vec q = cross(tv, e1);
  const float vv = dot(d, q) * inv_det;
  const float tt = dot(e2, q) * inv_det;
  *t = tt;
  *u = uu;
  *v = vv;
  return ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > t_min && tt < t_max;
}

// ---------------------------------------------------------------------------
// A: Karras topology, one thread per internal node
// ---------------------------------------------------------------------------

// δ(i, j): common-prefix length of the 64-bit keys (code << 32 | index),
// -1 where j is out of range; the plain version's `_make_delta` on int64
// codes (the test `cx != 0` is on all 64 bits, the count on the low 32).
__device__ __forceinline__ int delta(const long long* __restrict__ codes, long long n, long long i,
                                     long long j) {
  if (j < 0 || j >= n) return -1;
  const long long cx = codes[i] ^ codes[j];
  if (cx != 0) return __clz(static_cast<int>(static_cast<unsigned>(cx & 0xffffffffLL)));
  return 32 + __clz(static_cast<int>(static_cast<unsigned>((i ^ j) & 0xffffffffLL)));
}

__global__ void __launch_bounds__(kBlock) lbvh_topology_kernel(
    const long long* __restrict__ codes, int t, int* __restrict__ left, int* __restrict__ right,
    int* __restrict__ parent) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n = t;
  if (i >= n - 1) return;
  const long long d = delta(codes, n, i, i + 1) > delta(codes, n, i, i - 1) ? 1 : -1;
  const int delta_min = delta(codes, n, i, i - d);
  // Upper bound on the range length, doubled while δ(i, i + lmax·d) > δmin.
  long long lmax = 2;
  while (delta(codes, n, i, i + lmax * d) > delta_min) lmax *= 2;
  // Binary descent to the exact length l < lmax.
  long long l = 0;
  for (long long step = lmax / 2; step >= 1; step /= 2) {
    if (delta(codes, n, i, i + (l + step) * d) > delta_min) l += step;
  }
  const long long j = i + l * d;
  // Split: the largest s with δ(i, i + (s + ts)·d) > δ(i, j), ts = ceil(l / 2^k).
  const int delta_node = delta(codes, n, i, j);
  long long s = 0, div = 2, ts = (l + 1) / 2;
  while (ts >= 1) {
    if (delta(codes, n, i, i + (s + ts) * d) > delta_node) s += ts;
    div *= 2;
    ts = ts <= 1 ? 0 : (l + div - 1) / div;
  }
  const long long gamma = i + s * d + (d < 0 ? d : 0);
  const long long lo = i < j ? i : j, hi = i < j ? j : i;
  // A child is a leaf when its range is one element; leaf k is node (T-1)+k.
  const int lc = static_cast<int>(lo == gamma ? gamma + n - 1 : gamma);
  const int rc = static_cast<int>(hi == gamma + 1 ? gamma + n : gamma + 1);
  left[i] = lc;
  right[i] = rc;
  parent[lc] = static_cast<int>(i);
  parent[rc] = static_cast<int>(i);
  if (i == 0) parent[0] = -1;  // the root's
}

// ---------------------------------------------------------------------------
// B: bottom-up fit, one thread per leaf
// ---------------------------------------------------------------------------

// Each thread climbs from its leaf. At a parent the first thread to arrive
// stops; the second (its child's box and the other child's are written,
// fenced before the other thread's atomic) takes the union and climbs on,
// up to the root. `arrivals` [T-1] is zero at the launch.
__global__ void __launch_bounds__(kBlock) lbvh_fit_kernel(
    int t, const int* __restrict__ left, const int* __restrict__ right, const int* __restrict__ parent,
    int* arrivals, float* node_min, float* node_max) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= t) return;
  int node = static_cast<int>(t - 1 + k);
  while (node != 0) {
    const int p = parent[node];
    __threadfence();
    if (atomicAdd(&arrivals[p], 1) == 0) return;
    __threadfence();
    const int l = left[p], r = right[p];
    for (int c = 0; c < 3; ++c) {
      node_min[3 * p + c] = min_ieee(__ldcg(&node_min[3 * l + c]), __ldcg(&node_min[3 * r + c]));
      node_max[3 * p + c] = max_ieee(__ldcg(&node_max[3 * l + c]), __ldcg(&node_max[3 * r + c]));
    }
    node = p;
  }
}

// ---------------------------------------------------------------------------
// C: the LBVH walk, one thread per ray
// ---------------------------------------------------------------------------

// The plain version's edges: a push at or above 64 entries is dropped while
// the pointer still counts it; a pop above the stack reads its top entry;
// the near child (tl <= tr: the left one on a tie) pops first; an any-hit
// ray retires on its first accepted hit. A popped entry has always been
// written: the pointer passes a slot only by a push into it.
template <bool AnyHit>
__global__ void __launch_bounds__(kBlock) lbvh_walk_kernel(
    const float* __restrict__ node_min, const float* __restrict__ node_max, const int* __restrict__ left,
    const int* __restrict__ right, const int* __restrict__ leaf_tri, int t_tris,
    const float* __restrict__ v0, const float* __restrict__ v1, const float* __restrict__ v2,
    const float* __restrict__ orig, const float* __restrict__ dir, const float* __restrict__ t_cap,
    long long n, float t_min, float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_id) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t_internal = t_tris - 1;
  const Vec o = load3(orig + 3 * i), d = load3(dir + 3 * i);
  const Vec inv{1.0f / clamped(d.x), 1.0f / clamped(d.y), 1.0f / clamped(d.z)};
  Best b{t_cap[i], 0.0f, 0.0f, -1};
  int stack[kLbvhStack];
  stack[0] = 0;  // the root
  int sp = 1;
  while (sp > 0) {
    const int node = stack[sp - 1 < kLbvhStack - 1 ? sp - 1 : kLbvhStack - 1];
    sp -= 1;
    if (node >= t_internal) {
      int leaf = node - t_internal;
      leaf = leaf < t_tris - 1 ? leaf : t_tris - 1;
      const int tri = leaf_tri[leaf];
      const Vec a = load3(v0 + 3 * static_cast<long long>(tri));
      const Vec e1 = sub(load3(v1 + 3 * static_cast<long long>(tri)), a);
      const Vec e2 = sub(load3(v2 + 3 * static_cast<long long>(tri)), a);
      float tt, uu, vv;
      if (triangle(o, d, a, e1, e2, 1e-7f, t_min, &tt, &uu, &vv, b.t)) {
        b = Best{tt, uu, vv, tri};
      }
    } else {
      const int lc = left[node], rc = right[node];
      float tl, tr;
      const bool hl = slab(o, inv, node_min + 3 * lc, node_max + 3 * lc, t_min, b.t, &tl);
      const bool hr = slab(o, inv, node_min + 3 * rc, node_max + 3 * rc, t_min, b.t, &tr);
      const bool l_first = tl <= tr;
      const int near = l_first ? lc : rc, far = l_first ? rc : lc;
      const bool push_near = l_first ? hl : hr, push_far = l_first ? hr : hl;
      // Far first, so the near child pops first.
      if (push_far) {
        if (sp < kLbvhStack) stack[sp] = far;
        ++sp;
      }
      if (push_near) {
        if (sp < kLbvhStack) stack[sp] = near;
        ++sp;
      }
    }
    if (AnyHit && b.id >= 0) break;
  }
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_id[i] = b.id;
}

// ---------------------------------------------------------------------------
// D: the cluster-BVH walk, one thread per ray
// ---------------------------------------------------------------------------

// One compare-swap of `_sort8_desc`'s network: descending keys (far
// first), a tie left in slot order.
__device__ __forceinline__ void cswap(float* key, float* code, bool* valid, int a, int c) {
  if (key[a] < key[c]) {
    const float tk = key[a], tc = code[a];
    const bool tv = valid[a];
    key[a] = key[c];
    code[a] = code[c];
    valid[a] = valid[c];
    key[c] = tk;
    code[c] = tc;
    valid[c] = tv;
  }
}

// The 19 pairs of `_SORT8_PAIRS`, in order, so that children with equal
// keys push as in the plain version.
__device__ __forceinline__ void sort8_desc(float* key, float* code, bool* valid) {
  cswap(key, code, valid, 0, 1); cswap(key, code, valid, 2, 3); cswap(key, code, valid, 4, 5);
  cswap(key, code, valid, 6, 7); cswap(key, code, valid, 0, 2); cswap(key, code, valid, 1, 3);
  cswap(key, code, valid, 4, 6); cswap(key, code, valid, 5, 7); cswap(key, code, valid, 1, 2);
  cswap(key, code, valid, 5, 6); cswap(key, code, valid, 0, 4); cswap(key, code, valid, 3, 7);
  cswap(key, code, valid, 1, 5); cswap(key, code, valid, 2, 6); cswap(key, code, valid, 1, 4);
  cswap(key, code, valid, 3, 6); cswap(key, code, valid, 2, 4); cswap(key, code, valid, 3, 5);
  cswap(key, code, valid, 3, 4);
}

// `boxes` [M, 48]: the walk's child boxes (ops/cluster_bvh.walk_boxes: the
// node rows' boxes rounded outwards, then to bfloat16); node codes from the
// node rows' lanes 48-55 (node >= 0, empty -1.0, cluster c at -c-2);
// cluster rows of L x (v0 e1 e2) and tri_id [C, L]. Stack entries are the
// float codes; `entries` = max(32, 7·depth + 1), the pointer clamped there.
template <bool AnyHit, int Cap>
__global__ void __launch_bounds__(kBlock) cluster_walk_kernel(
    const float* __restrict__ boxes, const float* __restrict__ nodes, int node_row, int num_nodes,
    const float* __restrict__ clusters, int cluster_row, const int* __restrict__ tri_id,
    int num_clusters, int leaf_size, int entries, const float* __restrict__ orig,
    const float* __restrict__ dir, const float* __restrict__ t_cap, long long n, float t_min,
    float* __restrict__ out_t, float* __restrict__ out_u, float* __restrict__ out_v,
    int* __restrict__ out_id) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Vec o = load3(orig + 3 * i);
  const Vec d0 = load3(dir + 3 * i);
  const Vec d{clamped(d0.x), clamped(d0.y), clamped(d0.z)};
  const Vec inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  Best b{t_cap[i], 0.0f, 0.0f, -1};
  float stack[Cap];
  stack[0] = 0.0f;  // the root's code
  int sp = 1;
  while (sp > 0) {
    const float entry = stack[sp - 1];
    sp -= 1;
    if (entry < -1.0f) {
      long long c = static_cast<long long>(-entry - 2.0f);
      c = c < 0 ? 0 : (c > num_clusters - 1 ? num_clusters - 1 : c);
      const float* row = clusters + c * cluster_row;
      const int* ids = tri_id + c * leaf_size;
      for (int j = 0; j < leaf_size; ++j) {
        float tt, uu, vv;
        const bool hit = triangle(o, d, load3(row + 9 * j), load3(row + 9 * j + 3), load3(row + 9 * j + 6),
                                  1e-9f, t_min, &tt, &uu, &vv, b.t);
        if (hit && ids[j] >= 0) b = Best{tt, uu, vv, ids[j]};
      }
    } else if (entry >= 0.0f) {
      long long m = static_cast<long long>(entry);
      m = m > num_nodes - 1 ? num_nodes - 1 : m;
      const float* bx = boxes + 48 * m;
      const float* codes = nodes + m * node_row + 48;
      float key[8], code[8];
      bool valid[8];
      for (int k = 0; k < 8; ++k) {
        float tn;
        const bool hit = slab(o, inv, bx + 3 * k, bx + 24 + 3 * k, t_min, b.t, &tn);
        code[k] = codes[k];
        valid[k] = hit && fabsf(code[k] + 1.0f) > 0.25f;
        key[k] = valid[k] ? tn : __int_as_float(static_cast<int>(0xff800000u));
      }
      sort8_desc(key, code, valid);
      for (int k = 0; k < 8; ++k) {
        if (valid[k]) {
          if (sp < entries) stack[sp] = code[k];
          sp = sp + 1 < entries ? sp + 1 : entries;
        }
      }
    }
    if (AnyHit && b.id >= 0) break;
  }
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_id[i] = b.id;
}

// ---------------------------------------------------------------------------
// E: the wide-BVH walk, one thread per ray
// ---------------------------------------------------------------------------

// The plain walk's edges (ops/wide_bvh.wbvh_intersect_plain): 48 entries,
// and a push at 48 is dropped with the pointer left at 48 (not counted on,
// unlike C); an entry is a child code (node >= 0, leaf range < -1, empty
// -1, never pushed); the hit children go on the stack far to near in the
// order of a stable argsort of -t_near, so children with equal keys keep
// slot order (the lower slot is pushed first and pops last): an insertion
// sort that moves an entry only past strictly smaller keys. A leaf
// -(start << 4 | count) - 2 tests triangles start .. start + min(count,
// leaf_size) - 1 of the leaf order, each index clamped to [0, T-1], under
// the running best t; the id is tri_order[index]. An any-hit ray stops
// after the pop on which it first holds a hit.
template <bool AnyHit>
__global__ void __launch_bounds__(kBlock) wide_walk_kernel(
    const float* __restrict__ child_min, const float* __restrict__ child_max,
    const int* __restrict__ child_code, int num_nodes, int width, const int* __restrict__ tri_order,
    const float* __restrict__ v0, const float* __restrict__ v1, const float* __restrict__ v2, int n_tris,
    int leaf_size, const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_cap, long long n, float t_min, float* __restrict__ out_t,
    float* __restrict__ out_u, float* __restrict__ out_v, int* __restrict__ out_id) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Vec o = load3(orig + 3 * i), d = load3(dir + 3 * i);
  const Vec inv{1.0f / clamped(d.x), 1.0f / clamped(d.y), 1.0f / clamped(d.z)};
  Best b{t_cap[i], 0.0f, 0.0f, -1};
  int stack[kWideStack];
  stack[0] = 0;  // wide node 0, the root
  int sp = 1;
  while (sp > 0) {
    const int entry = stack[sp - 1];
    sp -= 1;
    if (entry < -1) {
      const int bits = -(entry + 2);
      const int start = bits >> kLeafCountBits, count = bits & ((1 << kLeafCountBits) - 1);
      const int m = count < leaf_size ? count : leaf_size;
      for (int j = 0; j < m; ++j) {
        int ti = start + j;
        ti = ti < 0 ? 0 : (ti > n_tris - 1 ? n_tris - 1 : ti);
        const long long t3 = 3 * static_cast<long long>(ti);
        const Vec a = load3(v0 + t3);
        float tt, uu, vv;
        if (triangle(o, d, a, sub(load3(v1 + t3), a), sub(load3(v2 + t3), a), 1e-7f, t_min, &tt, &uu, &vv,
                     b.t)) {
          b = Best{tt, uu, vv, tri_order[ti]};
        }
      }
    } else if (entry >= 0) {
      const long long node = entry < num_nodes - 1 ? entry : num_nodes - 1;
      float key[kWideMax];
      int code[kWideMax];
      int taken = 0;
      for (int k = 0; k < width; ++k) {
        const long long slot = node * width + k;
        const int c = child_code[slot];
        float tn;
        const bool hit = slab(o, inv, child_min + 3 * slot, child_max + 3 * slot, t_min, b.t, &tn);
        if (!hit || c == -1) continue;
        int j = taken++;
        for (; j > 0 && key[j - 1] < tn; --j) {
          key[j] = key[j - 1];
          code[j] = code[j - 1];
        }
        key[j] = tn;
        code[j] = c;
      }
      for (int k = 0; k < taken; ++k) {  // far first, so the nearest pops first
        if (sp < kWideStack) stack[sp++] = code[k];
      }
    }
    if (AnyHit && b.id >= 0) break;
  }
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_id[i] = b.id;
}

// ---------------------------------------------------------------------------
// F1, F2: a round of K3's rounds driver before and after its sort and K3
// ---------------------------------------------------------------------------

// treelets._morton6: each coordinate normalised to the scene box, scaled by
// 63, clamped to [0, 63] and truncated; bits interleaved x, y, z from the top.
__device__ __forceinline__ int morton6(Vec p, const float* __restrict__ lo, const float* __restrict__ hi) {
  const float pos[3] = {p.x, p.y, p.z};
  int q[3];
  for (int c = 0; c < 3; ++c) {
    float ext = hi[c] - lo[c];
    ext = ext < 1e-6f ? 1e-6f : ext;
    float x = (pos[c] - lo[c]) / ext * 63.0f;
    x = x < 0.0f ? 0.0f : x;
    x = x > 63.0f ? 63.0f : x;
    q[c] = static_cast<int>(x);
  }
  int m = 0;
  for (int bit = 0; bit < 6; ++bit) {
    m |= (((q[0] >> bit) & 1) << (3 * bit + 2)) | (((q[1] >> bit) & 1) << (3 * bit + 1)) |
         (((q[2] >> bit) & 1) << (3 * bit));
  }
  return m;
}

// F1, one thread per ray (treelets.treelet_intersect_rounds_plain's work
// before its sort, fused): the round's cap (0 for an any-hit ray that holds
// a hit), the slab test of every treelet box still pending (_treelet_slabs'
// floats, NaN-propagating), the nearest candidate (argmin's first index;
// none when the nearest entry is not finite: tid = K), the pending words
// cleared of the boxes the cap prunes and of the chosen one, and the sort
// key (tid << 18) | morton6(o + max(near, 0)·d), the entry point
// 1e30 where there is no candidate. `aabb` [K, 8] rows (min | max | pad).
__global__ void __launch_bounds__(kBlock) rounds_pick_kernel(
    const int* __restrict__ pending, int* __restrict__ pending_out, int n_words, const float* __restrict__ orig,
    const float* __restrict__ dir, const float* __restrict__ inv_dir, const float* __restrict__ best_t,
    const int* __restrict__ best_id, int any_hit, const float* __restrict__ aabb, int k, const float* __restrict__ lo,
    const float* __restrict__ hi, long long n, float t_min, unsigned char* __restrict__ has,
    int* __restrict__ tid, int* __restrict__ key, float* __restrict__ cap_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float cap = (any_hit && best_id[i] >= 0) ? 0.0f : best_t[i];
  cap_out[i] = cap;
  const Vec o = load3(orig + 3 * i), inv = load3(inv_dir + 3 * i);
  const float inf = __int_as_float(0x7f800000);
  float near = inf;
  int pick = k;
  const int* words = pending + i * n_words;
  int* out = pending_out + i * n_words;
  for (int w = 0; w < n_words; ++w) {
    unsigned bits = static_cast<unsigned>(words[w]);
    unsigned kept = 0u;
    while (bits != 0u) {
      const int b = __ffs(static_cast<int>(bits)) - 1;
      bits &= bits - 1u;
      const int t = 32 * w + b;
      if (t >= k) continue;
      const float* box = aabb + 8 * t;
      float tn;
      if (!slab(o, inv, box, box + 3, t_min, cap, &tn)) continue;
      kept |= 1u << b;
      if (tn < near) {
        near = tn;
        pick = t;
      }
    }
    out[w] = static_cast<int>(kept);
  }
  const bool found = fabsf(near) < inf;
  if (!found) pick = k;
  else out[pick >> 5] &= ~static_cast<int>(1u << (pick & 31));
  Vec e{1e30f, 1e30f, 1e30f};
  if (found) {
    const Vec d = load3(dir + 3 * i);
    const float s = near < 0.0f ? 0.0f : near;
    e = Vec{o.x + s * d.x, o.y + s * d.y, o.z + s * d.z};
  }
  has[i] = found ? 1 : 0;
  tid[i] = pick;
  key[i] = (pick << 18) | morton6(e, lo, hi);
}

// F2, one thread per sorted slot j (after K3): ray order[j] takes the slot's
// t, u, v and id when it had a candidate and the id is >= 0; with `counts`,
// the slot's five K5 counts are added to the ray's.
__global__ void __launch_bounds__(kBlock) rounds_merge_kernel(
    const long long* __restrict__ order, const unsigned char* __restrict__ has, const float* __restrict__ out_s,
    const int* __restrict__ counts_s, long long n, float* __restrict__ best_t, float* __restrict__ best_u,
    float* __restrict__ best_v, int* __restrict__ best_id, int* __restrict__ counts) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const long long r = order[j];
  if (counts != nullptr) {
    for (int c = 0; c < 5; ++c) counts[5 * r + c] += counts_s[5 * j + c];
  }
  const int id = static_cast<int>(out_s[3 * n + j]);
  if (has[r] && id >= 0) {
    best_t[r] = out_s[j];
    best_u[r] = out_s[n + j];
    best_v[r] = out_s[2 * n + j];
    best_id[r] = id;
  }
}

// Launch `kern` on `stream`; the host shim runs its threads one after the
// other instead.
template <typename... P, typename... A>
void launch_kernel(void (*kern)(P...), long long threads, cudaStream_t stream, A... args) {
  const unsigned grid = static_cast<unsigned>((threads + kBlock - 1) / kBlock);
#ifdef RT3_HOST_SHIM
  rt3_shim_launch(kern, grid, kBlock, 0, args...);
#else
  kern<<<grid, kBlock, 0, stream>>>(args...);
#endif
}

template <bool AnyHit, int Cap>
void launch_cluster(const float* boxes, const float* nodes, int node_row, int num_nodes,
                    const float* clusters, int cluster_row, const int* tri_id, int num_clusters,
                    int leaf_size, int entries, const float* orig, const float* dir, const float* t_cap,
                    long long n, float t_min, float* out_t, float* out_u, float* out_v, int* out_id,
                    cudaStream_t st) {
  launch_kernel(cluster_walk_kernel<AnyHit, Cap>, n, st, boxes, nodes, node_row, num_nodes, clusters,
                cluster_row, tri_id, num_clusters, leaf_size, entries, orig, dir, t_cap, n, t_min, out_t,
                out_u, out_v, out_id);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (a
// launch the card refused), or cudaErrorInvalidValue for arguments its
// kernel cannot take. Pointers are device pointers (host pointers in the
// host-shim build).

// A: left, right [T-1] and parent [2T-1] (-1 at the root) from the sorted
// int64 Morton codes [T], T >= 2.
extern "C" int rt3_lbvh_topology(const long long* codes, int t, int* left, int* right, int* parent,
                                 void* stream) {
  if (t < 2) return static_cast<int>(cudaErrorInvalidValue);
  launch_kernel(lbvh_topology_kernel, static_cast<long long>(t) - 1, static_cast<cudaStream_t>(stream),
                codes, t, left, right, parent);
  return static_cast<int>(cudaGetLastError());
}

// B: the internal rows [0, T-1) of node_min / node_max [2T-1, 3] from the
// leaf rows; arrivals [T-1] zeroed.
extern "C" int rt3_lbvh_fit(int t, const int* left, const int* right, const int* parent, int* arrivals,
                            float* node_min, float* node_max, void* stream) {
  if (t < 2) return static_cast<int>(cudaErrorInvalidValue);
  launch_kernel(lbvh_fit_kernel, static_cast<long long>(t), static_cast<cudaStream_t>(stream), t, left, right,
                parent, arrivals, node_min, node_max);
  return static_cast<int>(cudaGetLastError());
}

// C: the LBVH walk of rays [n, 3] with per-ray caps t_cap [n]; out best t,
// u, v, triangle id (-1 on a miss; t is then the cap).
extern "C" int rt3_lbvh_walk(int any_hit, const float* node_min, const float* node_max, const int* left,
                             const int* right, const int* leaf_tri, int t_tris, const float* v0,
                             const float* v1, const float* v2, const float* orig, const float* dir,
                             const float* t_cap, long long n, float t_min, float* out_t, float* out_u,
                             float* out_v, int* out_id, void* stream) {
  if (t_tris < 2 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = any_hit ? lbvh_walk_kernel<true> : lbvh_walk_kernel<false>;
  launch_kernel(kern, n, static_cast<cudaStream_t>(stream), node_min, node_max, left, right, leaf_tri, t_tris,
                v0, v1, v2, orig, dir, t_cap, n, t_min, out_t, out_u, out_v, out_id);
  return static_cast<int>(cudaGetLastError());
}

// D: the cluster-BVH walk; `entries` stack entries (1..512).
extern "C" int rt3_cluster_walk(int any_hit, const float* boxes, const float* nodes, int node_row,
                                int num_nodes, const float* clusters, int cluster_row, const int* tri_id,
                                int num_clusters, int leaf_size, int entries, const float* orig,
                                const float* dir, const float* t_cap, long long n, float t_min, float* out_t,
                                float* out_u, float* out_v, int* out_id, void* stream) {
  if (entries < 1 || entries > kClusterDeepStackCap || node_row < 56 || num_nodes < 1 ||
      num_clusters < 1 || leaf_size < 1 || cluster_row < 9 * leaf_size || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto fn = entries > kClusterStackCap
                      ? (any_hit ? launch_cluster<true, kClusterDeepStackCap> : launch_cluster<false, kClusterDeepStackCap>)
                      : (any_hit ? launch_cluster<true, kClusterStackCap> : launch_cluster<false, kClusterStackCap>);
  fn(boxes, nodes, node_row, num_nodes, clusters, cluster_row, tri_id, num_clusters, leaf_size, entries, orig,
     dir, t_cap, n, t_min, out_t, out_u, out_v, out_id, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// E: the wide-BVH walk of rays [n, 3] with caps t_cap [n]: child_min /
// child_max [W, width, 3], child_code [W, width], tri_order [T] and the
// triangles in leaf order v0, v1, v2 [T, 3]; out as C's.
extern "C" int rt3_wide_walk(int any_hit, const float* child_min, const float* child_max, const int* child_code,
                             int num_nodes, int width, const int* tri_order, const float* v0, const float* v1,
                             const float* v2, int n_tris, int leaf_size, const float* orig, const float* dir,
                             const float* t_cap, long long n, float t_min, float* out_t, float* out_u,
                             float* out_v, int* out_id, void* stream) {
  if (num_nodes < 1 || width < 1 || width > kWideMax || n_tris < 1 || leaf_size < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kern = any_hit ? wide_walk_kernel<true> : wide_walk_kernel<false>;
  launch_kernel(kern, n, static_cast<cudaStream_t>(stream), child_min, child_max, child_code, num_nodes, width,
                tri_order, v0, v1, v2, n_tris, leaf_size, orig, dir, t_cap, n, t_min, out_t, out_u, out_v, out_id);
  return static_cast<int>(cudaGetLastError());
}

// F1: pending [n, n_words] int32, rays, their clamped inverse directions
// and bests, treelet boxes aabb [k, 8] and the scene box lo, hi [3]; out the
// next round's pending words [n, n_words] (pending_out, distinct from
// pending), has [n] (bytes 0 / 1), tid [n], key [n], the round's cap [n].
extern "C" int rt3_rounds_pick(const int* pending, int* pending_out, int n_words, const float* orig, const float* dir,
                               const float* inv_dir, const float* best_t, const int* best_id, int any_hit,
                               const float* aabb, int k, const float* lo, const float* hi, long long n,
                               float t_min, unsigned char* has, int* tid, int* key, float* cap, void* stream) {
  if (k < 1 || k >= (1 << 13) || n_words != (k + 31) / 32 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (pending == pending_out) return static_cast<int>(cudaErrorInvalidValue);
  launch_kernel(rounds_pick_kernel, n, static_cast<cudaStream_t>(stream), pending, pending_out, n_words, orig, dir,
                inv_dir, best_t, best_id, any_hit, aabb, k, lo, hi, n, t_min, has, tid, key, cap);
  return static_cast<int>(cudaGetLastError());
}

// F2: order [n] int64 (sorted slot -> ray), has [n], K3's rows out_s [4, n]
// in sorted order and its counts [n, 5] (or null, with counts null); the
// bests [n] and counts [n, 5] updated in place.
extern "C" int rt3_rounds_merge(const long long* order, const unsigned char* has, const float* out_s,
                                const int* counts_s, long long n, float* best_t, float* best_u, float* best_v,
                                int* best_id, int* counts, void* stream) {
  if (n < 1 || (counts == nullptr) != (counts_s == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  launch_kernel(rounds_merge_kernel, n, static_cast<cudaStream_t>(stream), order, has, out_s, counts_s, n, best_t,
                best_u, best_v, best_id, counts);
  return static_cast<int>(cudaGetLastError());
}
