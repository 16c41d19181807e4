// The treelet driver's per-ray work around each K3 launch
// (ops/treelets.treelet_intersect), in two passes:
//
//   `treelet_key_kernel`   one thread a padded ray (`_prepare`): the pad
//                          lanes' rays, `_inv_dir`, the scene-exit cap
//                          (`step_cull`), the K slab tests against the
//                          treelet boxes with the nearest candidate
//                          (`_near_tid`), the octant, the entry point and
//                          `_morton6`: the sort key
//                          (tid0 << 21) | (octant << 18) | morton.
//   treelet metadata       after PyTorch's stable argsort of the keys, two
//                          kernels (`_seg_reduce` and `segment_metadata`):
//     `treelet_meta_kernel`         one block a ray group of a segment: each
//                                   sorted slot gathers its ray (the pad
//                                   lanes' rays past the caller's), writes
//                                   the rows K3 reads, and does its K slab
//                                   tests; a warp ballot and a warp minimum
//                                   give the group's want bits and least
//                                   entry distance a treelet.
//     `treelet_meta_finish_kernel`  one block a segment: the least entry
//                                   over its groups, the stable ascending
//                                   order of its K keys (infinity last, ties
//                                   by treelet id: torch.argsort's stable
//                                   order), `seg_list` with sentinel slots
//                                   repeating the last real id, `seg_entry`
//                                   (key·(1 - 1e-4) - 1e-5, 1e30 on
//                                   sentinels) and the group-mask words
//                                   (bit 31 the sign bit; 0 on sentinels and
//                                   from `e_cap` on).
//
// Replaces no Pallas kernel: the JAX package runs this work as plain ops
// inside its jitted step (raytracer3_tpu/ops/treelets.py). Its plain
// version is the port's PyTorch driver in ops/treelets.py, which every CPU
// call still takes; the wrapper is ops/treelet_driver_kernel.py.
//
// Every output equals the plain version's to the bit (the tests under
// csrc/host_shim.h, tests/test_torch_treelet_driver_kernel.py; chip_smoke.py
// and the card tests on the card). Each ray's arithmetic is the plain
// path's float32 operations in its order: torch.minimum / torch.maximum and
// amax / amin propagate a NaN, 1 / x is the IEEE quotient (PyTorch's
// reciprocal), the nudges round as float32 constants, and the source builds
// with --fmad=false, so no multiply-add is contracted. The reductions take
// minima and ors only, which are exact in any order, and no float atomic
// is used, so the outputs cannot depend on the order the threads arrive
// in. One rule differs between PyTorch's CPU and CUDA kernels and is kept
// per build: a NaN Morton coordinate converts to int32 as 0 on the card
// (cvt.rzi) and as INT_MIN on x86 (cvttss2si), which is what a plain
// static_cast gives in each build. argmin's first index on ties is the same
// in both (a strict `<` over the treelets in order).
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): bytes. The key
// pass reads a ray's origin and direction and its cap (28 B, 24 with a
// scalar cap) and writes its cap and key (8 B); the treelet boxes (K rows)
// are staged once a block in shared memory. The metadata pass reads the
// sort's order (8 B) and a ray's origin, direction and cap at that order
// (28 B, gathered) and writes them in sorted order (28 B) for K3; its
// per-group and per-segment outputs are a few KB. PERF.md §6 has the times.

#ifdef RT3_HOST_SHIM
#include "host_shim.h"  // g++ build for the CPU tests: one thread at a time
#else
#include <cuda_runtime.h>
#endif

#include <cmath>
#include <cstddef>

namespace {

constexpr int kKeyBlock = 128;
constexpr int kMetaBlock = 256;
constexpr int kFinishBlock = 128;
constexpr int kBatch = 4;  // slots a thread of the metadata kernel loads at once
constexpr int kMaxTreelets = 256;  // the boxes staged in shared memory
constexpr int kMaxWords = 32;      // group-mask words a segment (1,024 groups)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// torch.minimum / torch.maximum (and amin / amax): a NaN operand propagates.
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// _inv_dir: 1 / where(|a| < 1e-12, 1e-12, a).
__device__ __forceinline__ float inv_dir(float a) { return 1.0f / (fabsf(a) < 1e-12f ? 1e-12f : a); }

struct Vec {
  float x, y, z;
};

__device__ __forceinline__ Vec load3(const float* p) { return Vec{p[0], p[1], p[2]}; }

// _treelet_slabs for one box (lo = box[0..2], hi = box[3..5]): the clamped
// entry distance, and whether it is at or before the exit (capped at `cap`).
__device__ __forceinline__ bool slab(Vec o, Vec inv, const float* box, float t_min, float cap, float* t_near) {
  const float ax = (box[0] - o.x) * inv.x, bx = (box[3] - o.x) * inv.x;
  const float ay = (box[1] - o.y) * inv.y, by = (box[4] - o.y) * inv.y;
  const float az = (box[2] - o.z) * inv.z, bz = (box[5] - o.z) * inv.z;
  const float tn = max_nan(max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)), min_nan(az, bz)), t_min);
  const float tf = min_nan(min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)), max_nan(az, bz)), cap);
  *t_near = tn;
  return tn <= tf;
}

// _morton6: each coordinate normalised to the scene box, scaled by 63,
// clamped to [0, 63] and truncated; bits interleaved x, y, z from the top.
__device__ __forceinline__ int morton6(Vec p, const float* lo, const float* hi) {
  const float pos[3] = {p.x, p.y, p.z};
  int q[3];
  for (int c = 0; c < 3; ++c) {
    float ext = hi[c] - lo[c];
    ext = ext < 1e-6f ? 1e-6f : ext;
    float x = (pos[c] - lo[c]) / ext * 63.0f;
    x = x < 0.0f ? 0.0f : x;
    x = x > 63.0f ? 63.0f : x;
    q[c] = static_cast<int>(x);  // NaN: 0 on the card, INT_MIN on x86, as PyTorch's .to(int32)
  }
  int m = 0;
  for (int bit = 0; bit < 6; ++bit) {
    m |= (((q[0] >> bit) & 1) << (3 * bit + 2)) | (((q[1] >> bit) & 1) << (3 * bit + 1)) |
         (((q[2] >> bit) & 1) << (3 * bit));
  }
  return m;
}

// The K boxes of aabb [K, 8] (min | max | pad) as [K, 6] in shared memory.
__device__ __forceinline__ void stage_boxes(const float* __restrict__ aabb, int k, float* boxes) {
  for (int t = threadIdx.x; t < 6 * k; t += blockDim.x) boxes[t] = aabb[8 * (t / 6) + t % 6];
}

// The padded ray at j: the caller's ray below n, else the pad lane's
// (origin 1e30, direction 1).
__device__ __forceinline__ void ray_at(const float* __restrict__ orig, const float* __restrict__ dir, long long j,
                                       long long n, Vec* o, Vec* d) {
  if (j < n) {
    *o = load3(orig + 3 * j);
    *d = load3(dir + 3 * j);
  } else {
    *o = Vec{1e30f, 1e30f, 1e30f};
    *d = Vec{1.0f, 1.0f, 1.0f};
  }
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, off);
    v = w < v ? w : v;
  }
  return v;
}

// One thread a padded ray i < n_pad (_prepare): its cap (the scalar
// `t_cap_all` where `t_cap` is null; 0 on pad lanes), clamped to the
// scene-exit distance tf·exit_scale + exit_pad under `step_cull` (0 where
// the ray misses the scene box); with `key` non-null the sort key, and
// with `tid` non-null the nearest candidate treelet (K where none).
__global__ void __launch_bounds__(kKeyBlock) treelet_key_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir, const float* __restrict__ t_cap,
    float t_cap_all, long long n, long long n_pad, const float* __restrict__ aabb, int k, float t_min,
    int step_cull, float exit_scale, float exit_pad, float* __restrict__ cap_out, int* __restrict__ key,
    int* __restrict__ tid) {
  __shared__ float boxes[6 * kMaxTreelets];
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // The ray's loads go out before the block waits for its boxes.
  Vec o{0.0f, 0.0f, 0.0f}, d{0.0f, 0.0f, 0.0f};
  float cap = 0.0f;
  if (i < n_pad) {
    ray_at(orig, dir, i, n, &o, &d);
    if (i < n) cap = t_cap != nullptr ? t_cap[i] : t_cap_all;
  }
  stage_boxes(aabb, k, boxes);
  __syncthreads();
  if (i >= n_pad) return;
  float lo[3], hi[3];
  for (int c = 0; c < 3; ++c) {
    lo[c] = boxes[c];
    hi[c] = boxes[3 + c];
    for (int t = 1; t < k; ++t) {
      lo[c] = min_nan(lo[c], boxes[6 * t + c]);
      hi[c] = max_nan(hi[c], boxes[6 * t + 3 + c]);
    }
  }
  const Vec inv{inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)};
  if (step_cull) {
    const float scene[6] = {lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]};
    const float ax = (scene[0] - o.x) * inv.x, bx = (scene[3] - o.x) * inv.x;
    const float ay = (scene[1] - o.y) * inv.y, by = (scene[4] - o.y) * inv.y;
    const float az = (scene[2] - o.z) * inv.z, bz = (scene[5] - o.z) * inv.z;
    const float tn = max_nan(max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)), min_nan(az, bz)), t_min);
    const float tf = min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)), max_nan(az, bz));
    const float exit_t = tf * exit_scale + exit_pad;
    cap = tn <= exit_t ? min_nan(cap, exit_t) : 0.0f;
  }
  cap_out[i] = cap;
  if (key == nullptr) return;
  const float inf = inf_f();
  float near = inf;
  int pick = k;
  for (int t = 0; t < k; ++t) {
    float tn;
    if (slab(o, inv, boxes + 6 * t, t_min, cap, &tn) && tn < near) {
      near = tn;
      pick = t;
    }
  }
  const bool found = fabsf(near) < inf;
  if (!found) pick = k;
  const int octant = (d.x >= 0.0f ? 1 : 0) + 2 * (d.y >= 0.0f ? 1 : 0) + 4 * (d.z >= 0.0f ? 1 : 0);
  Vec e{1e30f, 1e30f, 1e30f};
  if (found) {
    const float s = near < 0.0f ? 0.0f : near;
    e = Vec{o.x + s * d.x, o.y + s * d.y, o.z + s * d.z};
  }
  key[i] = (pick << 21) | (octant << 18) | morton6(e, lo, hi);
  if (tid != nullptr) tid[i] = pick;
}

// One block a group of `group_rays` sorted slots (group g covers slots
// [g·group_rays, (g + 1)·group_rays)). Slot i takes ray j = order[i] (i
// without an order): its origin and direction (the pad lane's from n_src
// on), cap_src[j], its any-hit flag (0 on pad lanes) and,
// with tid_mode 1 / 2, tid[i], which keeps only that treelet in the ray's
// want / drops it. With `o_out` non-null the slot's rows are written for
// K3. Out: g_tn [G, K] the group's least entry over the rays that want
// each treelet (infinity where none), g_want [G, K] bytes whether any does.
__global__ void __launch_bounds__(kMetaBlock) treelet_meta_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir, long long n_src,
    const float* __restrict__ cap_src, const float* __restrict__ ah, const long long* __restrict__ order,
    const int* __restrict__ tid, int tid_mode,
    const float* __restrict__ aabb, int k, float t_min, int group_rays, float* __restrict__ o_out,
    float* __restrict__ d_out, float* __restrict__ cap_out, float* __restrict__ ah_out,
    float* __restrict__ g_tn, unsigned char* __restrict__ g_want) {
  constexpr int kWarps = kMetaBlock / 32;
  __shared__ float boxes[6 * kMaxTreelets];
  __shared__ float w_min[kWarps * kMaxTreelets];
  __shared__ unsigned w_any[kWarps * kMaxTreelets];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = (blockDim.x + 31) >> 5;
  const float inf = inf_f();
  stage_boxes(aabb, k, boxes);
  for (int t = threadIdx.x; t < warps * k; t += blockDim.x) {
    w_min[t] = inf;
    w_any[t] = 0u;
  }
  __syncthreads();
  const long long g = blockIdx.x;
  // kBatch slots a thread at a time, their loads issued together; a warp
  // then reduces the batch's minimum and want bits once a treelet.
  for (int r0 = 0; r0 < group_rays; r0 += kBatch * blockDim.x) {
    bool live[kBatch];
    long long i[kBatch], j[kBatch];
    Vec o[kBatch], d[kBatch];
    float cap[kBatch];
    int tv[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int r = r0 + b * blockDim.x + threadIdx.x;
      live[b] = r < group_rays;
      i[b] = g * group_rays + r;
      j[b] = live[b] ? (order != nullptr ? order[i[b]] : i[b]) : 0;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      o[b] = d[b] = Vec{0.0f, 0.0f, 0.0f};
      cap[b] = 0.0f;
      tv[b] = -1;
      if (live[b]) {
        ray_at(orig, dir, j[b], n_src, &o[b], &d[b]);
        cap[b] = cap_src[j[b]];
        if (tid_mode != 0) tv[b] = tid[i[b]];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (!live[b]) continue;
      if (o_out != nullptr) {
        const long long s = i[b];
        o_out[3 * s] = o[b].x, o_out[3 * s + 1] = o[b].y, o_out[3 * s + 2] = o[b].z;
        d_out[3 * s] = d[b].x, d_out[3 * s + 1] = d[b].y, d_out[3 * s + 2] = d[b].z;
        cap_out[s] = cap[b];
        if (ah_out != nullptr) ah_out[s] = j[b] < n_src ? ah[j[b]] : 0.0f;
      }
      d[b] = Vec{inv_dir(d[b].x), inv_dir(d[b].y), inv_dir(d[b].z)};  // from here on the inverse
    }
    for (int t = 0; t < k; ++t) {
      float v = inf;
      bool want = false;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (!live[b]) continue;
        float tn;
        bool w = slab(o[b], d[b], boxes + 6 * t, t_min, cap[b], &tn);
        if (tid_mode == 1) w = w && t == tv[b];
        if (tid_mode == 2) w = w && t != tv[b];
        if (w) {
          want = true;
          v = tn < v ? tn : v;
        }
      }
      if (__ballot_sync(kFull, want) != 0u) {  // the same in every lane of the warp
        v = warp_min(v);
        if (lane == 0) {
          float* m = w_min + warp * k + t;
          *m = v < *m ? v : *m;
          w_any[warp * k + t] = 1u;
        }
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    float m = inf;
    unsigned any = 0u;
    for (int w = 0; w < warps; ++w) {
      const float v = w_min[w * k + t];
      m = v < m ? v : m;
      any |= w_any[w * k + t];
    }
    g_tn[g * k + t] = m;
    g_want[g * k + t] = any ? 1 : 0;
  }
}

// One block a segment of `groups` groups (segment_metadata): out
// seg_list [S, K], seg_entry [S, K] and seg_gmask [S, K, n_words]; slots
// from `e_limit` on get mask 0.
__global__ void __launch_bounds__(kFinishBlock) treelet_meta_finish_kernel(
    const float* __restrict__ g_tn, const unsigned char* __restrict__ g_want, int k, int groups, int n_words,
    int e_limit, float entry_scale, float entry_pad, int* __restrict__ seg_list, float* __restrict__ seg_entry,
    int* __restrict__ seg_gmask) {
  constexpr int kWarps = kFinishBlock / 32;
  __shared__ float w_min[kWarps * kMaxTreelets];
  __shared__ unsigned words[kMaxTreelets * kMaxWords];
  __shared__ float key[kMaxTreelets];
  __shared__ int sorted[kMaxTreelets];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = (blockDim.x + 31) >> 5;
  const float inf = inf_f();
  const long long s = blockIdx.x;
  for (int t = threadIdx.x; t < warps * k; t += blockDim.x) w_min[t] = inf;
  for (int t = threadIdx.x; t < k * n_words; t += blockDim.x) words[t] = 0u;
  __syncthreads();
  // Group g of the segment in lane g mod 32 of its warp: a ballot over the
  // warp is the bits of one mask word, which lane 0 places at bit g mod 32
  // of word g / 32 (bit 0 on the card, where lane 0's g is a multiple of
  // 32; any bit under the host shim, which runs one lane a block).
  for (int g0 = 0; g0 < groups; g0 += blockDim.x) {
    const int g = g0 + threadIdx.x;
    const bool live = g < groups;
    const long long row = (s * groups + (live ? g : 0)) * k;
    for (int t = 0; t < k; ++t) {
      const float v = warp_min(live ? g_tn[row + t] : inf);
      const unsigned bits = __ballot_sync(kFull, live && g_want[row + t] != 0);
      if (lane == 0) {
        float* m = w_min + warp * k + t;
        *m = v < *m ? v : *m;
        if (bits != 0u) words[t * n_words + (g >> 5)] |= bits << (g & 31);
      }
    }
  }
  __syncthreads();
  // The segment's key a treelet: its least entry where a group wants it.
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    float m = inf;
    for (int w = 0; w < warps; ++w) m = w_min[w * k + t] < m ? w_min[w * k + t] : m;
    bool any = false;
    for (int w = 0; w < n_words; ++w) any = any || words[t * n_words + w] != 0u;
    key[t] = any ? m : inf;
  }
  __syncthreads();
  // Stable ascending order: a key's rank counts the smaller keys and the
  // equal keys of lower treelet ids (infinity equals infinity).
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    int rank = 0;
    for (int u = 0; u < k; ++u) rank += (key[u] < key[t] || (key[u] == key[t] && u < t)) ? 1 : 0;
    sorted[rank] = t;
  }
  __syncthreads();
  int length = 0;
  for (int t = 0; t < k; ++t) length += fabsf(key[t]) < inf ? 1 : 0;
  const int last = sorted[length > 0 ? length - 1 : 0];
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const int t = sorted[e];
    const bool valid = e < length;
    seg_list[s * k + e] = valid ? t : last;
    seg_entry[s * k + e] = valid ? key[t] * entry_scale - entry_pad : 1e30f;
    int* out = seg_gmask + (s * k + e) * n_words;
    for (int w = 0; w < n_words; ++w) out[w] = (valid && e < e_limit) ? static_cast<int>(words[t * n_words + w]) : 0;
  }
}

// A launch of `blocks` blocks of `threads` threads; the host shim runs each
// block as one thread, in turn.
template <typename... P, typename... A>
void launch_blocks(void (*kern)(P...), long long blocks, int threads, cudaStream_t stream, A... args) {
#ifdef RT3_HOST_SHIM
  (void)threads;
  (void)stream;
  rt3_shim_launch(kern, static_cast<unsigned>(blocks), 1u, 0, args...);
#else
  kern<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(args...);
#endif
}

}  // namespace

// The key pass over rays [n, 3] padded to n_pad: t_cap [n] (null: the scalar
// t_cap_all), treelet boxes aabb [k, 8]; out cap [n_pad], and key [n_pad]
// and tid [n_pad] where non-null.
extern "C" int rt3_treelet_key(const float* orig, const float* dir, const float* t_cap, float t_cap_all, long long n,
                               long long n_pad, const float* aabb, int k, float t_min, int step_cull,
                               float exit_scale, float exit_pad, float* cap, int* key, int* tid, void* stream) {
  if (k < 1 || k > kMaxTreelets || n < 0 || n_pad < 1 || n > n_pad || (tid != nullptr && key == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
#ifdef RT3_HOST_SHIM
  launch_blocks(treelet_key_kernel, n_pad, kKeyBlock, st, orig, dir, t_cap, t_cap_all, n, n_pad, aabb, k, t_min,
                step_cull, exit_scale, exit_pad, cap, key, tid);
#else
  launch_blocks(treelet_key_kernel, (n_pad + kKeyBlock - 1) / kKeyBlock, kKeyBlock, st, orig, dir, t_cap, t_cap_all,
                n, n_pad, aabb, k, t_min, step_cull, exit_scale, exit_pad, cap, key, tid);
#endif
  return static_cast<int>(cudaGetLastError());
}

// The metadata of n_pad sorted slots in segments of seg_rays, groups of
// group_rays: the caller's rays orig / dir [n_src, 3] (pad lanes from
// n_src on), caps cap [n_pad], the any-hit flags ah [n_src] (null: none),
// order [n_pad] int64 (null: slot i takes
// ray i), tid [n_pad] with tid_mode 1 (only) or 2 (exclude); out the sorted
// rows (o_out null: none written), the scratch g_tn / g_want [n_pad /
// group_rays, k], seg_list / seg_entry [S, k] and seg_gmask [S, k, n_words].
extern "C" int rt3_treelet_meta(const float* orig, const float* dir, long long n_src, const float* cap,
                                const float* ah, const long long* order, const int* tid,
                                int tid_mode, long long n_pad, const float* aabb, int k, float t_min, int seg_rays,
                                int group_rays, int n_words, int e_limit, float entry_scale, float entry_pad,
                                float* o_out, float* d_out, float* cap_out, float* ah_out, float* g_tn,
                                unsigned char* g_want, int* seg_list, float* seg_entry, int* seg_gmask,
                                void* stream) {
  if (k < 1 || k > kMaxTreelets || group_rays < 1 || seg_rays < group_rays || seg_rays % group_rays != 0 ||
      n_pad < 1 || n_pad % seg_rays != 0 || n_src < 0 || n_src > n_pad || tid_mode < 0 || tid_mode > 2 ||
      (tid_mode != 0 && tid == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = seg_rays / group_rays;
  if (n_words != (groups + 31) / 32 || n_words > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  if (o_out == nullptr && (order != nullptr || n_src != n_pad)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  launch_blocks(treelet_meta_kernel, n_pad / group_rays, kMetaBlock, st, orig, dir, n_src, cap, ah, order, tid,
                tid_mode, aabb, k, t_min, group_rays, o_out, d_out, cap_out, ah != nullptr ? ah_out : nullptr, g_tn,
                g_want);
  launch_blocks(treelet_meta_finish_kernel, n_pad / seg_rays, kFinishBlock, st, g_tn, g_want, k, groups, n_words,
                e_limit, entry_scale, entry_pad, seg_list, seg_entry, seg_gmask);
  return static_cast<int>(cudaGetLastError());
}
