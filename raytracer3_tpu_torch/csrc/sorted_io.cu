// The coherence-sorted launch's IO (render/wavefront.sorted_trace and
// sorted_occlusion, on a backend that does not sort its rays itself), in
// three passes around PyTorch's stable argsort and the launch:
//
//   `launch_key_kernel`   one thread a lane: wavefront.sort_key_pos_dir's
//                         int32 key from the lane's origin, direction and
//                         alive bit and the bounds (lo, hi): alive lanes
//                         first (1 << 30 on the dead), the direction octant
//                         << 18, the 18-bit Morton code of the position.
//   `launch_in_kernel`    one thread a sorted slot i: lane perm[i]'s origin,
//                         direction and, where there is one, its cap, as the
//                         contiguous [N, 3], [N, 3] and [N] the launch reads.
//   `launch_out_kernel`   one thread a sorted slot i: slot i's result to lane
//                         perm[i]: a closest hit's (t, u, v, prim id) as one
//                         16-byte row, its hit bit and, for a two-level
//                         trace, its instance id; or an any-hit launch's
//                         occlusion bit.
//
// Replaces no Pallas kernel: the JAX package runs this work as plain ops
// inside its jitted step (raytracer3_tpu/render/wavefront.py). Its plain
// version is the port's PyTorch code in render/wavefront.py
// (`sort_key_pos_dir_plain`, `sorted_trace_plain`,
// `sorted_occlusion_plain`), which every CPU call still takes; the wrapper
// is ops/sorted_io_kernel.py.
//
// Every output equals the plain version's to the bit
// (tests/test_torch_sorted_io_kernel.py under csrc/host_shim.h;
// chip_smoke.py and the card tests on the card). The key is the plain
// path's float32 operations in its order: (pos - lo) / max(hi - lo, 1e-6)
// · 63, clamped to [0, 63] (a NaN passes both, as torch.clamp lets it) and
// truncated; the source builds with --fmad=false. One rule differs between
// PyTorch's CPU and CUDA kernels and is kept per build: a NaN coordinate
// converts to int32 as 0 on the card (cvt.rzi) and as INT_MIN on x86
// (cvttss2si), which is what a plain static_cast gives in each build. The
// gather and the scatter copy bits and compute nothing.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): bytes. The key
// pass reads 25 B a lane and writes 4; the gather reads the order (8 B) and a
// lane's 24 B (28 with a cap) at that order and writes them in sorted order;
// the scatter reads the order and a slot's 16 B (20 with an instance id; 1
// for a bit) and writes them at the lane (17 / 21 B with the hit bit).
// Random rows cost whole sectors of DRAM, so the gather and the scatter sit
// above the bound: the scatter writes a hit as one 16-byte row, and reads
// its slot-order inputs as streaming loads (evict first), which leave L2 to
// the rows it scatters (1.6x faster than four columns under default loads
// at atrium1080's shapes). PERF.md §6 has the times.

#ifdef RT3_HOST_SHIM
#include "host_shim.h"  // g++ build for the CPU tests: one thread at a time
#else
#include <cuda_runtime.h>
#endif

#include <cstddef>

namespace {

constexpr int kBlock = 256;

// torch.clamp_min(x, 1e-6): a NaN passes.
__device__ __forceinline__ float clamp_min_nan(float x, float lo) { return x < lo ? lo : x; }

// The lane's Morton coordinate c: ((p - lo) / max(hi - lo, 1e-6)) · 63,
// clamped to [0, 63] and truncated.
__device__ __forceinline__ int cell(float p, float lo, float hi) {
  float x = (p - lo) / clamp_min_nan(hi - lo, 1e-6f) * 63.0f;
  x = x < 0.0f ? 0.0f : x;
  x = x > 63.0f ? 63.0f : x;
  return static_cast<int>(x);  // NaN: 0 on the card, INT_MIN on x86, as PyTorch's .to(int32)
}

// One thread a lane i < n: key[i] from pos / dir [n, 3], alive [n] (bytes
// 0 / 1) and the bounds lo / hi [3].
__global__ void __launch_bounds__(kBlock) launch_key_kernel(
    const float* __restrict__ pos, const float* __restrict__ dir, const unsigned char* __restrict__ alive,
    const float* __restrict__ lo, const float* __restrict__ hi, long long n, int* __restrict__ key) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = pos + 3 * i;
  const float* d = dir + 3 * i;
  const int octant = (d[0] >= 0.0f ? 1 : 0) + 2 * (d[1] >= 0.0f ? 1 : 0) + 4 * (d[2] >= 0.0f ? 1 : 0);
  int q[3];
  for (int c = 0; c < 3; ++c) q[c] = cell(p[c], lo[c], hi[c]);
  int morton = 0;
  for (int b = 0; b < 6; ++b) {
    morton |= (((q[0] >> b) & 1) << (3 * b + 2)) | (((q[1] >> b) & 1) << (3 * b + 1)) | (((q[2] >> b) & 1) << (3 * b));
  }
  key[i] = (alive[i] != 0 ? 0 : (1 << 30)) + (octant << 18) + morton;
}

// One thread a sorted slot i < n: lane j = perm[i]'s origin, direction and
// (cap non-null) cap to slot i of o_out / d_out [n, 3] and cap_out [n].
__global__ void __launch_bounds__(kBlock) launch_in_kernel(
    const long long* __restrict__ perm, const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ cap, long long n, float* __restrict__ o_out, float* __restrict__ d_out,
    float* __restrict__ cap_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long j = perm[i];
  const float ox = orig[3 * j], oy = orig[3 * j + 1], oz = orig[3 * j + 2];
  const float dx = dir[3 * j], dy = dir[3 * j + 1], dz = dir[3 * j + 2];
  const float c = cap != nullptr ? cap[j] : 0.0f;
  o_out[3 * i] = ox, o_out[3 * i + 1] = oy, o_out[3 * i + 2] = oz;
  d_out[3 * i] = dx, d_out[3 * i + 1] = dy, d_out[3 * i + 2] = dz;
  if (cap != nullptr) cap_out[i] = c;
}

// One thread a sorted slot i < n, whose result goes to lane j = perm[i]:
// with t non-null a closest hit (t, uv [n, 2], prim, and inst where
// non-null) as row_out[j] = (t, u, v, prim's bits), hit_out[j] = prim >= 0
// and inst_out[j]; else the bit bits[i].
__global__ void __launch_bounds__(kBlock) launch_out_kernel(
    const long long* __restrict__ perm, long long n, const float* __restrict__ t, const float* __restrict__ uv,
    const int* __restrict__ prim, const int* __restrict__ inst, const unsigned char* __restrict__ bits,
    float4* __restrict__ row_out, unsigned char* __restrict__ hit_out, int* __restrict__ inst_out,
    unsigned char* __restrict__ bits_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long j = __ldcs(perm + i);
  if (t == nullptr) {
    bits_out[j] = bits[i];
    return;
  }
  const int p = __ldcs(prim + i);
  const float4 row = {__ldcs(t + i), __ldcs(uv + 2 * i), __ldcs(uv + 2 * i + 1), __int_as_float(p)};
  const int in = inst != nullptr ? __ldcs(inst + i) : 0;
  row_out[j] = row;
  hit_out[j] = p >= 0 ? 1 : 0;
  if (inst != nullptr) inst_out[j] = in;
}

// A launch of one thread an element; the host shim runs each in turn.
template <typename... P, typename... A>
void launch_lanes(void (*kern)(P...), long long n, cudaStream_t stream, A... args) {
#ifdef RT3_HOST_SHIM
  (void)stream;
  rt3_shim_launch(kern, static_cast<unsigned>(n), 1u, 0, args...);
#else
  kern<<<static_cast<unsigned>((n + kBlock - 1) / kBlock), kBlock, 0, stream>>>(args...);
#endif
}

}  // namespace

// The sort key of n >= 1 lanes: pos / dir [n, 3], alive [n] (bool), the
// bounds lo / hi [3]; out key [n] int32.
extern "C" int rt3_launch_key(const float* pos, const float* dir, const unsigned char* alive, const float* lo,
                              const float* hi, long long n, int* key, void* stream) {
  if (n < 1 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  launch_lanes(launch_key_kernel, n, static_cast<cudaStream_t>(stream), pos, dir, alive, lo, hi, n, key);
  return static_cast<int>(cudaGetLastError());
}

// The launch's inputs of n >= 1 sorted slots: perm [n] int64 (a permutation
// of the lanes), orig / dir [n, 3], cap [n] or null; out o_out / d_out
// [n, 3] and cap_out [n] (null without a cap).
extern "C" int rt3_launch_in(const long long* perm, const float* orig, const float* dir, const float* cap,
                             long long n, float* o_out, float* d_out, float* cap_out, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || (cap != nullptr) != (cap_out != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch_lanes(launch_in_kernel, n, static_cast<cudaStream_t>(stream), perm, orig, dir, cap, n, o_out, d_out,
               cap_out);
  return static_cast<int>(cudaGetLastError());
}

// The launch's results of n >= 1 sorted slots back in lane order: perm [n]
// int64; either a closest hit (t [n], uv [n, 2], prim [n] int32, inst [n]
// int32 or null; out row_out [n, 4] float32, 16-byte aligned: t, u, v and
// prim's bits; hit_out [n] bool; inst_out where inst is given) or
// occlusion bits (bits [n] bool; out bits_out).
extern "C" int rt3_launch_out(const long long* perm, long long n, const float* t, const float* uv, const int* prim,
                              const int* inst, const unsigned char* bits, float* row_out, unsigned char* hit_out,
                              int* inst_out, unsigned char* bits_out, void* stream) {
  const bool hit = t != nullptr && uv != nullptr && prim != nullptr && row_out != nullptr && hit_out != nullptr &&
                   (inst != nullptr) == (inst_out != nullptr) && bits == nullptr && bits_out == nullptr &&
                   reinterpret_cast<size_t>(row_out) % 16 == 0;
  const bool occl = t == nullptr && uv == nullptr && prim == nullptr && inst == nullptr && bits != nullptr &&
                    bits_out != nullptr;
  if (n < 1 || n > 0x7fffffffLL || !(hit || occl)) return static_cast<int>(cudaErrorInvalidValue);
  launch_lanes(launch_out_kernel, n, static_cast<cudaStream_t>(stream), perm, n, t, uv, prim, inst, bits,
               reinterpret_cast<float4*>(row_out), hit_out, inst_out, bits_out);
  return static_cast<int>(cudaGetLastError());
}
