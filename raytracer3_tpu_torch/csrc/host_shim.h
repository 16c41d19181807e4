// Stand-ins for the CUDA runtime that let a C++ compiler build the sources of
// csrc/ for the CPU, so that the tests can run the kernels' source where there is
// no card:
//
//   g++ -std=c++17 -O1 -ffp-contract=off -x c++ -DRT3_HOST_SHIM -shared -fPIC
//
// (-ffp-contract=off is nvcc's --fmad=false.) A launch runs every thread of
// the grid one after the other, each as a block of its own (blockDim.x = 1),
// so a kernel may share memory within a block and call __syncthreads() as
// long as one thread alone can fill what its block shares: the kernels of
// traverse.cu do. Not thread-safe; nothing here is fast.

#ifndef RT3_HOST_SHIM_H_
#define RT3_HOST_SHIM_H_

#include <cmath>
#include <cstddef>
#include <cstring>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
// A block's shared arrays: one thread runs the block, so a static array
// the block fills before it reads is the block's own.
#define __shared__ static

struct float4 {
  float x, y, z, w;
};

struct Rt3ShimIndex {
  unsigned x, y, z;
};
static Rt3ShimIndex blockIdx{0, 0, 0}, blockDim{1, 1, 1}, threadIdx{0, 0, 0};

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

inline float __ldg(const float* p) { return *p; }
inline int __ldg(const int* p) { return *p; }
inline float4 __ldg(const float4* p) { return *p; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline void __syncthreads() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
// A warp of one lane: the ballot is the lane's own bit, a shuffle its own
// value.
inline unsigned __ballot_sync(unsigned, int pred) { return pred ? 1u : 0u; }
inline float __shfl_xor_sync(unsigned, float v, int) { return v; }
inline void __threadfence() {}
inline int __clz(int v) { return v == 0 ? 32 : __builtin_clz(static_cast<unsigned>(v)); }
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}
inline float __ldcg(const float* p) { return *p; }
template <typename T>
inline T __ldcs(const T* p) {
  return *p;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
using std::isinf;

// Dynamic shared memory of the running block.
static std::vector<int> rt3_shim_smem;
inline int* rt3_shim_dynamic_smem() { return rt3_shim_smem.data(); }

template <typename... P, typename... A>
void rt3_shim_launch(void (*kern)(P...), unsigned grid, unsigned block,
                     size_t shared_bytes, A... args) {
  rt3_shim_smem.assign(shared_bytes / sizeof(int) + 1, 0);
  blockDim.x = 1;
  threadIdx.x = 0;
  const size_t threads = static_cast<size_t>(grid) * block;
  for (size_t i = 0; i < threads; ++i) {
    blockIdx.x = static_cast<unsigned>(i);
    kern(args...);
  }
}

#endif  // RT3_HOST_SHIM_H_
