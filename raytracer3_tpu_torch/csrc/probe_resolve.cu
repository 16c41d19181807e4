// The probe resolve of the probe-GI frame (render/probes.py; the passes `sis`,
// `sh` and `interpolate` of render/pipelines._probe_pipeline) as one kernel a
// pass:
//
//   `probe_sis_kernel`          one block a probe tile (sp x sp pixels): the
//                               tile's normals decoded from word 1 of the
//                               packed G-buffer (and written out: every pixel
//                               of the image gets its normal, those outside
//                               the probe grid from the blocks past the
//                               tiles), the pdf of each of the R x R
//                               octahedral directions, each direction's
//                               stable rank, and the direction index and mip
//                               bit of structured importance sampling.
//   `probe_sh_kernel`           one block a probe: with the fill, the mean of
//                               the written texels put in the texels never
//                               written; then the projection onto SH3 at the
//                               texel centres, scaled by 4 pi / R^2.
//   `probe_interpolate_kernel`  one thread a pixel: albedo (word 0) and
//                               emission (word 3, or zero for the hybrid's
//                               indirect term) decoded, the four clamped
//                               neighbour probes' edge-aware weights and
//                               cosine-lobe irradiance, blended; red where no
//                               probe reaches, black on the sky.
//
// Replaces no TPU kernel: the JAX package runs these passes as plain jnp that
// XLA fuses (raytracer3_tpu/render/probes.py). Their plain versions are the
// port's PyTorch code in render/probes.py (`sis_packed_plain`,
// `project_sh_plain`, `interpolate_packed_plain`), which every CPU call still
// takes; the wrapper is ops/probe_resolve_kernel.py.
//
// The SIS's outputs (the normals, the direction indices and mip bits: they
// choose the rays the frame traces) and the interpolation's weights (they
// choose the pixels no probe reaches) equal the plain version's to the bit
// (tests/test_torch_probe_resolve_kernel.py under csrc/host_shim.h;
// chip_smoke.py and the card tests on the card): the float32 operations are
// the plain path's in its order and the source builds with --fmad=false. The
// tile's dot products are summed in `_sum_last`'s halving order (pairs i and
// i + half, the odd tail carried); the rank is a stable argsort's; a weight's
// dot product and the four weights' sum run left to right, as the plain path
// writes them out. Two of PyTorch's rules differ between its CPU and CUDA
// kernels and are kept per build, as in csrc/shade.cu: a tensor divided by a
// Python number is a true division on the CPU and a product with the
// number's float reciprocal on CUDA (`div_by_number`), and rsqrt is
// 1 / sqrt on the CPU and rsqrtf on CUDA. The SH coefficients and the light
// are not the plain path's to the bit: it sums them through PyTorch's
// reductions (an einsum over the texels, a sum over the irradiance's 9
// terms), whose order is the library's own. Here both sum by halving, and
// each value lies within a bound derived from its roundings of the plain
// formula evaluated exactly (ops/probe_resolve_kernel.py: `sh_bound`,
// `LIGHT_BOUND`, both under 1e-6 of the sum of the value's terms'
// magnitudes).
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): bytes, and at
// 1920x1088 with 120x68 probes of 8x8 texels (sp 16) very few of them. The
// passes must read each pixel's G-buffer words (8 B for sis, 16 B for
// interpolate, of its 32-byte row), depth (4 B) and normal (12 B, written
// once by sis), write the light (12 B), and move the 8 MB atlas and the
// probes' budgets; ~0.14 GB, ~0.04 ms at 3.35 TB/s. The SIS's 134M dot
// products are ~0.8 GFLOP, ~0.01 ms at 67 TFLOP/s. The PyTorch passes moved
// ~6 GB a frame, mostly the SIS's [8160, 64, 256] dot tensors and the
// interpolation's [2.09M, 3, 9] products. The design keeps every
// intermediate on chip: the SIS block decodes its tile's normals into shared
// memory, each warp sums one direction's dots in a shared scratch of half the
// tile (the first halving step fused into the dot products), and the ranks
// are a count over the block's pdfs (R x R compares a direction; no sort).
// The SH block holds its probe's texels and the basis in shared memory. The
// interpolation reads the neighbours' anchors and coefficients through the
// cache (a warp's 32 pixels share 2-3 probe columns) and writes each pixel
// once: 3.0x its bytes bound. The SIS runs 15x above it, bound instead by
// shared memory (~4.5 KB of dot operands and halving sums a direction), and
// the SH 31x, by the latency of its block-wide halving levels; together
// ~0.31 ms of a ~12 ms frame. PERF.md §6 has the times.

#ifdef RT3_HOST_SHIM
#include "host_shim.h"  // g++ build for the CPU tests: one thread at a time
#else
#include <cuda_runtime.h>
#endif

#include <cmath>

namespace {

constexpr int kMaxSpacing = 32;  // the largest probe spacing sp the SIS block takes
constexpr int kMaxTile = kMaxSpacing * kMaxSpacing;
constexpr int kMaxDirs = 256;  // the most directions R x R a probe may have
constexpr int kSisBlock = 256;
constexpr int kSisWarps = kSisBlock / 32;
constexpr int kShBlock = 128;
constexpr int kPixBlock = 256;

// A Python float as PyTorch takes it: the double rounded to float.
#define F(x) static_cast<float>(x)
constexpr float kBackground = F(100000.0);  // mathx.BACKGROUND_DEPTH
constexpr float kInvPi = F(0.3183098861837906715377675267450);
// ops/sh.py's basis constants and cosine-lobe factors.
constexpr float kC0 = F(0.28209479177387814347403972578039);
constexpr float kC1 = F(0.48860251190291992158638462283836);
constexpr float kC2 = F(1.09254843059207907054338570580268);
constexpr float kC3 = F(0.31539156525252000603089369029571);
constexpr float kC4 = F(0.54627421529603953527169285290134);
constexpr float kA0 = F(3.14159265358979323846);
constexpr float kA1 = F(2.0943951023931954923);
constexpr float kA2 = F(0.7853981633974483096);

// A tensor divided by a Python number.
__device__ __forceinline__ float div_by_number(float a, float b) {
#ifdef RT3_HOST_SHIM
  return a / b;
#else
  return a * (1.0f / b);
#endif
}

#ifdef RT3_HOST_SHIM
inline float rsqrt_f(float x) { return 1.0f / std::sqrt(x); }  // PyTorch's CPU rsqrt: 1 / sqrt
inline float exp2_f(float x) { return std::exp2(x); }
#else
__device__ __forceinline__ float rsqrt_f(float x) { return rsqrtf(x); }  // PyTorch's CUDA rsqrt
__device__ __forceinline__ float exp2_f(float x) { return exp2f(x); }
#endif

struct V3 {
  float x, y, z;
};

// torch.clamp_min(x, lo) and torch.clamp(x, lo, hi): a NaN passes.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// mathx.normalize: v * rsqrt(max(dot(v, v), 1e-20)).
__device__ __forceinline__ V3 normalize(float x, float y, float z) {
  const float r = rsqrt_f(clamp_min(x * x + y * y + z * z, F(1e-20)));
  return V3{x * r, y * r, z * r};
}

// packing.unpack_normal_11_10_11 of a packed word.
__device__ __forceinline__ V3 unpack_normal(long long word) {
  const unsigned p = static_cast<unsigned>(word);
  const float x = div_by_number(static_cast<float>(p & 2047u), 2047.0f) * 2.0f - 1.0f;
  const float y = div_by_number(static_cast<float>((p >> 11) & 1023u), 1023.0f) * 2.0f - 1.0f;
  const float z = div_by_number(static_cast<float>((p >> 21) & 2047u), 2047.0f) * 2.0f - 1.0f;
  return normalize(x, y, z);
}

// probes.octa_direction_grid(r)[d // r, d % r]: packing.octa_decode at the
// texel centre ((d % r + 0.5) / r, (d // r + 0.5) / r).
__device__ __forceinline__ V3 octa_dir(int d, int r) {
  const float f0 = div_by_number(static_cast<float>(d % r) + 0.5f, static_cast<float>(r)) * 2.0f - 1.0f;
  const float f1 = div_by_number(static_cast<float>(d / r) + 0.5f, static_cast<float>(r)) * 2.0f - 1.0f;
  const float z = 1.0f - fabsf(f0) - fabsf(f1);
  const float t = clamp(-z, 0.0f, 1.0f);
  const float x = f0 - (f0 >= 0.0f ? 1.0f : -1.0f) * t;
  const float y = f1 - (f1 >= 0.0f ? 1.0f : -1.0f) * t;
  return normalize(x, y, z);
}

// sh.sh3_evaluate at direction (x, y, z), coefficient k.
__device__ __forceinline__ float sh3(int k, float x, float y, float z) {
  switch (k) {
    case 0: return kC0;
    case 1: return -kC1 * y;
    case 2: return kC1 * z;
    case 3: return -kC1 * x;
    case 4: return kC2 * x * y;
    case 5: return kC2 * y * z;
    case 6: return kC3 * (3.0f * z * z - 1.0f);
    case 7: return kC2 * x * z;
    default: return kC4 * (x * x - y * y);
  }
}

__device__ __forceinline__ void store_normal(float* normal, long long pix, V3 v) {
  normal[3 * pix] = v.x, normal[3 * pix + 1] = v.y, normal[3 * pix + 2] = v.z;
}

// Blocks b < px * py: tile (b / px, b % px) of the probe grid. Blocks past
// them (`extra` of them) decode the normals of the pixels outside the grid.
// data [h, w, 4] int64 (packed words); out normal [h, w, 3], dir_index and
// mip [py, px, r * r] int64.
__global__ void __launch_bounds__(kSisBlock) probe_sis_kernel(
    const long long* __restrict__ data, int h, int w, int px, int py, int sp, int r, int ncull, int extra,
    float* __restrict__ normal, long long* __restrict__ dir_index, long long* __restrict__ mip) {
  __shared__ float tn[3][kMaxTile];
  __shared__ float dirs[3][kMaxDirs];
  __shared__ float pdf[kMaxDirs];
  __shared__ int rank[kMaxDirs];
  __shared__ int order[kMaxDirs];
  __shared__ float scratch[kSisWarps][kMaxTile / 2];
  const int tiles = px * py;
  const int b = static_cast<int>(blockIdx.x);
  if (b >= tiles) {
    // Pixels right of the grid (rows < gh, columns >= gw), then below it.
    const long long gw = static_cast<long long>(px) * sp, gh = static_cast<long long>(py) * sp;
    const long long right = gh * (w - gw), total = right + (h - gh) * w;
    for (long long k = static_cast<long long>(b - tiles) * blockDim.x + threadIdx.x; k < total;
         k += static_cast<long long>(extra) * blockDim.x) {
      const long long pix = k < right ? (k / (w - gw)) * w + gw + k % (w - gw) : gh * w + (k - right);
      store_normal(normal, pix, unpack_normal(data[4 * pix + 1]));
    }
    return;
  }
  const int ty = b / px, tx = b % px, n = sp * sp, rr = r * r;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long pix = static_cast<long long>(ty * sp + i / sp) * w + tx * sp + i % sp;
    const V3 v = unpack_normal(data[4 * pix + 1]);
    store_normal(normal, pix, v);
    tn[0][i] = v.x, tn[1][i] = v.y, tn[2][i] = v.z;
  }
  for (int d = threadIdx.x; d < rr; d += blockDim.x) {
    const V3 v = octa_dir(d, r);
    dirs[0][d] = v.x, dirs[1][d] = v.y, dirs[2][d] = v.z;
  }
  __syncthreads();

  // One warp a direction: pdf = max(sum_i n_i . dir, 0) / sp^2, the sum by
  // `_sum_last`'s halving (the first step fused into the dot products).
  const int lanes = blockDim.x < 32 ? blockDim.x : 32;
  const int warps = blockDim.x / lanes, warp = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  float* s = scratch[warp];
  for (int d = warp; d < rr; d += warps) {
    const float dx = dirs[0][d], dy = dirs[1][d], dz = dirs[2][d];
#define RT3_DOT(i) (tn[0][i] * dx + tn[1][i] * dy + tn[2][i] * dz)
    int m = 1;
    if (n == 1) {
      if (lane == 0) s[0] = RT3_DOT(0);
    } else {
      const int half = n / 2;
      for (int i = lane; i < half; i += lanes) s[i] = RT3_DOT(i) + RT3_DOT(i + half);
      if ((n & 1) && lane == 0) s[half] = RT3_DOT(2 * half);
      m = half + (n & 1);
    }
#undef RT3_DOT
    __syncwarp();
    while (m > 1) {
      const int half = m / 2;
      for (int i = lane; i < half; i += lanes) s[i] = s[i] + s[i + half];
      __syncwarp();
      if (m & 1) {
        if (lane == 0) s[half] = s[2 * half];
        __syncwarp();
      }
      m = half + (m & 1);
    }
    if (lane == 0) pdf[d] = div_by_number(clamp_min(s[0], 0.0f), static_cast<float>(n));
    __syncwarp();
  }
  __syncthreads();

  // The stable ascending rank of each direction's pdf (ties by index, as a
  // stable argsort), and the direction of each rank.
  for (int i = threadIdx.x; i < rr; i += blockDim.x) {
    const float p = pdf[i];
    int k = 0;
    for (int j = 0; j < rr; ++j) k += (pdf[j] < p || (pdf[j] == p && j < i)) ? 1 : 0;
    rank[i] = k;
    order[k] = i;
  }
  __syncthreads();
  // The lowest ncull ranks are culled: rank q is retraced at the fine mip in
  // the direction of rank q from the top.
  for (int i = threadIdx.x; i < rr; i += blockDim.x) {
    const int k = rank[i];
    const int target = order[rr - 1 - k];
    const bool culled = k < ncull;
    const long long out = static_cast<long long>(b) * rr + i;
    dir_index[out] = culled ? static_cast<long long>(target / r) * 2 * (2 * r) + (target % r) * 2 : i;
    mip[out] = culled ? 1 : 0;
  }
}

// The sums of rows [0, rows) of t, n terms each, by halving (`_sum_last`'s
// order: pairs j and j + half, the odd tail carried), in place: row o's sum
// ends in t[o][0]. The block's threads share each level.
__device__ __forceinline__ void block_halving(float (*t)[kMaxDirs + 1], int rows, int n) {
  while (n > 1) {
    const int half = n / 2;
    for (int i = threadIdx.x; i < rows * half; i += blockDim.x) {
      const int o = i / half, j = i % half;
      t[o][j] = t[o][j] + t[o][j + half];
    }
    __syncthreads();
    if (n & 1) {
      for (int o = threadIdx.x; o < rows; o += blockDim.x) t[o][half] = t[o][2 * half];
      __syncthreads();
    }
    n = half + (n & 1);
  }
}

// Block b: probe (b / px, b % px). atlas [py * r, px * r, 3], depth
// [py * r, px * r]; out [py, px, 3, 9].
__global__ void __launch_bounds__(kShBlock) probe_sh_kernel(
    const float* __restrict__ atlas, const float* __restrict__ depth, int px, int r, int fill, float scale,
    float* __restrict__ out) {
  __shared__ float tex[3][kMaxDirs];
  __shared__ float basis[9][kMaxDirs];
  __shared__ float terms[27][kMaxDirs + 1];  // a row a sum (+1: rows start in other banks)
  __shared__ unsigned char written[kMaxDirs];
  const int b = static_cast<int>(blockIdx.x), ty = b / px, tx = b % px, rr = r * r;
  const long long aw = static_cast<long long>(px) * r;
  for (int d = threadIdx.x; d < rr; d += blockDim.x) {
    const long long t = static_cast<long long>(ty * r + d / r) * aw + tx * r + d % r;
    for (int c = 0; c < 3; ++c) tex[c][d] = atlas[3 * t + c];
    written[d] = depth[t] > 0.0f ? 1 : 0;
    const V3 v = octa_dir(d, r);
    for (int k = 0; k < 9; ++k) basis[k][d] = sh3(k, v.x, v.y, v.z);
  }
  __syncthreads();
  if (fill) {
    // The texels never written take the mean of the written ones.
    for (int i = threadIdx.x; i < 3 * rr; i += blockDim.x) {
      const int c = i / rr, d = i % rr;
      terms[c][d] = written[d] ? tex[c][d] : 0.0f;
    }
    __syncthreads();
    block_halving(terms, 3, rr);
    for (int c = threadIdx.x; c < 3; c += blockDim.x) {
      int count = 0;
      for (int d = 0; d < rr; ++d) count += written[d];
      terms[c][0] = terms[c][0] / clamp_min(static_cast<float>(count), 1.0f);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * rr; i += blockDim.x) {
      const int c = i / rr, d = i % rr;
      if (!written[d]) tex[c][d] = terms[c][0];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 27 * rr; i += blockDim.x) {
    const int o = i / rr, d = i % rr;
    terms[o][d] = tex[o / 9][d] * basis[o % 9][d];
  }
  __syncthreads();
  block_halving(terms, 27, rr);
  for (int o = threadIdx.x; o < 27; o += blockDim.x) out[static_cast<long long>(b) * 27 + o] = terms[o][0] * scale;
}

// The sum of the 9 terms of an SH3 dot product by halving (`_sum_last`'s
// order): four levels.
__device__ __forceinline__ float sum9(const float (&t)[9]) {
  return (((t[0] + t[4]) + (t[2] + t[6])) + ((t[1] + t[5]) + (t[3] + t[7]))) + t[8];
}

// probes._edge_weight of a neighbour anchor (pdep, pn) at a pixel (dep, nrm).
__device__ __forceinline__ float edge_weight(float pdep, V3 pn, float dep, V3 nrm, float w_bil) {
  float wgt = clamp(1.0f - fabsf(pdep - dep) / clamp_min(dep, F(1e-6)), 0.0f, 1.0f);
  wgt = wgt * clamp_min(nrm.x * pn.x + nrm.y * pn.y + nrm.z * pn.z, 0.0f);
  const float w2 = wgt * wgt, w4 = w2 * w2;
  return pdep < kBackground ? (w_bil + F(1e-3)) * (w4 * w4) : 0.0f;
}

// One thread a pixel of the h x w image: depth [h, w], normal [h, w, 3],
// data [h, w, 4] int64, sh [py, px, 3, 9]; out light [h, w, 3].
__global__ void __launch_bounds__(kPixBlock) probe_interpolate_kernel(
    const long long* __restrict__ data, const float* __restrict__ depth, const float* __restrict__ normal,
    const float* __restrict__ sh, int h, int w, int px, int py, int sp, int emission, float* __restrict__ light) {
  const long long pix = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pix >= static_cast<long long>(h) * w) return;
  const int y = static_cast<int>(pix / w), x = static_cast<int>(pix % w);
  const float dep = depth[pix];
  const V3 nrm{normal[3 * pix], normal[3 * pix + 1], normal[3 * pix + 2]};
  // sh.sh3_transform_cos_lobe(normal): the basis times the lobe's factors.
  float basis[9];
  for (int k = 0; k < 9; ++k) basis[k] = sh3(k, nrm.x, nrm.y, nrm.z) * (k == 0 ? kA0 : k < 4 ? kA1 : kA2);
  const int p0x = x / sp < px - 1 ? x / sp : px - 1, p0y = y / sp < py - 1 ? y / sp : py - 1;
  const float fx = div_by_number(static_cast<float>(x - p0x * sp), static_cast<float>(sp));
  const float fy = div_by_number(static_cast<float>(y - p0y * sp), static_cast<float>(sp));
  float wgt[4], irr[4][3];
  for (int nb = 0; nb < 4; ++nb) {
    const int oy = nb >> 1, ox = nb & 1;
    const int pxc = p0x + ox < px - 1 ? p0x + ox : px - 1, pyc = p0y + oy < py - 1 ? p0y + oy : py - 1;
    const long long a = static_cast<long long>(pyc * sp) * w + pxc * sp;
    const V3 pn{normal[3 * a], normal[3 * a + 1], normal[3 * a + 2]};
    wgt[nb] = edge_weight(depth[a], pn, dep, nrm, (ox ? fx : 1.0f - fx) * (oy ? fy : 1.0f - fy));
    const float* co = sh + (static_cast<long long>(pyc) * px + pxc) * 27;
    for (int c = 0; c < 3; ++c) {
      float t[9];
      for (int k = 0; k < 9; ++k) t[k] = co[9 * c + k] * basis[k];
      irr[nb][c] = clamp_min(sum9(t), 0.0f);
    }
  }
  // probes._blend_neighbours.
  const float wsum = wgt[0] + wgt[1] + wgt[2] + wgt[3];
  const float den = clamp_min(wsum, F(1e-8));
  float wn[4];
  for (int nb = 0; nb < 4; ++nb) wn[nb] = wgt[nb] / den;
  const unsigned a = static_cast<unsigned>(data[4 * pix]);
  const unsigned e = static_cast<unsigned>(data[4 * pix + 3]);
  const float scale = exp2_f(static_cast<float>(static_cast<int>(e & 31u) - 24));
  float out[3];
  for (int c = 0; c < 3; ++c) {
    // packing.unpack_color_888 and unpack_rgb9e5.
    const float alb = div_by_number(static_cast<float>((a >> (8 * c)) & 255u), 255.0f);
    const float emis = emission ? static_cast<float>((e >> (23 - 9 * c)) & 511u) * scale : 0.0f;
    float v = irr[0][c] * wn[0] + 0.0f;
    for (int nb = 1; nb < 4; ++nb) v = v + irr[nb][c] * wn[nb];
    out[c] = v * (alb * alb) * kInvPi + emis;
  }
  const bool failed = wsum <= F(1e-8), sky = dep >= kBackground;
  for (int c = 0; c < 3; ++c) light[3 * pix + c] = sky ? 0.0f : failed ? (c == 0 ? 1.0f : 0.0f) : out[c];
}

// A launch of `grid` blocks; the host shim runs each block as one thread.
template <typename... P, typename... A>
void launch_blocks(void (*kern)(P...), long long grid, int block, cudaStream_t stream, A... args) {
#ifdef RT3_HOST_SHIM
  (void)block, (void)stream;
  rt3_shim_launch(kern, static_cast<unsigned>(grid), 1u, 0, args...);
#else
  kern<<<static_cast<unsigned>(grid), block, 0, stream>>>(args...);
#endif
}

// A launch of one thread an element; the host shim runs each in turn.
template <typename... P, typename... A>
void launch_lanes(void (*kern)(P...), long long n, cudaStream_t stream, A... args) {
#ifdef RT3_HOST_SHIM
  (void)stream;
  rt3_shim_launch(kern, static_cast<unsigned>(n), 1u, 0, args...);
#else
  kern<<<static_cast<unsigned>((n + kPixBlock - 1) / kPixBlock), kPixBlock, 0, stream>>>(args...);
#endif
}

bool grid_ok(int h, int w, int px, int py, int sp) {
  return h >= 1 && w >= 1 && px >= 1 && py >= 1 && sp >= 1 && static_cast<long long>(px) * sp <= w &&
         static_cast<long long>(py) * sp <= h && static_cast<long long>(h) * w <= 0x7fffffffLL;
}

}  // namespace

// SIS of an h x w packed G-buffer (data [h, w, 4] int64) over px x py probes
// of spacing sp <= 32 and r x r <= 256 directions, the lowest ncull ranks
// culled; out normal [h, w, 3], dir_index and mip [py, px, r * r] int64.
extern "C" int rt3_probe_sis(const long long* data, int h, int w, int px, int py, int sp, int r, int ncull,
                             float* normal, long long* dir_index, long long* mip, void* stream) {
  if (!grid_ok(h, w, px, py, sp) || sp > kMaxSpacing || r < 1 || r * r > kMaxDirs || ncull < 0 || ncull > r * r) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long outside = static_cast<long long>(h) * w - static_cast<long long>(px) * sp * py * sp;
#ifdef RT3_HOST_SHIM
  const long long extra = outside;  // one thread a block
#else
  long long extra = (outside + kSisBlock - 1) / kSisBlock;
  extra = extra > 1024 ? 1024 : extra;
#endif
  launch_blocks(probe_sis_kernel, static_cast<long long>(px) * py + extra, kSisBlock,
                static_cast<cudaStream_t>(stream), data, h, w, px, py, sp, r, ncull, static_cast<int>(extra), normal,
                dir_index, mip);
  return static_cast<int>(cudaGetLastError());
}

// SH3 of px x py probes of r x r <= 256 texels: atlas [py * r, px * r, 3],
// depth [py * r, px * r] (0: never written), fill 0 / 1, scale 4 pi / r^2;
// out [py, px, 3, 9].
extern "C" int rt3_probe_sh(const float* atlas, const float* depth, int px, int py, int r, int fill, float scale,
                            float* out, void* stream) {
  if (px < 1 || py < 1 || r < 1 || r * r > kMaxDirs || static_cast<long long>(px) * py * r * r > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch_blocks(probe_sh_kernel, static_cast<long long>(px) * py, kShBlock, static_cast<cudaStream_t>(stream), atlas,
                depth, px, r, fill, scale, out);
  return static_cast<int>(cudaGetLastError());
}

// The lit image of an h x w frame: data [h, w, 4] int64, depth [h, w],
// normal [h, w, 3], sh [py, px, 3, 9] of probes of spacing sp, emission
// 0 / 1; out light [h, w, 3].
extern "C" int rt3_probe_interpolate(const long long* data, const float* depth, const float* normal, const float* sh,
                                     int h, int w, int px, int py, int sp, int emission, float* light,
                                     void* stream) {
  if (!grid_ok(h, w, px, py, sp)) return static_cast<int>(cudaErrorInvalidValue);
  launch_lanes(probe_interpolate_kernel, static_cast<long long>(h) * w, static_cast<cudaStream_t>(stream), data,
               depth, normal, sh, h, w, px, py, sp, emission, light);
  return static_cast<int>(cudaGetLastError());
}
