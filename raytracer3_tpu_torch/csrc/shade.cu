// The wavefront's shade pass: everything `render/wavefront._shade` does
// between a bounce's recorded hit and its next launch, one thread a lane:
//
//   1. the hit's surface: its shade-table row (16 lanes, or 32 with vertex
//      colours) and material row (`scene/types.hit_surface_info`, with the
//      instance's normal matrix and material override on two-level scenes);
//   2. the barycentric normal, normalised and face-forwarded;
//   3. the emissive pickup, MIS-weighted against NEE from bounce 1 on;
//   4. NEE's light sample (`render/pathtracer._nee_prepare`: area lights by
//      a binary search of the area CDF, the env by its alias row, or the
//      mixture of both; the branch is the template's `Mode`) and its tail
//      (`_nee_finish`: the BRDF toward the light, the MIS weight, the
//      optional shadow-ray roulette): the shadow batch;
//   5. the BRDF sample (`ops/brdf.surface_sample` or `diffuse_sample`) in the
//      ONB of the face-forwarded normal;
//   6. liveness, then Russian roulette from `rr_start` on.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA
// (`raytracer3_tpu/render/wavefront.py`'s `_shade`, which XLA fuses inside
// its jitted step). Its plain version is the port's own PyTorch `_shade`,
// which the CPU and every scene this kernel does not cover (textures, no
// shade rows) still take; the wrapper is ops/shade_kernel.py.
//
// Three forms from one source (`Form`):
//   - kDeferred: all of the above in one pass; the shadow batch goes out to
//     ride the next launch (the tail bounce, and the fused launch);
//   - kSplitA: 1-4 before a bounce's own shadow launch: the radiance after
//     the emissive pickup and the shadow batch;
//   - kSplitB: after it: the occlusion bits add NEE, then 5-6. It re-reads
//     the lane's table rows rather than take the surface across the launch,
//     so no more lane state crosses a launch than the PyTorch path carries.
// With the lane diet, A writes the radiance and NEE's contribution as
// rgb9e5 words, and B rounds the incoming throughput through rgb9e5 for
// NEE's add, as the PyTorch path's pack and unpack do; the BRDF step reads
// the throughput unrounded.
//
// Every draw is murmur3(seed, counter) with the mantissa trick, on the
// counters the PyTorch path's order gives: the wrapper passes the first.
// The arithmetic is the PyTorch path's, operation for operation and in its
// order (the source builds with --fmad=false: no multiply-add is
// contracted, as PyTorch's separate elementwise kernels contract none), so
// the outputs are the plain path's bits wherever the functions agree. Two
// of PyTorch's rules differ between its CPU and CUDA kernels and are kept
// per build: a tensor divided by a Python number is a true division on the
// CPU and a product with the number's float reciprocal on CUDA
// (`div_by_number`), and a mean of 3 is a sum then a division on the CPU and
// a product with a float factor on CUDA (`mean3`). On the CPU the host shim's
// libm sqrtf, sinf and cosf are correctly rounded where PyTorch's
// vectorised CPU kernels are not always (tests/test_torch_shade_kernel.py).
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): bytes. A lane
// reads its queue columns (~80 B) and writes its outputs (~50-95 B); its
// shade, material and light rows are gathered from tables of a few MB that
// L2 holds. The arithmetic (~600 flops a lane, a few sqrt, sin and cos) is
// ~1.3 GFLOP a pass, far under the card's rate. The design meets the bound
// by reading each column and row once into registers and writing each
// output once; nothing is staged in shared memory, since no two lanes
// share a row in a predictable way. On bounce 1 of a 1920x1088 frame
// (2.09M lanes; chip_smoke.py's shade phase, PERF.md) the deferred pass
// takes 0.25 ms against its 0.107 ms bytes bound (2.3x), A 0.15 against
// 0.081, B 0.14 against 0.087, where the PyTorch path's deferred form took
// 19.4 ms.

#ifdef RT3_HOST_SHIM
#include "host_shim.h"  // g++ build for the CPU tests: one thread at a time
#else
#include <cuda_runtime.h>
#endif

#include <cmath>
#include <cstddef>

namespace {

constexpr int kBlock = 128;

enum Form { kDeferred = 0, kSplitA = 1, kSplitB = 2 };
enum Mode { kNoNee = 0, kArea = 1, kEnv = 2, kMix = 3 };

#ifdef RT3_HOST_SHIM
// Correctly rounded: the tests hold these to the plain path run with
// correctly rounded functions too.
inline float rsqrt_f(float x) { return 1.0f / std::sqrt(x); }  // PyTorch's CPU rsqrt: 1 / sqrt
inline float sqrt_f(float x) { return std::sqrt(x); }
inline float sin_f(float x) { return static_cast<float>(std::sin(static_cast<double>(x))); }
inline float cos_f(float x) { return static_cast<float>(std::cos(static_cast<double>(x))); }
inline float exp2_f(float x) { return std::exp2(x); }
inline float floor_f(float x) { return std::floor(x); }
#else
__device__ __forceinline__ float rsqrt_f(float x) { return rsqrtf(x); }  // PyTorch's CUDA rsqrt
__device__ __forceinline__ float sqrt_f(float x) { return sqrtf(x); }
__device__ __forceinline__ float sin_f(float x) { return sinf(x); }
__device__ __forceinline__ float cos_f(float x) { return cosf(x); }
__device__ __forceinline__ float exp2_f(float x) { return exp2f(x); }
__device__ __forceinline__ float floor_f(float x) { return floorf(x); }
#endif

// A tensor divided by a Python number.
__device__ __forceinline__ float div_by_number(float a, float b) {
#ifdef RT3_HOST_SHIM
  return a / b;
#else
  return a * (1.0f / b);
#endif
}

// torch.mean over a last axis of 3.
__device__ __forceinline__ float mean3(float a0, float a1, float a2, float factor) {
#ifdef RT3_HOST_SHIM
  (void)factor;
  return ((a0 + a1) + a2) / 3.0f;
#else
  return ((a0 + a2) + a1) * factor;
#endif
}

// A Python float as PyTorch takes it: the double rounded to float.
#define F(x) static_cast<float>(x)
constexpr float kTau = F(6.283185307179586476925286766559);
constexpr float kPi = F(3.141592653589793238462643383279);
constexpr float kInvPi = F(0.3183098861837906715377675267450);
constexpr float kBrdfMinCos = F(1e-5);
constexpr float kEps20 = F(1e-20);
constexpr float kMaxRgb9e5 = 65408.0f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

// PyTorch's clamps and max: a NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) { return clamp_max(clamp_min(x, lo), hi); }
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float amax3(V3 a) { return max_nan(max_nan(a.x, a.y), a.z); }

__device__ __forceinline__ V3 normalize(V3 v) { return scale(v, rsqrt_f(clamp_min(dot(v, v), kEps20))); }

__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }
__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// ops/rng: one MurmurHash3 round and finalizer keyed on (seed, counter),
// then the mantissa trick.
__device__ __forceinline__ unsigned rotl32(unsigned x, int r) { return (x << r) | (x >> (32 - r)); }
__device__ __forceinline__ float draw(unsigned seed, unsigned counter) {
  unsigned k = counter * 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  unsigned h = seed ^ k;
  h = rotl32(h, 13) * 5u + 0xE6546B64u;
  h ^= 4u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return __int_as_float(static_cast<int>((h & 0x7FFFFFu) | 0x3F800000u)) - 1.0f;
}

// ops/packing's rgb9e5 word of a non-negative colour, and back.
__device__ __forceinline__ unsigned pack_rgb9e5(V3 rgb) {
  const V3 c = v3(clamp(rgb.x, 0.0f, kMaxRgb9e5), clamp(rgb.y, 0.0f, kMaxRgb9e5), clamp(rgb.z, 0.0f, kMaxRgb9e5));
  const float maxrgb = amax3(c);
  const int floor_log2 = ((__float_as_int(maxrgb) & 0x7F800000) >> 23) - 127;
  int exp_shared = (floor_log2 < -16 ? -16 : floor_log2) + 1 + 15;
  float denom = exp2_f(static_cast<float>(exp_shared - 15 - 9));
  const int maxm = static_cast<int>(floor_f(maxrgb / denom + 0.5f));
  if (maxm == 512) {
    denom = denom * 2.0f;
    exp_shared = exp_shared + 1;
  }
  const long long m0 = static_cast<long long>(floor_f(c.x / denom + 0.5f));
  const long long m1 = static_cast<long long>(floor_f(c.y / denom + 0.5f));
  const long long m2 = static_cast<long long>(floor_f(c.z / denom + 0.5f));
  return static_cast<unsigned>(((m0 << 23) | (m1 << 14) | (m2 << 5) | static_cast<long long>(exp_shared)) &
                               0xFFFFFFFFll);
}

__device__ __forceinline__ V3 unpack_rgb9e5(unsigned v) {
  const float s = exp2_f(static_cast<float>(static_cast<int>(v & 0x1Fu) - 15 - 9));
  return v3(static_cast<float>((v >> 23) & 511u) * s, static_cast<float>((v >> 14) & 511u) * s,
            static_cast<float>((v >> 5) & 511u) * s);
}

// ops/mathx.build_orthonormal_basis: columns b1, b2, n.
struct Onb {
  V3 b1, b2, n;
};

__device__ __forceinline__ Onb onb_of(V3 n) {
  const float s = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (s + n.z);
  const float b = n.x * n.y * a;
  return Onb{v3(1.0f + s * n.x * n.x * a, s * b, -s * n.x), v3(b, s + n.y * n.y * a, -n.y), n};
}

__device__ __forceinline__ V3 to_local(const Onb& m, V3 v) { return v3(dot(m.b1, v), dot(m.b2, v), dot(m.n, v)); }
__device__ __forceinline__ V3 to_world(const Onb& m, V3 v) {
  return add(add(scale(m.b1, v.x), scale(m.b2, v.y)), scale(m.n, v.z));
}

// ops/brdf.

__device__ __forceinline__ V3 fresnel_schlick_rgb(V3 f0, float cos_theta) {
  const float m = clamp_min(1.0f - cos_theta, 0.0f);
  const float m5 = m * m * m * m * m;
  return v3(f0.x + (1.0f - f0.x) * m5, f0.y + (1.0f - f0.y) * m5, f0.z + (1.0f - f0.z) * m5);
}

__device__ __forceinline__ float g_smith_ggx_correlated(float ndotv, float ndotl, float a2) {
  const float lambda_v = ndotl * sqrt_f((-ndotv * a2 + ndotv) * ndotv + a2);
  const float lambda_l = ndotv * sqrt_f((-ndotl * a2 + ndotl) * ndotl + a2);
  return 2.0f * ndotl * ndotv / clamp_min(lambda_v + lambda_l, kEps20);
}

__device__ __forceinline__ float g_smith_ggx1(float ndotv, float a2) {
  const float nv2 = clamp_min(ndotv * ndotv, kEps20);
  const float tan2_v = (1.0f - nv2) / nv2;
  return 2.0f / (1.0f + sqrt_f(1.0f + a2 * tan2_v));
}

__device__ __forceinline__ float ggx_ndf(float a2, float cos_theta) {
  const float d = cos_theta * cos_theta * (a2 - 1.0f) + 1.0f;
  return a2 / clamp_min(kPi * d * d, kEps20);
}

__device__ __forceinline__ float pdf_ggx_vn(float a2, V3 wo, V3 h) {
  const float g1 = g_smith_ggx1(wo.z, a2);
  const float d = ggx_ndf(a2, h.z);
  return g1 * d * clamp_min(dot(wo, h), 0.0f) / clamp_min(wo.z, kEps20);
}

__device__ __forceinline__ V3 sample_vndf(float alpha, V3 wo, float u0, float u1) {
  const V3 vh = normalize(v3(alpha * wo.x, alpha * wo.y, wo.z));
  const V3 t1 = vh.z < F(0.9999) ? normalize(cross(v3(0.0f, 0.0f, 1.0f), vh)) : v3(1.0f, 0.0f, 0.0f);
  const V3 t2 = cross(vh, t1);
  const float r = sqrt_f(u0);
  const float phi = kTau * u1;
  const float p1 = r * cos_f(phi);
  float p2 = r * sin_f(phi);
  const float s = 0.5f * (1.0f + vh.z);
  p2 = (1.0f - s) * sqrt_f(clamp_min(1.0f - p1 * p1, 0.0f)) + s * p2;
  const V3 nh = add(add(scale(t1, p1), scale(t2, p2)), scale(vh, sqrt_f(clamp_min(1.0f - p1 * p1 - p2 * p2, 0.0f))));
  return normalize(v3(alpha * nh.x, alpha * nh.y, clamp_min(nh.z, 0.0f)));
}

__device__ __forceinline__ V3 cosine_sample_hemisphere(float u, float v) {
  const float phi = u * kTau;
  const float cos_theta = sqrt_f(clamp_min(1.0f - v, 0.0f));
  const float sin_theta = sqrt_f(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
  return v3(cos_f(phi) * sin_theta, sin_f(phi) * sin_theta, cos_theta);
}

struct Lobes {
  V3 f0, kd;
  float p_spec;
};

__device__ __forceinline__ Lobes lobe_setup(V3 albedo, float metalness, V3 wo, float mean_factor) {
  const float f = F(0.04);
  const V3 f0 = v3(f + (albedo.x - f) * metalness, f + (albedo.y - f) * metalness, f + (albedo.z - f) * metalness);
  const V3 kd = scale(albedo, 1.0f - metalness);
  const V3 fr = fresnel_schlick_rgb(f0, clamp_min(wo.z, 0.0f));
  const float f_avg = mean3(fr.x, fr.y, fr.z, mean_factor);
  const float d_avg = mean3(kd.x, kd.y, kd.z, mean_factor);
  return Lobes{f0, kd, clamp(f_avg / clamp_min(f_avg + d_avg, F(1e-6)), F(0.05), F(0.95))};
}

struct BrdfValue {
  V3 value;
  float pdf;
};

__device__ __forceinline__ BrdfValue diffuse_evaluate(V3 albedo, V3 wi) {
  const bool up = wi.z > 0.0f;
  const float pdf = up ? kInvPi : 0.0f;
  const V3 vop = up ? albedo : v3(0.0f, 0.0f, 0.0f);
  return BrdfValue{scale(vop, pdf), pdf};
}

__device__ __forceinline__ BrdfValue specular_evaluate(float roughness, V3 f0, V3 wo, V3 wi) {
  const float a2 = roughness * roughness;
  const bool valid = (wi.z > 0.0f) && (wo.z > 0.0f);
  const V3 m = normalize(add(wo, wi));
  const float pdf_h = pdf_ggx_vn(a2, wo, m);
  const float jacobian = 1.0f / clamp_min(4.0f * dot(wi, m), kEps20);
  const V3 fresnel = fresnel_schlick_rgb(f0, dot(m, wi));
  const float g = g_smith_ggx_correlated(wo.z, wi.z, a2);
  const float pdf = pdf_h * jacobian / clamp_min(wi.z, kEps20);
  const V3 value = scale(fresnel, g * ggx_ndf(a2, m.z) / clamp_min(4.0f * wo.z * wi.z, kEps20));
  return BrdfValue{valid ? value : v3(0.0f, 0.0f, 0.0f), valid ? pdf : 0.0f};
}

// brdf.surface_evaluate (NEE) or diffuse_evaluate (diffuse_only).
__device__ __forceinline__ BrdfValue surface_evaluate(V3 albedo, float roughness, float metalness, V3 wo, V3 wi,
                                                      bool diffuse_only, float mean_factor) {
  if (diffuse_only) return diffuse_evaluate(albedo, wi);
  const Lobes l = lobe_setup(albedo, metalness, wo, mean_factor);
  const BrdfValue dv = diffuse_evaluate(l.kd, wi);
  const BrdfValue sv = specular_evaluate(roughness, l.f0, wo, wi);
  return BrdfValue{add(dv.value, sv.value), l.p_spec * sv.pdf + (1.0f - l.p_spec) * dv.pdf};
}

struct BrdfSample {
  V3 wi, value_over_pdf;
  float pdf;
  bool valid;
};

__device__ __forceinline__ BrdfSample surface_sample(V3 albedo, float roughness, float metalness, V3 wo, float u0,
                                                     float u1, float u2, float mean_factor) {
  const Lobes l = lobe_setup(albedo, metalness, wo, mean_factor);
  const bool pick_spec = u2 < l.p_spec;
  // The diffuse lobe's sample.
  const V3 ds_wi = cosine_sample_hemisphere(u0, u1);
  const bool ds_valid = ds_wi.z > F(1e-6);
  // The specular lobe's: the VNDF half-vector reflected.
  const V3 h = sample_vndf(roughness, wo, u0, u1);
  const V3 v = neg(wo);
  const V3 r = sub(v, scale(h, 2.0f * dot(v, h)));
  const bool ss_valid = (h.z > kBrdfMinCos) && (r.z > kBrdfMinCos) && (wo.z > kBrdfMinCos);
  const V3 ss_wi = ss_valid ? r : v3(0.0f, 0.0f, -1.0f);
  const V3 wi = pick_spec ? ss_wi : ds_wi;
  const BrdfValue dv = diffuse_evaluate(l.kd, wi);
  const BrdfValue sv = specular_evaluate(roughness, l.f0, wo, wi);
  const float pdf = l.p_spec * sv.pdf + (1.0f - l.p_spec) * dv.pdf;
  const V3 value = add(dv.value, sv.value);
  const float denom = clamp_min(pdf, kEps20);
  const V3 vop = v3(value.x / denom, value.y / denom, value.z / denom);
  const bool valid = (pick_spec ? ss_valid : ds_valid) && (pdf > 0.0f);
  return BrdfSample{wi, valid ? vop : v3(0.0f, 0.0f, 0.0f), valid ? pdf : 0.0f, valid};
}

}  // namespace

// Everything a launch reads and writes (ops/shade_kernel.py mirrors it with
// ctypes). Row strides are in elements; a stride of 0 gives every lane the
// same row (the first bounce's constant throughput, radiance and pdf).
struct ShadeArgs {
  // The queue.
  const float* origin;
  const float* direction;
  const float* throughput;
  const float* radiance;
  const unsigned char* alive;
  const float* prev_pdf;
  const float* depth;
  const int* prim_id;
  const float* uv;
  const int* inst;  // null: one-level scene
  const long long* seed;
  long long s_origin, s_direction, s_throughput, s_radiance, s_alive, s_prev_pdf, s_depth, s_prim_id, s_uv, s_inst,
      s_seed;
  // The scene's tables.
  const float* shade_table;
  const float* mat_table;
  const float* inst_normal_mats;  // null: none
  const float* inst_mat_table;    // null: none
  const float* light_table;
  const float* cdf;
  const float* total_area;  // the 0-d tensor
  const float* env_table;
  long long n_tris, n_lights, n_env;
  int shade_row, mat_row, light_row, env_row, inst_mat_row, env_h, env_w;
  // Pass B's inputs: pass A's radiance and contribution (float [n, 3], or
  // int32 rgb9e5 words [n] under the diet), its pre_ok and the occlusion bits.
  const void* radiance_a;
  const void* contrib_a;
  const unsigned char* pre_ok_a;
  const unsigned char* blocked;
  long long s_blocked;
  // Outputs.
  void* radiance_out;  // float [n, 3]; pass A under the diet: int32 words [n]
  float* hit_pos;
  float* new_dir;
  float* throughput_out;
  float* prev_pdf_out;
  unsigned char* alive_out;
  float* shadow_o;
  float* shadow_d;
  float* shadow_t;
  unsigned char* pre_ok;
  void* contrib;  // float [n, 3]; pass A under the diet: int32 words [n]
  long long n;
  unsigned index;  // the sampler's counter at the pass's first draw
  int emit_mis;    // bounce > 0: the emissive pickup is MIS-weighted against NEE
  int diffuse_only;
  int roulette;  // bounce >= rr_start
  int diet;
  float q_env, one_minus_q_env, nee_rr_threshold, mean_factor;
};

namespace {

struct Surface {
  V3 albedo, emissive, normal;
  float roughness, metalness;
};

// scene/types.hit_surface_info's fast path.
__device__ __forceinline__ Surface surface_at(const ShadeArgs& a, long long i) {
  long long pid = a.prim_id[i * a.s_prim_id];
  pid = pid < 0 ? 0 : (pid > a.n_tris - 1 ? a.n_tris - 1 : pid);
  const float* row = a.shade_table + pid * a.shade_row;
  const float u = a.uv[i * a.s_uv], v = a.uv[i * a.s_uv + 1];
  const float w0 = 1.0f - u - v, w1 = u, w2 = v;
  V3 nrm = v3(row[0] * w0 + row[3] * w1 + row[6] * w2, row[1] * w0 + row[4] * w1 + row[7] * w2,
              row[2] * w0 + row[5] * w1 + row[8] * w2);
  long long iid = -1;
  if (a.inst != nullptr) {
    iid = a.inst[i * a.s_inst];
    iid = iid < 0 ? 0 : iid;
    if (a.inst_normal_mats != nullptr) {
      const float* nm = a.inst_normal_mats + iid * 9;
      nrm = v3(nm[0] * nrm.x + nm[1] * nrm.y + nm[2] * nrm.z, nm[3] * nrm.x + nm[4] * nrm.y + nm[5] * nrm.z,
               nm[6] * nrm.x + nm[7] * nrm.y + nm[8] * nrm.z);
    }
  }
  const float* mat = a.mat_table + static_cast<long long>(row[15]) * a.mat_row;
  if (iid >= 0 && a.inst_mat_table != nullptr) {
    const float* imat = a.inst_mat_table + iid * a.inst_mat_row;
    if (imat[11] > 0.5f) mat = imat;
  }
  V3 color = load3(mat);
  if (a.shade_row > 16) {
    color = mul(color, v3(row[16] * w0 + row[19] * w1 + row[22] * w2, row[17] * w0 + row[20] * w1 + row[23] * w2,
                          row[18] * w0 + row[21] * w1 + row[24] * w2));
  }
  return Surface{color, load3(mat + 3), normalize(nrm), mat[7], mat[6]};
}

// pathtracer._env_row_consume: direction, radiance and pdf of an alias row.
struct EnvSample {
  V3 wi, le;
  float pdf;
};

__device__ __forceinline__ EnvSample env_row_consume(const ShadeArgs& a, const float* row, long long kc, float u1,
                                                     float u2) {
  const bool take_alias = u1 >= row[0];
  const long long idx = take_alias ? static_cast<long long>(row[1]) : kc;
  const float pdf = take_alias ? row[6] : row[2];
  const V3 le = take_alias ? load3(row + 7) : load3(row + 3);
  const long long y = idx / a.env_w;  // idx >= 0: floor division
  const long long x = idx % a.env_w;
  const float prob = row[0];
  float jv = take_alias ? (u1 - prob) / clamp_min(1.0f - prob, F(1e-9))
                        : u1 / clamp_min(prob, F(1e-9));
  jv = clamp(jv, 0.0f, F(0.999999));
  const float eu = div_by_number(static_cast<float>(x) + u2, static_cast<float>(a.env_w));
  const float ev = div_by_number(static_cast<float>(y) + jv, static_cast<float>(a.env_h));
  // mathx.equirect_uv_to_direction
  const float phi = (eu - 0.5f) * kTau;
  const float theta = (0.5f - ev) * kPi;
  const float cos_t = cos_f(theta);
  return EnvSample{v3(cos_t * cos_f(phi), sin_f(theta), cos_t * sin_f(phi)), le, pdf};
}

__device__ __forceinline__ long long env_pick(long long n_tex, float u0) {
  const long long k = static_cast<long long>(u0 * static_cast<float>(n_tex));
  return k < 0 ? 0 : (k > n_tex - 1 ? n_tex - 1 : k);
}

// torch.searchsorted(cdf, u) (left), clamped to the table.
__device__ __forceinline__ long long light_pick(const ShadeArgs& a, float u) {
  long long lo = 0, hi = a.n_lights;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (!(a.cdf[mid] >= u)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo > a.n_lights - 1 ? a.n_lights - 1 : lo;
}

struct Shadow {
  V3 o, wi, contrib;
  float t;
  bool pre_ok;
};

// pathtracer._nee_prepare and _nee_finish for one lane; `counter` is the
// sampler's counter after u_l and advances past NEE's own draws.
template <int M>
__device__ __forceinline__ Shadow nee(const ShadeArgs& a, const Surface& sf, V3 hit_pos, V3 nrm, V3 wo_world,
                                      const Onb& onb, float ul0, float ul1, float ul2, unsigned seed,
                                      unsigned& counter, bool alive, V3 throughput) {
  V3 wi_world, le_sel;
  float pdf_sel, t_shadow;
  bool valid_sel;
  const float total_area = *a.total_area;
  if constexpr (M == kArea) {
    const float* row = a.light_table + light_pick(a, ul0) * a.light_row;
    const V3 v0 = load3(row), e1 = load3(row + 3), e2 = load3(row + 6);
    le_sel = load3(row + 9);
    const V3 v1 = add(v0, e1), v2 = add(v0, e2);
    const float su = sqrt_f(clamp_min(ul1, 0.0f));
    const float b0 = 1.0f - su;
    const float b1 = ul2 * su;
    const float b2 = 1.0f - b0 - b1;
    const V3 p = add(add(scale(v0, b0), scale(v1, b1)), scale(v2, b2));
    const V3 to_l = sub(p, hit_pos);
    const float dist2 = dot(to_l, to_l);
    const float dist = sqrt_f(clamp_min(dist2, F(1e-12)));
    wi_world = v3(to_l.x / dist, to_l.y / dist, to_l.z / dist);
    const V3 l_nrm = normalize(cross(sub(v1, v0), sub(v2, v0)));
    const float cos_l = fabsf(dot(l_nrm, neg(wi_world)));
    pdf_sel = dist2 / clamp_min(cos_l * total_area, kEps20);
    valid_sel = (row[12] > 0.5f) && (cos_l > F(1e-6)) && (pdf_sel > 0.0f);
    t_shadow = dist * F(1.0 - 1e-3);
  } else {
    const float ue0 = draw(seed, counter), ue1 = draw(seed, counter + 1u), ue2 = draw(seed, counter + 2u);
    const float u_sel = draw(seed, counter + 3u);
    counter += 4u;
    const bool choose_env = u_sel < a.q_env;
    const long long k_env = env_pick(a.n_env, ue0);
    if constexpr (M == kEnv) {
      const EnvSample es = env_row_consume(a, a.env_table + k_env * a.env_row, k_env, ue1, ue2);
      wi_world = choose_env ? es.wi : v3(0.0f, 1.0f, 0.0f);
      le_sel = choose_env ? es.le : v3(0.0f, 0.0f, 0.0f);
      pdf_sel = choose_env ? a.q_env * es.pdf : a.one_minus_q_env * 0.0f;
      valid_sel = choose_env ? es.pdf > 0.0f : false;
      t_shadow = choose_env ? F(100000.0 * 0.9) : 0.0f;
    } else if (choose_env) {  // kMix, the env row
      const EnvSample es = env_row_consume(a, a.env_table + k_env * a.env_row, k_env, ue1, ue2);
      wi_world = es.wi;
      le_sel = es.le;
      pdf_sel = a.q_env * es.pdf;
      valid_sel = es.pdf > 0.0f;
      t_shadow = F(100000.0 * 0.9);
    } else {  // kMix, an area light's row
      const float* row = a.light_table + light_pick(a, ul0) * a.light_row;
      const V3 v0 = load3(row), e1 = load3(row + 3), e2 = load3(row + 6);
      le_sel = load3(row + 9);
      const float su = sqrt_f(clamp_min(ul1, 0.0f));
      const float b0 = 1.0f - su;
      const float b1 = ul2 * su;
      const float b2 = 1.0f - b0 - b1;
      const V3 p = add(add(v0, scale(e1, b1)), scale(e2, b2));
      const V3 to_l = sub(p, hit_pos);
      const float dist2 = to_l.x * to_l.x + to_l.y * to_l.y + to_l.z * to_l.z;
      const float dist = sqrt_f(clamp_min(dist2, F(1e-12)));
      wi_world = v3(to_l.x / dist, to_l.y / dist, to_l.z / dist);
      const V3 l_nrm = normalize(cross(e1, e2));
      const float cos_l = fabsf(dot(l_nrm, neg(wi_world)));
      const float pdf_a = dist2 / clamp_min(cos_l * total_area, kEps20);
      pdf_sel = a.one_minus_q_env * pdf_a;
      valid_sel = (row[12] > 0.5f) && (cos_l > F(1e-6)) && (pdf_a > 0.0f);
      t_shadow = dist * F(1.0 - 1e-3);
    }
  }
  // _nee_finish
  const float cos_s = dot(nrm, wi_world);
  const V3 wo_l = to_local(onb, wo_world);
  const V3 wi_l = to_local(onb, wi_world);
  const BrdfValue ev =
      surface_evaluate(sf.albedo, sf.roughness, sf.metalness, wo_l, wi_l, a.diffuse_only != 0, a.mean_factor);
  const float pdf_brdf = ev.pdf * clamp_min(wi_l.z, 0.0f);
  const float mis_w = pdf_sel / clamp_min(pdf_sel + pdf_brdf, kEps20);
  bool pre_ok = valid_sel && (cos_s > 0.0f) && alive;
  V3 contrib = scale(mul(ev.value, le_sel), cos_s * mis_w / clamp_min(pdf_sel, kEps20));
  if (a.nee_rr_threshold > 0.0f) {
    const float inc = clamp_min(F(0.2126) * contrib.x * throughput.x +
                                    F(0.7152) * contrib.y * throughput.y +
                                    F(0.0722) * contrib.z * throughput.z,
                                0.0f);
    const float p = clamp(div_by_number(inc, a.nee_rr_threshold), F(0.05), 1.0f);
    const float u_rr = draw(seed, counter);
    counter += 1u;
    pre_ok = pre_ok && (u_rr < p);
    contrib = v3(contrib.x / p, contrib.y / p, contrib.z / p);
  }
  const V3 o = pre_ok ? add(hit_pos, scale(nrm, F(1e-3))) : v3(F(1e30), F(1e30), F(1e30));
  return Shadow{o, wi_world, contrib, t_shadow, pre_ok};
}

template <int F, int M>
__global__ void __launch_bounds__(kBlock) shade_kernel(ShadeArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const unsigned seed = static_cast<unsigned>(a.seed[i * a.s_seed] & 0xFFFFFFFFll);
  unsigned counter = a.index;
  const bool alive = a.alive[i * a.s_alive] != 0;
  const V3 d = load3(a.direction + i * a.s_direction);
  const V3 o = load3(a.origin + i * a.s_origin);
  const V3 thr = load3(a.throughput + i * a.s_throughput);
  const float depth = a.depth[i * a.s_depth];
  const Surface sf = surface_at(a, i);
  const V3 wo = neg(d);
  const V3 nrm = scale(sf.normal, dot(sf.normal, wo) < 0.0f ? -1.0f : 1.0f);
  const Onb onb = onb_of(nrm);
  const V3 hit_pos = add(o, scale(d, depth));

  V3 radiance;
  if constexpr (F != kSplitB) {
    // The emissive pickup.
    float emit_w = 1.0f;
    if constexpr (M != kNoNee) {
      if (a.emit_mis) {
        const float cos_l = fabsf(dot(nrm, wo));
        const float pdf_light = a.one_minus_q_env * (depth * depth) / clamp_min(cos_l * *a.total_area, kEps20);
        const float prev_pdf = a.prev_pdf[i * a.s_prev_pdf];
        const float w = prev_pdf / clamp_min(prev_pdf + pdf_light, kEps20);
        emit_w = amax3(sf.emissive) > 0.0f ? w : 1.0f;
      }
    }
    const V3 e = alive ? scale(mul(thr, sf.emissive), emit_w) : v3(0.0f, 0.0f, 0.0f);
    radiance = add(load3(a.radiance + i * a.s_radiance), e);
  }

  if constexpr (F != kSplitB && M != kNoNee) {
    const float ul0 = draw(seed, counter), ul1 = draw(seed, counter + 1u), ul2 = draw(seed, counter + 2u);
    counter += 3u;
    const Shadow sh = nee<M>(a, sf, hit_pos, nrm, wo, onb, ul0, ul1, ul2, seed, counter, alive, thr);
    store3(a.shadow_o, i, sh.o);
    store3(a.shadow_d, i, sh.wi);
    a.shadow_t[i] = sh.t;
    a.pre_ok[i] = sh.pre_ok ? 1 : 0;
    if (F == kSplitA && a.diet) {
      static_cast<int*>(a.contrib)[i] = static_cast<int>(pack_rgb9e5(sh.contrib));
    } else {
      store3(static_cast<float*>(a.contrib), i, sh.contrib);
    }
  }

  if constexpr (F == kSplitA) {
    if (a.diet) {
      static_cast<int*>(a.radiance_out)[i] = static_cast<int>(pack_rgb9e5(radiance));
    } else {
      store3(static_cast<float*>(a.radiance_out), i, radiance);
    }
    return;
  } else {
    if constexpr (F == kSplitB) {
      // NEE's add after the shadow launch, on the diet's rounded colours.
      V3 contrib;
      V3 q_thr = thr;
      if (a.diet) {
        radiance = unpack_rgb9e5(static_cast<unsigned>(static_cast<const int*>(a.radiance_a)[i]));
        contrib = unpack_rgb9e5(static_cast<unsigned>(static_cast<const int*>(a.contrib_a)[i]));
        q_thr = unpack_rgb9e5(pack_rgb9e5(thr));
      } else {
        radiance = load3(static_cast<const float*>(a.radiance_a) + 3 * i);
        contrib = load3(static_cast<const float*>(a.contrib_a) + 3 * i);
      }
      const bool ok = (a.pre_ok_a[i] != 0) && !(a.blocked[i * a.s_blocked] != 0);
      const V3 li = ok ? contrib : v3(0.0f, 0.0f, 0.0f);
      radiance = add(radiance, alive ? mul(q_thr, li) : v3(0.0f, 0.0f, 0.0f));
    }
    // The BRDF sample.
    BrdfSample s;
    if (a.diffuse_only) {
      const float u0 = draw(seed, counter), u1 = draw(seed, counter + 1u);
      counter += 2u;
      const V3 wi = cosine_sample_hemisphere(u0, u1);
      s = BrdfSample{wi, sf.albedo, kInvPi, wi.z > F(1e-6)};
    } else {
      const float u0 = draw(seed, counter), u1 = draw(seed, counter + 1u), u2 = draw(seed, counter + 2u);
      counter += 3u;
      s = surface_sample(sf.albedo, sf.roughness, sf.metalness, to_local(onb, wo), u0, u1, u2, a.mean_factor);
    }
    const V3 new_dir = to_world(onb, s.wi);
    V3 throughput = mul(thr, s.value_over_pdf);
    const float prev_pdf = clamp_min(s.pdf * fabsf(s.wi.z), F(1e-8));
    bool alive_out = alive && s.valid && (amax3(throughput) > 0.0f);
    // Russian roulette: the draw is taken on every bounce.
    const float u_rr = draw(seed, counter);
    if (a.roulette) {
      const float p_cont = clamp(amax3(throughput), F(0.05), 1.0f);
      const bool survive = u_rr < p_cont;
      const float q = clamp_min(p_cont, F(1e-6));
      if (survive) throughput = v3(throughput.x / q, throughput.y / q, throughput.z / q);
      alive_out = alive_out && survive;
    }
    store3(static_cast<float*>(a.radiance_out), i, radiance);
    store3(a.hit_pos, i, hit_pos);
    store3(a.new_dir, i, new_dir);
    store3(a.throughput_out, i, throughput);
    a.prev_pdf_out[i] = prev_pdf;
    a.alive_out[i] = alive_out ? 1 : 0;
  }
}

template <int F, int M>
void launch(const ShadeArgs& a, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((a.n + kBlock - 1) / kBlock);
#ifdef RT3_HOST_SHIM
  (void)stream;
  rt3_shim_launch(shade_kernel<F, M>, grid, kBlock, 0, a);
#else
  shade_kernel<F, M><<<grid, kBlock, 0, stream>>>(a);
#endif
}

}  // namespace

// One shade pass of form `form` (0 deferred, 1 split A, 2 split B) with NEE
// branch `mode` (0 none, 1 area lights, 2 env, 3 both; B takes any) over
// a->n lanes, on `stream`. Returns cudaGetLastError() (a launch the card
// refused), or cudaErrorInvalidValue for a form and branch no pass has.
// Pointers are device pointers (host pointers in the host-shim build).
extern "C" int rt3_shade(int form, int mode, const ShadeArgs* args, void* stream) {
  if (args == nullptr || args->n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ShadeArgs& a = *args;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == kSplitB) {
    launch<kSplitB, kNoNee>(a, st);
  } else if (form == kDeferred && mode == kNoNee) {
    launch<kDeferred, kNoNee>(a, st);
  } else if (form == kDeferred && mode == kArea) {
    launch<kDeferred, kArea>(a, st);
  } else if (form == kDeferred && mode == kEnv) {
    launch<kDeferred, kEnv>(a, st);
  } else if (form == kDeferred && mode == kMix) {
    launch<kDeferred, kMix>(a, st);
  } else if (form == kSplitA && mode == kArea) {
    launch<kSplitA, kArea>(a, st);
  } else if (form == kSplitA && mode == kEnv) {
    launch<kSplitA, kEnv>(a, st);
  } else if (form == kSplitA && mode == kMix) {
    launch<kSplitA, kMix>(a, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// sizeof(ShadeArgs), for the wrapper's check of its mirror.
extern "C" int rt3_shade_args_size() { return static_cast<int>(sizeof(ShadeArgs)); }
