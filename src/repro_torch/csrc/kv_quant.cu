// Fused clipped group-quantize + bit-pack of K/V tokens for Hopper (sm_90a).
//
// Replaces the TPU kernel kv_quant_pallas (src/repro/kernels/kv_quant.py,
// body _kernel).  For each row of x (N, D) and each plane of the plane
// layout (two planes for 1.5 bits): per-group min/max times the clip factor
// alpha, h = max((hi - lo) / (2^b - 1), 1e-8), h and lo rounded through
// FP8-E4M3 (or fp16), codes = clamp(rint((x - lo) / h), 0, 2^b - 1),
// packed little-endian (code i of a byte at bits [i*b, (i+1)*b)).
//
// Contract: bytes-for-bytes equal to repro.core.quant.quantize_groups,
// which SATURATES metadata at +-448 (the Pallas kernel does not).  That
// rests on three primitives:
//   * IEEE round-to-nearest single-precision mul/sub/div: the __fmul_rn /
//     __fsub_rn / __fdiv_rn intrinsics are never contracted into FMAs or
//     replaced by approximate division (build without --use_fast_math);
//   * rintf, round-half-to-even (roundf rounds halves away from zero);
//   * __nv_cvt_float_to_fp8(.., __NV_SATFINITE, __NV_E4M3), round to
//     nearest even after the +-448 clamp.
// A group whose step rounds to 0 in its storage dtype divides 0/0 = NaN and
// x/0 = +-inf: fminf(fmaxf(rintf(v), 0), maxq) maps NaN to code 0 and +inf
// to the top code, as the reference does.
//
// What bounds it on an H100: bytes.  One decode step quantizes B*Hkv rows
// of D values (128 rows x 128 channels at llama2-7b with 4 slots): a few
// tens of KB, far below what one launch can move, so the launch itself is
// the cost.  The design keeps one block per row: the row is staged in
// shared memory once, one thread per group computes the metadata, then one
// thread per output byte packs the codes; nothing but the packed planes
// returns to device memory.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGroups = 64;     // groups of one row, both planes together

struct Plane {
  int start, width, bits, gs;
  uint8_t* codes;
  void* scale;
  void* zero;
};

__device__ __forceinline__ float clamp_keep_nan(float v, float lim) {
  return (v != v) ? v : fminf(fmaxf(v, -lim), lim);
}

__device__ __forceinline__ uint8_t enc_fp8(float v) {
  return (uint8_t)__nv_cvt_float_to_fp8(clamp_keep_nan(v, 448.f),
                                        __NV_SATFINITE, __NV_E4M3);
}

__device__ __forceinline__ float dec_fp8(uint8_t b) {
  __half_raw hr = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E4M3);
  return __half2float(__half(hr));
}

__device__ __forceinline__ float load_x(const float* x, size_t i) {
  return x[i];
}

__device__ __forceinline__ float load_x(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_quant_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                int alpha_stride, int d, int n_planes, Plane p0, Plane p1,
                int fp8_meta) {
  extern __shared__ float smem[];
  float* xs = smem;                       // the row, d floats
  float* hs = smem + d;                   // decoded step per group
  float* los = hs + kMaxGroups;           // decoded zero per group
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;

  for (int c = tid; c < d; c += kThreads) xs[c] = load_x(x, row * d + c);
  __syncthreads();

  const int g0 = p0.width / p0.gs;
  const int g1 = n_planes > 1 ? p1.width / p1.gs : 0;
  for (int gi = tid; gi < g0 + g1; gi += kThreads) {
    const bool first = gi < g0;
    const Plane& p = first ? p0 : p1;
    const int g = first ? gi : gi - g0;
    const int gp = first ? g0 : g1;
    const int base = p.start + g * p.gs;
    float lo = xs[base], hi = xs[base];
    for (int i = 1; i < p.gs; ++i) {
      lo = fminf(lo, xs[base + i]);
      hi = fmaxf(hi, xs[base + i]);
    }
    const float a = alpha[row * alpha_stride + gi];
    lo = __fmul_rn(lo, a);
    hi = __fmul_rn(hi, a);
    float h = __fdiv_rn(__fsub_rn(hi, lo), (float)((1 << p.bits) - 1));
    h = fmaxf(h, 1e-8f);
    const size_t mi = row * gp + g;
    if (fp8_meta) {
      const uint8_t hb = enc_fp8(h), lb = enc_fp8(lo);
      ((uint8_t*)p.scale)[mi] = hb;
      ((uint8_t*)p.zero)[mi] = lb;
      hs[gi] = dec_fp8(hb);
      los[gi] = dec_fp8(lb);
    } else {
      const __half hh = __float2half_rn(clamp_keep_nan(h, 6.5e4f));
      const __half lh = __float2half_rn(clamp_keep_nan(lo, 6.5e4f));
      ((__half*)p.scale)[mi] = hh;
      ((__half*)p.zero)[mi] = lh;
      hs[gi] = __half2float(hh);
      los[gi] = __half2float(lh);
    }
  }
  __syncthreads();

  const int nb0 = p0.width * p0.bits / 8;
  const int nb1 = n_planes > 1 ? p1.width * p1.bits / 8 : 0;
  for (int j = tid; j < nb0 + nb1; j += kThreads) {
    const bool first = j < nb0;
    const Plane& p = first ? p0 : p1;
    const int jj = first ? j : j - nb0;
    const int goff = first ? 0 : g0;
    const int cpb = 8 / p.bits;
    const float maxq = (float)((1 << p.bits) - 1);
    unsigned byte = 0;
    for (int i = 0; i < cpb; ++i) {
      const int c = jj * cpb + i;
      const int g = goff + c / p.gs;
      const float v = __fdiv_rn(__fsub_rn(xs[p.start + c], los[g]), hs[g]);
      const float q = fminf(fmaxf(rintf(v), 0.f), maxq);
      byte |= ((unsigned)q) << (i * p.bits);
    }
    p.codes[row * (first ? nb0 : nb1) + jj] = (uint8_t)byte;
  }
}

}  // namespace

// x: (n, d) f32 (x_is_bf16 == 0) or bf16; alpha: f32, row r reads
// alpha[r * alpha_stride + group] (stride 0 = one shared row).
// Plane i writes codes (n, width*bits/8) u8 and scale/zero (n, width/gs),
// u8 fp8 bit patterns (fp8_meta) or fp16.  Returns cudaGetLastError().
extern "C" int kv_quant_launch(
    const void* x, int x_is_bf16, const float* alpha, int alpha_stride,
    int n, int d, int n_planes,
    int s0, int w0, int b0, int gs0, void* c0, void* sc0, void* z0,
    int s1, int w1, int b1, int gs1, void* c1, void* sc1, void* z1,
    int fp8_meta, void* stream) {
  if (n <= 0) return 0;
  const int groups = w0 / gs0 + (n_planes > 1 ? w1 / gs1 : 0);
  if (n_planes < 1 || n_planes > 2 || groups > kMaxGroups || d > 8192)
    return (int)cudaErrorInvalidValue;
  Plane p0{s0, w0, b0, gs0, (uint8_t*)c0, sc0, z0};
  Plane p1{s1, w1, b1, gs1, (uint8_t*)c1, sc1, z1};
  const size_t smem = (size_t)(d + 2 * kMaxGroups) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_bf16) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kv_quant_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    kv_quant_kernel<__nv_bfloat16><<<n, kThreads, smem, st>>>(
        (const __nv_bfloat16*)x, alpha, alpha_stride, d, n_planes, p0, p1,
        fp8_meta);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kv_quant_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    kv_quant_kernel<float><<<n, kThreads, smem, st>>>(
        (const float*)x, alpha, alpha_stride, d, n_planes, p0, p1, fp8_meta);
  }
  return (int)cudaGetLastError();
}
