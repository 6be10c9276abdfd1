// Clipped group-quantize + bit-pack of K/V rows for Hopper (sm_90a): a bulk
// entry point (prefill rows) and a fused decode append (one launch per
// layer), both built on ONE warp-level row quantizer, so their bytes cannot
// drift apart.
//
// Replaces the TPU kernel kv_quant_pallas (src/repro/kernels/kv_quant.py:78,
// body _kernel) and, for the append, the program that the JAX package's
// decode_append (src/repro/core/kv_cache.py:471) compiles around it under
// jit: ring-slot gather, quantize, scatter into the packed planes (striped
// or through a block table), ring/sink write, length update.
//
// One row, per plane of the plane layout (two planes for 1.5 and 3 bits):
// per-group min/max times the clip factor alpha,
// h = max((hi - lo) / (2^b - 1), 1e-8), h and lo rounded through FP8-E4M3
// (or fp16), codes = clamp(rint((x - lo) / h), 0, 2^b - 1), packed
// little-endian (code i of a byte at bits [i*b, (i+1)*b)).
//
// Contract: bytes-for-bytes equal to repro_torch.core.quant.quantize_groups
// on finite inputs (which SATURATES metadata at +-448; the Pallas kernel
// does not).  That rests on:
//   * IEEE round-to-nearest single-precision mul/sub/div: __fmul_rn /
//     __fsub_rn / __fdiv_rn are never contracted into FMAs or replaced by
//     approximate division (build without --use_fast_math);
//   * the group minimum signed as XLA's min (and so quantize_groups) signs
//     it, -0 below +0: a zero minimum is -0 exactly when a member of the
//     group is -0 (one ballot over the group, in that rare case only), so
//     the shuffle tree gives the zero byte (0x00 vs 0x80) any order would.
//     The maximum's sign cannot reach a byte (h clamps at 1e-8 when hi - lo
//     is a zero);
//   * codes from q = x y - RN(lo y), y = rcp.approx(h) (<= 1 ulp):
//     |q - RN(RN(x - lo) / h)| <= 1.25 * 2^-22 (m + 1) + 2^-24 |lo y|
//     wherever a boundary can lie (m = 2^b - 1), so a clamped q farther
//     than 2^-20 (m + 1) + 2^-21 |lo y| from every half-integer rounds
//     (half to even: adding 1.5 * 2^23 leaves rint in the low mantissa
//     bits) to the code of the exact quotient; a lane with one nearer, or
//     with h rounded to 0, takes the exact __fdiv_rn.  clamp(rint(v), 0, m)
//     == rint(clamp(v, 0, m)); d / 0 gives NaN, which clamps to code 0, or
//     +inf, the top code, as the reference does;
//   * __nv_cvt_float2_to_fp8x2(.., __NV_SATFINITE, __NV_E4M3), round to
//     nearest even, +-448 saturation, for scale and zero together.
//
// Lane layout: a lane holds CPL consecutive channels of a row, inside one
// plane and one group; the lanes of a group are a power-of-two run of
// neighbouring lanes, so the group's min/max is a butterfly of
// __shfl_xor_sync over them, after which every lane holds the group's
// values and computes the same metadata; the group's first lane stores it.
// Codes are packed in registers and stored as one word per lane (a 4-
// channel lane at 1 bit holds a nibble, which the even lane of a pair joins
// with its neighbour's by shuffle).
//
// What bounds it on an H100: bytes at prefill sizes -- a D-128 bf16 row is
// 256 B in and 34 B (K2) or 28 B (V1.5) out, ~7.9 us for the 91,744 rows of
// one layer of a 3000-token llama2-7b prompt -- with the instruction
// throughput close behind: the butterfly and the metadata are paid once
// per lane, so the bulk kernel gives each lane 16 channels (a warp
// quantizes 32 / (W / 16) rows of a W-channel plane at once), takes one
// plane per CTA (its code width is then a compile-time constant), and
// keeps the next rows' loads in flight while it quantizes these.  At decode the launch is the cost: the
// append does in ONE launch per layer what the eager torch version does in
// ~96 kernels, one CTA per slot and one warp per kv head (4 channels per
// lane; 8 at D 256).  Neither uses tensor cores: there is no product.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBulkWarps = 8;        // warps per CTA of the bulk kernel
constexpr int kWide = 16;            // channels per lane of the bulk kernel
constexpr int kAppendMaxWarps = 32;  // <= 1024 threads per slot
constexpr float kRoundMagic = 12582912.f;   // 1.5 * 2^23
constexpr uint32_t kMagicBits = 0x4b400000u;  // its bit pattern

struct Plane {
  int start, width, bits, gs;   // channels; code bits; channels per group
  int g_off;                    // the plane's first group in an alpha row
  uint8_t* codes;               // (rows, width * bits / 8)
  uint8_t* scale;               // (rows, width / gs): fp8 bytes or fp16
  uint8_t* zero;
};

struct Layout {
  int d, n_planes;
  int g_total;                  // groups per row over the planes: alpha row
  Plane p[2];
};

// CPL channels of a row as raw 32-bit words.
template <typename T, int CPL>
struct Raw {
  static constexpr int kBytes = CPL * (int)sizeof(T);
  uint32_t w[kBytes / 4];
};

template <typename T, int CPL, bool STREAM>
__device__ __forceinline__ void load_raw(const T* p, Raw<T, CPL>& r) {
  if constexpr (Raw<T, CPL>::kBytes == 8) {
    const uint2 v = STREAM ? __ldcs(reinterpret_cast<const uint2*>(p))
                           : *reinterpret_cast<const uint2*>(p);
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < Raw<T, CPL>::kBytes / 16; ++i) {
      const uint4 v = STREAM ? __ldcs(reinterpret_cast<const uint4*>(p) + i)
                             : reinterpret_cast<const uint4*>(p)[i];
      r.w[4 * i] = v.x;
      r.w[4 * i + 1] = v.y;
      r.w[4 * i + 2] = v.z;
      r.w[4 * i + 3] = v.w;
    }
  }
}

template <typename T, int CPL>
__device__ __forceinline__ void store_raw(T* p, const Raw<T, CPL>& r) {
  if constexpr (Raw<T, CPL>::kBytes == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < Raw<T, CPL>::kBytes / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(
          r.w[4 * i], r.w[4 * i + 1], r.w[4 * i + 2], r.w[4 * i + 3]);
  }
}

template <typename T, int CPL>
__device__ __forceinline__ void zero_raw(Raw<T, CPL>& r) {
#pragma unroll
  for (int i = 0; i < Raw<T, CPL>::kBytes / 4; ++i) r.w[i] = 0;
}

template <typename T, int CPL>
__device__ __forceinline__ void to_f32(const Raw<T, CPL>& r,
                                       float (&x)[CPL]) {
  if constexpr (sizeof(T) == 2) {               // bf16: the high half
#pragma unroll
    for (int i = 0; i < CPL / 2; ++i) {
      x[2 * i] = __uint_as_float(r.w[i] << 16);
      x[2 * i + 1] = __uint_as_float(r.w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < CPL; ++i) x[i] = __uint_as_float(r.w[i]);
  }
}

__device__ __forceinline__ float clamp_keep_nan(float v, float lim) {
  return (v != v) ? v : fminf(fmaxf(v, -lim), lim);
}

__device__ __forceinline__ float rcp_approx(float v) {     // <= 1 ulp
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// What a lane needs of the plane and group its channels fall in: fixed for
// the kernel's life, so it is worked out once and kept in registers.
struct Lane {
  uint8_t* codes;   // the lane's code bytes in row 0 of the plane
  uint8_t* scale;   // its group's scale / zero entry in row 0
  uint8_t* zero;
  int row_bytes;    // codes bytes per row of the plane
  int row_meta;     // scale (zero) bytes per row of the plane
  int aidx;         // the group's entry in an alpha row
  int glanes;       // lanes per group, a power of two
  int bits;
  float maxq;
  float near;       // 2^-20 (maxq + 1): see the contract above
  bool first;       // the group's first lane: stores the metadata
  bool put;         // stores code bits (4-channel lanes at 1 bit: even)
};

// Lane info for the CPL channels starting at channel c0 of plane P.
template <int CPL, bool FP8>
__device__ __forceinline__ Lane lane_in(const Plane& P, int c0) {
  const int meta = FP8 ? 1 : 2;
  const int pc = c0 - P.start;
  const int g = pc / P.gs;
  Lane q;
  q.bits = P.bits;
  q.glanes = P.gs / CPL;
  q.row_bytes = P.width * P.bits / 8;
  q.row_meta = (P.width / P.gs) * meta;
  q.aidx = P.g_off + g;
  q.maxq = (float)((1 << P.bits) - 1);
  q.near = (q.maxq + 1.f) * (1.f / 1048576.f);
  q.first = pc % P.gs == 0;
  q.put = CPL > 4 || P.bits > 1 || (pc / 4) % 2 == 0;
  q.codes = P.codes + pc * P.bits / 8;
  q.scale = P.scale + g * meta;
  q.zero = P.zero + g * meta;
  return q;
}

// Lane info for lane j of a row (CPL channels per lane) of layout L.
template <int CPL, bool FP8>
__device__ __forceinline__ Lane lane_of(const Layout& L, int j) {
  const int c0 = j * CPL;
  if (L.n_planes > 1 && c0 >= L.p[1].start)
    return lane_in<CPL, FP8>(L.p[1], c0);
  return lane_in<CPL, FP8>(L.p[0], c0);
}

// Adds v << (the bit offset of code i) into the packed words w: B bits a
// code when B > 0, else `bits` (<= 8 channels a lane; words 0 and 1).
template <int B, int CPL, int NW>
__device__ __forceinline__ void put_code(uint32_t (&w)[NW], int i, int bits,
                                         uint32_t v) {
  if constexpr (B > 0) {
    w[(i * B) / 32] += v << ((i * B) % 32);
  } else if (i >= 4 && bits == 8) {
    w[1] += v << ((i - 4) * 8);
  } else {
    w[0] += v << (i * bits);
  }
}

// Stores the packed codes of a lane, CPL codes of B bits (one word).
template <int B, int CPL, int NW>
__device__ __forceinline__ void store_codes(uint8_t* c,
                                            const uint32_t (&w)[NW]) {
  constexpr int kBits = B * CPL;
  static_assert(kBits >= 8, "a lane stores whole bytes here");
  if constexpr (kBits == 8) {
    *c = (uint8_t)w[0];
  } else if constexpr (kBits == 16) {
    *reinterpret_cast<uint16_t*>(c) = (uint16_t)w[0];
  } else if constexpr (kBits == 32) {
    *reinterpret_cast<uint32_t*>(c) = w[0];
  } else if constexpr (kBits == 64) {
    *reinterpret_cast<uint2*>(c) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint4*>(c) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// THE row quantizer.  Each lane holds CPL consecutive channels x of one
// row; the lanes of the row's groups quantize together.  Codes and
// metadata go to row `orow` of the lane's plane when `store` holds.  arow:
// the lane's clip factor (alpha row + q.aidx), or nullptr for none.  B:
// the lane's code width when the caller knows it at compile time (one plane
// per warp), 0 for q.bits (then CPL <= 8).  All 32 lanes must call it.
template <int CPL, bool FP8, int B>
__device__ __forceinline__ void quant_lane(const float (&x)[CPL],
                                           const float* __restrict__ arow,
                                           unsigned orow, bool store,
                                           const Lane& q, int lane) {
  float lo = x[0], hi = x[0];
#pragma unroll
  for (int i = 1; i < CPL; ++i) {
    lo = fminf(lo, x[i]);
    hi = fmaxf(hi, x[i]);
  }
  if constexpr (B > 0) {        // one plane per warp: a uniform depth
    for (int off = 1; off < q.glanes; off <<= 1) {
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, off));
    }
  } else {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float ol = __shfl_xor_sync(kFull, lo, off);
      const float oh = __shfl_xor_sync(kFull, hi, off);
      const bool in = off < q.glanes;
      lo = fminf(lo, in ? ol : lo);
      hi = fmaxf(hi, in ? oh : hi);
    }
  }
  if (lo == 0.f) {              // the whole group: -0 if any member is -0
    bool neg0 = false;
#pragma unroll
    for (int i = 0; i < CPL; ++i) neg0 |= __float_as_uint(x[i]) == 0x80000000u;
    const int first = lane & ~(q.glanes - 1);
    const unsigned gm = q.glanes == 32 ? kFull
                                       : ((1u << q.glanes) - 1u) << first;
    lo = __ballot_sync(gm, neg0) ? -0.f : 0.f;
  }
  const float a = arow != nullptr ? __ldg(arow) : 1.f;
  lo = __fmul_rn(lo, a);
  const float h = fmaxf(
      __fdiv_rn(__fsub_rn(__fmul_rn(hi, a), lo), q.maxq), 1e-8f);
  unsigned hb, lb;
  float hd, ld;
  if (FP8) {
    const __nv_fp8x2_storage_t p = __nv_cvt_float2_to_fp8x2(
        make_float2(lo, h), __NV_SATFINITE, __NV_E4M3);
    const float2 f = __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2(p, __NV_E4M3)));
    lb = p & 0xffu;
    hb = p >> 8;
    ld = f.x;
    hd = f.y;
  } else {
    const __half hh = __float2half_rn(clamp_keep_nan(h, 6.5e4f));
    const __half lh = __float2half_rn(clamp_keep_nan(lo, 6.5e4f));
    hb = __half_as_ushort(hh);
    lb = __half_as_ushort(lh);
    hd = __half2float(hh);
    ld = __half2float(lh);
  }
  // codes from x y - ld y; a lane with a quotient near a boundary takes
  // the exact division (the margin: see the contract above)
  const float y = rcp_approx(hd);
  const float ly = __fmul_rn(ld, y);
  const float margin = 0.5f - fmaf(fabsf(ly), 1.f / 2097152.f, q.near);
  // r = 1.5 * 2^23 + code: shifted sums of bits(r) less the same sums of
  // the constant's bits are the packed codes (mod 2^32, fields disjoint)
  constexpr int kW = B > 0 ? (B * CPL + 31) / 32 : 2;
  uint32_t w[kW] = {}, k[kW] = {};
  bool near = !(margin > 0.f);  // h rounded to 0 (d / 0), or a vast offset
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const float qc = fminf(fmaxf(fmaf(x[i], y, -ly), 0.f), q.maxq);
    const float r = __fadd_rn(qc, kRoundMagic);
    near |= fabsf(__fsub_rn(qc, __fsub_rn(r, kRoundMagic))) > margin;
    put_code<B, CPL>(w, i, q.bits, __float_as_uint(r));
    put_code<B, CPL>(k, i, q.bits, kMagicBits);
  }
  if (near) {
#pragma unroll
    for (int j = 0; j < kW; ++j) w[j] = 0;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const float v = __fdiv_rn(__fsub_rn(x[i], ld), hd);
      put_code<B, CPL>(w, i, q.bits, __float_as_uint(
          __fadd_rn(fminf(fmaxf(v, 0.f), q.maxq), kRoundMagic)));
    }
  }
#pragma unroll
  for (int j = 0; j < kW; ++j) w[j] -= k[j];
  uint8_t* c = q.codes + (size_t)orow * q.row_bytes;
  if constexpr (B > 0) {
    if (store) store_codes<B, CPL>(c, w);
  } else {
    static_assert(CPL <= 8, "runtime code widths take <= 8 channels a lane");
    const unsigned up = CPL == 4 ? __shfl_down_sync(kFull, w[0], 1) : 0u;
    if (store && q.put) {
      const int bytes = CPL * q.bits / 8;
      if (bytes == 0) *c = (uint8_t)(w[0] | (up << 4));   // 4 x 1 bit
      else if (bytes == 1) *c = (uint8_t)w[0];
      else if (bytes == 2) *reinterpret_cast<uint16_t*>(c) = (uint16_t)w[0];
      else if (bytes == 4) *reinterpret_cast<uint32_t*>(c) = w[0];
      else *reinterpret_cast<uint2*>(c) = make_uint2(w[0], w[1]);
    }
  }
  if (store && q.first) {
    const size_t m = (size_t)orow * q.row_meta;
    if (FP8) {
      q.scale[m] = (uint8_t)hb;
      q.zero[m] = (uint8_t)lb;
    } else {
      *reinterpret_cast<uint16_t*>(q.scale + m) = (uint16_t)hb;
      *reinterpret_cast<uint16_t*>(q.zero + m) = (uint16_t)lb;
    }
  }
}

// The bulk rows of one plane P (CTA-uniform), code width B: lane l of a
// warp step holds channels [P.start + 16 j, +16) of row step + l / lpr
// (j = l % lpr, lpr = P.width / 16 lanes per row); steps stride over the
// grid with the next step's loads in flight.  Row r reads clip factors
// alpha[(r % alpha_period) * g_total] (period 0: one shared row).
template <typename T, bool FP8, int B>
__device__ __forceinline__ void bulk_plane(const T* __restrict__ x,
                                           const float* __restrict__ alpha,
                                           int alpha_period, int n,
                                           const Layout& L, const Plane& P) {
  const int lane = threadIdx.x & 31;
  const int lpr = P.width / kWide;              // divides 32
  const int rpw = 32 / lpr;                     // rows per warp step
  const int j = lane % lpr;
  const int warp = blockIdx.x * kBulkWarps + (threadIdx.x >> 5);
  const int stride = gridDim.x * kBulkWarps * rpw;
  const Lane q = lane_in<kWide, FP8>(P, P.start + j * kWide);
  const int period = alpha_period > 0 ? alpha_period : 1;
  const int astep = stride % period;
  int row = warp * rpw + lane / lpr;
  int ar = row % period;
  const float* abase = alpha == nullptr ? nullptr : alpha + q.aidx;
  const T* xl = x + P.start + j * kWide;
  Raw<T, kWide> cur, nxt;
  if (row < n) load_raw<T, kWide, true>(xl + (size_t)row * L.d, cur);
  else zero_raw(cur);
  for (int step = warp * rpw; step < n; step += stride, row += stride) {
    if (row + stride < n)
      load_raw<T, kWide, true>(xl + (size_t)(row + stride) * L.d, nxt);
    else
      zero_raw(nxt);
    float xs[kWide];
    to_f32(cur, xs);
    quant_lane<kWide, FP8, B>(
        xs, abase == nullptr ? nullptr : abase + (size_t)ar * L.g_total,
        (unsigned)row, row < n, q, lane);
    ar += astep;
    if (ar >= period) ar -= period;
    cur = nxt;
  }
}

// Bulk rows, fast form (every plane in whole 16-channel lanes): CTA column
// blockIdx.y takes plane blockIdx.y.
template <typename T, bool FP8>
__global__ void __launch_bounds__(kBulkWarps * 32, 3)
kv_quant_wide(const T* __restrict__ x, const float* __restrict__ alpha,
              int alpha_period, int n, const __grid_constant__ Layout L) {
  const Plane& P = L.p[blockIdx.y];
  switch (P.bits) {                             // uniform over the CTA
    case 1: bulk_plane<T, FP8, 1>(x, alpha, alpha_period, n, L, P); break;
    case 2: bulk_plane<T, FP8, 2>(x, alpha, alpha_period, n, L, P); break;
    case 4: bulk_plane<T, FP8, 4>(x, alpha, alpha_period, n, L, P); break;
    default: bulk_plane<T, FP8, 8>(x, alpha, alpha_period, n, L, P); break;
  }
}

// Bulk rows, any layout the quantizer takes: CPL channels per lane over the
// whole row (both planes), one row per D / CPL lanes.
template <typename T, int CPL, bool FP8>
__global__ void __launch_bounds__(kBulkWarps * 32, 3)
kv_quant_rows(const T* __restrict__ x, const float* __restrict__ alpha,
              int alpha_period, int n, const __grid_constant__ Layout L) {
  const int lane = threadIdx.x & 31;
  const int lpr = L.d / CPL;
  const int rpw = 32 / lpr;
  const int j = lane % lpr;
  const int warp = blockIdx.x * kBulkWarps + (threadIdx.x >> 5);
  const int stride = gridDim.x * kBulkWarps * rpw;
  const Lane q = lane_of<CPL, FP8>(L, j);
  const int period = alpha_period > 0 ? alpha_period : 1;
  for (int step = warp * rpw; step < n; step += stride) {
    const int row = step + lane / lpr;
    Raw<T, CPL> raw;
    if (row < n) load_raw<T, CPL, true>(x + (size_t)row * L.d + j * CPL, raw);
    else zero_raw(raw);
    float xs[CPL];
    to_f32(raw, xs);
    const float* arow = alpha == nullptr ? nullptr
        : alpha + (size_t)(row % period) * L.g_total + q.aidx;
    quant_lane<CPL, FP8, 0>(xs, arow, (unsigned)row, row < n, q, lane);
  }
}

template <typename T>
struct AppendArgs {
  int h, w, ns;        // kv heads, window, sinks
  int cap;             // logical packed tokens per slot (NB * BT if pooled)
  int bt, nb, n_phys;  // pooled: block tokens, table width, pool blocks;
                       // bt == 0: striped planes (B, cap, H, ...)
  int ak_period, av_period;   // H: alpha is (H, G) per head; 0: shared
  int32_t* length;            // (B,)
  const uint8_t* valid;       // (B,) bool, or nullptr: every row valid
  const int32_t* tbl;         // (B, nb) when pooled
  const T* k_new;             // (B, 1, H, D)
  const T* v_new;
  T* win_k;                   // (B, w, H, D), nullptr when w == 0
  T* win_v;
  T* sink_k;                  // (B, ns, H, D), nullptr when ns == 0
  T* sink_v;
  const float* alpha_k;       // nullptr: no clip factors
  const float* alpha_v;
  Layout lk, lv;
};

// The decode append of one layer (kv_cache.decode_append, in place): CTA b
// owns slot b -- it reads length[b], and only it writes length[b], after a
// barrier that orders every warp's read of the ring slot before the write.
// A warp takes 32 / (D / CPL) kv heads (one at D 128), a lane CPL channels.
template <typename T, int CPL, bool FP8>
__global__ void __launch_bounds__(kAppendMaxWarps * 32)
kv_append_kernel(const __grid_constant__ AppendArgs<T> a) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int d = a.lk.d;
  const int lpr = d / CPL;
  const int hpw = 32 / lpr;                     // heads per warp
  const int j = lane % lpr;
  const int t = a.length[b];
  const bool ok = a.valid == nullptr || a.valid[b] != 0;
  if (ok) {                                     // uniform over the CTA
    const bool is_sink = t < a.ns;
    int slot = 0, idx;
    bool quant;
    if (a.w > 0) {
      slot = max(t - a.ns, 0) % a.w;
      const int u_e = t - a.ns - a.w;           // evicted token's index
      quant = u_e >= 0 && a.cap > 0;
      idx = min(max(u_e, 0), a.cap - 1);
    } else {                      // no window: the new token itself
      quant = a.cap > 0;
      idx = min(max(t - a.ns, 0), a.cap - 1);
    }
    unsigned orow = 0;            // packed row of head 0
    if (quant) {
      if (a.bt > 0) {
        const int lb = min(idx / a.bt, a.nb - 1);
        const int phys = a.tbl[(size_t)b * a.nb + lb];
        quant = phys >= 0 && phys < a.n_phys;
        orow = ((unsigned)phys * a.bt + idx % a.bt) * a.h;
      } else {
        orow = ((unsigned)b * a.cap + idx) * a.h;
      }
    }
    const bool evict = quant && a.w > 0;
    const Lane qk = lane_of<CPL, FP8>(a.lk, j);
    const Lane qv = lane_of<CPL, FP8>(a.lv, j);
    const int warps = blockDim.x >> 5;
    const int rounds = (a.h + warps * hpw - 1) / (warps * hpw);
    for (int r = 0; r < rounds; ++r) {          // uniform over the CTA
      const int hh = (r * warps + (threadIdx.x >> 5)) * hpw + lane / lpr;
      const bool live = hh < a.h;
      const size_t nrow = ((size_t)b * a.h + hh) * d + j * CPL;
      const size_t wrow = (((size_t)b * a.w + slot) * a.h + hh) * d + j * CPL;
      Raw<T, CPL> kn, vn, ek, ev;
      zero_raw(kn);
      zero_raw(vn);
      if (live) {
        load_raw<T, CPL, false>(a.k_new + nrow, kn);
        load_raw<T, CPL, false>(a.v_new + nrow, vn);
      }
      if (evict && live) {         // read the ring slot before it is reused
        load_raw<T, CPL, false>(a.win_k + wrow, ek);
        load_raw<T, CPL, false>(a.win_v + wrow, ev);
      } else {
        ek = kn;
        ev = vn;
      }
      float xk[CPL], xv[CPL];
      to_f32(ek, xk);
      to_f32(ev, xv);
      const float* ak = a.alpha_k == nullptr || !live ? nullptr
          : a.alpha_k + (size_t)(a.ak_period ? hh % a.ak_period : 0)
                            * a.lk.g_total + qk.aidx;
      const float* av = a.alpha_v == nullptr || !live ? nullptr
          : a.alpha_v + (size_t)(a.av_period ? hh % a.av_period : 0)
                            * a.lv.g_total + qv.aidx;
      quant_lane<CPL, FP8, 0>(xk, ak, orow + hh, quant && live, qk, lane);
      quant_lane<CPL, FP8, 0>(xv, av, orow + hh, quant && live, qv, lane);
      if (live && is_sink) {
        const size_t srow = (((size_t)b * a.ns + t) * a.h + hh) * d + j * CPL;
        store_raw<T, CPL>(a.sink_k + srow, kn);
        store_raw<T, CPL>(a.sink_v + srow, vn);
      } else if (live && a.w > 0) {
        store_raw<T, CPL>(a.win_k + wrow, kn);
        store_raw<T, CPL>(a.win_v + wrow, vn);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) a.length[b] = t + (ok ? 1 : 0);
}

bool pow2(int v) { return v > 0 && !(v & (v - 1)); }

// Channels per lane of a row of d channels on the general path: 4, or 8
// above 128, so that a row spans at most a warp.
int general_cpl(int d) { return d > 128 ? 8 : 4; }

// plane_ints: per plane {start, width, bits, group_size} in channels;
// plane_ptrs: per plane {codes, scale, zero}.  Returns false for a layout
// the row quantizer does not take at general_cpl(d) channels per lane (the
// host wrapper raises first).
bool make_layout(int d, int n_planes, const int* pi, void* const* pp,
                 Layout* L) {
  const int cpl = general_cpl(d);
  if (d <= 0 || d > 256 || d % cpl || !pow2(d / cpl) || n_planes < 1 ||
      n_planes > 2)
    return false;
  *L = Layout{};
  L->d = d;
  L->n_planes = n_planes;
  int g_off = 0, end = 0;
  for (int i = 0; i < n_planes; ++i) {
    const int start = pi[4 * i], width = pi[4 * i + 1];
    const int bits = pi[4 * i + 2], gs = pi[4 * i + 3];
    if (start != end || width <= 0 || gs <= 0 || start % cpl ||
        width % cpl || gs % cpl || !pow2(gs / cpl) || start % gs ||
        width % gs || (bits != 1 && bits != 2 && bits != 4 && bits != 8) ||
        (cpl * bits < 8 && (start % 8 || width % 8)))
      return false;
    Plane& P = L->p[i];
    P.start = start;
    P.width = width;
    P.bits = bits;
    P.gs = gs;
    P.g_off = g_off;
    P.codes = static_cast<uint8_t*>(pp[3 * i]);
    P.scale = static_cast<uint8_t*>(pp[3 * i + 1]);
    P.zero = static_cast<uint8_t*>(pp[3 * i + 2]);
    g_off += width / gs;
    end = start + width;
  }
  L->g_total = g_off;
  return end == d;
}

// Every plane in whole 16-channel lanes, a power of two of them per row
// and per group: the fast bulk form applies.
bool wide_ok(const Layout& L) {
  for (int i = 0; i < L.n_planes; ++i) {
    const Plane& P = L.p[i];
    if (P.width % kWide || P.gs % kWide || !pow2(P.width / kWide) ||
        P.width / kWide > 32 || !pow2(P.gs / kWide))
      return false;
  }
  return true;
}

int sm_count() {
  int dev = 0, n = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <typename T, bool FP8>
void launch_bulk(const void* x, const float* alpha, int period, int n,
                 const Layout& L, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const int per_plane = 3 * sm_count() / L.n_planes;   // CTAs per plane
  if (wide_ok(L)) {
    // a CTA step covers 8 warps x 32 / lpr rows; plane 0 is the widest
    const int rows_per_cta = kBulkWarps * 32 / (L.p[0].width / kWide);
    int grid = (n + rows_per_cta - 1) / rows_per_cta;
    if (grid > per_plane) grid = per_plane;
    kv_quant_wide<T, FP8><<<dim3(grid, L.n_planes), kBulkWarps * 32, 0,
                            st>>>(xt, alpha, period, n, L);
    return;
  }
  const int cpl = general_cpl(L.d);
  const int rows_per_cta = kBulkWarps * 32 / (L.d / cpl);
  int grid = (n + rows_per_cta - 1) / rows_per_cta;
  if (grid > 3 * sm_count()) grid = 3 * sm_count();
  if (cpl == 4)
    kv_quant_rows<T, 4, FP8><<<grid, kBulkWarps * 32, 0, st>>>(
        xt, alpha, period, n, L);
  else
    kv_quant_rows<T, 8, FP8><<<grid, kBulkWarps * 32, 0, st>>>(
        xt, alpha, period, n, L);
}

template <typename T, bool FP8>
void launch_append(int b, const int* dims, void* const* ptrs, int ak_period,
                   int av_period, const Layout& lk, const Layout& lv,
                   cudaStream_t st) {
  AppendArgs<T> a;
  a.h = dims[0];
  a.w = dims[1];
  a.ns = dims[2];
  a.cap = dims[3];
  a.bt = dims[4];
  a.nb = dims[5];
  a.n_phys = dims[6];
  a.ak_period = ak_period;
  a.av_period = av_period;
  a.length = static_cast<int32_t*>(ptrs[0]);
  a.valid = static_cast<const uint8_t*>(ptrs[1]);
  a.tbl = static_cast<const int32_t*>(ptrs[2]);
  a.k_new = static_cast<const T*>(ptrs[3]);
  a.v_new = static_cast<const T*>(ptrs[4]);
  a.win_k = static_cast<T*>(ptrs[5]);
  a.win_v = static_cast<T*>(ptrs[6]);
  a.sink_k = static_cast<T*>(ptrs[7]);
  a.sink_v = static_cast<T*>(ptrs[8]);
  a.alpha_k = static_cast<const float*>(ptrs[9]);
  a.alpha_v = static_cast<const float*>(ptrs[10]);
  a.lk = lk;
  a.lv = lv;
  const int cpl = general_cpl(lk.d);
  const int hpw = 32 / (lk.d / cpl);
  int warps = (a.h + hpw - 1) / hpw;
  if (warps > kAppendMaxWarps) warps = kAppendMaxWarps;
  if (cpl == 4)
    kv_append_kernel<T, 4, FP8><<<b, warps * 32, 0, st>>>(a);
  else
    kv_append_kernel<T, 8, FP8><<<b, warps * 32, 0, st>>>(a);
}

}  // namespace

// Bulk rows.  x: (n, d) f32 (x_is_bf16 == 0) or bf16, 16-byte aligned;
// alpha: f32 or nullptr, row r reads alpha[(r % alpha_period) * g_total +
// group] (period 0: one shared row).  Plane i writes codes (n,
// width*bits/8) u8 and scale/zero (n, width/gs), u8 fp8 bit patterns
// (fp8_meta) or fp16, each 16-byte aligned.  Returns cudaGetLastError().
extern "C" int kv_quant_launch(const void* x, int x_is_bf16, int n, int d,
                               const float* alpha, int alpha_period,
                               int n_planes, const int* plane_ints,
                               void* const* plane_ptrs, int fp8_meta,
                               void* stream) {
  Layout L;
  if (!make_layout(d, n_planes, plane_ints, plane_ptrs, &L) || n < 0 ||
      alpha_period < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16 && fp8_meta)
    launch_bulk<__nv_bfloat16, true>(x, alpha, alpha_period, n, L, st);
  else if (x_is_bf16)
    launch_bulk<__nv_bfloat16, false>(x, alpha, alpha_period, n, L, st);
  else if (fp8_meta)
    launch_bulk<float, true>(x, alpha, alpha_period, n, L, st);
  else
    launch_bulk<float, false>(x, alpha, alpha_period, n, L, st);
  return (int)cudaGetLastError();
}

// The fused decode append of one layer, in place, over b slots.
// dims: {h, w, ns, cap, bt, nb, n_phys} (bt = 0: striped planes);
// ptrs: {length, valid, tbl, k_new, v_new, win_k, win_v, sink_k, sink_v,
// alpha_k, alpha_v} (valid, tbl, the ring, the sinks and alpha may be
// nullptr where the layout has none); K and V planes as in kv_quant_launch,
// leaves (B, cap, H, ...) striped or (n_phys, bt, H, ...) pooled.
extern "C" int kv_append_launch(int x_is_bf16, int b, int d, const int* dims,
                                void* const* ptrs, int ak_period,
                                int av_period, int nk_planes,
                                const int* k_plane_ints,
                                void* const* k_plane_ptrs, int nv_planes,
                                const int* v_plane_ints,
                                void* const* v_plane_ptrs, int fp8_meta,
                                void* stream) {
  Layout lk, lv;
  if (!make_layout(d, nk_planes, k_plane_ints, k_plane_ptrs, &lk) ||
      !make_layout(d, nv_planes, v_plane_ints, v_plane_ptrs, &lv) ||
      dims[0] <= 0 || dims[1] < 0 || dims[2] < 0 || dims[3] < 0 ||
      (dims[1] == 0 && dims[3] == 0) || (dims[4] > 0 && dims[5] <= 0))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16 && fp8_meta)
    launch_append<__nv_bfloat16, true>(b, dims, ptrs, ak_period, av_period,
                                       lk, lv, st);
  else if (x_is_bf16)
    launch_append<__nv_bfloat16, false>(b, dims, ptrs, ak_period, av_period,
                                        lk, lv, st);
  else if (fp8_meta)
    launch_append<float, true>(b, dims, ptrs, ak_period, av_period, lk, lv,
                               st);
  else
    launch_append<float, false>(b, dims, ptrs, ak_period, av_period, lk, lv,
                                st);
  return (int)cudaGetLastError();
}
