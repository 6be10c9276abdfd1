// Fused dequantize + online-softmax decode attention over the packed SKVQ
// planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel decode_attn_pallas (src/repro/kernels/decode_attn.py,
// body _kernel with helpers _unpack_block / _dequant_tile), striped layout
// with per-slot block bounds.  For one (slot, kv-head) it unpacks the 2- and
// 1-bit codes, dequantizes code*scale + zero per group in f32 (scale/zero
// FP8-E4M3 or fp16), scores (q*scale).k for the Gq query heads sharing the
// kv head, applies the optional tanh softcap and the per-slot mask, and runs
// an online softmax over block_s-token tiles.  It returns the UNNORMALIZED
// f32 triple (num, m, l) that the caller merges with the fp sink/window
// segments.
//
// Translation from the TPU kernel:
//   * The TPU grid walks tiles in order on one core with the accumulator in
//     VMEM scratch.  Here one thread block owns one (slot, kv-head) and
//     walks its tiles in a loop, carrying m, l and the accumulator in
//     registers (identically in every thread) — no state crosses blocks.
//   * The TPU prefetches the [lo, hi) bounds as scalars.  Here each block
//     reads its own bounds from device memory, so the host never reads them
//     (no sync per layer per step).  Tiles outside [lo, hi) are neither
//     loaded nor computed.  A tile that is entirely masked is an exact
//     no-op — p = exp(s - m) * mask = 0 and the rescale is exp(0) = 1 — so
//     the pruned walk is bit-identical to the full walk.
//   * A whole f32 tile of K and V (2 x 256 x 128 x 4 B = 256 KB) does not
//     fit in 227 KB of shared memory.  K is dequantized in registers: each
//     thread owns one token of the tile and dots its dequantized row with q
//     held in shared memory.  V is dequantized into shared memory in
//     64-token sub-tiles (32 KB at D = 128) that the P.V products consume.
//   * Planes may hold fewer tokens (S) than the mask (S_mask, a multiple of
//     block_s): tokens at or past S are treated as masked and never read,
//     so the caller need not pad the planes.
//   * Block-table (pooled) mode, DESIGN.md §9 (decode_attn_pallas with
//     block_table=).  The planes are pool-major, (n_phys, bt, Hkv, W), and
//     logical token t of slot b lives in physical block tbl[b, t / bt] at
//     offset t % bt, S = NB * bt.  The TPU kernel fetches one pool block per
//     grid step through its BlockSpec index map, which pins its tile to bt.
//     Here every thread gathers its own token's row, so the tile stays the
//     striped one (256 tokens) whatever bt is: a 16-token tile would leave
//     15/16 of the 256 threads idle.  The table is read on the device, so a
//     table that changes costs neither a host sync nor a rebuild.  At the
//     same tile the pooled walk reads the same values in the same order as
//     the striped walk over the gathered planes, so the two are bitwise
//     equal.  An entry outside [0, n_phys) reads null block 0 instead of
//     memory past the pool.
//
// What bounds it on an H100: bytes.  Per live token it reads the packed K
// and V rows (60 B at D = 128, K2/V1.5, fp8 meta) plus a 4 B mask entry for
// about 4 * D * Gq flops, far below the 295 flop/byte ridge of the card.
// This first version runs one block per (slot, kv-head) — 128 blocks at the
// llama2-7b serving shape, about one per SM — and loads each token's row
// with one thread, so it is latency-bound well short of the memory rate;
// splitting the sequence across blocks is the next step.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // = the largest tile (block_s <= 256)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;             // query heads per kv head
constexpr int kMaxOut = 4;           // (g, channel) outputs per thread
constexpr int kSub = 64;             // V sub-tile, tokens
constexpr float kNeg = -1e30f;

struct Plane {
  const uint8_t* codes;
  const void* scale;
  const void* zero;
  int start, width, bits, gs;
};

struct Planes {
  Plane p[2];
  int n;
};

__device__ __forceinline__ float dec_meta(const void* base, size_t i,
                                          int fp8_meta) {
  if (fp8_meta) {
    const uint8_t b = ((const uint8_t*)base)[i];
    __half_raw hr = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E4M3);
    return __half2float(__half(hr));
  }
  return __half2float(((const __half*)base)[i]);
}

// Row of token t of slot b in the (B*S or n_phys*bt, hkv) plane rows: the
// striped row, or the physical block's row through the table.
__device__ __forceinline__ size_t plane_row(const int* tbl, int nb, int bt,
                                            int n_phys, int b, int S, int t,
                                            int hkv, int h) {
  size_t tok;
  if (tbl) {
    int phys = __ldg(tbl + (size_t)b * nb + t / bt);
    phys = (phys < 0 || phys >= n_phys) ? 0 : phys;
    tok = (size_t)phys * bt + t % bt;
  } else {
    tok = (size_t)b * S + t;
  }
  return tok * hkv + h;
}

// Reduce v[0..gq) across the block; every thread gets the same result.
__device__ __forceinline__ void block_reduce(float (&v)[kMaxG], int gq,
                                             float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= gq) break;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[g], off);
      v[g] = is_max ? fmaxf(v[g], o) : v[g] + o;
    }
  }
  if (lane == 0)
    for (int g = 0; g < gq; ++g) red[warp * kMaxG + g] = v[g];
  __syncthreads();
  for (int g = 0; g < gq; ++g) {
    float r = red[g];
    for (int w = 1; w < kWarps; ++w)
      r = is_max ? fmaxf(r, red[w * kMaxG + g]) : r + red[w * kMaxG + g];
    v[g] = r;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q, const float* __restrict__ mask,
                   const int* __restrict__ bounds, const int* __restrict__ tbl,
                   int nb, int bt, int n_phys, Planes kp, Planes vp,
                   int S, int S_mask, int hkv, int gq, int d, int bs,
                   float scale, float softcap, int fp8_meta,
                   float* __restrict__ num_out, float* __restrict__ m_out,
                   float* __restrict__ l_out) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // gq * d, pre-scaled
  float* p_s = q_s + gq * d;          // gq * bs
  float* v_s = p_s + gq * bs;         // kSub * d
  float* red = v_s + kSub * d;        // kWarps * kMaxG

  const int tid = threadIdx.x;
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const size_t qbase = ((size_t)b * hkv + h) * gq * d;
  for (int i = tid; i < gq * d; i += kThreads) q_s[i] = q[qbase + i] * scale;

  const int n_blocks = S_mask / bs;
  const int lo = max(bounds[2 * b], 0);
  const int hi = min(bounds[2 * b + 1], n_blocks);

  float m_run[kMaxG], l_run[kMaxG], acc[kMaxOut];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) { m_run[g] = kNeg; l_run[g] = 0.f; }
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) acc[o] = 0.f;
  __syncthreads();

  for (int blk = lo; blk < hi; ++blk) {
    const int t0 = blk * bs;
    // ---- scores: one token per thread, K dequantized in registers ----
    float sc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) sc[g] = 0.f;
    float mk = 0.f;
    const int t = t0 + tid;
    if (tid < bs && t < S) {
      mk = mask[(size_t)b * S_mask + t];
      const size_t row = plane_row(tbl, nb, bt, n_phys, b, S, t, hkv, h);
      for (int pi = 0; pi < kp.n; ++pi) {
        const Plane& p = kp.p[pi];
        const int wb = p.width * p.bits / 8, cpb = 8 / p.bits;
        const int ng = p.width / p.gs;
        const uint8_t* cr = p.codes + row * wb;
        const unsigned cmask = (1u << p.bits) - 1u;
        int gcur = -1;
        float hh = 0.f, zz = 0.f;
        for (int j = 0; j < wb; ++j) {
          const unsigned byte = __ldg(cr + j);
          for (int i = 0; i < cpb; ++i) {
            const int c = j * cpb + i;
            const int grp = c / p.gs;
            if (grp != gcur) {
              gcur = grp;
              hh = dec_meta(p.scale, row * ng + grp, fp8_meta);
              zz = dec_meta(p.zero, row * ng + grp, fp8_meta);
            }
            const float kv = (float)((byte >> (i * p.bits)) & cmask) * hh + zz;
            const int ch = p.start + c;
#pragma unroll
            for (int g = 0; g < kMaxG; ++g)
              if (g < gq) sc[g] += q_s[g * d + ch] * kv;
          }
        }
      }
      if (softcap > 0.f)
        for (int g = 0; g < gq; ++g) sc[g] = softcap * tanhf(sc[g] / softcap);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) sc[g] = (mk > 0.f) ? sc[g] : kNeg;

    // ---- online-softmax update (identical in every thread) ----
    float mx[kMaxG], sm[kMaxG], alpha[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) mx[g] = sc[g];
    block_reduce(mx, gq, red, true);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      const float m_new = fmaxf(m_run[g], mx[g]);
      sm[g] = expf(sc[g] - m_new) * mk;
      alpha[g] = expf(m_run[g] - m_new);
      m_run[g] = m_new;
      if (g < gq && tid < bs) p_s[g * bs + tid] = sm[g];
    }
    block_reduce(sm, gq, red, false);   // also orders the p_s writes
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) l_run[g] = l_run[g] * alpha[g] + sm[g];

    // ---- P.V over V sub-tiles dequantized into shared memory ----
    float pv[kMaxOut];
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) pv[o] = 0.f;
    for (int sub = 0; sub < bs; sub += kSub) {
      const int nsub = min(kSub, bs - sub);
      int nbytes = 0;
      for (int pi = 0; pi < vp.n; ++pi)
        nbytes += vp.p[pi].width * vp.p[pi].bits / 8;
      for (int idx = tid; idx < nsub * nbytes; idx += kThreads) {
        const int tt = idx / nbytes;
        int j = idx - tt * nbytes;
        const int pi = (vp.n > 1 && j >= vp.p[0].width * vp.p[0].bits / 8);
        const Plane& p = vp.p[pi];
        if (pi) j -= vp.p[0].width * vp.p[0].bits / 8;
        const int cpb = 8 / p.bits, ng = p.width / p.gs;
        const int tok = t0 + sub + tt;
        float* dst = v_s + tt * d + p.start + j * cpb;
        if (tok < S) {
          const size_t row = plane_row(tbl, nb, bt, n_phys, b, S, tok, hkv,
                                       h);
          const unsigned byte = __ldg(p.codes + row * (p.width * p.bits / 8) + j);
          const unsigned cmask = (1u << p.bits) - 1u;
          for (int i = 0; i < cpb; ++i) {
            const int grp = (j * cpb + i) / p.gs;
            const float hh = dec_meta(p.scale, row * ng + grp, fp8_meta);
            const float zz = dec_meta(p.zero, row * ng + grp, fp8_meta);
            dst[i] = (float)((byte >> (i * p.bits)) & cmask) * hh + zz;
          }
        } else {
          for (int i = 0; i < cpb; ++i) dst[i] = 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kMaxOut; ++k) {
        const int o = tid + k * kThreads;
        if (o < gq * d) {
          const int g = o / d, c = o - g * d;
          const float* pr = p_s + g * bs + sub;
          float s = 0.f;
          for (int tt = 0; tt < nsub; ++tt) s += pr[tt] * v_s[tt * d + c];
          pv[k] += s;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      const int o = tid + k * kThreads;
      if (o < gq * d) acc[k] = acc[k] * alpha[o / d] + pv[k];
    }
  }

  const size_t obase = ((size_t)b * hkv + h) * gq;
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    const int o = tid + k * kThreads;
    if (o < gq * d) num_out[obase * d + o] = acc[k];
  }
  if (tid == 0)
    for (int g = 0; g < gq; ++g) {
      m_out[obase + g] = m_run[g];
      l_out[obase + g] = l_run[g];
    }
}

Planes make_planes(int n, const void* c0, const void* s0, const void* z0,
                   int st0, int w0, int b0, int gs0, const void* c1,
                   const void* s1, const void* z1, int st1, int w1, int b1,
                   int gs1) {
  Planes ps;
  ps.n = n;
  ps.p[0] = Plane{(const uint8_t*)c0, s0, z0, st0, w0, b0, gs0};
  ps.p[1] = Plane{(const uint8_t*)c1, s1, z1, st1, w1, b1, gs1};
  return ps;
}

}  // namespace

// q: (B, Hkv, Gq, D) f32; mask: (B, S_mask) f32; bounds: (B, 2) i32 block
// range [lo, hi) over S_mask / bs tiles.  Striped (tbl null): planes codes
// (B, S, Hkv, W*b/8) u8, scale/zero (B, S, Hkv, W/gs) u8 (fp8) or f16.
// Pooled: tbl (B, nb) i32, planes (n_phys, bt, Hkv, ...), S = nb * bt.
// Outputs: num (B, Hkv, Gq, D), m and l (B, Hkv, Gq) f32.  Returns
// cudaGetLastError().
extern "C" int decode_attn_launch(
    const float* q, const float* mask, const int* bounds, const int* tbl,
    int nb, int bt, int n_phys,
    int nk, const void* kc0, const void* ks0, const void* kz0, int kst0,
    int kw0, int kb0, int kgs0, const void* kc1, const void* ks1,
    const void* kz1, int kst1, int kw1, int kb1, int kgs1,
    int nv, const void* vc0, const void* vs0, const void* vz0, int vst0,
    int vw0, int vb0, int vgs0, const void* vc1, const void* vs1,
    const void* vz1, int vst1, int vw1, int vb1, int vgs1,
    int B, int S, int S_mask, int hkv, int gq, int d, int bs, float scale,
    float softcap, int fp8_meta, float* num, float* m, float* l,
    void* stream) {
  if (B <= 0 || hkv <= 0) return 0;
  if (gq < 1 || gq > kMaxG || gq * d > kThreads * kMaxOut || bs < 1 ||
      bs > kThreads || S_mask % bs != 0 || S > S_mask)
    return (int)cudaErrorInvalidValue;
  if (tbl && (nb < 1 || bt < 1 || n_phys < 1 || S != nb * bt))
    return (int)cudaErrorInvalidValue;
  const Planes kp = make_planes(nk, kc0, ks0, kz0, kst0, kw0, kb0, kgs0, kc1,
                                ks1, kz1, kst1, kw1, kb1, kgs1);
  const Planes vp = make_planes(nv, vc0, vs0, vz0, vst0, vw0, vb0, vgs0, vc1,
                                vs1, vz1, vst1, vw1, vb1, vgs1);
  const size_t smem =
      (size_t)(gq * d + gq * bs + kSub * d + kWarps * kMaxG) * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(decode_attn_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  decode_attn_kernel<<<B * hkv, kThreads, smem, (cudaStream_t)stream>>>(
      q, mask, bounds, tbl, nb, bt, n_phys, kp, vp, S, S_mask, hkv, gq, d,
      bs, scale, softcap,
      fp8_meta, num, m, l);
  return (int)cudaGetLastError();
}
