// Fused dequantize + online-softmax decode attention over the packed SKVQ
// planes, for Hopper (sm_90a): a split-sequence (flash-decoding) kernel and
// a deterministic merge of its partials.
//
// Replaces the TPU kernel decode_attn_pallas (src/repro/kernels/decode_attn.py,
// body _kernel with helpers _unpack_block / _dequant_tile), in its striped
// layout with per-slot block bounds and in its block-table (pooled) mode,
// DESIGN.md §4 and §9.  For each (slot, kv head) it unpacks the 1/2/4/8-bit
// codes of one or two planes, dequantizes code*scale + zero per group in f32
// (scale/zero FP8-E4M3 or fp16), scores (q*scale).k for the Gq query heads
// sharing the kv head, applies the optional tanh softcap and the per-slot
// mask, and runs an online softmax.  It returns the UNNORMALIZED f32 triple
// (num, m, l) that the caller merges with the fp sink/window segments.
//
// What bounds it on an H100: bytes.  Per live token and kv head it reads
// 62 B of packed K and V rows and metadata (D = 128, K2/V1.5, fp8 meta) for
// about 4 * D * Gq flops; Gq <= 8 query rows per kv head stay far below the
// card's 295 flop/byte ridge, so tensor cores (wgmma) would buy nothing and
// the math runs on the f32 pipes.  Unpacking and dequantizing cost more
// instructions per byte than the products themselves, so the kernel is
// written to spend few of them per code (below).  The design:
//
//   * Split plan (kernels/decode_attn.py:split_plan, from shapes alone).
//     The grid is (kv-head group, split, slot).  A split owns tps
//     consecutive block_s-token tiles; the plan picks tps so that there are
//     about eight CTAs per SM, so a single long slot fills the card as well
//     as a batch does.  Each CTA reads its slot's [lo, hi) bounds from
//     device memory and clips its range to them and to the plane length S:
//     the plan never depends on the bounds, the host never reads them, and
//     a split with no live tile writes the empty partial (num 0, m -1e30,
//     l 0) and exits.
//   * Merge.  A second kernel combines a (slot, head)'s split partials by
//     logsumexp in split order 0..n-1 (m = max, num and l rescaled to it).
//     No atomics: launches are bitwise repeatable, the pruned walk equals
//     the full walk bitwise, and pooled equals striped bitwise.  With one
//     split the main kernel writes the outputs itself and no merge runs.
//   * Coalesced loads.  A CTA covers hg (<= 8) kv heads of one slot, one
//     warp per head.  The hg rows of a token are contiguous in every plane,
//     both in the striped (B, S, Hkv, W) layout and the pool-major
//     (NP, BT, Hkv, W) one, so a CTA copies whole row runs (K codes 256 B,
//     V codes 128 + 64 B, every scale/zero plane 8 B per token at hg = 8)
//     with 16-byte cp.async where the widths allow.  Tokens go through a
//     3-stage ring of 32-token chunks in shared memory, so two chunks are
//     in flight while one is computed.  In pooled mode the physical block
//     of a token is read from the table once per pool block and chunk (one
//     lane per block loads it, the others take it by shuffle); an entry
//     outside [0, n_phys) reads null block 0.
//   * One barrier per chunk.  The online-softmax state of a head lives in
//     its warp: scores with one token per lane (the K row dequantized in
//     registers against q held in shared memory), one warp max per chunk,
//     per-lane partial l (summed once per split), then P.V with the warp's
//     lanes spread over the Gq x D outputs in 4-channel quads (several
//     tokens at once when D < 128).  Warps never merge with each other.
//   * Cheap unpacking.  A code at bit k (k + bits <= 23) of a word x
//     becomes an exact float as  bits_as_float((x & mask) | magic) - magic
//     with magic = 2^(23-k): one logic op and one add, instead of the
//     quarter-rate integer-to-float conversion.  Dequantization is then
//     fmaf(code, scale, zero) in f32, as in the TPU kernel.  In the scores
//     every code of a 16-bit piece shares the magic 2^23 (held in a
//     register, so that mask and or are one LOP3) and is read as code * 2^k
//     against scale * 2^-k, which is the same product exactly.  Planes whose
//     codes are at most 2 bits wide take byte loads in P.V (the paper's
//     V1.5); wider ones a word and two shifts.
//   * Tokens at or past S (planes shorter than the mask) are masked and
//     never read.  A chunk or token that is entirely masked adds exactly
//     nothing (p = 0, rescale exp(0) = 1), so chunk boundaries are fixed
//     relative to the split and the pruned walk is bitwise the full walk.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kTT = 32;          // tokens per chunk = lanes of a warp
constexpr int kStages = 3;       // depth of the cp.async ring
constexpr int kMaxHG = 8;        // kv heads per CTA, one warp each
constexpr int kStreams = 13;     // mask, then (codes, scale, zero) of K0 K1 V0 V1
constexpr int kKs = 1, kVs = 7;  // first stream of K and of V
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;

struct Plane { int start, width, bits, gs; };

// One plane (or the mask) as the CTA copies it: per token, hg rows of
// row_bytes, in upt units of unit bytes, to ts-byte slots at off.
struct Stream {
  const uint8_t* ptr;
  int row_bytes, unit, upt, upt_shift, ts, off;
};

struct Params {
  const float* q;
  const float* mask;
  const int* bounds;
  const int* tbl;
  int nb, bt, n_phys;
  int S, S_mask, hkv, gq, d, bs, fp8_meta;
  float scale, softcap;
  int hg, tps, nspl;
  int nk, nv, ngv;
  Plane kp[2], vp[2];
  Stream st[kStreams];
  int stage_bytes, q_off, p_off, vm_off;
  uint32_t magic;                  // bits of 2^23, the code-to-float magic
  float* num;
  float* m;
  float* l;
};

__device__ __forceinline__ float dec_meta(const uint8_t* row, int gi,
                                          int fp8_meta) {
  if (fp8_meta) {
    __half_raw hr = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)row[gi],
                                            __NV_E4M3);
    return __half2float(__half(hr));
  }
  return __half2float(reinterpret_cast<const __half*>(row)[gi]);
}

// The code in bits [k, k + b) of x as an exact float, for k + b <= 23:
// magic = bits of 2^(23-k), so the float (x & mask) | magic is
// 2^(23-k) + code.
__device__ __forceinline__ float code_at(uint32_t x, uint32_t mask,
                                         uint32_t magic) {
  return __uint_as_float((x & mask) | magic) - __uint_as_float(magic);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void copy_unit(uint8_t* dst, const uint8_t* src,
                                          int unit) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (unit == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (unit == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (unit == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (unit == 2)
    *reinterpret_cast<unsigned short*>(dst) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
  else
    *dst = __ldg(src);
}

// Plane row (in tokens) of token t of slot b for this lane.  Pooled: the
// first lane of each pool block in the warp reads the table, the others
// take its entry by shuffle.
__device__ __forceinline__ int token_row(const Params& P, int b, int t,
                                         int lane) {
  if (!P.tbl) return b * P.S + t;
  const int tt = min(max(t, 0), P.S - 1);
  const int blk = tt / P.bt, off = tt - blk * P.bt;
  const int src = max(lane - off, 0);
  int phys = 0;
  if (lane == src) phys = __ldg(P.tbl + (size_t)b * P.nb + blk);
  phys = __shfl_sync(kFull, phys, src);
  if (phys < 0 || phys >= P.n_phys) phys = 0;
  return phys * P.bt + off;
}

// sc[g] += q[g, c] * (code_c * s + z) for the NC codes at bits 0.. of x.
// Code c is taken in place, at bit k = c * B, as the exact float
// bits_as_float((x & mask_k) | magic) - 2^23 = code * 2^k (magic = the bits
// of 2^23, held in a register so that one logic op does mask and or), and
// sk[c] = s * 2^-k: fmaf(code * 2^k, s * 2^-k, z) is exactly fmaf(code, s, z).
template <int B, int NC, int G>
__device__ __forceinline__ void dot_piece(uint32_t x, uint32_t magic,
                                          const float* q, int d,
                                          const float (&sk)[16 / B], float z,
                                          float (&sc)[G]) {
  float v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    v[c] = fmaf(__uint_as_float((x & (((1u << B) - 1u) << (c * B))) | magic)
                    - 8388608.f,
                sk[c], z);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float* qg = q + g * d;
    if constexpr (NC % 4 == 0) {
#pragma unroll
      for (int c = 0; c < NC; c += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qg + c);
        sc[g] = fmaf(qq.x, v[c], sc[g]);
        sc[g] = fmaf(qq.y, v[c + 1], sc[g]);
        sc[g] = fmaf(qq.z, v[c + 2], sc[g]);
        sc[g] = fmaf(qq.w, v[c + 3], sc[g]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) sc[g] = fmaf(qg[c], v[c], sc[g]);
    }
  }
}

// Scores of one token against the G query rows over one K plane; q points
// at the plane's first channel of row 0.  The widest loads the row's
// alignment allows; 16-bit pieces of codes (8-bit ones for groups of one
// byte).
template <int B, int G>
__device__ __forceinline__ void score_plane(const uint8_t* crow,
                                            const uint8_t* srow,
                                            const uint8_t* zrow, int fp8_meta,
                                            uint32_t magic, const float* q,
                                            int d, int width, int gs,
                                            float (&sc)[G]) {
  constexpr int H = 16 / B;            // codes in 16 bits
  const int ng = width / gs, gbytes = gs * B / 8;
  for (int gi = 0; gi < ng; ++gi) {
    const float s = dec_meta(srow, gi, fp8_meta);
    const float z = dec_meta(zrow, gi, fp8_meta);
    float sk[H];
#pragma unroll
    for (int c = 0; c < H; ++c) sk[c] = s * (1.f / (float)(1u << (c * B)));
    const uint8_t* cg = crow + gi * gbytes;
    const float* qg = q + gi * gs;
    if ((gbytes & 15) == 0 && ((uintptr_t)cg & 15) == 0) {
      for (int j = 0; j < gbytes; j += 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(cg + j);
        const float* qj = qg + j * 8 / B;
        dot_piece<B, H, G>(w.x, magic, qj, d, sk, z, sc);
        dot_piece<B, H, G>(w.x >> 16, magic, qj + H, d, sk, z, sc);
        dot_piece<B, H, G>(w.y, magic, qj + 2 * H, d, sk, z, sc);
        dot_piece<B, H, G>(w.y >> 16, magic, qj + 3 * H, d, sk, z, sc);
        dot_piece<B, H, G>(w.z, magic, qj + 4 * H, d, sk, z, sc);
        dot_piece<B, H, G>(w.z >> 16, magic, qj + 5 * H, d, sk, z, sc);
        dot_piece<B, H, G>(w.w, magic, qj + 6 * H, d, sk, z, sc);
        dot_piece<B, H, G>(w.w >> 16, magic, qj + 7 * H, d, sk, z, sc);
      }
    } else if ((gbytes & 3) == 0 && ((uintptr_t)cg & 3) == 0) {
      for (int j = 0; j < gbytes; j += 4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(cg + j);
        dot_piece<B, H, G>(w, magic, qg + j * 8 / B, d, sk, z, sc);
        dot_piece<B, H, G>(w >> 16, magic, qg + j * 8 / B + H, d, sk, z, sc);
      }
    } else if ((gbytes & 1) == 0 && ((uintptr_t)cg & 1) == 0) {
      for (int j = 0; j < gbytes; j += 2)
        dot_piece<B, H, G>(*reinterpret_cast<const uint16_t*>(cg + j), magic,
                           qg + j * 8 / B, d, sk, z, sc);
    } else {
      for (int j = 0; j < gbytes; ++j)
        dot_piece<B, 8 / B, G>(cg[j], magic, qg + j * 8 / B, d, sk, z, sc);
    }
  }
}

// Where lane's quad Q (channels 4Q..4Q+3) of V lives in a stage, and how
// to unpack it.  LK8: the quad is in one byte (planes of <= 2 bits), at
// bits k0 + c*bits.  Otherwise: the aligned word holding it, shifted by sh;
// codes 0, 1 at bits 0 and bits of x, codes 2, 3 the same of x >> sh2.
struct VQ {
  int addr, ts, gidx, sh, sh2;
  uint32_t mk[4], mg[4];
  bool active;
};

template <bool LK8>
__device__ __forceinline__ VQ make_vq(const Params& P, int Q, int w) {
  VQ r;
  r.active = Q < P.d / 4;
  r.addr = r.ts = r.gidx = r.sh = r.sh2 = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) r.mk[c] = r.mg[c] = 0u;
  if (!r.active) return r;
  const int ch = 4 * Q;
  const bool hi = P.nv > 1 && ch >= P.vp[1].start;
  const Plane pl = hi ? P.vp[1] : P.vp[0];
  const int row_bytes = hi ? P.st[kVs + 3].row_bytes : P.st[kVs].row_bytes;
  const int off = hi ? P.st[kVs + 3].off : P.st[kVs].off;
  r.ts = hi ? P.st[kVs + 3].ts : P.st[kVs].ts;
  const int bitoff = (ch - pl.start) * pl.bits;
  const int byte = off + w * row_bytes + bitoff / 8;
  r.gidx = (hi ? P.vp[0].width / P.vp[0].gs : 0) + (ch - pl.start) / pl.gs;
  const uint32_t mb = (1u << pl.bits) - 1u;
  if (LK8) {
    r.addr = byte;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = bitoff % 8 + c * pl.bits;
      r.mk[c] = mb << k;
      r.mg[c] = (uint32_t)(150 - k) << 23;
    }
  } else {
    r.addr = byte & ~3;
    r.sh = (byte & 3) * 8 + bitoff % 8;
    r.sh2 = 2 * pl.bits;
    r.mk[0] = mb;
    r.mk[1] = mb << pl.bits;
    r.mg[0] = 150u << 23;
    r.mg[1] = (uint32_t)(150 - pl.bits) << 23;
  }
  return r;
}

template <int G, int kNQ, bool LK8>
__global__ void __launch_bounds__(kMaxHG * 32,
                                  G >= 4 || kNQ > 1 ? 2 : 3)
decode_attn_split(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nthreads = blockDim.x;
  const int h0 = blockIdx.x * P.hg, h = h0 + w;
  const int split = blockIdx.y, b = blockIdx.z;
  const int D = P.d;
  float* q_s = reinterpret_cast<float*>(smem + P.q_off);
  float* p_s = reinterpret_cast<float*>(smem + P.p_off);
  const float2* vm_s = reinterpret_cast<const float2*>(smem + P.vm_off);

  // This CTA's tokens: the split's tiles, clipped to the slot's bounds and
  // to the plane length.
  const int n_blocks = P.S_mask / P.bs;
  const int lo = max(P.bounds[2 * b], 0);
  const int hi = min(P.bounds[2 * b + 1], n_blocks);
  const int s_lo = split * P.tps * P.bs;
  const int s_hi = min((split + 1) * P.tps, n_blocks) * P.bs;
  const int rlo = max(s_lo, lo * P.bs);
  const int rhi = min(min(s_hi, hi * P.bs), P.S);
  const size_t pbase = ((size_t)(b * P.hkv + h) * P.nspl + split) * P.gq;
  if (rlo >= rhi) {                          // no live tile: empty partial
    for (int g = 0; g < P.gq; ++g) {
      for (int c = lane; c < D; c += 32) P.num[(pbase + g) * D + c] = 0.f;
      if (lane == 0) {
        P.m[pbase + g] = kNeg;
        P.l[pbase + g] = 0.f;
      }
    }
    return;
  }

  for (int i = threadIdx.x; i < P.hg * G * D; i += nthreads) {
    const int hw = i / (G * D), r = i - hw * G * D, g = r / D;
    q_s[i] = g < P.gq ? P.q[((size_t)(b * P.hkv + h0 + hw) * P.gq + g) * D
                            + (r - g * D)] * P.scale
                      : 0.f;
  }

  // Chunks start at fixed offsets from the split's start, whatever the
  // bounds: dead chunks of the full walk are the ones the pruned walk skips.
  const int c0 = s_lo + (rlo - s_lo) / kTT * kTT;
  const int n_chunks = (rhi - c0 + kTT - 1) / kTT;

  // Copies of one chunk: for each stream, consecutive threads take
  // consecutive units of the chunk's row runs; a stream's first warp
  // rotates with the stream, so the small ones spread over the warps.
  auto load_chunk = [&](int c) {
    const int t0 = c0 + c * kTT;
    const int row = P.tbl ? token_row(P, b, t0 + lane, lane) : 0;
    const size_t row0 = (size_t)b * P.S + t0;
    uint8_t* stage = smem + (c % kStages) * P.stage_bytes;
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      const Stream& X = P.st[s];
      if (X.upt == 0) continue;
      const int n = kTT * X.upt;
      for (int base = ((w + s) & (P.hg - 1)) * 32; base < n;
           base += nthreads) {
        const int idx = base + lane;
        const int i = X.upt_shift >= 0 ? idx >> X.upt_shift : idx / X.upt;
        const int u = idx - i * X.upt;
        const size_t r = P.tbl ? (size_t)__shfl_sync(kFull, row, i & 31)
                               : row0 + i;
        const int t = t0 + i;
        if (idx < n && t >= rlo && t < rhi) {
          const uint8_t* src =
              s == 0 ? reinterpret_cast<const uint8_t*>(
                           P.mask + (size_t)b * P.S_mask + t)
                     : X.ptr + (r * P.hkv + h0) * X.row_bytes +
                           u * X.unit;
          copy_unit(stage + X.off + i * X.ts + u * X.unit, src, X.unit);
        }
      }
    }
  };

  float m_run[G], l_lane[G], acc[kNQ][G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = kNeg;
    l_lane[g] = 0.f;
#pragma unroll
    for (int qd = 0; qd < kNQ; ++qd)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[qd][g][c] = 0.f;
  }
  // P.V lanes: nquad quads per token; tpi tokens at once when D < 128.
  const int nquad = D / 4;
  const int tpi = nquad <= 32 ? 32 / nquad : 1;
  const int slot = nquad <= 32 ? lane / nquad : 0;
  const int qbase = nquad <= 32 ? lane % nquad : lane;
  const int nq = (nquad + 31) / 32;
  const VQ vq0 = make_vq<LK8>(P, qbase, w);

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_chunks) load_chunk(k);
    cp_async_commit();
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();            // chunk c landed; chunk c-1's stage is free
    if (c + kStages - 1 < n_chunks) load_chunk(c + kStages - 1);
    cp_async_commit();
    const uint8_t* stage = smem + (c % kStages) * P.stage_bytes;
    const int t0 = c0 + c * kTT;

    // ---- scores, one token per lane; the token's V metadata decoded ----
    const int t = t0 + lane;
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
    float mk = 0.f;
    if (t >= rlo && t < rhi) {
      mk = reinterpret_cast<const float*>(stage + P.st[0].off)[lane];
      const float* qw = q_s + w * G * D;
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        if (pi >= P.nk) break;
        const Plane pl = P.kp[pi];
        const Stream& cs = P.st[kKs + 3 * pi];
        const Stream& ss = P.st[kKs + 3 * pi + 1];
        const Stream& zs = P.st[kKs + 3 * pi + 2];
        const uint8_t* crow = stage + cs.off + lane * cs.ts + w * cs.row_bytes;
        const uint8_t* srow = stage + ss.off + lane * ss.ts + w * ss.row_bytes;
        const uint8_t* zrow = stage + zs.off + lane * zs.ts + w * zs.row_bytes;
        const float* qp = qw + pl.start;
        switch (pl.bits) {
          case 1: score_plane<1, G>(crow, srow, zrow, P.fp8_meta, P.magic,
                                    qp, D, pl.width, pl.gs, sc); break;
          case 2: score_plane<2, G>(crow, srow, zrow, P.fp8_meta, P.magic,
                                    qp, D, pl.width, pl.gs, sc); break;
          case 4: score_plane<4, G>(crow, srow, zrow, P.fp8_meta, P.magic,
                                    qp, D, pl.width, pl.gs, sc); break;
          default: score_plane<8, G>(crow, srow, zrow, P.fp8_meta, P.magic,
                                     qp, D, pl.width, pl.gs, sc); break;
        }
      }
      if (P.softcap > 0.f) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          sc[g] = P.softcap * tanhf(sc[g] / P.softcap);
      }
      float2* vm = const_cast<float2*>(vm_s) + (w * kTT + lane) * P.ngv;
      int go = 0;
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        if (pi >= P.nv) break;
        const Stream& ss = P.st[kVs + 3 * pi + 1];
        const Stream& zs = P.st[kVs + 3 * pi + 2];
        const uint8_t* srow = stage + ss.off + lane * ss.ts + w * ss.row_bytes;
        const uint8_t* zrow = stage + zs.off + lane * zs.ts + w * zs.row_bytes;
        const int ng = P.vp[pi].width / P.vp[pi].gs;
        for (int gi = 0; gi < ng; ++gi)
          vm[go + gi] = make_float2(dec_meta(srow, gi, P.fp8_meta),
                                    dec_meta(zrow, gi, P.fp8_meta));
        go += ng;
      }
    }

    // ---- online softmax: one warp max per chunk, per-lane partial l ----
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sc[g] = (mk > 0.f) ? sc[g] : kNeg;
      float cm = sc[g];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, o));
      const float m_new = fmaxf(m_run[g], cm);
      const float alpha = expf(m_run[g] - m_new);
      const float p = expf(sc[g] - m_new) * mk;
      l_lane[g] = l_lane[g] * alpha + p;
      m_run[g] = m_new;
      p_s[(w * kTT + lane) * G + g] = p;
      if (alpha != 1.f) {
#pragma unroll
        for (int qd = 0; qd < kNQ; ++qd) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[qd][g][c] *= alpha;
        }
      }
    }
    __syncwarp();

    // ---- P.V over the chunk's copied tokens, lanes over 4-channel quads --
    const int va = max(t0, rlo) - t0, vb = min(t0 + kTT, rhi) - t0;
    if (slot < tpi) {
      const int ib = va + ((slot - va) % tpi + tpi) % tpi;
#pragma unroll
      for (int qd = 0; qd < kNQ; ++qd) {
        if (qd >= nq) break;
        const VQ vq = qd == 0 ? vq0 : make_vq<LK8>(P, qbase + 32 * qd, w);
        if (!vq.active) continue;
        const uint8_t* cp = stage + vq.addr + ib * vq.ts;
#pragma unroll 4
        for (int i = ib; i < vb; i += tpi, cp += tpi * vq.ts) {
          const float2 sz = vm_s[(w * kTT + i) * P.ngv + vq.gidx];
          float v[4];
          if constexpr (LK8) {
            const uint32_t x = *cp;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              v[k] = fmaf(code_at(x, vq.mk[k], vq.mg[k]), sz.x, sz.y);
          } else {
            const uint32_t x = *reinterpret_cast<const uint32_t*>(cp) >> vq.sh;
            const uint32_t x2 = x >> vq.sh2;
            v[0] = fmaf(code_at(x, vq.mk[0], vq.mg[0]), sz.x, sz.y);
            v[1] = fmaf(code_at(x, vq.mk[1], vq.mg[1]), sz.x, sz.y);
            v[2] = fmaf(code_at(x2, vq.mk[0], vq.mg[0]), sz.x, sz.y);
            v[3] = fmaf(code_at(x2, vq.mk[1], vq.mg[1]), sz.x, sz.y);
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pg = p_s[(w * kTT + i) * G + g];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc[qd][g][k] = fmaf(pg, v[k], acc[qd][g][k]);
          }
        }
      }
    }
  }

  // ---- once per split: sum l over lanes and the token slots' outputs ----
  float l_sum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float l = l_lane[g];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
    l_sum[g] = l;
  }
  if (tpi > 1) {                 // D < 128: only kNQ slot 0 is in use
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = acc[0][g][c];
        for (int k = 1; k < tpi; ++k)
          a += __shfl_sync(kFull, acc[0][g][c], (lane + k * nquad) & 31);
        acc[0][g][c] = a;
      }
  }
  if (slot == 0) {
#pragma unroll
    for (int qd = 0; qd < kNQ; ++qd) {
      if (qd >= nq) break;
      const int Q = qbase + 32 * qd;
      if (Q >= nquad) continue;
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (g < P.gq)
          *reinterpret_cast<float4*>(P.num + (pbase + g) * D + 4 * Q) =
              make_float4(acc[qd][g][0], acc[qd][g][1], acc[qd][g][2],
                          acc[qd][g][3]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g < P.gq) {
        P.m[pbase + g] = m_run[g];
        P.l[pbase + g] = l_sum[g];
      }
  }
}

// Logsumexp merge of the split partials of one (slot, kv head): m = max_s
// m_s, num = sum_s e^(m_s - m) num_s, l likewise.  The block's threads
// split the n splits into R runs of consecutive splits; each run is summed
// in split order and the R run sums are added in run order, so the result
// depends only on n and the block shape.
__global__ void merge_splits(const float* __restrict__ pnum,
                             const float* __restrict__ pm,
                             const float* __restrict__ pl, int nspl, int gq,
                             int d, float* __restrict__ num,
                             float* __restrict__ m, float* __restrict__ l) {
  extern __shared__ float f_s[];          // nspl * gq factors, R * gq * d sums
  __shared__ float mx_s[8];
  const size_t bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const float* ms = pm + bh * nspl * gq;
  const float* ls = pl + bh * nspl * gq;
  if (w < gq) {
    float v = kNeg;
    for (int s = lane; s < nspl; s += 32) v = fmaxf(v, ms[s * gq + w]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    if (lane == 0) mx_s[w] = v;
  }
  __syncthreads();
  for (int i = tid; i < nspl * gq; i += blockDim.x)
    f_s[i] = expf(ms[i] - mx_s[i % gq]);
  __syncthreads();
  const int n_out = gq * d, runs = blockDim.x / n_out;
  const int per = (nspl + runs - 1) / runs;
  float* sums = f_s + nspl * gq;
  for (int o = tid; o < runs * n_out; o += blockDim.x) {
    const int r = o / n_out, e = o - r * n_out, g = e / d;
    const int s1 = min(nspl, (r + 1) * per);
    const float* src = pnum + bh * nspl * n_out + e;
    float a = 0.f;
#pragma unroll 8
    for (int s = r * per; s < s1; ++s) a = fmaf(f_s[s * gq + g], src[(size_t)s * n_out], a);
    sums[o] = a;
  }
  __syncthreads();
  for (int o = tid; o < n_out; o += blockDim.x) {
    float a = sums[o];
    for (int r = 1; r < runs; ++r) a += sums[r * n_out + o];
    num[bh * n_out + o] = a;
  }
  if (tid < gq) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < nspl; ++s) a = fmaf(f_s[s * gq + tid], ls[s * gq + tid], a);
    m[bh * gq + tid] = mx_s[tid];
    l[bh * gq + tid] = a;
  }
}

Plane make_plane(int st, int w, int bits, int gs) {
  return Plane{st, w, bits, gs};
}

bool plane_ok(const Plane& p, int d) {
  return (p.bits == 1 || p.bits == 2 || p.bits == 4 || p.bits == 8) &&
         p.gs > 0 && p.gs % 4 == 0 && p.width % p.gs == 0 &&
         (p.gs * p.bits) % 8 == 0 && p.start % 4 == 0 &&
         p.start + p.width <= d;
}

// Stream of hg rows of row_bytes per token: the widest copy unit that the
// run length and the base pointer allow, and a shared-memory slot padded
// to an odd number of 16-byte lines, so that 32 lanes reading one row each
// spread over the banks.
void set_stream(Stream& X, const void* ptr, int row_bytes, int hg, int& off) {
  const int e = hg * row_bytes;
  int unit = 16;
  while (unit > 1 && (e % unit != 0 || (uintptr_t)ptr % unit != 0)) unit >>= 1;
  X.ptr = (const uint8_t*)ptr;
  X.row_bytes = row_bytes;
  X.unit = unit;
  X.upt = e / unit;
  X.upt_shift = -1;
  for (int k = 0; k < 31; ++k)
    if ((1 << k) == X.upt) X.upt_shift = k;
  X.ts = (e + 15) & ~15;
  if (e >= 16 && (X.ts / 16) % 2 == 0) X.ts += 16;
  X.off = off;
  off += kTT * X.ts;
}

template <int G, int NQ>
int launch_g(const Params& P, bool lk8, dim3 grid, int threads, size_t smem,
             cudaStream_t st) {
  auto kern = lk8 ? decode_attn_split<G, NQ, true>
                  : decode_attn_split<G, NQ, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, st>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Hkv, Gq, D) f32; mask: (B, S_mask) f32; bounds: (B, 2) i32 block
// range [lo, hi) over S_mask / bs tiles.  Striped (tbl null): planes codes
// (B, S, Hkv, W*b/8) u8, scale/zero (B, S, Hkv, W/gs) u8 (fp8) or f16.
// Pooled: tbl (B, nb) i32, planes (n_phys, bt, Hkv, ...), S = nb * bt.
// Plan: hg kv heads per CTA (1, 2, 4 or 8, dividing Hkv), nspl splits of
// ceil(S_mask / bs / nspl) tiles; with nspl > 1, part is f32 scratch of
// B * Hkv * nspl * Gq * (D + 2).  Outputs: num (B, Hkv, Gq, D), m and l
// (B, Hkv, Gq) f32.  Returns cudaGetLastError() of the launches.
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
    float softcap, int fp8_meta, int hg, int nspl, float* part, float* num,
    float* m, float* l, void* stream) {
  if (B <= 0 || hkv <= 0) return 0;
  if (gq < 1 || gq > 8 || gq * d > 1024 || d < 4 || d % 4 != 0 || bs < 1 ||
      bs > 256 || S_mask % bs != 0 || S < 1 || S > S_mask || nk < 1 ||
      nk > 2 || nv < 1 || nv > 2)
    return (int)cudaErrorInvalidValue;
  if (!(hg == 1 || hg == 2 || hg == 4 || hg == 8) || hkv % hg != 0)
    return (int)cudaErrorInvalidValue;
  const int n_blocks = S_mask / bs;
  if (nspl < 1 || nspl > n_blocks || (nspl > 1 && !part))
    return (int)cudaErrorInvalidValue;
  if (tbl && (nb < 1 || bt < 1 || n_phys < 1 || S != nb * bt))
    return (int)cudaErrorInvalidValue;

  Params P{};
  P.q = q;
  P.mask = mask;
  P.bounds = bounds;
  P.tbl = tbl;
  P.nb = nb;
  P.bt = bt;
  P.n_phys = n_phys;
  P.S = S;
  P.S_mask = S_mask;
  P.hkv = hkv;
  P.gq = gq;
  P.d = d;
  P.bs = bs;
  P.fp8_meta = fp8_meta;
  P.magic = 0x4B000000u;
  P.scale = scale;
  P.softcap = softcap;
  P.hg = hg;
  P.nspl = nspl;
  P.tps = (n_blocks + nspl - 1) / nspl;
  P.nk = nk;
  P.nv = nv;
  P.kp[0] = make_plane(kst0, kw0, kb0, kgs0);
  P.kp[1] = make_plane(kst1, kw1, kb1, kgs1);
  P.vp[0] = make_plane(vst0, vw0, vb0, vgs0);
  P.vp[1] = make_plane(vst1, vw1, vb1, vgs1);
  bool lk8 = true;
  P.ngv = 0;
  for (int i = 0; i < nk; ++i)
    if (!plane_ok(P.kp[i], d)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nv; ++i) {
    if (!plane_ok(P.vp[i], d)) return (int)cudaErrorInvalidValue;
    lk8 = lk8 && P.vp[i].bits <= 2;
    P.ngv += P.vp[i].width / P.vp[i].gs;
  }
  // P.V takes each lane's quads from one plane and one group
  if (nv > 1 && P.vp[1].start != P.vp[0].width) return (int)cudaErrorInvalidValue;

  const int msz = fp8_meta ? 1 : 2;
  int off = kTT * 4;                               // the mask
  P.st[0] = Stream{(const uint8_t*)mask, 4, 4, 1, 0, 4, 0};
  const void* kptr[2][3] = {{kc0, ks0, kz0}, {kc1, ks1, kz1}};
  const void* vptr[2][3] = {{vc0, vs0, vz0}, {vc1, vs1, vz1}};
  for (int i = 0; i < 2; ++i) {
    const Plane* pls[2] = {&P.kp[i], &P.vp[i]};
    const int n[2] = {nk, nv};
    const int base[2] = {kKs, kVs};
    for (int side = 0; side < 2; ++side) {
      if (i >= n[side]) continue;
      const Plane& p = *pls[side];
      const void* const* ptr = side ? vptr[i] : kptr[i];
      set_stream(P.st[base[side] + 3 * i], ptr[0], p.width * p.bits / 8, hg,
                 off);
      set_stream(P.st[base[side] + 3 * i + 1], ptr[1], p.width / p.gs * msz,
                 hg, off);
      set_stream(P.st[base[side] + 3 * i + 2], ptr[2], p.width / p.gs * msz,
                 hg, off);
    }
  }
  const int G = gq <= 1 ? 1 : gq <= 2 ? 2 : gq <= 4 ? 4 : 8;
  if (d > 128 && (d / 4 + 31) / 32 > (G == 1 ? 8 : G == 8 ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  P.stage_bytes = (off + 15) & ~15;
  P.q_off = kStages * P.stage_bytes;
  P.p_off = P.q_off + hg * G * d * 4;
  P.vm_off = P.p_off + hg * kTT * G * 4;
  size_t smem = (size_t)P.vm_off + (size_t)hg * kTT * P.ngv * 8;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;

  const size_t nbh = (size_t)B * hkv;
  if (nspl > 1) {
    P.num = part;
    P.m = part + nbh * nspl * gq * d;
    P.l = P.m + nbh * nspl * gq;
  } else {
    P.num = num;
    P.m = m;
    P.l = l;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(hkv / hg, nspl, B);
  int rc;
  // quads per lane in P.V: one up to D = 128; past it, as many as
  // Gq * D <= 1024 can need (8, 4, 4 and 2 for G = 1, 2, 4, 8)
  const bool wide = d > 128;
  switch (G) {
    case 1: rc = wide ? launch_g<1, 8>(P, lk8, grid, 32 * hg, smem, st)
                      : launch_g<1, 1>(P, lk8, grid, 32 * hg, smem, st); break;
    case 2: rc = wide ? launch_g<2, 4>(P, lk8, grid, 32 * hg, smem, st)
                      : launch_g<2, 1>(P, lk8, grid, 32 * hg, smem, st); break;
    case 4: rc = wide ? launch_g<4, 4>(P, lk8, grid, 32 * hg, smem, st)
                      : launch_g<4, 1>(P, lk8, grid, 32 * hg, smem, st); break;
    default: rc = wide ? launch_g<8, 2>(P, lk8, grid, 32 * hg, smem, st)
                       : launch_g<8, 1>(P, lk8, grid, 32 * hg, smem, st); break;
  }
  if (rc != 0 || nspl == 1) return rc;
  // runs of splits per output: as many as 1024 threads hold
  const int n_out = gq * d, runs = n_out >= 1024 ? 1 : 1024 / n_out;
  const int threads = n_out >= 1024 ? 1024 : runs * n_out;
  const size_t msmem = ((size_t)nspl * gq + (size_t)runs * n_out) * 4;
  if (threads < 32 * gq || msmem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (msmem > 48 * 1024 &&
      cudaFuncSetAttribute(merge_splits,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)msmem) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  merge_splits<<<(unsigned)nbh, threads, msmem, st>>>(P.num, P.m, P.l, nspl,
                                                      gq, d, num, m, l);
  return (int)cudaGetLastError();
}
