// flash_tc: causal (or full) GQA attention for bf16 and f16 operands on
// Hopper's tensor cores (wgmma) with TMA loads into an mbarrier ring.
//
// Replaces the Pallas kernel repro/kernels/flash.py:flash_attention (and its
// batched wrapper flash_attention_bshd) for 16-bit operands; f32 operands go
// to the SIMT kernel in flash.cu (kernels/flash.py routes by dtype). It
// computes what the Pallas body computes: q [B, S, H, hd], k and v
// [B, T, KV, hd], query head h reads kv head h / G (K/V never repeated);
// scores in f32 masked with -1e30 where k_index > q_index (top-left aligned,
// also when S != T) and where k_index >= T; the running max m, the row sum l
// and the accumulator acc in f32; the output acc / max(l, 1e-30), rounded
// once to q's dtype.
//
// Two places differ from the reference's f32 arithmetic, by design:
// - s = (q k^T) * hd^-0.5: the scale is applied to the f32 product, not to
//   q before it (the tensor cores take q as it is stored). Where hd^-0.5 is
//   no power of 2 (hd = 32, 128, 192) that moves a score by a few f32 ulps
//   of the sum of |q_i k_i|, inside the derived tolerance's ds (two f32 sums
//   of hd products in other orders).
// - p v: p is kept in f32 for m, l and the rescaling, and enters the tensor
//   cores as two 16-bit terms, p_hi = rn(p) and p_lo = rn(p - p_hi), each
//   multiplied by v into the one f32 acc. The pair carries p to a relative
//   2^-16 in bf16 (2^-22 in f16) where one bf16 p would be 2^-8 off, 256
//   times the data-scaled tolerance of 256 u max|v| (u = 2^-24). For f16
//   the pair is taken of p * 2^15 (p <= 1, so p * 2^15 <= 2^15 < 65504) and
//   acc is scaled back by 2^-15, exactly, before the division: without it a
//   p below 2^-14 would round in f16's subnormal range, to an absolute
//   2^-25 whatever its size, and a p below 2^-25 would vanish.
// The split costs 1.5x the tensor-core work of a one-pass p v.
//
// Bound on this card: 4 B H hd S (S + 1) / 2 operations for a causal call
// (times 1.5 with the split) on 2 (B S H + 2 B T KV) hd bytes: at gemma-2b's
// B = 4, S = 2048, H = 8, KV = 1, hd = 256 that is 103 GFLOP of tensor work
// on 42 MB, so operations bound it: 0.104 ms at the bf16 peak.
//
// Design. One CTA of three warpgroups per (batch * head, 128-row q block);
// the q blocks are launched last block first, so the longest causal rows
// start first and the short ones fill the tail.
// - Warpgroup 2 is the producer: it gives its registers away (setmaxnreg)
//   and one thread issues the TMA loads, q once and the K and V blocks into
//   a ring of ST stages. Each stage has "full" mbarriers for K and for V
//   (transaction counted) and "empty" ones for K and for V, on which the
//   eight consumer warps arrive when they are done with it: K is free once
//   its S is computed, long before V is.
// - Warpgroups 0 and 1 each own 64 q rows. S = Q K^T by wgmma, both
//   operands K-major from swizzled shared memory; then the scale, the masks
//   (only on the blocks that cross the diagonal or T) and the online
//   softmax on the accumulator fragment in registers (row max and sum
//   across the four lanes of a quad); then acc += p_hi V + p_lo V by wgmma
//   with A from registers (the accumulator's layout is the A fragment's, so
//   p needs no shuffle) and V MN-major through the transpose bit.
// - Overlap: block n + 1's S is issued together with block n's P V, and its
//   softmax runs while the tensor cores finish P V; named barriers make the
//   two warpgroups take turns at issuing their GEMMs, so one's softmax runs
//   under the other's GEMMs.
// - A consumer skips the kv blocks past its own rows' diagonal but still
//   takes its turn and releases their stages. The output is written from
//   registers, masked at S.
//
// Shared memory: TMA boxes of BOXD columns, the widest of 64, 32 and 16
// that divides hd (64 columns, 128 bytes, is the widest row a swizzle can
// take), one region per box; a row of BOXD columns is one swizzle row, so
// the wgmma descriptors use the swizzle of BOXD * 2 bytes: 32 (hd 16 and
// 80), 64 (hd 32) or 128 bytes (hd 64, 128, 192, 256). hd 80 is five boxes
// of 16 columns: S = Q K^T takes one box a k-step and P V one m64n16 wgmma
// a box, so the head dims of the dense configs keep the boxes they had. At
// hd = 256 that is Q 64 KiB + 2 x (K 32 + V 32) KiB = 192 KiB; at hd = 80,
// Q 20 KiB + 2 x (K 20 + V 20) KiB = 100 KiB.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr float FTC_NEG_INF = -1e30f;
constexpr int FTC_WG = 128;  // threads of a warpgroup
// p is split as p * PSCALE: 2^15 keeps f16's pair out of its subnormals
template <bool BF>
constexpr float FTC_PSCALE = BF ? 1.0f : 32768.0f;

template <bool BF, int HD>
struct FtcCfg {
  static constexpr int NC = 2;               // consumer warpgroups
  static constexpr int BM = 64 * NC;         // q rows of a CTA
  static constexpr int BKV = HD <= 128 ? 128 : 64;  // kv rows of a block
  static constexpr int ST = 2;               // stages of the K/V ring
  // columns of a TMA box: the widest of 64, 32 and 16 that divides HD
  static constexpr int BOXD = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int NB = HD / BOXD;       // boxes of a row
  static constexpr int ROWB = BOXD * 2;      // bytes of a swizzle row
  static constexpr int SWZ = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;  // descriptor code
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;
  static constexpr int BAR_BYTES = 8 * (1 + 4 * ST);
  // + 1 KiB to align the base to the swizzle pattern's 1024-byte repeat
  static constexpr int SMEM = Q_BYTES + 2 * ST * KV_BYTES + BAR_BYTES + 1024;
  static constexpr int THREADS = FTC_WG * (NC + 1);
  static_assert(SMEM <= 232448, "shared memory of one CTA");
  static_assert(HD % 16 == 0 && HD % BOXD == 0, "head dim");
};

// D (64 x N, f32) = A (64 x 16) B (16 x N) + [scale_d] D. SS: A and B
// K-major in shared memory. RS: A from four registers of 16-bit pairs, B
// MN-major in shared memory (transpose bit set).
#define FTC_SS64(TY)                                                              \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define FTC_SS128(TY)                                                              \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define FTC_RS16(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7" \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define FTC_RS32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define FTC_RS64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

template <bool BF, int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "QK^T block width");
  if constexpr (N == 64) {
    if constexpr (BF) FTC_SS64("bf16"); else FTC_SS64("f16");
  } else {
    if constexpr (BF) FTC_SS128("bf16"); else FTC_SS128("f16");
  }
}

template <bool BF, int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "PV column chunk");
  if constexpr (N == 16) {
    if constexpr (BF) FTC_RS16("bf16"); else FTC_RS16("f16");
  } else if constexpr (N == 32) {
    if constexpr (BF) FTC_RS32("bf16"); else FTC_RS32("f16");
  } else {
    if constexpr (BF) FTC_RS64("bf16"); else FTC_RS64("f16");
  }
}

// Two floats as one 16-bit pair (the first in the low half), and back.
template <bool BF>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (BF) {
    __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&x);
  } else {
    __half2 x = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&x);
  }
}
template <bool BF>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (BF) {
    const __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&u);
    return __bfloat1622float2(x);
  } else {
    const __half2 x = *reinterpret_cast<__half2*>(&u);
    return __half22float2(x);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// The consumer's steps on one kv block. Accumulator fragments (m64nN, f32):
// register e of a thread (lane = 4 g + t of warp w in its warpgroup) holds
// row 16 w + g + 8 ((e >> 1) & 1) and column 8 (e >> 2) + 2 t + (e & 1).
// ---------------------------------------------------------------------------
// Issue S = Q K^T (k-steps of 16 columns: box kk * 16 / BOXD, 32 bytes
// into it) and commit it as one group. dq is made opaque here so that the
// compiler does not hoist the HD / 16 descriptors into live registers.
template <bool BF, int HD>
__device__ __forceinline__ void issue_qk(float* sc, uint64_t dq0, uint64_t dk) {
  using C = FtcCfg<BF, HD>;
  uint64_t dq;
  asm volatile("mov.b64 %0, %1;" : "=l"(dq) : "l"(dq0));
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t bx = kk * 16 / C::BOXD, off = (kk * 16 % C::BOXD) * 2;
    wgmma_ss<BF, C::BKV>(sc, dq + ((bx * C::BM * C::ROWB + off) >> 4),
                         dk + ((bx * C::BKV * C::ROWB + off) >> 4), kk > 0);
  }
  wg_commit();
}

// Issue acc += p_hi V + p_lo V in column chunks of BOXD (one box each) and
// commit it as one group.
template <bool BF, int HD>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*phi)[4], uint32_t (*plo)[4],
                                         uint64_t dv) {
  using C = FtcCfg<BF, HD>;
  wg_fence();
#pragma unroll
  for (int c = 0; c < C::BKV / 16; ++c)
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      const uint64_t db = dv + ((j * C::BKV * C::ROWB + c * 16 * C::ROWB) >> 4);
      wgmma_rs<BF, C::BOXD>(o + j * (C::BOXD / 2), phi[c], db, 1);
      wgmma_rs<BF, C::BOXD>(o + j * (C::BOXD / 2), plo[c], db, 1);
    }
  wg_commit();
}

// Scale, mask and the online softmax of one block: sc holds the f32 scores
// on entry and p on exit; m, l are updated and corr = exp(m_old - m_new)
// is returned per row for the accumulator. Only a block that crosses the
// diagonal or T is masked.
template <int NS>
__device__ __forceinline__ void softmax_block(float* sc, int k0, int Tk, bool edge, bool causal,
                                              int r0, int tq4, float scale, float& m0, float& m1,
                                              float& l0, float& l1, float& c0, float& c1) {
  float mx0 = FTC_NEG_INF, mx1 = FTC_NEG_INF;
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    float x = sc[e] * scale;
    const int hi = (e >> 1) & 1;
    if (edge) {
      const int col = k0 + 8 * (e >> 2) + 2 * tq4 + (e & 1);
      if (col >= Tk || (causal && col > r0 + 8 * hi)) x = FTC_NEG_INF;
    }
    sc[e] = x;
    if (hi) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
  }
  const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
  c0 = expf(m0 - mn0);
  c1 = expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    const int hi = (e >> 1) & 1;
    const float p = expf(sc[e] - (hi ? mn1 : mn0));
    sc[e] = p;
    if (hi) ps1 += p; else ps0 += p;
  }
  l0 = l0 * c0 + quad_sum(ps0);
  l1 = l1 * c1 + quad_sum(ps1);
}

// p = p_hi + p_lo in 16-bit pairs (of p * PSCALE). Register j of k-chunk c
// holds the accumulator's columns 16 c + 8 (j >> 1) + 2 t + {0, 1}, in row
// g for even j and g + 8 for odd: the A fragment of m64nNk16, so the
// scores need no shuffle.
template <bool BF, int BKV>
__device__ __forceinline__ void split_p(const float* sc, uint32_t (*phi)[4], uint32_t (*plo)[4]) {
  constexpr float PS = FTC_PSCALE<BF>;
#pragma unroll
  for (int c = 0; c < BKV / 16; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = sc[8 * c + 2 * j] * PS, a2 = sc[8 * c + 2 * j + 1] * PS;
      phi[c][j] = pack2<BF>(a, a2);
      const float2 r = unpack2<BF>(phi[c][j]);
      plo[c][j] = pack2<BF>(a - r.x, a2 - r.y);
    }
}

// Named barriers 1 and 2 order the two consumer warpgroups' turns at the
// tensor cores: a warpgroup waits for its own before it issues its GEMMs and
// arrives on the other's after, so one warpgroup's softmax runs while the
// other's GEMMs do.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
}

// A consumer warp is done with a stage's K or V: one arrival per warp.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(bar);
}

// ---------------------------------------------------------------------------
// The kernel. (m64nN, f32): register e of a thread
// (lane = 4 g + t of warp w in its warpgroup) holds row 16 w + g + 8 ((e >> 1) & 1)
// and column 8 (e >> 2) + 2 t + (e & 1).
// ---------------------------------------------------------------------------
template <bool BF, int HD>
__global__ void __launch_bounds__(FtcCfg<BF, HD>::THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, void* __restrict__ out, ll osb,
                ll oss, ll osh, int H, int G, int S, int Tk, float scale, int causal) {
  using C = FtcCfg<BF, HD>;
  using T = typename std::conditional<BF, __nv_bfloat16, __half>::type;
  constexpr int BKV = C::BKV, ROWB = C::ROWB, NS = BKV / 2, NO = HD / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::Q_BYTES;  // stage s: K at sKV + 2 s KV_BYTES, V after it
  const uint32_t sBar = sKV + 2 * C::ST * C::KV_BYTES;
  const uint32_t bar_q = sBar;
  auto full_k = [&](int s) { return sBar + 8u * (1 + s); };
  auto full_v = [&](int s) { return sBar + 8u * (1 + C::ST + s); };
  auto empty_k = [&](int s) { return sBar + 8u * (1 + 2 * C::ST + s); };
  auto empty_v = [&](int s) { return sBar + 8u * (1 + 3 * C::ST + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, kh = h / G;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * C::BM;  // the last q block first
  const int kend = causal ? min(Tk, q0 + C::BM) : Tk;
  const int nkb = (kend + BKV - 1) / BKV;

  if (tid == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < C::ST; ++s) {
      bar_init(full_k(s), 1);
      bar_init(full_v(s), 1);
      bar_init(empty_k(s), 4 * C::NC);  // one arrival per consumer warp
      bar_init(empty_v(s), 4 * C::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, warp-uniform as the compiler can see (the
  // register split of setmaxnreg follows this branch)
  const int wg = __shfl_sync(0xffffffffu, tid / FTC_WG, 0);
  if (wg == C::NC) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == C::NC * FTC_WG) {
      bar_expect_tx(bar_q, C::Q_BYTES);
      for (int bx = 0; bx < C::NB; ++bx)
        tma_load(sQ + bx * C::BM * ROWB, &tq, bar_q, bx * C::BOXD, q0, h, b);
      for (int n = 0; n < nkb; ++n) {
        const int s = n % C::ST;
        const uint32_t ks = sKV + 2 * s * C::KV_BYTES, vs = ks + C::KV_BYTES;
        if (n >= C::ST) bar_wait(empty_k(s), ((n / C::ST) - 1) & 1);
        bar_expect_tx(full_k(s), C::KV_BYTES);
        for (int bx = 0; bx < C::NB; ++bx)
          tma_load(ks + bx * BKV * ROWB, &tk, full_k(s), bx * C::BOXD, n * BKV, kh, b);
        if (n >= C::ST) bar_wait(empty_v(s), ((n / C::ST) - 1) & 1);
        bar_expect_tx(full_v(s), C::KV_BYTES);
        for (int bx = 0; bx < C::NB; ++bx)
          tma_load(vs + bx * BKV * ROWB, &tv, full_v(s), bx * C::BOXD, n * BKV, kh, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = tid % FTC_WG, lane = t % 32, tq4 = lane % 4;
    const int qw0 = q0 + 64 * wg;                   // first row of this warpgroup
    const int r0 = qw0 + 16 * (t / 32) + lane / 4;  // this thread's rows: r0, r0 + 8
    const int wend = causal ? min(Tk, qw0 + 64) : Tk;
    const int nkw = (wend + BKV - 1) / BKV;         // blocks this warpgroup needs

    float o[NO], sc[NS];
#pragma unroll
    for (int e = 0; e < NO; ++e) o[e] = 0.f;
#pragma unroll
    for (int e = 0; e < NS; ++e) sc[e] = 0.f;
    float m0 = FTC_NEG_INF, m1 = FTC_NEG_INF, l0 = 0.f, l1 = 0.f;
    uint32_t phi[BKV / 16][4], plo[BKV / 16][4];

    // descriptors of the stage-0 tiles; the loop adds offsets in 16-byte
    // units (every address is below 256 KiB, so no carry leaves the field)
    const uint64_t dq0 = gmma_desc(sQ + 64 * wg * ROWB, 16, 8 * ROWB, C::SWZ);
    const uint64_t dk0 = gmma_desc(sKV, 16, 8 * ROWB, C::SWZ);
    const uint64_t dv0 = gmma_desc(sKV + C::KV_BYTES, BKV * ROWB, 8 * ROWB, C::SWZ);

    auto k_desc = [&](int s) { return dk0 + (uint64_t)((2 * s * C::KV_BYTES) >> 4); };
    auto v_desc = [&](int s) { return dv0 + (uint64_t)((2 * s * C::KV_BYTES) >> 4); };
    auto edge = [&](int k0) { return k0 + BKV > Tk || (causal && k0 + BKV - 1 > qw0); };
    float c0, c1;
    // Turns: one for S of block 0, then one per kv block of the CTA (a
    // block past this warpgroup's diagonal is a turn with no GEMMs), so
    // both warpgroups take 1 + nkb turns; warpgroup 1 lets 0 go first.
    if (wg == 1) turn_pass(wg);
    bar_wait(bar_q, 0);
    bar_wait(full_k(0), 0);
    turn_wait(wg);
    issue_qk<BF, HD>(sc, dq0, dk0);
    turn_pass(wg);
    wg_wait<0>();
    reg_fence<NS>(sc);
    release(empty_k(0), lane);
    softmax_block<NS>(sc, 0, Tk, edge(0), causal, r0, tq4, scale, m0, m1, l0, l1, c0, c1);
    split_p<BF, BKV>(sc, phi, plo);  // acc is still 0: nothing to rescale

    // Block n + 1's S = Q K^T is issued with block n's P V, so the softmax
    // of n + 1 waits only for the first while the tensor cores run the
    // second; the accumulator is rescaled, and p split, once P V is done.
    // (The loop issues both groups on every pass, so that ptxas can see
    // which one each wait retires and keeps the wgmmas asynchronous.)
    for (int n = 0; n + 1 < nkw; ++n) {
      const int s = n % C::ST, s1 = (n + 1) % C::ST;
      bar_wait(full_k(s1), ((n + 1) / C::ST) & 1);
      bar_wait(full_v(s), (n / C::ST) & 1);
      turn_wait(wg);
      issue_qk<BF, HD>(sc, dq0, k_desc(s1));
      issue_pv<BF, HD>(o, phi, plo, v_desc(s));
      turn_pass(wg);
      wg_wait<1>();  // S of n + 1; P V of n may still run
      reg_fence<NS>(sc);
      release(empty_k(s1), lane);
      const int k1 = (n + 1) * BKV;
      softmax_block<NS>(sc, k1, Tk, edge(k1), causal, r0, tq4, scale, m0, m1, l0, l1, c0, c1);
      wg_wait<0>();
      reg_fence<NO>(o);
      reg_fence<BKV / 4>(&phi[0][0]);  // the A registers stay live until here
      reg_fence<BKV / 4>(&plo[0][0]);
      release(empty_v(s), lane);
#pragma unroll
      for (int e = 0; e < NO; ++e) o[e] *= ((e >> 1) & 1) ? c1 : c0;
      split_p<BF, BKV>(sc, phi, plo);
    }
    {  // P V of this warpgroup's last block
      const int n = nkw - 1, s = n % C::ST;
      bar_wait(full_v(s), (n / C::ST) & 1);
      turn_wait(wg);
      issue_pv<BF, HD>(o, phi, plo, v_desc(s));
      turn_pass(wg);
      wg_wait<0>();
      reg_fence<NO>(o);
      reg_fence<BKV / 4>(&phi[0][0]);
      reg_fence<BKV / 4>(&plo[0][0]);
      release(empty_v(s), lane);
    }
    // blocks past this warpgroup's diagonal (the other one's): keep the
    // ring and the turns in step
    for (int n = nkw; n < nkb; ++n) {
      const int s = n % C::ST;
      const uint32_t par = (n / C::ST) & 1;
      turn_wait(wg);
      turn_pass(wg);
      bar_wait(full_k(s), par);
      release(empty_k(s), lane);
      bar_wait(full_v(s), par);
      release(empty_v(s), lane);
    }

    // out = acc / max(l, 1e-30), rounded once; rows past S are not written
    T* op = reinterpret_cast<T*>(out) + (ll)b * osb + (ll)h * osh;
    const float inv = 1.0f / FTC_PSCALE<BF>;  // a power of 2: exact
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int e = 0; e < NO; e += 2) {
      const int hi = (e >> 1) & 1, row = r0 + 8 * hi;
      if (row < S) {
        const float den = hi ? d1 : d0;
        const int col = 8 * (e >> 2) + 2 * tq4;
        *reinterpret_cast<uint32_t*>(op + (ll)row * oss + col) =
            pack2<BF>(o[e] * inv / den, o[e + 1] * inv / den);
      }
    }
  }
}

// A [batch, seq, heads, hd] operand as the rank-4 map (hd, seq, heads, batch)
// with its real strides (elements; the wrapper has checked that each is a
// multiple of 16 bytes), boxes of BOXD x rows, zero fill past the edges.
template <bool BF, int HD>
int encode(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, ll sb, ll ss,
           ll sh, int rows) {
  using C = FtcCfg<BF, HD>;
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::BOXD, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = C::ROWB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : C::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r =
      fn(map, BF ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
         const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool BF, int HD>
int launch_tc(const void* q, ll qsb, ll qss, ll qsh, const void* k, ll ksb, ll kss, ll ksh,
              const void* v, ll vsb, ll vss, ll vsh, void* o, ll osb, ll oss, ll osh, int B,
              int H, int KV, int S, int Tk, float scale, int causal, cudaStream_t stream) {
  using C = FtcCfg<BF, HD>;
  if (const int err = dyn_smem<flash_tc_kernel<BF, HD>, C::SMEM>()) return err;
  CUtensorMap mq, mk, mv;
  int err = encode<BF, HD>(&mq, q, B, S, H, qsb, qss, qsh, C::BM);
  if (!err) err = encode<BF, HD>(&mk, k, B, Tk, KV, ksb, kss, ksh, C::BKV);
  if (!err) err = encode<BF, HD>(&mv, v, B, Tk, KV, vsb, vss, vsh, C::BKV);
  if (err) return err;
  const dim3 grid(B * H, (S + C::BM - 1) / C::BM);
  flash_tc_kernel<BF, HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, o, osb, oss, osh, H, H / KV, S, Tk, scale, causal);
  RETURN_LAUNCH_STATUS();
}

}  // namespace

// hd is one of the zoo's head dims (DISPATCH_HEAD_DIM); any other
// returns cudaErrorInvalidValue. Strides are in elements.
#define FLASH_TC_ENTRY(NAME, BF)                                                            \
  extern "C" int NAME(const void* q, ll qsb, ll qss, ll qsh, const void* k, ll ksb,        \
                      ll kss, ll ksh, const void* v, ll vsb, ll vss, ll vsh, void* o,      \
                      ll osb, ll oss, ll osh, int B, int H, int KV, int S, int Tk, int hd, \
                      float scale, int causal, void* stream) {                             \
    if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue; \
    cudaStream_t st = (cudaStream_t)stream;                                                 \
    DISPATCH_HEAD_DIM(hd, launch_tc<BF, HD>(q, qsb, qss, qsh, k, ksb, kss, ksh, v, vsb, vss,  \
                                            vsh, o, osb, oss, osh, B, H, KV, S, Tk, scale,  \
                                            causal, st))                                    \
  }
