// The tensor-core main loop shared by qgemm.cu's tc route and syrk.cu's
// packed tc route: a CTA of three warpgroups owns a 128 x 256 output tile.
// Warpgroup 2 gives its registers away and one of its threads keeps a ring
// of QTC_ST stages full by TMA (A's and B's tiles of 128 and 256 rows x 128
// bytes of k, 128-byte swizzle, zero fill past the edges), with full and
// empty mbarriers; warpgroups 0 and 1 each run wgmma m64n256 (k16 for
// 16-bit, k32 for int8) on 64 of the rows, accumulating in registers (f32,
// or s32 for int8, which is then exact), and release a stage as soon as
// the wgmmas that read it have retired. The caller maps its tile, issues
// a stage's loads (qtc_produce's `load`) and writes the epilogue.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int QTC_BM = 128, QTC_BN = 256, QTC_ST = 4, QTC_WG = 128;
// bytes of A's and B's tiles in a stage: 128 or 256 rows of 128 bytes of k
constexpr int QTC_A_TILE = QTC_BM * 128, QTC_B_TILE = QTC_BN * 128;
constexpr int QTC_STAGE = QTC_A_TILE + QTC_B_TILE;
// + 1 KiB to align the base to the swizzle pattern's 1024-byte repeat
constexpr int QTC_SMEM = QTC_ST * QTC_STAGE + 16 * QTC_ST + 1024;
static_assert(QTC_SMEM <= 232448, "shared memory of one CTA");

template <typename T> struct Qtc;
template <> struct Qtc<__half> {
  static constexpr int KT = 64;  // k of a stage: one 128-byte swizzle row
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  typedef float Acc;
};
template <> struct Qtc<__nv_bfloat16> {
  static constexpr int KT = 64;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  typedef float Acc;
};
template <> struct Qtc<int8_t> {
  static constexpr int KT = 128;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // bits as they are
  typedef int Acc;
};

// D (64 x 256) += A (64 x k) B (k x 256): TA / TB = 1 for an MN-major
// operand (the transpose bits; 16-bit only).
#define QTC_WGMMA_16(TY)                                                            \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                  \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"                                \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), \
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
        "+f"(d[126]), "+f"(d[127]) \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

#define QTC_WGMMA_S8()                                                              \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                  \
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"                        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
      "}, %128, %129, p;\n}\n"                                                 \
      : \
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), \
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), \
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), \
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), \
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), \
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), \
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), \
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), \
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), \
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), \
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), \
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), \
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), \
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), \
        "+r"(d[126]), "+r"(d[127]) \
      : "l"(da), "l"(db), "r"(1))

template <typename T, int TA, int TB>
__device__ __forceinline__ void qtc_mma(typename Qtc<T>::Acc* d, uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, int8_t>::value) {
    static_assert(TA == 0 && TB == 0, "s8 wgmma takes K-major operands only");
    QTC_WGMMA_S8();
  } else if constexpr (std::is_same<T, __half>::value) {
    QTC_WGMMA_16("f16");
  } else {
    QTC_WGMMA_16("bf16");
  }
}

// A consumer warp is done with a stage: one arrival per warp.
__device__ __forceinline__ void qtc_release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(bar);
}

// Shared memory: stage s holds A's tile at base + s QTC_STAGE and B's
// QTC_A_TILE bytes after it, then the 2 QTC_ST mbarriers. A K-major tile is
// 128 (A) or 256 (B) rows of 128 bytes (the wgmma descriptor's 8-row groups
// 1024 bytes apart); an MN-major one is two (A) or four (B) boxes of 64
// columns x KT rows (KT * 128 bytes each, 1024 bytes per 8 k-rows).
__device__ __forceinline__ uint32_t qtc_full(uint32_t base, int s) {
  return base + QTC_ST * QTC_STAGE + 8u * s;
}
__device__ __forceinline__ uint32_t qtc_empty(uint32_t base, int s) {
  return base + QTC_ST * QTC_STAGE + 8u * (QTC_ST + s);
}

// The ring's base (aligned to the swizzle pattern's 1024-byte repeat) with
// its barriers initialised; every thread of the CTA calls it.
__device__ __forceinline__ uint32_t qtc_setup(uint8_t* smem_raw) {
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < QTC_ST; ++s) {
      bar_init(qtc_full(base, s), 1);
      bar_init(qtc_empty(base, s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return base;
}

// The producer thread: stage t of nk, once its slot is free, gets
// load(full barrier, A tile address, B tile address, k0) with QTC_STAGE
// bytes expected.
template <typename T, typename Load>
__device__ __forceinline__ void qtc_produce(uint32_t base, int nk, Load load) {
  constexpr int KT = Qtc<T>::KT;
  for (int t = 0; t < nk; ++t) {
    const int s = t % QTC_ST;
    const uint32_t a = base + s * QTC_STAGE;
    if (t >= QTC_ST) bar_wait(qtc_empty(base, s), ((t / QTC_ST) - 1) & 1);
    bar_expect_tx(qtc_full(base, s), QTC_STAGE);
    load(qtc_full(base, s), a, a + QTC_A_TILE, t * KT);
  }
}

// A consumer warpgroup wg (0 or 1): d = its 64 rows of A times B over the
// nk stages. Register e of lane 4 g + q of warp w then holds row
// 16 w + g + 8 ((e >> 1) & 1) and column 8 (e >> 2) + 2 q + (e & 1) of the
// warpgroup's 64 x 256.
template <typename T, int TA, int TB>
__device__ __forceinline__ void qtc_consume(typename Qtc<T>::Acc* d, uint32_t base, int nk,
                                            int wg, int lane) {
  using Acc = typename Qtc<T>::Acc;
  constexpr uint32_t BOX = Qtc<T>::KT * 128;
  // descriptor steps (16-byte units) of one wgmma's k: 32 bytes along a
  // K-major row, 16 k-rows of 128 bytes in an MN-major box
  constexpr uint32_t STEP_A = TA ? 2048 / 16 : 32 / 16, STEP_B = TB ? 2048 / 16 : 32 / 16;
#pragma unroll
  for (int e = 0; e < QTC_BN / 2; ++e) d[e] = Acc(0);
  const uint64_t da0 = TA ? gmma_desc(base + wg * BOX, BOX, 1024, 1)
                          : gmma_desc(base + wg * 64 * 128, 16, 1024, 1);
  const uint64_t db0 = TB ? gmma_desc(base + QTC_A_TILE, BOX, 1024, 1)
                          : gmma_desc(base + QTC_A_TILE, 16, 1024, 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % QTC_ST;
    const uint64_t off = (uint64_t)((s * QTC_STAGE) >> 4);
    bar_wait(qtc_full(base, s), (kt / QTC_ST) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      qtc_mma<T, TA, TB>(d, da0 + off + kk * STEP_A, db0 + off + kk * STEP_B);
    wg_commit();
    wg_wait<1>();  // the previous stage's wgmmas have retired
    if (kt > 0) qtc_release(qtc_empty(base, (kt - 1) % QTC_ST), lane);
  }
  wg_wait<0>();
  reg_fence<QTC_BN / 2>(d);
}

// A K-major operand: (rows, K) with K contiguous, rows ld elements apart,
// in boxes of KT x box_rows; an MN-major one: (K, rows) with rows
// contiguous, k-rows ld apart, in boxes of 64 x KT.
template <typename T>
int qtc_map(CUtensorMap* map, const void* p, ll ld, int mn, int rows, int K, int box_rows) {
  constexpr int KT = Qtc<T>::KT;
  const uint64_t k = K > 0 ? K : 1, s = (uint64_t)ld * sizeof(T);
  return mn ? encode_2d(map, Qtc<T>::TYPE, p, rows, k, s, 64, KT, CU_TENSOR_MAP_SWIZZLE_128B)
            : encode_2d(map, Qtc<T>::TYPE, p, k, rows, s, KT, box_rows,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
