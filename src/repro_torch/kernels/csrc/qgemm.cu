// qgemm: out = scale * (A @ B) + beta * C, wide accumulation.
//
// Replaces the Pallas kernel repro/kernels/qgemm.py:qgemm (its pallas_call
// at :153), which contracts in the operands' narrow type on the MXU with an
// f32 accumulator and applies the scale and beta * C in its epilogue.
// Operand types and accumulators, as repro_torch/kernels/ref.py:qgemm_ref:
//   f16, bf16      -> f32 accumulation, f32 out       (tensor cores)
//   int8           -> exact s32 accumulation, f32 out (tensor cores)
//   f32            -> f32 accumulation, f32 out       (CUDA cores)
//   f64            -> f64 accumulation, f64 out       (CUDA cores)
//   f32 with f64 C -> f64 accumulation, f64 out (the tree engine's f32
//                     levels inside an f64 container, ladder f32x3_f64)
// The epilogue computes (acc * scale) + (beta * C), each product and the sum
// rounded once, as the plain version does. `out` may be `C` itself (each
// element is read before it is written, by one thread). `scale` comes from
// the host, or from an f32 in device memory when `scale_dev` is not null:
// the tree engine's scales are products of per-block quantization scales
// computed on the card, and reading them there spares a host sync a call.
//
// The wrapper (kernels/qgemm.py:plan) picks one of two kernel families from
// the dtypes, M, K and the operands' layouts:
//
// 1. Tensor cores (qgemm_tc_kernel; f16, bf16, int8). Bound by operations:
//    the tree engine's (4096 x 8192) (4096 x 8192)^T f16 product is 275 GFLOP,
//    0.278 ms at 989 TFLOP/s. A CTA of three warpgroups owns a 128 x 256
//    output tile (at 128 x 128 the tiles a k-step brings from L2 held 64
//    operations a byte, too few to keep the tensor cores fed; 128 x 256
//    holds 87): warpgroup 2 gives its registers away and one of its threads
//    keeps a ring of QTC_ST stages full by TMA (A and B tiles of 128 and 256
//    rows x 128 bytes of k, 128-byte swizzle, zero fill past M, N and K),
//    with full and empty mbarriers; warpgroups 0 and 1 each run wgmma
//    m64n256 (k16 for 16-bit, k32 for int8) on 64 of the rows,
//    accumulating in registers (f32, or s32 for int8, which is then exact
//    and bitwise equal to qgemm_ref), and release a stage as soon as the
//    wgmmas that read it have retired.
//    16-bit operands may be K-major or MN-major (the transpose bits; an
//    MN-major tile arrives in 64-column boxes); s8 wgmma takes K-major
//    operands only, so the wrapper copies an MN-major int8 operand, and any
//    operand TMA cannot address (a base or a row stride not a multiple of 16
//    bytes), into a K-major buffer first (route "tc_staged"). The hardware's
//    f32 accumulation inside a wgmma need not round to nearest: 16-bit
//    results are held to a data-scaled tolerance, not bitwise.
//
// 2. CUDA cores (qgemm_simt_kernel; f32, f64, f32 x f64) on the register-
//    blocked core of simt_gemm.cuh: 128 x 128 tiles of 8 x 8 micro-tiles in
//    f32 (64 x 64 of 4 x 4 with an f64 accumulator, and for f32 outputs
//    whose 128 x 128 tiles would not fill half the SMs), fed by a cp.async
//    ring when both operands are K-major (the tree engine's A B^T); or a
//    narrow 64 x 16 tile that streams A once for the sweeps' few
//    right-hand sides ((16128 x 256) (256 x 16) is bound by the 16.5 MB of L
//    it reads: 0.0049 ms at 3.35 TB/s). A narrow output with a long k (the
//    tree's (256 x 8192) (256 x 8192)^T: four 128 x 128 tiles for 132 SMs)
//    splits k into chunks fixed by (M, K) (grid.z): pass 1 writes each
//    chunk's sums to scratch P, pass 2 (qgemm_reduce_kernel) adds them in
//    chunk order and applies the epilogue. No atomics. Every element is
//    summed in the same order by every SIMT tile (simt_gemm.cuh), so a
//    column's bits depend on M, K and the types only, never on N or on the
//    tile: the serving contract (continuous == windowed batching, bitwise)
//    holds.
#include <type_traits>

#include "simt_gemm.cuh"
#include "tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// 1. tensor cores
// ---------------------------------------------------------------------------
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
// QTC_A_TILE bytes after it. A K-major tile is 128 (A) or 256 (B) rows of
// 128 bytes (the wgmma descriptor's 8-row groups 1024 bytes apart); an
// MN-major one is two (A) or four (B) boxes of 64 columns x KT rows (BOX
// bytes each, 1024 bytes per 8 k-rows).
template <typename T, int TA, int TB>
__global__ void __launch_bounds__(3 * QTC_WG, 1)
qgemm_tc_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const float* C, ll ldc, float* O, ll ldo, int M, int N, int K, float scale,
                float beta, const float* scale_dev, int has_c) {
  using Acc = typename Qtc<T>::Acc;
  constexpr int KT = Qtc<T>::KT;
  constexpr uint32_t BOX = KT * 128;
  // descriptor steps (16-byte units) of one wgmma's k: 32 bytes along a
  // K-major row, 16 k-rows of 128 bytes in an MN-major box
  constexpr uint32_t STEP_A = TA ? 2048 / 16 : 32 / 16, STEP_B = TB ? 2048 / 16 : 32 / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + QTC_ST * QTC_STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (QTC_ST + s); };
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * QTC_BM, n0 = blockIdx.x * QTC_BN;
  const int nk = (K + KT - 1) / KT;

  if (tid == 0) {
    for (int s = 0; s < QTC_ST; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / QTC_WG, 0);
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * QTC_WG) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % QTC_ST, k0 = t * KT;
        const uint32_t a = base + s * QTC_STAGE, b = a + QTC_A_TILE;
        if (t >= QTC_ST) bar_wait(empty(s), ((t / QTC_ST) - 1) & 1);
        bar_expect_tx(full(s), QTC_STAGE);
        if (TA) {
          tma_load_2d(a, &ta, full(s), m0, k0);
          tma_load_2d(a + BOX, &ta, full(s), m0 + 64, k0);
        } else {
          tma_load_2d(a, &ta, full(s), k0, m0);
        }
        if (TB) {
          for (int j = 0; j < QTC_BN / 64; ++j)
            tma_load_2d(b + j * BOX, &tb, full(s), n0 + 64 * j, k0);
        } else {
          tma_load_2d(b, &tb, full(s), k0, n0);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = tid % QTC_WG, lane = t % 32, warp = t / 32;
    Acc d[QTC_BN / 2];
#pragma unroll
    for (int e = 0; e < QTC_BN / 2; ++e) d[e] = Acc(0);
    const uint64_t da0 = TA ? gmma_desc(base + wg * BOX, BOX, 1024, 1)
                            : gmma_desc(base + wg * 64 * 128, 16, 1024, 1);
    const uint64_t db0 = TB ? gmma_desc(base + QTC_A_TILE, BOX, 1024, 1)
                            : gmma_desc(base + QTC_A_TILE, 16, 1024, 1);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % QTC_ST;
      const uint64_t off = (uint64_t)((s * QTC_STAGE) >> 4);
      bar_wait(full(s), (kt / QTC_ST) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        qtc_mma<T, TA, TB>(d, da0 + off + kk * STEP_A, db0 + off + kk * STEP_B);
      wg_commit();
      wg_wait<1>();  // the previous stage's wgmmas have retired
      if (kt > 0) qtc_release(empty((kt - 1) % QTC_ST), lane);
    }
    wg_wait<0>();
    reg_fence<QTC_BN / 2>(d);
    // register e of lane 4 g + q of warp w holds row 16 w + g + 8 ((e >> 1) & 1)
    // and column 8 (e >> 2) + 2 q + (e & 1) of this warpgroup's 64 x 256
    if (scale_dev) scale = *scale_dev;
    const int row0 = m0 + 64 * wg + 16 * warp + lane / 4, col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < QTC_BN / 2; ++e) {
      const int row = row0 + 8 * ((e >> 1) & 1), col = col0 + 8 * (e >> 2) + (e & 1);
      if (row < M && col < N)
        O[(ll)row * ldo + col] = sg_epilogue<float>(
            (float)d[e], scale, beta, has_c ? C + (ll)row * ldc + col : nullptr);
    }
  }
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

template <typename T, int TA, int TB>
int launch_tc(const void* A, ll lda, const void* B, ll ldb, const void* C, ll ldc, void* O,
              ll ldo, int M, int N, int K, double scale, double beta, const void* scale_dev,
              int has_c, cudaStream_t stream) {
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        qgemm_tc_kernel<T, TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, QTC_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap ma, mb;
  int err = qtc_map<T>(&ma, A, lda, TA, M, K, QTC_BM);
  if (!err) err = qtc_map<T>(&mb, B, ldb, TB, N, K, QTC_BN);
  if (err) return err;
  const dim3 grid((N + QTC_BN - 1) / QTC_BN, (M + QTC_BM - 1) / QTC_BM);
  qgemm_tc_kernel<T, TA, TB><<<grid, 3 * QTC_WG, QTC_SMEM, stream>>>(
      ma, mb, (const float*)C, ldc, (float*)O, ldo, M, N, K, (float)scale, (float)beta,
      (const float*)scale_dev, has_c);
  RETURN_LAUNCH_STATUS();
}

// ---------------------------------------------------------------------------
// 2. CUDA cores
// ---------------------------------------------------------------------------
// grid (N tiles, M tiles, k-chunks of kc); P != null: write chunk z's sums
// to P[z] (M x N), else apply the epilogue. ASYNC: both operands K-major,
// fed by the cp.async ring of QS_ST stages (dynamic shared memory); else the
// register-staged path, k-steps of BK.
constexpr int QS_ST = 3, QS_BK = 2 * SG_BK;

template <typename Tin, typename Tacc, int BM, int BN, int TM, int TN, int BK, bool ASYNC>
__global__ void __launch_bounds__(SG_THREADS, BM * BN <= 64 * 64 ? 2 : 1)
qgemm_simt_kernel(const Tin* __restrict__ A, ll sam, ll sak, int alay, const Tin* __restrict__ B,
                  ll sbn, ll sbk, int blay, const Tacc* C, ll ldc, Tacc* O, ll ldo, Tacc* P,
                  int M, int N, int K, int kc, Tacc scale, Tacc beta, const float* scale_dev,
                  int has_c) {
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kc, kend = min(K, kbeg + kc);
  Tacc acc[TM][TN];
  if constexpr (ASYNC) {
    extern __shared__ __align__(16) uint8_t qs_smem[];
    sg_block_async<Tin, Tacc, BM, BN, TM, TN, QS_ST, BK>(
        acc, reinterpret_cast<Tin*>(qs_smem), A, sam, B, sbn, M, N, m0, n0, kbeg, kend);
  } else {
    sg_block<Tin, Tacc, BM, BN, TM, TN, BK>(acc, A, sam, sak, alay, B, sbn, sbk, blay, M, N, m0,
                                            n0, kbeg, kend);
  }
  if (scale_dev) scale = (Tacc)*scale_dev;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  Tacc* part = P ? P + (ll)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gm = m0 + ty + (BM / TM) * r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gn = n0 + tx + (BN / TN) * c;
      if (gn >= N) continue;
      if (part)
        part[(ll)gm * N + gn] = acc[r][c];
      else
        O[(ll)gm * ldo + gn] =
            sg_epilogue(acc[r][c], scale, beta, has_c ? C + (ll)gm * ldc + gn : nullptr);
    }
  }
}

// out = epilogue(P[0] + P[1] + ... + P[S-1]), added in chunk order (the
// loads of a group of chunks are issued before its adds)
template <typename T>
__global__ void __launch_bounds__(256)
qgemm_reduce_kernel(const T* __restrict__ P, int S, const T* C, ll ldc, T* O, ll ldo, int M,
                    int N, T scale, T beta, const float* scale_dev, int has_c) {
  if (scale_dev) scale = (T)*scale_dev;
  const ll mn = (ll)M * N;
  for (ll i = blockIdx.x * (ll)blockDim.x + threadIdx.x; i < mn; i += (ll)gridDim.x * blockDim.x) {
    T s = P[i];
#pragma unroll 8
    for (int q = 1; q < S; ++q) s = sg_add(s, P[q * mn + i]);
    const ll gm = i / N, gn = i - gm * N;
    O[gm * ldo + gn] = sg_epilogue(s, scale, beta, has_c ? C + gm * ldc + gn : nullptr);
  }
}

template <typename Tin, typename Tacc, int BM, int BN, int TM, int TN, int BK, bool ASYNC>
int launch_simt(const void* A, ll sam, ll sak, int alay, const void* B, ll sbn, ll sbk, int blay,
                const void* C, ll ldc, void* O, ll ldo, void* P, int M, int N, int K, int kc,
                int S, double scale, double beta, const void* scale_dev, int has_c,
                cudaStream_t stream) {
  auto kernel = qgemm_simt_kernel<Tin, Tacc, BM, BN, TM, TN, BK, ASYNC>;
  constexpr int SMEM = ASYNC ? sg_async_smem<Tin, BM, BN, QS_ST, BK>() : 0;
  if constexpr (SMEM > 0) {
    static bool configured = false;  // the attribute is set once per instance
    if (!configured) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, S);
  kernel<<<grid, SG_THREADS, SMEM, stream>>>(
      (const Tin*)A, sam, sak, alay, (const Tin*)B, sbn, sbk, blay, (const Tacc*)C, ldc,
      (Tacc*)O, ldo, S > 1 ? (Tacc*)P : nullptr, M, N, K, kc, (Tacc)scale, (Tacc)beta,
      (const float*)scale_dev, has_c);
  if (S > 1) {
    const ll mn = (ll)M * N;
    const int blocks = (int)((mn + 255) / 256 < 132 * 16 ? (mn + 255) / 256 : 132 * 16);
    qgemm_reduce_kernel<Tacc><<<blocks, 256, 0, stream>>>(
        (const Tacc*)P, S, (const Tacc*)C, ldc, (Tacc*)O, ldo, M, N, (Tacc)scale, (Tacc)beta,
        (const float*)scale_dev, has_c);
  }
  RETURN_LAUNCH_STATUS();
}

// The SIMT tiles (tile = 0, 1, 2): wide (BM x BN, TM x TN micro-tiles),
// narrow (64 x 16, 4 x 1, k-steps of 256 bytes of k, two CTAs an SM: the
// sweeps stream A with 16 KB of it in flight per CTA) or mid (64 x 64, 4 x
// 4: outputs that wide tiles would not spread over the card); the wide and
// mid tiles take the cp.async ring when both operands are K-major.
template <typename Tin, typename Tacc, int BM, int BN, int TM, int TN>
int dispatch_simt(const void* A, ll sam, ll sak, int alay, const void* B, ll sbn, ll sbk,
                  int blay, const void* C, ll ldc, void* O, ll ldo, void* P, int M, int N, int K,
                  int kc, int tile, double scale, double beta, const void* scale_dev,
                  int has_c, void* stream) {
  if (M < 0 || N < 0 || K < 0 || kc <= 0 || tile < 0 || tile > 2)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const int S = K > kc ? (K + kc - 1) / kc : 1;
  if (S > 65535 || (S > 1 && !P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool async = alay == LAY_K && blay == LAY_K;
#define QS_LAUNCH(BM_, BN_, TM_, TN_, BK_, ASYNC_)                                         \
  return launch_simt<Tin, Tacc, BM_, BN_, TM_, TN_, BK_, ASYNC_>(                          \
      A, sam, sak, alay, B, sbn, sbk, blay, C, ldc, O, ldo, P, M, N, K, kc, S, scale, beta, \
      scale_dev, has_c, st)
  if (tile == 1) QS_LAUNCH(64, 16, 4, 1, 256 / (int)sizeof(Tin), false);
  if (tile == 2) {
    if (async) QS_LAUNCH(64, 64, 4, 4, QS_BK, true);
    QS_LAUNCH(64, 64, 4, 4, SG_BK, false);
  }
  if (async) QS_LAUNCH(BM, BN, TM, TN, QS_BK, true);
  QS_LAUNCH(BM, BN, TM, TN, SG_BK, false);
#undef QS_LAUNCH
}

template <typename T, bool MN_OK>
int dispatch_tc(const void* A, ll lda, int a_mn, const void* B, ll ldb, int b_mn, const void* C,
                ll ldc, void* O, ll ldo, int M, int N, int K, double scale, double beta,
                const void* scale_dev, int has_c, void* stream) {
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (!a_mn && !b_mn)
    return launch_tc<T, 0, 0>(A, lda, B, ldb, C, ldc, O, ldo, M, N, K, scale, beta, scale_dev,
                              has_c, st);
  if constexpr (MN_OK) {
    if (a_mn && b_mn)
      return launch_tc<T, 1, 1>(A, lda, B, ldb, C, ldc, O, ldo, M, N, K, scale, beta,
                                scale_dev, has_c, st);
    if (a_mn)
      return launch_tc<T, 1, 0>(A, lda, B, ldb, C, ldc, O, ldo, M, N, K, scale, beta,
                                scale_dev, has_c, st);
    return launch_tc<T, 0, 1>(A, lda, B, ldb, C, ldc, O, ldo, M, N, K, scale, beta, scale_dev,
                              has_c, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Tensor-core entries. A: (M, K) K-major (a_mn = 0: rows lda apart) or
// MN-major (a_mn = 1: k-rows lda apart); B: its (N, K) view likewise. Bases
// and lda, ldb in bytes must be multiples of 16 (the wrapper checks); s8
// takes K-major operands only.
#define QGEMM_TC_ENTRY(NAME, T, MN_OK)                                                    \
  extern "C" int NAME(const void* A, ll lda, int a_mn, const void* B, ll ldb, int b_mn,  \
                      const void* C, ll ldc, void* O, ll ldo, int M, int N, int K,       \
                      double scale, double beta, const void* scale_dev, int has_c,       \
                      void* stream) {                                                    \
    return dispatch_tc<T, MN_OK>(A, lda, a_mn, B, ldb, b_mn, C, ldc, O, ldo, M, N, K,    \
                                 scale, beta, scale_dev, has_c, stream);                 \
  }

QGEMM_TC_ENTRY(qgemm_f16, __half, true)
QGEMM_TC_ENTRY(qgemm_bf16, __nv_bfloat16, true)
QGEMM_TC_ENTRY(qgemm_s8, int8_t, false)

// SIMT entries. Element (m, k) of A is A[m sam + k sak], element (n, k) of B
// is B[n sbn + k sbk]; alay, blay: LAY_ANY / LAY_K / LAY_MN (simt_gemm.cuh).
// k is split into chunks of kc when K > kc (P: (ceil(K / kc), M, N) scratch
// of the accumulator type); tile: 0 wide, 1 narrow (64 x 16), 2 mid (64 x 64).
#define QGEMM_SIMT_ENTRY(NAME, TIN, TACC, BM, BN, TM, TN)                                  \
  extern "C" int NAME(const void* A, ll sam, ll sak, int alay, const void* B, ll sbn,      \
                      ll sbk, int blay, const void* C, ll ldc, void* O, ll ldo, void* P,   \
                      int M, int N, int K, int kc, int tile, double scale, double beta,    \
                      const void* scale_dev, int has_c, void* stream) {                    \
    return dispatch_simt<TIN, TACC, BM, BN, TM, TN>(A, sam, sak, alay, B, sbn, sbk, blay, \
                                                    C, ldc, O, ldo, P, M, N, K, kc,       \
                                                    tile, scale, beta, scale_dev,         \
                                                    has_c, stream);                        \
  }

QGEMM_SIMT_ENTRY(qgemm_f32, float, float, 128, 128, 8, 8)
QGEMM_SIMT_ENTRY(qgemm_f64, double, double, 64, 64, 4, 4)
QGEMM_SIMT_ENTRY(qgemm_f32_f64, float, double, 64, 64, 4, 4)
