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
// 1. Tensor cores (qgemm_tc_kernel on the main loop of tc_gemm.cuh, which
//    syrk.cu's packed tc route shares; f16, bf16, int8). Bound by operations:
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
#include "simt_gemm.cuh"
#include "tc_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// 1. tensor cores
// ---------------------------------------------------------------------------
template <typename T, int TA, int TB>
__global__ void __launch_bounds__(3 * QTC_WG, 1)
qgemm_tc_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const float* C, ll ldc, float* O, ll ldo, int M, int N, int K, float scale,
                float beta, const float* scale_dev, int has_c) {
  constexpr uint32_t BOX = Qtc<T>::KT * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = qtc_setup(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * QTC_BM, n0 = blockIdx.x * QTC_BN;
  const int nk = (K + Qtc<T>::KT - 1) / Qtc<T>::KT;

  const int wg = __shfl_sync(0xffffffffu, tid / QTC_WG, 0);
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * QTC_WG)
      qtc_produce<T>(base, nk, [&](uint32_t bar, uint32_t a, uint32_t b, int k0) {
        if (TA) {
          tma_load_2d(a, &ta, bar, m0, k0);
          tma_load_2d(a + BOX, &ta, bar, m0 + 64, k0);
        } else {
          tma_load_2d(a, &ta, bar, k0, m0);
        }
        if (TB) {
          for (int j = 0; j < QTC_BN / 64; ++j) tma_load_2d(b + j * BOX, &tb, bar, n0 + 64 * j, k0);
        } else {
          tma_load_2d(b, &tb, bar, k0, n0);
        }
      });
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = tid % QTC_WG, lane = t % 32, warp = t / 32;
    typename Qtc<T>::Acc d[QTC_BN / 2];
    qtc_consume<T, TA, TB>(d, base, nk, wg, lane);
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
