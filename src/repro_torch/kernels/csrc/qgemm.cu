// qgemm: out = scale * (A @ B) + beta * C, wide accumulation.
//
// Replaces the Pallas kernel repro/kernels/qgemm.py:qgemm. On the solve
// path (core/blocked.py:blocked_trsm_left) it runs (b, b) @ (b, k) and
// (m, b) @ (b, k) products with k the number of right-hand sides, so it is
// bound by the bytes of the factor it streams (each element of L is read
// once per sweep), not by arithmetic: at k = 16 it does 32 flops per f32
// element read. The design is the simplest one that reads each operand
// tile once per CTA: a 64 x 64 output block per CTA, 16-deep k-steps
// through shared memory, a 4 x 4 register micro-tile per thread (see
// common.cuh). f32 data stays IEEE f32 on the CUDA cores: no tensor cores,
// which would round f32 operands to TF32. The tree engine (core/tree.py)
// also runs its exposed GEMMs here, up to (8192 x 4096) @ (4096 x 4096) at
// n = 16384 in the ladder's narrow types; there the bound is arithmetic,
// and the same SIMT tile is a first version that leaves the tensor cores
// idle.
//
// Operand types and accumulators, as repro_torch/kernels/ref.py:qgemm_ref:
//   f32, f16, bf16 -> f32 accumulation, f32 out
//   f64            -> f64 accumulation, f64 out
//   int8           -> exact s32 accumulation, f32 epilogue
//   f32 with f64 C -> f64 accumulation, f64 out (the tree engine's f32
//                     levels inside an f64 container, ladder f32x3_f64)
// The epilogue computes (Tout)acc * scale, then adds beta * C. `out` may be
// `C` itself (each element is read before it is written, by one thread).
// `scale` comes from the host, or from an f32 in device memory when
// `scale_dev` is not null: the tree engine's scales are products of
// per-block quantization scales computed on the card, and reading them
// there spares a device-to-host sync per call.
#include "common.cuh"

template <typename Tin, typename Tacc, typename Tout>
__global__ void __launch_bounds__(G_THREADS)
qgemm_kernel(const Tin* __restrict__ A, ll sam, ll sak, const Tin* __restrict__ B,
             ll sbk, ll sbn, const Tout* C, ll ldc, Tout* O, ll ldo, int M, int N,
             int K, Tout scale, Tout beta, const float* scale_dev, int has_c) {
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;
  Tacc acc[4][4];
  gemm_block<Tin, Tacc>(acc, A, sam, sak, B, sbk, sbn, M, N, K, m0, n0);
  if (scale_dev) scale = (Tout)*scale_dev;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gm = m0 + ty + 16 * r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gn = n0 + tx + 16 * c;
      if (gn >= N) continue;
      Tout v = (Tout)acc[r][c] * scale;
      if (has_c) v = v + beta * C[gm * ldc + gn];
      O[gm * ldo + gn] = v;
    }
  }
}

template <typename Tin, typename Tacc, typename Tout>
static int launch(const void* A, ll sam, ll sak, const void* B, ll sbk, ll sbn,
                  const void* C, ll ldc, void* O, ll ldo, int M, int N, int K,
                  double scale, double beta, const void* scale_dev, int has_c,
                  void* stream) {
  dim3 grid((N + GB_N - 1) / GB_N, (M + GB_M - 1) / GB_M);
  qgemm_kernel<Tin, Tacc, Tout><<<grid, G_THREADS, 0, (cudaStream_t)stream>>>(
      (const Tin*)A, sam, sak, (const Tin*)B, sbk, sbn, (const Tout*)C, ldc, (Tout*)O,
      ldo, M, N, K, (Tout)scale, (Tout)beta, (const float*)scale_dev, has_c);
  RETURN_LAUNCH_STATUS();
}

#define QGEMM_ENTRY(NAME, TIN, TACC, TOUT)                                            \
  extern "C" int NAME(const void* A, ll sam, ll sak, const void* B, ll sbk, ll sbn,   \
                      const void* C, ll ldc, void* O, ll ldo, int M, int N, int K,    \
                      double scale, double beta, const void* scale_dev, int has_c,    \
                      void* stream) {                                                 \
    return launch<TIN, TACC, TOUT>(A, sam, sak, B, sbk, sbn, C, ldc, O, ldo, M, N, K, \
                                   scale, beta, scale_dev, has_c, stream);            \
  }

QGEMM_ENTRY(qgemm_f32, float, float, float)
QGEMM_ENTRY(qgemm_f64, double, double, double)
QGEMM_ENTRY(qgemm_f16, __half, float, float)
QGEMM_ENTRY(qgemm_bf16, __nv_bfloat16, float, float)
QGEMM_ENTRY(qgemm_s8, int8_t, int, float)
QGEMM_ENTRY(qgemm_f32_f64, float, double, double)
