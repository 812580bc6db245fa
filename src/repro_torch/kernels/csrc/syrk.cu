// syrk_leaf and syrk_packed: C <- beta C + scale A A^T on the lower
// triangle of C, in place; the strict upper triangle of C is never written.
//
// Replaces the Pallas kernels repro/kernels/syrk.py:syrk_leaf (the tree
// engine's diagonal leaf, core/tree.py:tree_syrk: C is one 256 x 256 f32 or
// f64 leaf, A is (256, k) with k from 256 to 8192 at n = 16384, in the
// level's type f32, bf16, f16, int8 or f64) and syrk.py:syrk_packed (the same
// update over a whole (n, k) operand on a triangular tile grid: the
// reference's fused SYRK for large n, and the flat side of the paper's
// Fig. 4 race).
//
// Bound: n^2 k operations (the lower half of A A^T) against n k + 2 n^2
// elements moved, so arithmetic bounds every shape with k > 64: at
// n = k = 8192 that is 0.55 TFLOP, 8.2 ms at the CUDA cores' 67 TFLOP/s for
// f32, 0.56 ms at the tensor cores' 989 TFLOP/s for bf16 and f16 (whose
// products are exact in f32), 0.28 ms at 1979 TOP/s for int8 (exact in s32).
// The TPU kernel holds one output tile in VMEM and walks k in sequence on
// the MXU, which takes 16-bit and int8 operands natively.
//
// syrk_packed takes one of two routes (kernels/syrk.py:packed_plan):
//   tc   (bf16, f16, int8 A; f32 C): the tensor-core main loop of
//        tc_gemm.cuh (TMA ring, wgmma m64n256, three warpgroups) on a
//        triangular grid of 128 x 256 output tiles, two 128-row halves of
//        each lower 256 x 256 tile decoded by tri_decode; both operands are
//        A, through one K-major tensor map (the B tile is two 128-row
//        boxes). While the last stages stream, the producer warp prefetches
//        the tile's lower part of C into L2, and the epilogue writes
//        (acc * scale) + (beta * C) on the lower triangle only. Rows of A
//        that TMA cannot address (a base or a row stride off the 16-byte
//        grid) are first copied into an aligned K-major buffer by the
//        wrapper (route tc_staged: n k bytes against n^2 k products).
//   simt (f32, f64, f32 A with f64 C): the register-blocked core of
//        simt_gemm.cuh on the same kind of triangular grid of B x B lower
//        blocks, one pass over all of k: 128 x 128 blocks of 8 x 8
//        micro-tiles for f32 where they fill a wave (2080 blocks at
//        n = 8192), else 64 x 64 of 4 x 4 (and always for an f64
//        accumulator), through the cp.async ring when A's rows are 16-byte
//        aligned. Every element is fma in k order from +0, whatever the
//        block, so the block choice moves no bit; the epilogue rounds as
//        the plain version does (no contraction).
// syrk_leaf keeps its k-split (a 256 x 256 leaf is 10 lower 64 x 64 blocks,
// which would leave 122 of 132 SMs idle):
//   pass 1 (syrk_tiles, grid lower blocks x k-chunks): each CTA sums one
//          64 x 64 block over one k-chunk (the GEMM core of common.cuh) and
//          writes its partial sums to scratch P;
//   pass 2 (syrk_reduce, grid lower blocks): each element adds its chunks'
//          partial sums in chunk order, then the epilogue beta C + scale S.
// No atomics: the order of every sum is fixed by (n, k) alone, so a factor
// is bitwise the same from run to run. With one chunk pass 1 applies the
// epilogue itself. The f32 leaf (every leaf of the tree factor) runs pass 1
// on the register-blocked core of simt_gemm.cuh instead (syrk_tiles_wide),
// on 128 x 128 lower blocks fed by its cp.async ring: 3 blocks at n = 256,
// so kernels/syrk.py:leaf_chunk aims at one wave of 132 CTAs, one an SM
// (43 chunks of k = 192 at k = 8192). Pass 2 splits each block's elements
// over 16 CTAs. The leaf's other types keep the 64 x 64 core of common.cuh.
//
// Ragged n and k are masked. `scale` and `beta` come from the host, or each
// from an f32 in device memory when its pointer is not null (the tree
// engine's scales are products of per-block quantization scales computed
// on the card; reading them there spares a device-to-host sync per call, as
// the TPU kernel reads them from an SMEM block). Each diagonal block keeps
// C's values above the diagonal; blocks above the block diagonal are not in
// the grid. The epilogue is in C's type (f32, or f64 when C or A is f64), as
// repro_torch/kernels/ref.py:syrk_ref computes.
#include "simt_gemm.cuh"
#include "tc_gemm.cuh"

// Accumulator: f32 for f32/f16/bf16 A, s32 for int8 A, f64 if C or A is f64.
template <typename Ta, typename Tc> struct SyrkAcc { typedef typename AccOf<Ta>::type type; };
template <> struct SyrkAcc<float, double> { typedef double type; };

template <typename T> __device__ __forceinline__ T load_scalar(const float* p, double h) {
  return p ? (T)*p : (T)h;
}

template <typename Tacc, typename Tc>
__device__ __forceinline__ void syrk_store(Tc* C, ll ldc, int n, int gm, int gn, Tacc s,
                                           Tc scale, Tc beta) {
  if (gm < n && gn <= gm) {
    Tc* p = C + (ll)gm * ldc + gn;
    *p = beta * *p + scale * (Tc)s;
  }
}

// grid (lower 64 x 64 blocks, k-chunks of kc)
template <typename Ta, typename Tacc, typename Tc, bool SPLIT>
__global__ void __launch_bounds__(G_THREADS)
syrk_tiles(const Ta* __restrict__ A, ll lda, Tc* C, ll ldc, Tacc* P, int n, int K, int kc,
           const float* sdev, double sh, const float* bdev, double bh) {
  int bi, bj;
  tri_decode(blockIdx.x, bi, bj);
  const int m0 = bi * GB_M, n0 = bj * GB_N;
  const int k0 = blockIdx.y * kc, klen = min(kc, K - k0);
  Tacc acc[4][4];
  // rows m0.. of A times (rows n0.. of A)^T over columns k0 .. k0 + klen
  gemm_block<Ta, Tacc>(acc, A + k0, lda, 1, A + k0, 1, lda, n, n, klen, m0, n0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  if (SPLIT) {
    Tacc* p = P + ((ll)blockIdx.y * gridDim.x + blockIdx.x) * (GB_M * GB_N);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[(ty + 16 * r) * GB_N + tx + 16 * c] = acc[r][c];
    return;
  }
  const Tc scale = load_scalar<Tc>(sdev, sh), beta = load_scalar<Tc>(bdev, bh);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      syrk_store(C, ldc, n, m0 + ty + 16 * r, n0 + tx + 16 * c, acc[r][c], scale, beta);
}

// grid (lower B x B blocks, parts): P[s][t] summed over s = 0 .. S-1 in
// order; part y of a block takes its elements y, y + parts, ... in rows of
// blockDim.x (the loads of a group of chunks are issued before its adds)
template <typename Tacc, typename Tc, int B>
__global__ void __launch_bounds__(G_THREADS)
syrk_reduce(const Tacc* __restrict__ P, int S, Tc* C, ll ldc, int n, const float* sdev,
            double sh, const float* bdev, double bh) {
  int bi, bj;
  tri_decode(blockIdx.x, bi, bj);
  const ll ntri = gridDim.x;
  const Tc scale = load_scalar<Tc>(sdev, sh), beta = load_scalar<Tc>(bdev, bh);
  for (int e = threadIdx.x + blockIdx.y * blockDim.x; e < B * B; e += blockDim.x * gridDim.y) {
    Tacc s = P[(ll)blockIdx.x * (B * B) + e];
#pragma unroll 8
    for (int q = 1; q < S; ++q) s += P[((ll)q * ntri + blockIdx.x) * (B * B) + e];
    syrk_store(C, ldc, n, bi * B + e / B, bj * B + e % B, s, scale, beta);
  }
}

// The f32 leaf's pass 1: grid (lower 128 x 128 blocks, k-chunks of kc) on
// the simt_gemm core, through its cp.async ring when A's base and row
// stride allow 16-byte copies (ASYNC), else one element at a time.
constexpr int SW_B = 128, SW_ST = 3, SW_BK = 2 * SG_BK;
template <bool SPLIT, bool ASYNC>
__global__ void __launch_bounds__(SG_THREADS, 1)
syrk_tiles_wide(const float* __restrict__ A, ll lda, float* C, ll ldc, float* P, int n, int K,
                int kc, const float* sdev, double sh, const float* bdev, double bh) {
  int bi, bj;
  tri_decode(blockIdx.x, bi, bj);
  const int m0 = bi * SW_B, n0 = bj * SW_B;
  const int kbeg = blockIdx.y * kc, kend = min(K, kbeg + kc);
  float acc[8][8];
  // rows m0.. of A times (rows n0.. of A)^T over k in [kbeg, kend)
  if constexpr (ASYNC) {
    extern __shared__ __align__(16) uint8_t sw_smem[];
    sg_block_async<float, float, SW_B, SW_B, 8, 8, SW_ST, SW_BK>(
        acc, reinterpret_cast<float*>(sw_smem), A, lda, A, lda, n, n, m0, n0, kbeg, kend);
  } else {
    sg_block<float, float, SW_B, SW_B, 8, 8>(acc, A, lda, 1, LAY_ANY, A, lda, 1, LAY_ANY, n, n,
                                             m0, n0, kbeg, kend);
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (SPLIT) {
    float* p = P + ((ll)blockIdx.y * gridDim.x + blockIdx.x) * (SW_B * SW_B);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) p[(ty + 16 * r) * SW_B + tx + 16 * c] = acc[r][c];
    return;
  }
  const float scale = load_scalar<float>(sdev, sh), beta = load_scalar<float>(bdev, bh);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      syrk_store(C, ldc, n, m0 + ty + 16 * r, n0 + tx + 16 * c, acc[r][c], scale, beta);
}

template <bool SPLIT, bool ASYNC>
static int launch_wide(dim3 grid, const void* A, ll lda, void* C, ll ldc, void* P, int n, int K,
                       int kc, const float* s, double sh, const float* b, double bh,
                       cudaStream_t stream) {
  constexpr int SMEM = ASYNC ? sg_async_smem<float, SW_B, SW_B, SW_ST, SW_BK>() : 0;
  if (const int err = dyn_smem<syrk_tiles_wide<SPLIT, ASYNC>, SMEM>()) return err;
  syrk_tiles_wide<SPLIT, ASYNC><<<grid, SG_THREADS, SMEM, stream>>>(
      (const float*)A, lda, (float*)C, ldc, (float*)P, n, K, kc, s, sh, b, bh);
  return 0;
}

static int launch_leaf_f32(const void* A, ll lda, void* C, ll ldc, void* P, int n, int K, int kc,
                           const void* sdev, double sh, const void* bdev, double bh,
                           void* stream_) {
  if (n <= 0 || K < 0 || kc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const int nt = (n + SW_B - 1) / SW_B, ntri = nt * (nt + 1) / 2;
  const int S = K > kc ? (K + kc - 1) / kc : 1;
  const bool async = (uintptr_t)A % 16 == 0 && lda % 4 == 0;
  const float* s = (const float*)sdev;
  const float* b = (const float*)bdev;
  if (S > 1 && !P) return (int)cudaErrorInvalidValue;
  const dim3 grid(ntri, S);
  const int kk = S > 1 ? kc : (K > 0 ? K : 1);
  float* part = S > 1 ? (float*)P : nullptr;
  int err = S > 1 ? (async ? launch_wide<true, true>(grid, A, lda, C, ldc, part, n, K, kk, s, sh, b, bh, stream)
                           : launch_wide<true, false>(grid, A, lda, C, ldc, part, n, K, kk, s, sh, b, bh, stream))
                  : (async ? launch_wide<false, true>(grid, A, lda, C, ldc, part, n, K, kk, s, sh, b, bh, stream)
                           : launch_wide<false, false>(grid, A, lda, C, ldc, part, n, K, kk, s, sh, b, bh, stream));
  if (err) return err;
  if (S > 1 && (err = dyn_smem<syrk_reduce<float, float, SW_B>, 0>())) return err;
  if (S > 1)
    syrk_reduce<float, float, SW_B><<<dim3(ntri, 16), G_THREADS, 0, stream>>>(
        (const float*)P, S, (float*)C, ldc, n, s, sh, b, bh);
  RETURN_LAUNCH_STATUS();
}

// kc: the k-chunk of each pass-1 block; kc >= K means one pass.
template <typename Ta, typename Tc>
static int launch(const void* A, ll lda, void* C, ll ldc, void* P, int n, int K, int kc,
                  const void* sdev, double sh, const void* bdev, double bh, void* stream_) {
  typedef typename SyrkAcc<Ta, Tc>::type Tacc;
  if (n <= 0 || K < 0 || kc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const int nt = (n + GB_M - 1) / GB_M, ntri = nt * (nt + 1) / 2;
  const int S = K > kc ? (K + kc - 1) / kc : 1;
  const float* s = (const float*)sdev;
  const float* b = (const float*)bdev;
  int err = dyn_smem<syrk_tiles<Ta, Tacc, Tc, false>, 0>();
  if (!err) err = dyn_smem<syrk_tiles<Ta, Tacc, Tc, true>, 0>();
  if (!err) err = dyn_smem<syrk_reduce<Tacc, Tc, GB_M>, 0>();
  if (err) return err;
  if (S == 1) {
    syrk_tiles<Ta, Tacc, Tc, false><<<dim3(ntri, 1), G_THREADS, 0, stream>>>(
        (const Ta*)A, lda, (Tc*)C, ldc, nullptr, n, K, K, s, sh, b, bh);
  } else {
    if (!P) return (int)cudaErrorInvalidValue;
    syrk_tiles<Ta, Tacc, Tc, true><<<dim3(ntri, S), G_THREADS, 0, stream>>>(
        (const Ta*)A, lda, (Tc*)C, ldc, (Tacc*)P, n, K, kc, s, sh, b, bh);
    syrk_reduce<Tacc, Tc, GB_M><<<ntri, G_THREADS, 0, stream>>>((const Tacc*)P, S, (Tc*)C, ldc, n,
                                                          s, sh, b, bh);
  }
  RETURN_LAUNCH_STATUS();
}

// ---------------------------------------------------------------------------
// syrk_packed, route tc: grid 2 T (T + 1) / 2 for T = ceil(n / 256); CTA x
// is half x & 1 of lower 256 x 256 tile x >> 1.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(3 * QTC_WG, 1)
syrk_tc_kernel(const __grid_constant__ CUtensorMap ta, float* C, ll ldc, int n, int K,
               float scale, float beta, const float* sdev, const float* bdev) {
  int bi, bj;
  tri_decode(blockIdx.x >> 1, bi, bj);
  const int m0 = 2 * QTC_BM * bi + QTC_BM * (blockIdx.x & 1), n0 = QTC_BN * bj;
  if (m0 >= n) return;  // the second half of a last tile row past n
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = qtc_setup(smem_raw);
  const int tid = threadIdx.x;
  const int nk = (K + Qtc<T>::KT - 1) / Qtc<T>::KT;

  const int wg = __shfl_sync(0xffffffffu, tid / QTC_WG, 0);
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * QTC_WG)
      qtc_produce<T>(base, nk, [&](uint32_t bar, uint32_t a, uint32_t b, int k0) {
        tma_load_2d(a, &ta, bar, k0, m0);
        tma_load_2d(b, &ta, bar, k0, n0);
        tma_load_2d(b + QTC_A_TILE, &ta, bar, k0, n0 + QTC_BM);
      });
    if (tid < 2 * QTC_WG + 32) {
      // the tile's lower part of C into L2 while the last stages run: row
      // r's 128-byte lines from column n0 up to min(r, n - 1)
      __syncwarp();
      const int lane = tid - 2 * QTC_WG;
      for (int q = lane; q < QTC_BM * (QTC_BN / 32); q += 32) {
        const int row = m0 + q / (QTC_BN / 32), col = n0 + 32 * (q % (QTC_BN / 32));
        if (row < n && col <= row)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(C + (ll)row * ldc + col));
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = tid % QTC_WG, lane = t % 32, warp = t / 32;
    typename Qtc<T>::Acc d[QTC_BN / 2];
    qtc_consume<T, 0, 0>(d, base, nk, wg, lane);
    if (sdev) scale = *sdev;
    if (bdev) beta = *bdev;
    const int row0 = m0 + 64 * wg + 16 * warp + lane / 4, col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < QTC_BN / 2; ++e) {
      const int row = row0 + 8 * ((e >> 1) & 1), col = col0 + 8 * (e >> 2) + (e & 1);
      if (row < n && col <= row) {
        float* p = C + (ll)row * ldc + col;
        *p = sg_epilogue<float>((float)d[e], scale, beta, p);
      }
    }
  }
}

template <typename T>
static int launch_packed_tc(const void* A, ll lda, void* C, ll ldc, int n, int K,
                            const void* sdev, double sh, const void* bdev, double bh,
                            cudaStream_t stream) {
  if ((uintptr_t)A % 16 || (lda * (ll)sizeof(T)) % 16) return (int)cudaErrorInvalidValue;
  int err = dyn_smem<syrk_tc_kernel<T>, QTC_SMEM>();
  if (err) return err;
  CUtensorMap map;
  err = qtc_map<T>(&map, A, lda, 0, n, K, QTC_BM);
  if (err) return err;
  const int nt = (n + QTC_BN - 1) / QTC_BN;
  syrk_tc_kernel<T><<<nt * (nt + 1), 3 * QTC_WG, QTC_SMEM, stream>>>(
      map, (float*)C, ldc, n, K, (float)sh, (float)bh, (const float*)sdev,
      (const float*)bdev);
  RETURN_LAUNCH_STATUS();
}

// ---------------------------------------------------------------------------
// syrk_packed, route simt: grid of lower B x B blocks (tri_decode), one pass
// over k; ASYNC: A's rows through the cp.async ring (16-byte aligned rows),
// else one element a load.
// ---------------------------------------------------------------------------
constexpr int SP_ST = 3, SP_BK = 2 * SG_BK;
template <typename Ta, typename Tc, int B, int TM, bool ASYNC>
__global__ void __launch_bounds__(SG_THREADS, B <= 64 ? 2 : 1)
syrk_packed_simt(const Ta* __restrict__ A, ll lda, Tc* C, ll ldc, int n, int K,
                 const float* sdev, double sh, const float* bdev, double bh) {
  int bi, bj;
  tri_decode(blockIdx.x, bi, bj);
  const int m0 = bi * B, n0 = bj * B;
  Tc acc[TM][TM];
  if constexpr (ASYNC) {
    extern __shared__ __align__(16) uint8_t sp_smem[];
    sg_block_async<Ta, Tc, B, B, TM, TM, SP_ST, SP_BK>(
        acc, reinterpret_cast<Ta*>(sp_smem), A, lda, A, lda, n, n, m0, n0, 0, K);
  } else {
    sg_block<Ta, Tc, B, B, TM, TM>(acc, A, lda, 1, LAY_ANY, A, lda, 1, LAY_ANY, n, n, m0, n0, 0,
                                   K);
  }
  const Tc scale = load_scalar<Tc>(sdev, sh), beta = load_scalar<Tc>(bdev, bh);
  const int tx = threadIdx.x % (B / TM), ty = threadIdx.x / (B / TM);
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gm = m0 + ty + (B / TM) * r;
#pragma unroll
    for (int c = 0; c < TM; ++c) {
      const int gn = n0 + tx + (B / TM) * c;
      if (gm < n && gn <= gm) {
        Tc* p = C + (ll)gm * ldc + gn;
        *p = sg_epilogue<Tc>(acc[r][c], scale, beta, p);
      }
    }
  }
}

template <typename Ta, typename Tc, int B, int TM, bool ASYNC>
static int launch_packed_simt(const void* A, ll lda, void* C, ll ldc, int n, int K,
                              const void* sdev, double sh, const void* bdev, double bh,
                              cudaStream_t stream) {
  auto kernel = syrk_packed_simt<Ta, Tc, B, TM, ASYNC>;
  constexpr int SMEM = ASYNC ? sg_async_smem<Ta, B, B, SP_ST, SP_BK>() : 0;
  if (const int err = dyn_smem<syrk_packed_simt<Ta, Tc, B, TM, ASYNC>, SMEM>()) return err;
  const int nt = (n + B - 1) / B;
  kernel<<<nt * (nt + 1) / 2, SG_THREADS, SMEM, stream>>>(
      (const Ta*)A, lda, (Tc*)C, ldc, n, K, (const float*)sdev, sh, (const float*)bdev, bh);
  RETURN_LAUNCH_STATUS();
}

// block: 128 (8 x 8 micro-tiles, f32 only) or 64 (4 x 4); async: A's base
// and rows 16-byte aligned (the wrapper's layout verdict, checked here)
template <typename Ta, typename Tc>
static int dispatch_packed_simt(const void* A, ll lda, void* C, ll ldc, int n, int K, int block,
                                int async, const void* sdev, double sh, const void* bdev,
                                double bh, cudaStream_t stream) {
  if (async && ((uintptr_t)A % 16 || (lda * (ll)sizeof(Ta)) % 16))
    return (int)cudaErrorInvalidValue;
#define SP_LAUNCH(B_, TM_)                                                                  \
  return async ? launch_packed_simt<Ta, Tc, B_, TM_, true>(A, lda, C, ldc, n, K, sdev, sh,   \
                                                           bdev, bh, stream)                \
               : launch_packed_simt<Ta, Tc, B_, TM_, false>(A, lda, C, ldc, n, K, sdev, sh,  \
                                                            bdev, bh, stream)
  if (block == 64) SP_LAUNCH(64, 4);
  if constexpr (std::is_same<Tc, float>::value) {
    if (block == 128) SP_LAUNCH(128, 8);
  }
#undef SP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// syrk_leaf_*: k split in chunks of kc (pass 1 + pass 2);
// syrk_packed_*: one pass over all of k on the route of the type (block and
// async are read by the simt route only).
#define SYRK_LEAF_ENTRY(SFX, LAUNCH)                                                      \
  extern "C" int syrk_leaf_##SFX(const void* A, ll lda, void* C, ll ldc, void* P, int n, \
                                 int K, int kc, const void* sdev, double sh,              \
                                 const void* bdev, double bh, void* stream) {             \
    return LAUNCH(A, lda, C, ldc, P, n, K, kc, sdev, sh, bdev, bh, stream);               \
  }
#define SYRK_PACKED_ENTRY(SFX, CALL)                                                       \
  extern "C" int syrk_packed_##SFX(const void* A, ll lda, void* C, ll ldc, int n, int K,  \
                                   int block, int async, const void* sdev, double sh,      \
                                   const void* bdev, double bh, void* stream) {            \
    if (n <= 0 || K < 0) return (int)cudaErrorInvalidValue;                                \
    cudaStream_t st = (cudaStream_t)stream;                                                \
    return CALL;                                                                           \
  }

SYRK_LEAF_ENTRY(f32, launch_leaf_f32)
SYRK_LEAF_ENTRY(bf16, (launch<__nv_bfloat16, float>))
SYRK_LEAF_ENTRY(f16, (launch<__half, float>))
SYRK_LEAF_ENTRY(s8, (launch<int8_t, float>))
SYRK_LEAF_ENTRY(f32_f64, (launch<float, double>))
SYRK_LEAF_ENTRY(f64, (launch<double, double>))
SYRK_PACKED_ENTRY(bf16, launch_packed_tc<__nv_bfloat16>(A, lda, C, ldc, n, K, sdev, sh, bdev, bh, st))
SYRK_PACKED_ENTRY(f16, launch_packed_tc<__half>(A, lda, C, ldc, n, K, sdev, sh, bdev, bh, st))
SYRK_PACKED_ENTRY(s8, launch_packed_tc<int8_t>(A, lda, C, ldc, n, K, sdev, sh, bdev, bh, st))
SYRK_PACKED_ENTRY(f32, (dispatch_packed_simt<float, float>(A, lda, C, ldc, n, K, block, async,
                                                            sdev, sh, bdev, bh, st)))
SYRK_PACKED_ENTRY(f32_f64, (dispatch_packed_simt<float, double>(A, lda, C, ldc, n, K, block,
                                                                 async, sdev, sh, bdev, bh, st)))
SYRK_PACKED_ENTRY(f64, (dispatch_packed_simt<double, double>(A, lda, C, ldc, n, K, block, async,
                                                              sdev, sh, bdev, bh, st)))

// The decode the kernels run, for a check against integer arithmetic on the
// host: I[t], J[t] for t < count.
__global__ void tri_decode_kernel(int* I, int* J, int count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < count) tri_decode(t, I[t], J[t]);
}

extern "C" int tri_decode_check(void* I, void* J, int count, void* stream) {
  if (count <= 0) return (int)cudaErrorInvalidValue;
  if (const int err = dyn_smem<tri_decode_kernel, 0>()) return err;
  tri_decode_kernel<<<(count + 255) / 256, 256, 0, (cudaStream_t)stream>>>((int*)I, (int*)J,
                                                                           count);
  RETURN_LAUNCH_STATUS();
}
