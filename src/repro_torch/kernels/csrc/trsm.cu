// trsm_leaf: X = B @ Linv^T, the right-side triangular solve X L^T = B of
// one leaf, through the leaf's precomputed inverse Linv = L^-1.
//
// Replaces the Pallas kernel repro/kernels/trsm.py:trsm_leaf, the leaf of
// the tree engine's panel solve (core/tree.py:tree_trsm): B is (M, n) with
// n the leaf size (256) and M from 256 to 8192 at n = 16384, L^-1 comes from
// tri_inv_leaf (csrc/tri_inv.cu) in the same dtype. M n^2 flops (the lower
// half of a GEMM) against 2 M n elements read and written: at M = 8192,
// n = 256 that is 0.54 GFLOP and 16 MiB in f32, about 8 us at the CUDA
// cores' f32 rate and 5 us at the memory rate, so arithmetic bounds it.
//
// The TPU kernel keeps all of L^-1 resident in VMEM and grids over rows of
// B. A 256 x 256 f32 L^-1 is 256 KiB, more than a block's shared memory, so
// here it streams through shared memory in 16-deep k-chunks, as the GEMM
// core of common.cuh does, with two changes that are the point of the
// kernel:
//   - L^-1 is lower-triangular, so X[i, j] = sum_{k <= j} B[i, k] L^-1[j, k]:
//     the block of output columns n0 .. n0 + 63 stops its k loop at n0 + 64
//     and masks k > j to zero in its tile of L^-1, so the strict upper
//     triangle of L^-1 is never read and 3/8 of a GEMM's work is skipped
//     at n = 256;
//   - rows of B past M are masked, not padded (the TPU wrapper pads M up to
//     a multiple of its row block and slices the result).
// Each CTA owns a 64 x 64 block of X with a 4 x 4 register micro-tile per
// thread; B and X are read and written through their leading dimensions
// (a column block of the tree's working buffer needs no copy). f32 data
// stays IEEE f32 on the CUDA cores, f64 has its own instance.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(G_THREADS)
trsm_kernel(const T* __restrict__ B, ll ldb, const T* __restrict__ Li, ll ldl,
            T* __restrict__ X, ll ldx, int M, int n) {
  __shared__ T Bs[GB_K][GB_M + 1];  // Bs[k][i] = B[m0 + i][k0 + k]
  __shared__ T Ls[GB_K][GB_N + 1];  // Ls[k][j] = Li[n0 + j][k0 + k], 0 for k > j
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  T acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = T(0);

  const int kend = min(n, n0 + GB_N);
  for (int k0 = 0; k0 < kend; k0 += GB_K) {
    // both tiles are read along their unit-stride k dimension: 16
    // consecutive elements of a row per 16 consecutive threads
#pragma unroll
    for (int q = 0; q < (GB_M * GB_K) / G_THREADS; ++q) {
      const int e = tid + q * G_THREADS;
      const int kk = e & (GB_K - 1), rr = e / GB_K;
      const int gk = k0 + kk, gm = m0 + rr, gj = n0 + rr;
      Bs[kk][rr] = (gm < M && gk < n) ? B[(ll)gm * ldb + gk] : T(0);
      Ls[kk][rr] = (gj < n && gk <= gj) ? Li[(ll)gj * ldl + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GB_K; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Bs[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Ls[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * b[c];
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gm = m0 + ty + 16 * r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gn = n0 + tx + 16 * c;
      if (gn < n) X[(ll)gm * ldx + gn] = acc[r][c];
    }
  }
}

#define TRSM_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const void* B, ll ldb, const void* Li, ll ldl, void* X, ll ldx, \
                      int M, int n, void* stream) {                                   \
    if (M <= 0 || n <= 0) return (int)cudaErrorInvalidValue;                          \
    dim3 grid((n + GB_N - 1) / GB_N, (M + GB_M - 1) / GB_M);                          \
    trsm_kernel<T><<<grid, G_THREADS, 0, (cudaStream_t)stream>>>(                     \
        (const T*)B, ldb, (const T*)Li, ldl, (T*)X, ldx, M, n);                       \
    RETURN_LAUNCH_STATUS();                                                            \
  }

TRSM_ENTRY(trsm_leaf_f32, float)
TRSM_ENTRY(trsm_leaf_f64, double)
