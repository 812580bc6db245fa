// trsm_leaf: X = B @ Linv^T, the right-side triangular solve X L^T = B of
// one leaf, through the leaf's precomputed inverse Linv = L^-1.
//
// Replaces the Pallas kernel repro/kernels/trsm.py:trsm_leaf, the leaf of
// the tree engine's panel solve (core/tree.py:tree_trsm): B is (M, n) with
// n the leaf size (256) and M = 256, 512, ..., 8192 at n = 16384 (32 calls
// at each M a factor), L^-1 comes from tri_inv_leaf (csrc/tri_inv.cu) in the
// same dtype. M n^2 operations (the lower half of a GEMM) against 2 M n
// elements read and written: at M = 8192, n = 256 that is 0.54 GFLOP and
// 16 MiB in f32, about 8 us at the CUDA cores' f32 rate and 5 us at the
// memory rate, so arithmetic bounds it; at M <= 1024 the whole call is a
// few microseconds of work and the launch itself is the floor.
//
// The TPU kernel keeps all of L^-1 resident in VMEM and grids over rows of
// B in sequence. Here both operands are K-major (rows of B along the leaf
// column, rows of L^-1 along k), so the block product runs on the
// register-blocked core of simt_gemm.cuh (IEEE fma in k order, cp.async
// ring, 8 x 4 or 4 x 4 micro-tiles) with L^-1 as its lower-triangular B
// operand:
//   - X[i, j] = sum_{k <= j} B[i, k] L^-1[j, k]: the block of output
//     columns [n0, n0 + BN) stops its k-range at min(n, n0 + BN), and only
//     the k-steps that cross the diagonal mask k > j (element by element);
//     the others load whole 16-byte vectors by cp.async. The strict upper
//     triangle of L^-1 is never read.
//   - One CTA walks its k-range step after step, about a microsecond a
//     step alone on an SM, so at the tree's small M the time is the
//     heaviest CTA's chain of steps, not the card's rate. The grid fills
//     the card at every M the tree factor launches, by the plan of
//     kernels/trsm.py (chosen from (M, n, dtype) alone): 128 x 64 blocks
//     (two CTAs an SM) where they make two waves, else 64 x 64 where they
//     make one, else 64 x 64 with k split into chunks (grid.y walks
//     (column block, chunk) items), which shortens each CTA's chain; a
//     split writes each chunk's sums to scratch P and trsm_reduce adds them
//     in chunk order (no atomics: bitwise repeatable). A column block
//     further right has a longer k-range, so grid.y starts with the
//     heaviest items and they are dispatched first.
//   - Rows of B past M are masked, not padded. B and X go through their
//     leading dimensions (the tree passes views of its working buffer); a
//     base or row stride off the 16-byte grid takes the register-staged
//     path, one element a load.
// f32 data stays IEEE f32 on the CUDA cores, f64 has its own instance.
#include "simt_gemm.cuh"

constexpr int TR_ST = 3, TR_BK = 2 * SG_BK;

// item y of a plan -> (column block j, chunk s): the column blocks from the
// right (longest k-range) to the left, the chunks of each in order
template <int BN>
__device__ __forceinline__ void trsm_item(int y, int n, int kc, int& j, int& s) {
  j = (n + BN - 1) / BN - 1;
  s = y;
  for (;;) {
    const int chunks = (min(n, (j + 1) * BN) + kc - 1) / kc;
    if (s < chunks || j == 0) return;
    s -= chunks;
    --j;
  }
}

// grid (row blocks of BM, items); P: the chunks' sums, (chunks, M, n), or
// null for one pass (X written here)
template <typename T, int BM, int BN, int TM, int TN, bool ASYNC>
__global__ void __launch_bounds__(SG_THREADS, BM * BN <= 128 * 64 ? 2 : 1)
trsm_kernel(const T* __restrict__ B, ll ldb, int blay, const T* __restrict__ Li, ll ldl,
            int llay, T* __restrict__ X, ll ldx, T* __restrict__ P, int M, int n, int kc) {
  int j, s;
  trsm_item<BN>(blockIdx.y, n, kc, j, s);
  const int m0 = blockIdx.x * BM, n0 = j * BN;
  const int kbeg = s * kc, kend = min(min(n, n0 + BN), kbeg + kc);
  T acc[TM][TN];
  if constexpr (ASYNC) {
    extern __shared__ __align__(16) uint8_t tr_smem[];
    sg_block_async<T, T, BM, BN, TM, TN, TR_ST, TR_BK, true>(
        acc, reinterpret_cast<T*>(tr_smem), B, ldb, Li, ldl, M, n, m0, n0, kbeg, kend);
  } else {
    sg_block<T, T, BM, BN, TM, TN, SG_BK, true>(acc, B, ldb, 1, blay, Li, ldl, 1, llay, M, n, m0,
                                                n0, kbeg, kend);
  }
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  T* out = P ? P + (ll)s * M * n : X;
  const ll ld = P ? n : ldx;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gm = m0 + ty + (BM / TM) * r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gn = n0 + tx + (BN / TN) * c;
      if (gn < n) out[(ll)gm * ld + gn] = acc[r][c];
    }
  }
}

// X[i, j] = P[0][i, j] + P[1][i, j] + ... over the chunks of j's column
// block, added in chunk order
template <typename T, int BN>
__global__ void __launch_bounds__(256)
trsm_reduce(const T* __restrict__ P, T* __restrict__ X, ll ldx, int M, int n, int kc) {
  const ll mn = (ll)M * n;
  for (ll e = blockIdx.x * (ll)blockDim.x + threadIdx.x; e < mn; e += (ll)gridDim.x * blockDim.x) {
    const int gm = (int)(e / n), gn = (int)(e - (ll)gm * n);
    const int chunks = (min(n, (gn / BN + 1) * BN) + kc - 1) / kc;
    T acc = P[e];
    for (int q = 1; q < chunks; ++q) acc = sg_add(acc, P[q * mn + e]);
    X[(ll)gm * ldx + gn] = acc;
  }
}

template <typename T, int BM, int BN, int TM, int TN, bool ASYNC>
static int launch(const void* B, ll ldb, int blay, const void* Li, ll ldl, int llay, void* X,
                  ll ldx, void* P, int M, int n, int kc, cudaStream_t stream) {
  auto kernel = trsm_kernel<T, BM, BN, TM, TN, ASYNC>;
  constexpr int SMEM = ASYNC ? sg_async_smem<T, BM, BN, TR_ST, TR_BK>() : 0;
  int err = dyn_smem<trsm_kernel<T, BM, BN, TM, TN, ASYNC>, SMEM>();
  if (!err) err = dyn_smem<trsm_reduce<T, BN>, 0>();
  if (err) return err;
  int items = 0;
  for (int j = 0; j * BN < n; ++j) items += (min(n, (j + 1) * BN) + kc - 1) / kc;
  const bool split = kc < n;
  if (split && !P) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((M + BM - 1) / BM, items), SG_THREADS, SMEM, stream>>>(
      (const T*)B, ldb, blay, (const T*)Li, ldl, llay, (T*)X, ldx, split ? (T*)P : nullptr, M, n,
      kc);
  if (split) {
    const ll mn = (ll)M * n;
    const int blocks = (int)((mn + 255) / 256 < 132 * 8 ? (mn + 255) / 256 : 132 * 8);
    trsm_reduce<T, BN><<<blocks, 256, 0, stream>>>((const T*)P, (T*)X, ldx, M, n, kc);
  }
  RETURN_LAUNCH_STATUS();
}

// tile: 0 = 128 x 64 (8 x 4 micro-tiles; f32 only), 1 = 64 x 64 (4 x 4);
// kc: the k-chunk (kc >= n: one pass; else P holds (ceil(n / kc), M, n));
// blay, llay: LAY_K (16-byte aligned K-major rows) or LAY_ANY.
template <typename T>
static int dispatch(const void* B, ll ldb, int blay, const void* Li, ll ldl, int llay, void* X,
                    ll ldx, void* P, int M, int n, int tile, int kc, void* stream_) {
  if (M <= 0 || n <= 0 || kc <= 0 || kc % SG_BK) return (int)cudaErrorInvalidValue;
  if ((blay != LAY_K && blay != LAY_ANY) || (llay != LAY_K && llay != LAY_ANY))
    return (int)cudaErrorInvalidValue;
  const bool async = blay == LAY_K && llay == LAY_K;
  if (async && ((uintptr_t)B % 16 || (uintptr_t)Li % 16 || (ldb * (ll)sizeof(T)) % 16 ||
                (ldl * (ll)sizeof(T)) % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_;
#define TR_LAUNCH(BM_, BN_, TM_, TN_)                                                       \
  return async ? launch<T, BM_, BN_, TM_, TN_, true>(B, ldb, blay, Li, ldl, llay, X, ldx, P, \
                                                     M, n, kc, st)                          \
               : launch<T, BM_, BN_, TM_, TN_, false>(B, ldb, blay, Li, ldl, llay, X, ldx, P, \
                                                      M, n, kc, st)
  if (tile == 1) TR_LAUNCH(64, 64, 4, 4);
  if constexpr (sizeof(T) == 4) {
    if (tile == 0) TR_LAUNCH(128, 64, 8, 4);
  }
#undef TR_LAUNCH
  return (int)cudaErrorInvalidValue;
}

#define TRSM_ENTRY(NAME, T)                                                              \
  extern "C" int NAME(const void* B, ll ldb, int blay, const void* Li, ll ldl, int llay,  \
                      void* X, ll ldx, void* P, int M, int n, int tile, int kc,          \
                      void* stream) {                                                    \
    return dispatch<T>(B, ldb, blay, Li, ldl, llay, X, ldx, P, M, n, tile, kc, stream);  \
  }

TRSM_ENTRY(trsm_leaf_f32, float)
TRSM_ENTRY(trsm_leaf_f64, double)
