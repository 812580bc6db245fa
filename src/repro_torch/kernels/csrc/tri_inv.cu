// tri_inv_leaf: X = L^-1 for one lower-triangular (b, b) tile.
//
// Replaces the Pallas kernel repro/kernels/potrf.py:tri_inv_leaf (the
// L11^-1 operand of every panel update, and the diagonal inverses both
// solve sweeps reuse). b^3 / 3 flops on one tile held in L2, done by one
// CTA: the bound is the latency of the dependent substitution, not the
// card's rates. A row-by-row substitution pays a barrier and an L2 round
// trip per row, b of them in sequence; measured on an H100 (700 W) that
// took 0.6-0.7 ms at b = 256, eight times the library's triangular solve.
// So this kernel works on 32 x 32 blocks (nb = b / 32 block rows), which
// took 0.18 ms on the same card:
//   1. warp w inverts diagonal block w in registers (a lane per column, the
//      substitution over the block's 32 rows fully unrolled) and writes it
//      to X[w][w]; the strict upper blocks of X are zeroed;
//   2. for each block row I = 1 .. nb-1 in turn, all blocks J < I at once:
//      S_J = sum_{J<=K<I} L[I][K] X[K][J] into shared memory, then
//      X[I][J] = -X[I][I] S_J.
// That is 2 nb - 1 barriers instead of 2 b, and the inner products stream
// independent loads.
#include "common.cuh"

constexpr int TB = 32;  // block size: one warp per diagonal block
constexpr int TI_THREADS = 512;  // 128 registers a thread: x[32] stays in them

template <typename T>
__global__ void __launch_bounds__(TI_THREADS)
tri_inv_kernel(const T* __restrict__ L, ll ldl, T* __restrict__ X, ll ldx, int b) {
  // nb blocks of TB x (TB + 1): the diagonal blocks of L in step 1, the
  // partial products S_J in step 2
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nb = b / TB;

  for (int e = tid; e < b * b; e += nth) {  // strict upper blocks of X
    const int i = e / b, j = e % b;
    if (j / TB > i / TB) X[(ll)i * ldx + j] = T(0);
  }
  // 1. diagonal blocks: lane c computes column c of the block's inverse
  if (warp < nb) {
    const int d0 = warp * TB;
    T* lb = buf + warp * TB * (TB + 1);
    for (int r = 0; r < TB; ++r) lb[r * (TB + 1) + lane] = L[(ll)(d0 + r) * ldl + d0 + lane];
    __syncwarp();
    T x[TB];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      T s = (i == lane) ? T(1) : T(0);
#pragma unroll
      for (int k = 0; k < i; ++k) s -= lb[i * (TB + 1) + k] * x[k];
      x[i] = s / lb[i * (TB + 1) + i];  // 0 for i < lane: X is lower
    }
#pragma unroll
    for (int i = 0; i < TB; ++i) X[(ll)(d0 + i) * ldx + d0 + lane] = x[i];
  }
  __syncthreads();

  // 2. block rows below the first, one after the other
  for (int I = 1; I < nb; ++I) {
    const int i0 = I * TB;
    for (int e = tid; e < I * TB * TB; e += nth) {  // S_J[r][c], J < I
      const int J = e / (TB * TB), r = (e / TB) % TB, c = e % TB;
      const T* lrow = L + (ll)(i0 + r) * ldl;
      const T* xcol = X + J * TB + c;
      T s = T(0);
#pragma unroll 8
      for (int k = J * TB; k < i0; ++k) s += lrow[k] * xcol[(ll)k * ldx];
      buf[(J * TB + r) * (TB + 1) + c] = s;
    }
    __syncthreads();
    for (int e = tid; e < I * TB * TB; e += nth) {  // X[I][J] = -X[I][I] S_J
      const int J = e / (TB * TB), r = (e / TB) % TB, c = e % TB;
      const T* drow = X + (ll)(i0 + r) * ldx + i0;
      T s = T(0);
      for (int k = 0; k <= r; ++k) s += drow[k] * buf[(J * TB + k) * (TB + 1) + c];
      X[(ll)(i0 + r) * ldx + J * TB + c] = -s;
    }
    __syncthreads();
  }
}

template <typename T>
static int launch(const void* L, ll ldl, void* X, ll ldx, int b, void* stream) {
  if (b % TB != 0 || b / TB > TI_THREADS / 32) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(b / TB) * TB * (TB + 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      tri_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tri_inv_kernel<T><<<1, TI_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)L, ldl, (T*)X, ldx, b);
  RETURN_LAUNCH_STATUS();
}

extern "C" int tri_inv_f32(const void* L, ll ldl, void* X, ll ldx, int b, void* s) {
  return launch<float>(L, ldl, X, ldx, b, s);
}
extern "C" int tri_inv_f64(const void* L, ll ldl, void* X, ll ldx, int b, void* s) {
  return launch<double>(L, ldl, X, ldx, b, s);
}
