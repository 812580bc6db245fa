// potrf_leaf: lower Cholesky factor of one SPD (b, b) tile, upper zeroed.
//
// Replaces the Pallas kernel repro/kernels/potrf.py:potrf_leaf (one leaf
// per diagonal tile of the blocked engine, b = leaf = 128..512). The work is
// b^3 / 3 flops on a tile that stays in L2, done by one CTA, so the bound is
// latency and synchronisation, not the card's rate or its memory: a single
// CTA uses one SM of 132. The Pallas design keeps the whole tile in VMEM,
// but at b = 256 an f32 tile is 256 KiB, more than the 227 KB of shared
// memory a block can have. So this kernel is right-looking over 32-wide
// micro-panels:
//   1. the tile's lower triangle is copied to `out` (global memory / L2);
//   2. each micro-panel (rows j0..b-1, 32 columns) is loaded into shared
//      memory (row stride 33, so column reads hit 32 distinct banks);
//      warp 0 factors its 32 x 32 diagonal block alone (warp barriers
//      only), then every thread solves one row below it against that block
//      with the row held in registers;
//   3. the panel is written back and the trailing lower triangle takes its
//      rank-32 update, a warp per row, each element reading its two panel
//      rows from shared memory.
// That is four block barriers per micro-panel. A first version that let
// the whole block take each column in turn, three block barriers per
// column, took 0.32-0.35 ms at b = 256 on an H100 (700 W); this one takes
// 0.29 ms, so the barriers were not what bounds it. The trailing updates
// are: b^3 / 6 multiply-adds that each read two operands from shared
// memory, in one CTA. Register blocking of that update is the next step.
// A pivot that is not positive (or NaN) marks the tile, and a marked tile
// comes out NaN on and below the diagonal, as jnp.linalg.cholesky and the
// plain version (cholesky_ex + where) give it.
// The input is read through its leading dimension; `out` may be `a`.
#include "common.cuh"

constexpr int PW = 32;          // micro-panel width = one warp
constexpr int POTRF_THREADS = 512;

template <typename T>
__global__ void __launch_bounds__(POTRF_THREADS)
potrf_kernel(const T* A, ll lda, T* O, ll ldo, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* P = reinterpret_cast<T*>(smem_raw);  // (b - j0) rows x (PW + 1)
  __shared__ int bad;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  if (tid == 0) bad = 0;
  for (int e = tid; e < b * b; e += nth) {
    const int i = e / b, k = e % b;
    O[i * ldo + k] = (k <= i) ? A[i * lda + k] : T(0);
  }
  __syncthreads();

  for (int j0 = 0; j0 < b; j0 += PW) {
    const int m = b - j0;
    for (int e = tid; e < m * PW; e += nth) {
      const int r = e / PW, c = e % PW;
      P[r * (PW + 1) + c] = (c <= r) ? O[(ll)(j0 + r) * ldo + j0 + c] : T(0);
    }
    __syncthreads();
    if (warp == 0) {  // the diagonal block, lane = row
      for (int c = 0; c < PW; ++c) {
        const T piv = P[c * (PW + 1) + c];
        if (!(piv > T(0)) && lane == 0) bad = 1;
        const T d = sqrt(piv);
        __syncwarp();  // every lane has read the pivot
        if (lane >= c) P[lane * (PW + 1) + c] = (lane == c) ? d : P[lane * (PW + 1) + c] / d;
        __syncwarp();
        for (int cc = c + 1; cc <= lane; ++cc)
          P[lane * (PW + 1) + cc] -= P[lane * (PW + 1) + c] * P[cc * (PW + 1) + c];
        __syncwarp();
      }
    }
    __syncthreads();
    // rows below the diagonal block: x L_dd^T = p, one row per thread
    for (int r = PW + tid; r < m; r += nth) {
      T x[PW];
#pragma unroll
      for (int c = 0; c < PW; ++c) x[c] = P[r * (PW + 1) + c];
#pragma unroll
      for (int c = 0; c < PW; ++c) {
        T s = x[c];
#pragma unroll
        for (int k = 0; k < c; ++k) s -= x[k] * P[c * (PW + 1) + k];
        x[c] = s / P[c * (PW + 1) + c];
      }
#pragma unroll
      for (int c = 0; c < PW; ++c) P[r * (PW + 1) + c] = x[c];
    }
    __syncthreads();
    for (int e = tid; e < m * PW; e += nth) {
      const int r = e / PW, c = e % PW;
      if (c <= r) O[(ll)(j0 + r) * ldo + j0 + c] = P[r * (PW + 1) + c];
    }
    // trailing rank-32 update of the lower triangle: a warp per row, lanes
    // along the row (coalesced in O, distinct banks in P)
    const int mt = m - PW;
    for (int ii = warp; ii < mt; ii += nwarps) {
      const T* pi = P + (PW + ii) * (PW + 1);
      for (int kk = lane; kk <= ii; kk += 32) {
        const T* pk = P + (PW + kk) * (PW + 1);
        T s = T(0);
#pragma unroll
        for (int c = 0; c < PW; ++c) s += pi[c] * pk[c];
        O[(ll)(j0 + PW + ii) * ldo + j0 + PW + kk] -= s;
      }
    }
    __syncthreads();
  }
  if (bad) {  // the upper triangle is already zero
    for (int e = tid; e < b * b; e += nth)
      if (e % b <= e / b) O[(e / b) * ldo + e % b] = qnan<T>();
  }
}

template <typename T>
static int launch(const void* A, ll lda, void* O, ll ldo, int b, void* stream) {
  if (b % PW != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)b * (PW + 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      potrf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  potrf_kernel<T><<<1, POTRF_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)A, lda, (T*)O, ldo, b);
  RETURN_LAUNCH_STATUS();
}

extern "C" int potrf_f32(const void* A, ll lda, void* O, ll ldo, int b, void* s) {
  return launch<float>(A, lda, O, ldo, b, s);
}
extern "C" int potrf_f64(const void* A, ll lda, void* O, ll ldo, int b, void* s) {
  return launch<double>(A, lda, O, ldo, b, s);
}
