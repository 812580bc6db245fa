// residual_fused: out = b - A @ x, the refinement sweep's residual.
//
// Replaces the Pallas kernel repro/kernels/residual.py:residual_fused. A is
// (n, n) with unit column stride; x, b and out are (n, k), read and written
// through their strides, so a column block of the refinement stepper's slot
// state needs no copy. f32 operands accumulate in f32, f64 in f64, and the
// epilogue computes b - acc in that type, as residual_ref does.
//
// What bounds it on the card: every sweep streams A once (n^2 elements) and
// does 2 k flops per element, k <= 32 right-hand sides on the serving path,
// so it is bound by the bytes of A (n = 16384: 1 GiB in f32, 0.32 ms at
// 3.35 TB/s). The design streams each row of A once per column chunk with
// 16-byte loads, one warp per two rows, while the chunk of x it multiplies
// sits in shared memory for the whole block; the next chunk is loaded into
// registers while the current one is multiplied. At k = 1 that reaches the
// bytes bound; at k = 16 the shared-memory reads of x (one 16-byte load per
// 8 FMAs in f32, per 4 in f64) and the FMAs keep it at about twice the
// bound. The TPU kernel's padding of the columns to 128 lanes is gone: a
// column chunk is 1, 4 or 16 wide. `out` may be `b` itself (each element is
// read before it is written, by one thread), never A or x.
//
// Column independence (a system contract, not a speed choice): a column's
// result must be bitwise the same whatever k, its position in x, or its
// neighbours, because the refinement stepper runs a column in blocks of
// varying width and co-tenants (core/refine.py). So each output element is
// summed in an order that depends on n alone: lane l of a warp owns the
// elements j = j0 + VEC l + q (q < VEC) of every chunk j0 and accumulates
// them with explicit fma in that order; the 32 lane sums are then added in
// a fixed xor butterfly. No split of the n dimension across blocks, no
// atomics, and the column chunk width KC only selects which columns a block
// holds, never how a column is summed.
#include "common.cuh"

// 8 warps a block, RPW rows of A a warp: at a 16-column chunk the
// accumulators take 32 (f32) or 64 (f64) registers, so two blocks fit an SM
// with the next chunk's prefetch and without spills
constexpr int R_WARPS = 8, R_THREADS = 32 * R_WARPS, RPW = 2;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  typedef float4 type;
};
template <> struct Vec<double> {
  static constexpr int N = 2;
  typedef double2 type;
};

template <typename T> __device__ __forceinline__ T fma_(T a, T b, T c);
template <> __device__ __forceinline__ float fma_<float>(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
template <> __device__ __forceinline__ double fma_<double>(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// VEC consecutive elements of row `row` of A from column j on (zeros past n).
template <typename T, bool ALIGNED>
__device__ __forceinline__ void load_row(T (&v)[Vec<T>::N], const T* __restrict__ A, ll lda,
                                         int n, int row, int j) {
  constexpr int VEC = Vec<T>::N;
  const T* p = A + (ll)row * lda + j;
  if (ALIGNED && j + VEC <= n) {
    typename Vec<T>::type w = *reinterpret_cast<const typename Vec<T>::type*>(p);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = e[q];
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = (j + q < n) ? p[q] : T(0);
  }
}

// Rows row0 .. row0 + RPW - 1 of A, VEC columns from j on (zeros past n).
template <typename T, bool ALIGNED>
__device__ __forceinline__ void load_a(T (&a)[RPW][Vec<T>::N], const T* __restrict__ A,
                                       ll lda, int n, int row0, int j) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (row0 + r < n) {
      load_row<T, ALIGNED>(a[r], A, lda, n, row0 + r, j);
    } else {
#pragma unroll
      for (int q = 0; q < Vec<T>::N; ++q) a[r][q] = T(0);
    }
  }
}

// This thread's share of the x chunk [j0, j0 + JC) x [c0, c0 + kc): element
// e = threadIdx.x + s * R_THREADS is column e % KC, row e / KC, so
// neighbouring threads read neighbouring columns (the unit-stride dimension
// of a slot block).
template <typename T, int KC, int JC, int SPT>
__device__ __forceinline__ void load_x(T (&xr)[SPT], const T* __restrict__ X, ll sx0, ll sx1,
                                       int n, int c0, int kc, int j0) {
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int e = threadIdx.x + s * R_THREADS, c = e % KC, j = j0 + e / KC;
    xr[s] = (e < KC * JC && c < kc && j < n) ? X[(ll)j * sx0 + (ll)(c0 + c) * sx1] : T(0);
  }
}

// Block (blockIdx.x, blockIdx.y) computes rows [RPW * R_WARPS * blockIdx.x, ...)
// and columns [KC * blockIdx.y, ...) of the result. The next chunk's slice of
// A and share of x are loaded into registers before the current chunk's
// FMAs, so their latency overlaps the arithmetic; the summation order is the
// same as without the prefetch.
template <typename T, int KC, bool ALIGNED>
__global__ void __launch_bounds__(R_THREADS, 2)
residual_kernel(const T* __restrict__ A, ll lda, const T* __restrict__ X, ll sx0, ll sx1,
                const T* B, ll sb0, ll sb1, T* O, ll so0, ll so1,
                int n, int k) {
  constexpr int VEC = Vec<T>::N, JC = 32 * VEC;
  constexpr int SPT = (KC * JC + R_THREADS - 1) / R_THREADS;
  // rows padded by one vector: a stage store of 16 neighbouring columns at
  // one jj then spreads over 8 banks instead of 1; rows stay 16-byte aligned
  __shared__ __align__(16) T xs[KC][JC + VEC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * KC;
  const int kc = min(KC, k - c0);
  const int row0 = (blockIdx.x * R_WARPS + warp) * RPW;

  T acc[RPW][KC];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[r][c] = T(0);

  T a[RPW][VEC], xr[SPT];
  load_a<T, ALIGNED>(a, A, lda, n, row0, VEC * lane);
  load_x<T, KC, JC, SPT>(xr, X, sx0, sx1, n, c0, kc, 0);
  for (int j0 = 0; j0 < n; j0 += JC) {
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int e = threadIdx.x + s * R_THREADS;
      if (e < KC * JC) xs[e % KC][e / KC] = xr[s];
    }
    __syncthreads();
    const int jn = j0 + JC;
    T an[RPW][VEC];
    if (jn < n) {
      load_a<T, ALIGNED>(an, A, lda, n, row0, jn + VEC * lane);
      load_x<T, KC, JC, SPT>(xr, X, sx0, sx1, n, c0, kc, jn);
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      T xv[VEC];
      const typename Vec<T>::type w =
          *reinterpret_cast<const typename Vec<T>::type*>(&xs[c][VEC * lane]);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int q = 0; q < VEC; ++q) xv[q] = e[q];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[r][c] = fma_(a[r][q], xv[q], acc[r][c]);
    }
    __syncthreads();  // xs is overwritten by the next chunk
    if (jn < n) {
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int q = 0; q < VEC; ++q) a[r][q] = an[r][q];
    }
  }

  // the 32 lane sums of each element, in a fixed butterfly; every lane ends
  // with the same total, and lane c writes column c of the chunk
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      T v = acc[r][c];
#pragma unroll
      for (int o = 16; o; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
      if (row < n && lane == c && c < kc) {
        const ll col = c0 + c;
        O[(ll)row * so0 + col * so1] = B[(ll)row * sb0 + col * sb1] - v;
      }
    }
  }
}

template <typename T, int KC>
static int launch_kc(const void* A, ll lda, const void* X, ll sx0, ll sx1, const void* B,
                     ll sb0, ll sb1, void* O, ll so0, ll so1, int n, int k, int aligned,
                     cudaStream_t stream) {
  const int rows = R_WARPS * RPW;
  dim3 grid((n + rows - 1) / rows, (k + KC - 1) / KC);
  if (aligned)
    residual_kernel<T, KC, true><<<grid, R_THREADS, 0, stream>>>(
        (const T*)A, lda, (const T*)X, sx0, sx1, (const T*)B, sb0, sb1, (T*)O, so0, so1, n, k);
  else
    residual_kernel<T, KC, false><<<grid, R_THREADS, 0, stream>>>(
        (const T*)A, lda, (const T*)X, sx0, sx1, (const T*)B, sb0, sb1, (T*)O, so0, so1, n, k);
  RETURN_LAUNCH_STATUS();
}

// The column chunk is the narrowest of 1, 4, 16 that holds k (16 beyond).
template <typename T>
static int launch(const void* A, ll lda, const void* X, ll sx0, ll sx1, const void* B, ll sb0,
                  ll sb1, void* O, ll so0, ll so1, int n, int k, int aligned, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    return launch_kc<T, 1>(A, lda, X, sx0, sx1, B, sb0, sb1, O, so0, so1, n, k, aligned, s);
  if (k <= 4)
    return launch_kc<T, 4>(A, lda, X, sx0, sx1, B, sb0, sb1, O, so0, so1, n, k, aligned, s);
  return launch_kc<T, 16>(A, lda, X, sx0, sx1, B, sb0, sb1, O, so0, so1, n, k, aligned, s);
}

#define RESIDUAL_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* A, ll lda, const void* X, ll sx0, ll sx1, const void* B, \
                      ll sb0, ll sb1, void* O, ll so0, ll so1, int n, int k, int aligned,  \
                      void* stream) {                                                    \
    return launch<T>(A, lda, X, sx0, sx1, B, sb0, sb1, O, so0, so1, n, k, aligned,        \
                     stream);                                                            \
  }

RESIDUAL_ENTRY(residual_f32, float)
RESIDUAL_ENTRY(residual_f64, double)
