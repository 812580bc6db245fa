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
// 3.35 TB/s; f64 2 GiB, 0.64 ms). A block of 8 warps streams a band of
// rows: chunks of A's rows and the matching rows of x move from global to
// shared memory by cp.async through a ring of RS = 4 stages (3 chunks in
// flight while one is multiplied, one block barrier a chunk). What is
// left to bound is shared memory: every warp reads the whole x chunk of
// its columns, so each 16-byte read of x must feed many FMAs, RPW x VEC
// of them for RPW rows a warp. At k = 16 in f64 a warp holds 8 rows and
// half the columns (64 accumulators a thread; all 16 columns of 8 rows
// would be 128), so the x reads and A's trips through shared memory come
// to ~2.75 KiB a row of A, against the 4 KiB of 4 rows and 16 columns;
// Shape below gives each case's numbers.
// The summation order below depends on n alone: not on the ring, on RPW
// or on the block's shape.
// The TPU kernel's padding of the columns to 128 lanes is gone: a
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

// 8 warps a block
constexpr int R_WARPS = 8, R_THREADS = 32 * R_WARPS, RS = 4;

// The block's shape by type and column chunk KC: its warps are
// R_WARPS / CH row groups of RPW rows, times CH groups of KC / CH columns
// (the CH warps of a row group read the same rows of A); x's rows in
// shared memory are XLD = JC + XPAD elements apart. A 16-byte read of x
// feeds RPW x VEC FMAs, so RPW sets the shared-memory bytes per FMA, and
// RPW x KC / CH accumulators a thread set the registers:
// - f64, KC = 16: RPW 8 and CH 2 (the x chunk's 8 KiB read by 8 warps
//   would otherwise be 4 rows to an x read); XPAD 1, an odd row length,
//   so the 16 columns of one row of x land in 16 bank pairs when they are
//   stored (x is then read 8 bytes at a time);
// - f32, KC = 16: RPW 4, CH 1, XPAD 4 (16-byte reads);
// - KC = 1 and 4: RPW 8, CH 1, XPAD VEC.
template <typename T, int KC> struct Shape {
  static constexpr bool SPLIT = sizeof(T) == 8 && KC == 16;
  static constexpr int VEC = 16 / sizeof(T), JC = 32 * VEC;
  static constexpr int RPW = (KC == 16 && !SPLIT) ? 4 : 8;
  static constexpr int CH = SPLIT ? 2 : 1, KCH = KC / CH;
  static constexpr int XLD = JC + (SPLIT ? 1 : VEC);
  static constexpr int ROWS = R_WARPS / CH * RPW;  // rows of A a block
};

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

// cp.async of BYTES (4, 8 or 16) from src to shared dst; the bytes past
// `valid` (0 or BYTES) are zero-filled, and nothing is read when it is 0
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src), "n"(BYTES),
                 "r"(n)
                 : "memory");
}

// One ring stage: the block's ROWS rows of A over JC columns, and the x
// chunk [j0, j0 + JC) x [c0, c0 + KC) transposed (row c of x is column
// c0 + c).
template <typename T, int KC>
struct Stage {
  using S = Shape<T, KC>;
  T a[S::ROWS][S::JC];
  T x[KC][S::XLD];
};

template <typename T, int KC>
__host__ __device__ constexpr int ring_bytes() {
  return RS * (((int)sizeof(Stage<T, KC>) + 15) / 16 * 16);
}

// Issue chunk j0 into stage st: the block's rows of A, VEC elements a
// lane (thread t copies rows t / 32 + R_WARPS i, columns j0 + VEC (t % 32)
// on), and the x chunk, element e = threadIdx.x + s R_THREADS being column
// e % KC, row e / KC (neighbouring threads read neighbouring columns, the
// unit-stride dimension of a slot block). Past n and past k: zeros.
template <typename T, int KC, bool ALIGNED>
__device__ __forceinline__ void issue(Stage<T, KC>& st, const T* __restrict__ A, ll lda,
                                      const T* __restrict__ X, ll sx0, ll sx1, int n, int c0,
                                      int kc, int rowb, int j0) {
  using S = Shape<T, KC>;
  constexpr int VEC = S::VEC, JC = S::JC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = j0 + VEC * lane;
#pragma unroll
  for (int i = 0; i < S::ROWS / R_WARPS; ++i) {
    const int rr = warp + R_WARPS * i, row = rowb + rr;
    T* d = &st.a[rr][VEC * lane];
    const T* p = A + (ll)min(row, n - 1) * lda + j;
    if (ALIGNED && j + VEC <= n) {
      cp_async_zfill<16>(d, p, row < n);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        cp_async_zfill<sizeof(T)>(d + q, (row < n && j + q < n) ? p + q : A, row < n && j + q < n);
    }
  }
#pragma unroll
  for (int s = 0; s < (KC * JC + R_THREADS - 1) / R_THREADS; ++s) {
    const int e = threadIdx.x + s * R_THREADS, c = e % KC, jj = e / KC;
    if (e < KC * JC) {
      const bool ok = c < kc && j0 + jj < n;
      cp_async_zfill<sizeof(T)>(&st.x[c][jj], ok ? X + (ll)(j0 + jj) * sx0 + (ll)(c0 + c) * sx1 : X,
                                ok);
    }
  }
}

// Block (blockIdx.x, blockIdx.y) computes rows [ROWS blockIdx.x, ...) and
// columns [KC blockIdx.y, ...) of the result; warp w owns rows
// (w % (R_WARPS / CH)) RPW .. + RPW - 1 of them and columns
// (w / (R_WARPS / CH)) KCH .. + KCH - 1 of the chunk. Chunks of JC columns
// of A and the matching rows of x go through a ring of RS stages in shared
// memory by cp.async, RS - 1 chunks in flight, one block barrier a chunk;
// the summation order is that of the file's header, whatever the ring and
// the shape do.
template <typename T, int KC, bool ALIGNED, int MINB>
__global__ void __launch_bounds__(R_THREADS, MINB)
residual_kernel(const T* __restrict__ A, ll lda, const T* __restrict__ X, ll sx0, ll sx1,
                const T* B, ll sb0, ll sb1, T* O, ll so0, ll so1,
                int n, int k) {
  using S = Shape<T, KC>;
  constexpr int VEC = S::VEC, JC = S::JC, RPW = S::RPW, KCH = S::KCH;
  extern __shared__ __align__(16) uint8_t ring_raw[];
  constexpr int STAGE = ring_bytes<T, KC>() / RS;
  auto stage = [&](int t) -> Stage<T, KC>& {
    return *reinterpret_cast<Stage<T, KC>*>(ring_raw + (t % RS) * STAGE);
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % (R_WARPS / S::CH), cg0 = (warp / (R_WARPS / S::CH)) * KCH;
  const int c0 = blockIdx.y * KC;
  const int kc = min(KC, k - c0);
  const int rowb = blockIdx.x * S::ROWS;
  const int nch = (n + JC - 1) / JC;

  T acc[RPW][KCH];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < KCH; ++c) acc[r][c] = T(0);

#pragma unroll
  for (int t = 0; t < RS - 1; ++t) {
    if (t < nch)
      issue<T, KC, ALIGNED>(stage(t), A, lda, X, sx0, sx1, n, c0, kc, rowb, t * JC);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int t = 0; t < nch; ++t) {
    asm volatile("cp.async.wait_group %0;" ::"n"(RS - 2) : "memory");
    __syncthreads();  // chunk t is everyone's; stage (t - 1) % RS is free
    const int tn = t + RS - 1;
    if (tn < nch)
      issue<T, KC, ALIGNED>(stage(tn), A, lda, X, sx0, sx1, n, c0, kc, rowb, tn * JC);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const Stage<T, KC>& st = stage(t);
    T a[RPW][VEC];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const typename Vec<T>::type w =
          *reinterpret_cast<const typename Vec<T>::type*>(&st.a[rg * RPW + r][VEC * lane]);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int q = 0; q < VEC; ++q) a[r][q] = e[q];
    }
#pragma unroll
    for (int c = 0; c < KCH; ++c) {
      T xv[VEC];
      const T* xp = &st.x[cg0 + c][VEC * lane];
      if constexpr (S::XLD % VEC == 0) {
        const typename Vec<T>::type w = *reinterpret_cast<const typename Vec<T>::type*>(xp);
        const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
        for (int q = 0; q < VEC; ++q) xv[q] = e[q];
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) xv[q] = xp[q];
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[r][c] = fma_(a[r][q], xv[q], acc[r][c]);
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");

  // the 32 lane sums of each element, in a fixed butterfly; every lane ends
  // with the same total, and lane c writes column cg0 + c of the chunk
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = rowb + rg * RPW + r;
#pragma unroll
    for (int c = 0; c < KCH; ++c) {
      T v = acc[r][c];
#pragma unroll
      for (int o = 16; o; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
      if (row < n && lane == c && cg0 + c < kc) {
        const ll col = c0 + cg0 + c;
        O[(ll)row * so0 + col * so1] = B[(ll)row * sb0 + col * sb1] - v;
      }
    }
  }
}

template <typename T, int KC, bool ALIGNED>
static int launch_kc(const T* A, ll lda, const T* X, ll sx0, ll sx1, const T* B, ll sb0, ll sb1,
                     T* O, ll so0, ll so1, int n, int k, cudaStream_t stream) {
  // f64 at 16 columns holds 64 f64 accumulators a thread: one block an SM
  constexpr int MINB = (sizeof(T) == 8 && KC == 16) ? 1 : 2;
  constexpr int SMEM = ring_bytes<T, KC>();
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        residual_kernel<T, KC, ALIGNED, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int rows = Shape<T, KC>::ROWS;
  dim3 grid((n + rows - 1) / rows, (k + KC - 1) / KC);
  residual_kernel<T, KC, ALIGNED, MINB><<<grid, R_THREADS, SMEM, stream>>>(
      A, lda, X, sx0, sx1, B, sb0, sb1, O, so0, so1, n, k);
  RETURN_LAUNCH_STATUS();
}

template <typename T, int KC>
static int launch_kc(const void* A, ll lda, const void* X, ll sx0, ll sx1, const void* B,
                     ll sb0, ll sb1, void* O, ll so0, ll so1, int n, int k, int aligned,
                     cudaStream_t stream) {
  if (aligned)
    return launch_kc<T, KC, true>((const T*)A, lda, (const T*)X, sx0, sx1, (const T*)B, sb0, sb1,
                                  (T*)O, so0, so1, n, k, stream);
  return launch_kc<T, KC, false>((const T*)A, lda, (const T*)X, sx0, sx1, (const T*)B, sb0, sb1,
                                 (T*)O, so0, so1, n, k, stream);
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
