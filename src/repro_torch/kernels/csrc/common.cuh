// Shared device code of the port's kernels: the per-tile rounding of the
// precision plan, a block-wide absmax, the triangular tile-index decode
// used by panel.cu and syrk.cu, and the tiled GEMM core used by qgemm.cu,
// panel.cu and syrk.cu.
//
// All arithmetic is IEEE: the build passes no --use_fast_math, so `/` and
// sqrt are correctly rounded and every rounding below matches the plain
// PyTorch version (repro_torch/kernels/ref.py) operation for operation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef long long ll;

// ---------------------------------------------------------------------------
// Rounding codes: name | quant << 3 (kernels/panel.py:NAME_CODE).
// ---------------------------------------------------------------------------
enum { NM_F64 = 0, NM_F32 = 1, NM_BF16 = 2, NM_F16 = 3, NM_INT8 = 4 };

__device__ __forceinline__ int rc_name(int rc) { return rc & 7; }
__device__ __forceinline__ bool rc_quant(int rc) { return (rc >> 3) & 1; }

// Rounding onto the container's own grid (or a wider one) is the identity.
template <typename T> __device__ __forceinline__ bool rc_identity(int rc);
template <> __device__ __forceinline__ bool rc_identity<float>(int rc) {
  return rc_name(rc) == NM_F64 || rc_name(rc) == NM_F32;
}
template <> __device__ __forceinline__ bool rc_identity<double>(int rc) {
  return rc_name(rc) == NM_F64;
}

// int8 and quantized f16 scale by the tile's absmax.
__device__ __forceinline__ bool rc_scaled(int rc) {
  return rc_name(rc) == NM_INT8 || (rc_name(rc) == NM_F16 && rc_quant(rc));
}

// The tile's scale, in f32 as the reference computes it.
__device__ __forceinline__ float rc_alpha(int rc, float amax) {
  if (rc_name(rc) == NM_INT8) return fmaxf(amax, 1e-30f) / 127.0f;
  return fmaxf(1.0f, amax / 65504.0f);
}

__device__ __forceinline__ float round_int8(float x, float alpha) {
  // rintf rounds half to even like jnp.round / torch.round (roundf would
  // round half away from zero)
  float q = rintf(x / alpha);
  return fminf(fmaxf(q, -127.0f), 127.0f) * alpha;
}

// Round x onto the grid of code rc, keeping the container type.
template <typename T> __device__ __forceinline__ T round_val(T x, int rc, float alpha);

template <>
__device__ __forceinline__ float round_val<float>(float x, int rc, float alpha) {
  switch (rc_name(rc)) {
    case NM_BF16:
      return __bfloat162float(__float2bfloat16_rn(x));
    case NM_F16:
      if (rc_quant(rc)) return __half2float(__float2half_rn(x / alpha)) * alpha;
      return __half2float(__float2half_rn(x));
    case NM_INT8:
      return round_int8(x, alpha);
    default:
      return x;
  }
}

template <>
__device__ __forceinline__ double round_val<double>(double x, int rc, float alpha) {
  switch (rc_name(rc)) {
    case NM_F32:  // an "f32" tile in an f64 container lies on the f32 grid
      return (double)__double2float_rn(x);
    case NM_BF16:  // through f32, as torch casts f64 -> bf16
      return (double)__bfloat162float(__float2bfloat16_rn(__double2float_rn(x)));
    case NM_F16:  // straight from double, no double rounding through f32
      if (rc_quant(rc))
        return (double)__half2float(__double2half(x / (double)alpha)) * (double)alpha;
      return (double)__half2float(__double2half(x));
    case NM_INT8:  // the reference divides and multiplies in f32 here
      return (double)round_int8(__double2float_rn(x), alpha);
    default:
      return x;
  }
}

// ---------------------------------------------------------------------------
// Block-wide max of |x| that propagates NaN like jnp.max.
// ---------------------------------------------------------------------------
template <typename T> __device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T> __device__ T block_max(T v) {
  __shared__ T red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red[] may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
  for (int o = 16; o; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max |x| over a (b, b) tile with leading dimension ld, as f32. Threads
// walk the columns of each row, so every row is read coalesced.
template <typename T> __device__ float tile_absmax(const T* x, ll ld, int b) {
  T m = T(0);
  for (int r = 0; r < b; ++r)
    for (int c = threadIdx.x; c < b; c += blockDim.x) m = nan_max(m, (T)fabs(x[r * ld + c]));
  return (float)block_max(m);
}

template <typename T> __device__ __forceinline__ T qnan();
template <> __device__ __forceinline__ float qnan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// ---------------------------------------------------------------------------
// Lower-triangular grid: t -> (i, j), i >= j, t = i (i + 1) / 2 + j. The
// square root in f64 gives a first guess and two integer loops correct it,
// so the decode is exact for every t below 2^30, where the products stay
// inside an int (the reference decodes in f32 with a +-1 correction).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void tri_decode(int t, int& i, int& j) {
  int r = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  i = r;
  j = t - r * (r + 1) / 2;
}

// ---------------------------------------------------------------------------
// Tiled GEMM core: 64 x 64 output block per CTA of 256 threads, k-steps of
// 16 staged in shared memory, a 4 x 4 register micro-tile per thread.
// Thread (tx, ty) = (tid % 16, tid / 16) owns rows m0 + ty + 16 r and
// columns n0 + tx + 16 c, so shared reads are broadcasts or consecutive and
// the epilogue's stores are coalesced along a row. Operands are read
// through arbitrary strides (a transposed view costs no copy); the load
// loop walks the unit-stride dimension when there is one.
// ---------------------------------------------------------------------------
constexpr int GB_M = 64, GB_N = 64, GB_K = 16, G_THREADS = 256;

template <typename Tin> struct AccOf { typedef float type; };
template <> struct AccOf<double> { typedef double type; };
template <> struct AccOf<int8_t> { typedef int type; };

template <typename Tacc, typename Tin> __device__ __forceinline__ Tacc to_acc(Tin v) {
  return (Tacc)v;
}
template <> __device__ __forceinline__ float to_acc<float, __half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float to_acc<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename Tin, typename Tacc>
__device__ void gemm_block(Tacc (&acc)[4][4], const Tin* __restrict__ A, ll sam, ll sak,
                           const Tin* __restrict__ B, ll sbk, ll sbn, int M, int N,
                           int K, int m0, int n0) {
  __shared__ Tacc As[GB_K][GB_M + 1];
  __shared__ Tacc Bs[GB_K][GB_N + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const bool a_kc = (sak == 1), b_nc = (sbn == 1);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = Tacc(0);

  for (int k0 = 0; k0 < K; k0 += GB_K) {
#pragma unroll
    for (int q = 0; q < (GB_M * GB_K) / G_THREADS; ++q) {
      const int e = tid + q * G_THREADS;
      int mm, kk;
      if (a_kc) { kk = e & (GB_K - 1); mm = e / GB_K; }
      else      { mm = e & (GB_M - 1); kk = e / GB_M; }
      int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? to_acc<Tacc>(A[gm * sam + gk * sak]) : Tacc(0);
      int nn;
      if (b_nc) { nn = e & (GB_N - 1); kk = e / GB_N; }
      else      { kk = e & (GB_K - 1); nn = e / GB_K; }
      int gn = n0 + nn;
      gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K) ? to_acc<Tacc>(B[gk * sbk + gn * sbn]) : Tacc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GB_K; ++kk) {
      Tacc a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * b[c];
    }
    __syncthreads();
  }
}

// Launch-error convention of every C entry point: return the launch's
// cudaError_t (0 on success) so the Python wrapper can raise.
#define RETURN_LAUNCH_STATUS() return (int)cudaGetLastError()
