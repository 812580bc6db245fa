// Shared device code of the port's kernels: the per-tile rounding of the
// precision plan, a block-wide max, the triangular tile-index decode and
// the tiled GEMM core used by syrk.cu, and the 32 x 32 block storage and
// register-blocked block products of the leaf kernels potrf.cu and
// tri_inv.cu.
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

// ---------------------------------------------------------------------------
// Leaf tiles as 32 x 32 blocks (potrf.cu, tri_inv.cu). A block lives either
// in shared memory, 32 elements a row with the 16-byte slots of row r
// XOR-ed by r & 7 (so eight consecutive rows reading one logical slot, or
// one row's eight slots, hit eight different bank groups), or in global
// memory, row-major through a leading dimension. VEC says that global rows
// may be read and written 16 bytes at a time (base and ld aligned).
// ---------------------------------------------------------------------------
constexpr int LB = 32;

template <typename T> struct alignas(16) Vec { T e[16 / sizeof(T)]; };

template <typename T, bool SMEM, bool VEC> struct Blk {
  static constexpr int VW = 16 / sizeof(T);
  // k-steps of the block products to unroll: all of them from shared
  // memory in f32; fewer where hoisting every step's loads (global memory,
  // f64) would run out of registers
  static constexpr int KUNROLL = (SMEM && sizeof(T) == 4) ? LB / VW : 2;
  T* p;
  ll ld;
  __device__ __forceinline__ ll off(int r, int c) const {
    if constexpr (SMEM) return r * LB + (((c / VW) ^ (r & 7)) * VW) + c % VW;
    else return (ll)r * ld + c;
  }
  __device__ __forceinline__ T& at(int r, int c) const { return p[off(r, c)]; }
  // the VW elements of row r from column c on (c a multiple of VW)
  __device__ __forceinline__ Vec<T> ldv(int r, int c) const {
    if constexpr (SMEM || VEC) {
      return *reinterpret_cast<const Vec<T>*>(p + off(r, c));
    } else {
      Vec<T> v;
#pragma unroll
      for (int i = 0; i < VW; ++i) v.e[i] = p[off(r, c + i)];
      return v;
    }
  }
  __device__ __forceinline__ void stv(int r, int c, const Vec<T>& v) const {
    if constexpr (SMEM || VEC) {
      *reinterpret_cast<Vec<T>*>(p + off(r, c)) = v;
    } else {
#pragma unroll
      for (int i = 0; i < VW; ++i) p[off(r, c + i)] = v.e[i];
    }
  }
};

// The lower triangle of an (nb LB) x (nb LB) tile: in shared memory the
// blocks (I, J), J <= I, packed row by row; in global memory the tile.
template <typename T, bool SMEM, bool VEC> struct TriStore {
  T* base;
  ll ld;
  __device__ __forceinline__ Blk<T, SMEM, VEC> blk(int I, int J) const {
    if constexpr (SMEM) return {base + (ll)(I * (I + 1) / 2 + J) * (LB * LB), LB};
    else return {base + (ll)I * LB * ld + (ll)J * LB, ld};
  }
};

// Bytes of a packed shared-memory triangle of nb block rows.
__host__ __device__ inline size_t tri_bytes(int nb, size_t elem) {
  return (size_t)nb * (nb + 1) / 2 * LB * LB * elem;
}

// Row r, columns c .. c + VW - 1 of a global tile -> shared block slot, by
// cp.async (16 bytes, VEC) or through registers.
template <typename T, bool VEC, class B>
__device__ __forceinline__ void copy_in(const B& dst, int r, int c, const T* src) {
  if constexpr (VEC) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(&dst.at(r, c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
#pragma unroll
    for (int i = 0; i < B::VW; ++i) dst.at(r, c + i) = src[i];
  }
}
__device__ __forceinline__ void copy_in_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Global row vector store (16 bytes when VEC).
template <typename T, bool VEC>
__device__ __forceinline__ void store_row(T* dst, const Vec<T>& v) {
  if constexpr (VEC) {
    *reinterpret_cast<Vec<T>*>(dst) = v;
  } else {
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = v.e[i];
  }
}

// C -= A B^T on one 32 x 32 block by 64 threads (q = 0 .. 63), each a 4 x 4
// register micro-tile: rows tr + 8 r and columns tc + 8 c, a warp covering
// the 8 row classes x 4 column classes. A quarter warp's 16-byte operand
// reads are then two A rows (broadcasts) and four B rows of one logical
// slot, all in distinct bank groups, and the warp's 32 scalar reads and
// writes of C hit 32 banks. Each 16-byte k-step loads 4 + 4 vectors for
// 16 VW multiply-adds. The sum runs over k in order and is subtracted once.
template <typename T, class BC, class BO>
__device__ __forceinline__ void nt_sub(const BC& C, const BO& A, const BO& B, int q) {
  constexpr int VW = 16 / sizeof(T);
  const int tr = (q & 31) >> 2, tc = ((q >> 5) << 2) | (q & 3);
  T acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
#pragma unroll(BO::KUNROLL)
  for (int k = 0; k < LB; k += VW) {
    Vec<T> a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A.ldv(tr + 8 * r, k);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B.ldv(tc + 8 * c, k);
#pragma unroll
    for (int kk = 0; kk < VW; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fma(a[r].e[kk], b[c].e[kk], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) C.at(tr + 8 * r, tc + 8 * c) -= acc[r][c];
}

// acc += A B on one 32 x 32 block by 64 threads, each rows tr + 8 r and the
// four contiguous columns 4 tc .. 4 tc + 3 (tr = q / 8, tc = q % 8): a
// quarter warp reads one A row (a broadcast) and the eight slots of one B
// row. Called once per K block, K ascending, so each sum's order is fixed.
template <typename T, class BA, class BB>
__device__ __forceinline__ void nn_acc(T (&acc)[4][4], const BA& A, const BB& B, int q) {
  constexpr int VW = 16 / sizeof(T);
  const int tr = q >> 3, tc = q & 7;
#pragma unroll(BA::KUNROLL)
  for (int k = 0; k < LB; k += VW) {
    Vec<T> a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A.ldv(tr + 8 * r, k);
#pragma unroll
    for (int kk = 0; kk < VW; ++kk) {
      T bk[4];
#pragma unroll
      for (int v = 0; v < 4; v += VW) {
        const Vec<T> x = B.ldv(k + kk, 4 * tc + v);
#pragma unroll
        for (int i = 0; i < VW; ++i) bk[v + i] = x.e[i];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fma(a[r].e[kk], bk[c], acc[r][c]);
    }
  }
}

// C = sign * acc on the micro-tile of nn_acc.
template <typename T, class BC>
__device__ __forceinline__ void nn_store(const BC& C, const T (&acc)[4][4], T sign, int q) {
  constexpr int VW = 16 / sizeof(T);
  const int tr = q >> 3, tc = q & 7;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int v = 0; v < 4; v += VW) {
      Vec<T> x;
#pragma unroll
      for (int i = 0; i < VW; ++i) x.e[i] = sign * acc[r][v + i];
      C.stv(tr + 8 * r, 4 * tc + v, x);
    }
}

// Largest dynamic shared memory a block may have on the current device,
// less what the leaf kernels declare statically.
inline size_t leaf_smem_limit() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)optin - 256;
}

// ---------------------------------------------------------------------------
// Dynamic shared memory, listed kernel by kernel. Every launcher states its
// kernel's dynamic shared memory before it launches, through
// dyn_smem<K, BYTES>() (each launch of K takes exactly BYTES) or
// dyn_smem_upto<K, BOUND>(bytes) (a size found at run time, at most BOUND).
// Both take the kernel and the size as template arguments, so each launcher
// the library holds lists its kernel while the library loads, whether it
// ever launches or not; smem_table() reads the list back. The resource audit
// (repro_torch/audit/kernelaudit.py) holds every compiled kernel's static
// plus listed dynamic shared memory against the card's limit, and a compiled
// kernel that no launcher lists is an error there. Internal linkage: each
// library keeps its own list.
// ---------------------------------------------------------------------------
// cudaDevAttrMaxSharedMemoryPerBlockOptin of sm_90 (H100)
constexpr int SM90_SMEM_OPTIN = 232448;
// leaf_smem_limit() on sm_90: the leaf kernels' run-time sizes stay below it
constexpr int LEAF_SMEM_BOUND = SM90_SMEM_OPTIN - 256;

namespace {

struct DynSmemEntry {
  const void* fn;
  int bytes, bound;
};
constexpr int DYN_SMEM_MAX = 256;
DynSmemEntry dyn_smem_list[DYN_SMEM_MAX];  // constant-initialized: filled
int dyn_smem_count = 0;                    // before any launcher can run

bool dyn_smem_add(const void* fn, int bytes, int bound) {
  if (dyn_smem_count == DYN_SMEM_MAX) return false;
  dyn_smem_list[dyn_smem_count++] = {fn, bytes, bound};
  return true;
}

template <auto K, int BYTES, int BOUND> struct DynSmemListed {
  static const bool ok;
};
template <auto K, int BYTES, int BOUND>
const bool DynSmemListed<K, BYTES, BOUND>::ok = dyn_smem_add((const void*)K, BYTES, BOUND);

// Kernel K's dynamic shared memory is BYTES in every launch: set it once.
template <auto K, int BYTES> int dyn_smem() {
  static bool configured = false;  // the attribute is set once per kernel
  if (!DynSmemListed<K, BYTES, 0>::ok) return (int)cudaErrorInitializationError;
  if (BYTES > 0 && !configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  return 0;
}

// Kernel K's dynamic shared memory is `bytes` in this launch, at most BOUND.
template <auto K, int BOUND> int dyn_smem_upto(size_t bytes) {
  if (!DynSmemListed<K, BOUND, 1>::ok || bytes > (size_t)BOUND)
    return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Entry i of the library's list: the kernel's name (cudaFuncGetName), its
// dynamic shared memory, and whether that is a bound (1) or exact (0).
// Returns the number of entries, or -1 - the error where a name is unread.
extern "C" int smem_table(int i, const char** name, int* bytes, int* bound) {
  if (i < 0 || i >= dyn_smem_count) return dyn_smem_count;
  const cudaError_t err = cudaFuncGetName(name, dyn_smem_list[i].fn);
  if (err != cudaSuccess) return -1 - (int)err;
  *bytes = dyn_smem_list[i].bytes;
  *bound = dyn_smem_list[i].bound;
  return dyn_smem_count;
}

// Launch-error convention of every C entry point: return the launch's
// cudaError_t (0 on success) so the Python wrapper can raise.
#define RETURN_LAUNCH_STATUS() return (int)cudaGetLastError()

// Head-dim dispatch of the attention entry points: returns the call, an
// expression in the constant HD, at HD = hd for each head dim of the dense
// configs (16 and 32 for the smoke configs, 64, 128, 192, 256), and
// cudaErrorInvalidValue for any other hd.
#define HEAD_DIM_CASE(D, ...) \
  case D: {                   \
    constexpr int HD = D;     \
    return __VA_ARGS__;       \
  }
#define DISPATCH_HEAD_DIM(hd, ...)                                                         \
  switch (hd) {                                                                            \
    HEAD_DIM_CASE(16, __VA_ARGS__)                                                         \
    HEAD_DIM_CASE(32, __VA_ARGS__)                                                         \
    HEAD_DIM_CASE(64, __VA_ARGS__)                                                         \
    HEAD_DIM_CASE(128, __VA_ARGS__)                                                        \
    HEAD_DIM_CASE(192, __VA_ARGS__)                                                        \
    HEAD_DIM_CASE(256, __VA_ARGS__)                                                        \
    default:                                                                               \
      return (int)cudaErrorInvalidValue;                                                   \
  }
