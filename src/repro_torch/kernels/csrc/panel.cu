// panel_update: the blocked Cholesky's fused panel step, in place.
//
//   L21 = A21 @ L11^-T        (panel TRSM through the precomputed inverse)
//   C  -= L21 @ L21^T         (trailing update, lower tiles only)
//
// with the precision plan's per-tile roundings. Replaces the Pallas kernel
// repro/kernels/panel.py:panel_update. This is the O(n^3) part of the
// factorization: 2 b^3 operations per lower trailing tile pair (i, j), each
// at the pair's name. The plan rounds both L21 tiles of a pair onto that
// name's grid before the product, and f16, bf16 and int8 values multiply
// exactly in f32 (int8 codes exactly in s32), so a pair named f16, bf16 or
// int8 is bound by the tensor cores' rate (989 / 1979 T/s), an f32 pair by
// the CUDA cores' (67 T/s; TF32 would round f32 operands), and every pair
// by one read and one write of its C tile (3.35 TB/s).
//
// Design, one panel on the caller's stream:
//   1. panel_round_rows: A_r = round(A21) per (b, b) row tile at its
//      storage name (a plain copy without rounding). Steps 1, 3 and 4 run
//      one CTA of 1024 threads a row tile, 16 loads a thread in flight.
//   2. panel_solve: L21 = A_r @ Linv^T over A21, on simt_gemm.cuh's
//      register-blocked core (cp.async ring, IEEE fma in k order).
//   3. panel_round_rows: L21 back onto its storage grid, in place.
//   4. panel_copies: one copy of L21 per pair name, rounded at that name
//      (the reference rounds L21 at the pair name also with rounding off):
//      - route tc (f32 container, names f16, bf16 and int8, b = 128 or
//        256): the codes in the name's own type, f16(x / alpha) or
//        bf16(x), or the int8 codes q = rint(x / alpha), with one f32
//        scale alpha per row tile (1 for an unscaled name);
//      - route simt (f32 names, every name on an f64 container, and any
//        b the tc route does not take): the rounded values in the
//        container type; none for a name whose rounding leaves the
//        container's values as they are (f32 in f32, f64): step 6 then
//        reads L21 in place where its rows are 16-byte aligned.
//   5. panel_tc, one launch per tc name over a device list of its pairs:
//      a cluster of b / 128 CTAs owns one b x b tile, each CTA 128 rows of
//      it. Thread 0 brings the CTA's operands (128 x b codes of row tile
//      i, b x b of row tile j, K-major, 128-byte swizzle) into shared
//      memory by TMA through a ring of two stages of 128 bytes of k (one
//      mbarrier each; at b = 256 in f16 a stage is refilled once both
//      warpgroups' products have read it), while all threads bring the
//      CTA's 128 rows of C into the rest of shared memory by one burst of
//      cp.async, so that C's read overlaps the products. Two warpgroups
//      run wgmma m64n128 (k16 for f16/bf16, k32 for s8) on 64 rows each,
//      f32 accumulation (s32 for int8, exact), and the epilogue works from
//      registers:
//      upd = C - acc * (alpha_i alpha_j), rounded at the pair's name, put
//      back in C's place in shared memory and written once by 16-byte
//      stores along whole rows (a diagonal tile's lower triangle only). A
//      scaled name (int8, quantized f16) needs the absmax of the whole
//      b x b update first (a diagonal tile's stale upper half included, as
//      in the reference): each CTA reduces its 128 rows, the CTAs of the
//      cluster exchange the partial maxima through distributed shared
//      memory across one cluster barrier, and a second barrier keeps each
//      CTA's shared memory alive until its peer has read it.
//   6. panel_simt, one launch over a device list of (pair, 128 x 128 or
//      64 x 64 sub-block) items on the same core as step 2, the sub-block
//      of C brought into shared memory by cp.async beside the operands'
//      ring, the same one-pass epilogue for unscaled names. A scaled name
//      on this route (only on an f64 container, or at a b the tc route
//      does not take) is one CTA a tile: it walks the tile's sub-blocks,
//      writes the unrounded update while it takes the absmax, then rounds
//      what it wrote.
// Batched (panel_update_batched: the K-FAC refactor's panel p of every
// block at once): one plan for all N matrices (it depends on m, b and the
// ladder only), and every step above is one launch over the batch, the
// batch index the last grid dimension (the tc route's tensor map spans the
// N codes buffers of a slot as N m rows, a box never crossing a matrix);
// each matrix's tiles take their own absmax and scales, so element z's
// bits are those of the one-matrix call on it (the one-matrix entry is
// the batched one with N = 1).
// Summation order: a tile's b-term dot products are summed in another
// order than the reference's (the tensor cores' f32 accumulation, or
// sequential fma in k order on the CUDA cores), so a result may differ in
// its last bits before the rounding, and by one grid unit after it; the
// products themselves are the reference's (exact on the grid values).
#include <cooperative_groups.h>

#include "simt_gemm.cuh"
#include "tc.cuh"

namespace cg = cooperative_groups;

// the row tiles' passes (steps 1, 3, 4): one CTA of R_THREADS a tile
constexpr int R_THREADS = 1024;
// the tc route's CTA: two consumer warpgroups of 64 rows each
constexpr int PT_ROWS = 128, PT_THREADS = 256;
// k bytes of one TMA box and mbarrier stage (one 128-byte swizzle row)
constexpr int PT_KBYTES = 128;
// registers of C a thread takes at a time in the epilogue
constexpr int PT_CHUNK = 16;
// slot kinds of the pair-name copies (kernels/panel.py:KIND)
// (KIND_SELF: no copy, the CUDA cores read L21 in place)
enum { KIND_SIMT = 0, KIND_F16 = 1, KIND_BF16 = 2, KIND_S8 = 3, KIND_SELF = 4 };
// sub-block index of a simt item that walks the whole (scaled) tile
constexpr int SUB_ALL = 0xff;

// ---------------------------------------------------------------------------
// steps 1 and 3: row tiles at their storage names
// ---------------------------------------------------------------------------
// The row tiles' passes below keep PB loads a thread in flight (a loop of
// one load an iteration would wait a memory latency an element). Thread
// (tx, ty) = (tid % 64, tid / 64) takes columns 64 cb + tx and rows
// ty + TY r of the tile (b % 64 == 0), so a warp reads 128 contiguous
// bytes of a row and no index needs a division by b.
constexpr int PB = 16, TX = 64, TY = R_THREADS / TX;

// f(v, r, c) for every element (r, c) of a (b, b) tile, PB rows of a
// column at a time: the loads of a batch are all issued before its f.
template <typename T, typename F>
__device__ __forceinline__ void tile_walk(const T* s, ll lds, int b, F f) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  for (int c = tx; c < b; c += TX)
    for (int r0 = ty; r0 < b; r0 += TY * PB) {
      T v[PB];
#pragma unroll
      for (int k = 0; k < PB; ++k) {
        const int r = r0 + TY * k;
        v[k] = r < b ? s[(ll)r * lds + c] : T(0);
      }
#pragma unroll
      for (int k = 0; k < PB; ++k) {
        const int r = r0 + TY * k;
        if (r < b) f(v[k], r, c);
      }
    }
}

// max |x| over a (b, b) tile with leading dimension ld, as f32, NaN
// propagating like jnp.max.
template <typename T>
__device__ float tile_amax(const T* s, ll lds, int b) {
  T m = T(0);
  tile_walk(s, lds, b, [&](T v, int, int) { m = nan_max(m, (T)fabs(v)); });
  return (float)block_max(m);
}

// dst = f(src) over a (b, b) tile (src may be dst: each element is read
// and written by one thread)
template <typename T, typename Td, typename F>
__device__ void tile_map(const T* src, ll lds, Td* dst, ll ldd, int b, F f) {
  tile_walk(src, lds, b, [&](T v, int r, int c) { dst[(ll)r * ldd + c] = f(v); });
}

// Round row tile i (rows i*b .. i*b+b-1, b columns) of src into dst, for
// batch element blockIdx.y (ss, sd: the batch strides). code < 0: the
// tile's code comes from codes[i].
template <typename T>
__global__ void __launch_bounds__(R_THREADS)
panel_round_rows(const T* src, ll lds, ll ss, T* dst, ll ldd, ll sd, int b, const int* codes,
                 int code) {
  const int i = blockIdx.x;
  const int rc = code >= 0 ? code : codes[i];
  const T* s = src + (ll)blockIdx.y * ss + (ll)i * b * lds;
  T* d = dst + (ll)blockIdx.y * sd + (ll)i * b * ldd;
  if (rc_identity<T>(rc)) {
    if (s != d) tile_map(s, lds, d, ldd, b, [](T v) { return v; });
    return;
  }
  const float alpha = rc_scaled(rc) ? rc_alpha(rc, tile_amax(s, lds, b)) : 1.0f;
  tile_map(s, lds, d, ldd, b, [=](T v) { return round_val<T>(v, rc, alpha); });
}

// ---------------------------------------------------------------------------
// step 2: L21 = A_r Linv^T
// ---------------------------------------------------------------------------
// cp.async stages and k-step of the CUDA-core products (a k-step of 32
// read the same times as 16 on the card)
constexpr int PS_ST = 3, PS_BK = SG_BK;

// panel_simt's C sub-block in shared memory, rows BT + 16 elements apart
// (the two rows a warp reads in the epilogue then lie in other banks)
template <typename T, int BT>
__host__ __device__ constexpr int simt_cpitch() {
  return BT + 16;
}

// the cp.async ring, and panel_simt's C sub-block after it
template <typename T, int BT, int TM>
constexpr int simt_smem() {
  return sg_async_smem<T, BT, BT, PS_ST, PS_BK>() + BT * simt_cpitch<T, BT>() * (int)sizeof(T);
}

// O (M x N) = A (M x K, ld lda) @ B^T, B (N x K, ld ldb); both K-major,
// 16-byte aligned rows. Grid (N / BT, M / BT, batch); sa, sb, so: the
// batch strides.
template <typename T, int BT, int TM>
__global__ void __launch_bounds__(SG_THREADS)
panel_solve(const T* A, ll lda, ll sa, const T* B, ll ldb, ll sb, T* O, ll ldo, ll so, int M,
            int N, int K) {
  extern __shared__ __align__(16) uint8_t sm_raw[];
  A += (ll)blockIdx.z * sa;
  B += (ll)blockIdx.z * sb;
  O += (ll)blockIdx.z * so;
  const int m0 = blockIdx.y * BT, n0 = blockIdx.x * BT;
  T acc[TM][TM];
  sg_block_async<T, T, BT, BT, TM, TM, PS_ST, PS_BK>(acc, (T*)sm_raw, A, lda, B, ldb, M, N, m0,
                                                     n0, 0, K);
  constexpr int CX = BT / TM;
  const int tx = threadIdx.x % CX, ty = threadIdx.x / CX;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TM; ++c) {
      const int gm = m0 + ty + CX * r, gn = n0 + tx + CX * c;
      if (gm < M && gn < N) O[(ll)gm * ldo + gn] = acc[r][c];
    }
}

// ---------------------------------------------------------------------------
// step 4: one copy of L21 per pair name
// ---------------------------------------------------------------------------
template <typename Tq> __device__ __forceinline__ Tq to_code(float v);
template <> __device__ __forceinline__ __half to_code<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 to_code<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ int8_t to_code<int8_t>(float v) {
  // rintf rounds half to even like torch.round; |q| <= 127 after the clamp
  return (int8_t)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

// Row tile i of L21 as codes of slot s: dst + s * slot_stride bytes, then
// m b codes a batch element, b x b codes a tile, ld b; alpha[(s * N + z) *
// nt + i] its scale. f16 and int8 codes are
// x / alpha (alpha = 1 unscaled), bf16 codes are bf16(x).
template <typename Tq>
__device__ void tile_codes(const float* src, ll lds, Tq* dst, float* alpha_out, int b, int rc) {
  const bool scaled = rc_scaled(rc);
  const float alpha = scaled ? rc_alpha(rc, tile_amax(src, lds, b)) : 1.0f;
  if (threadIdx.x == 0) *alpha_out = alpha;
  tile_map(src, lds, dst, (ll)b, b, [=](float v) { return to_code<Tq>(scaled ? v / alpha : v); });
}

// grid (nt, nslots, N); codes[s], kinds[s]: the slot's rounding code and
// kind; sl: L21's batch stride
template <typename T>
__global__ void __launch_bounds__(R_THREADS)
panel_copies(const T* l21, ll lda, ll sl, uint8_t* lq, ll slot_stride, float* alpha,
             const int* codes, const int* kinds, int nt, int b) {
  const int i = blockIdx.x, s = blockIdx.y, z = blockIdx.z;
  const int rc = codes[s], kind = kinds[s];
  if (kind == KIND_SELF) return;
  const T* src = l21 + (ll)z * sl + (ll)i * b * lda;
  uint8_t* slot = lq + s * slot_stride;
  const ll t0 = ((ll)z * nt + i) * b * b;  // the tile's first element in the slot
  if (kind == KIND_SIMT) {
    T* d = (T*)slot + t0;
    if (rc_identity<T>(rc)) {
      tile_map(src, lda, d, (ll)b, b, [](T v) { return v; });
      return;
    }
    const float a = rc_scaled(rc) ? rc_alpha(rc, tile_amax(src, lda, b)) : 1.0f;
    tile_map(src, lda, d, (ll)b, b, [=](T v) { return round_val<T>(v, rc, a); });
    return;
  }
  if constexpr (sizeof(T) == 4) {  // the tc route takes f32 containers only
    float* al = alpha + ((ll)s * gridDim.z + z) * nt + i;
    if (kind == KIND_F16)
      tile_codes<__half>(src, lda, (__half*)slot + t0, al, b, rc);
    else if (kind == KIND_BF16)
      tile_codes<__nv_bfloat16>(src, lda, (__nv_bfloat16*)slot + t0, al, b, rc);
    else
      tile_codes<int8_t>(src, lda, (int8_t*)slot + t0, al, b, rc);
  }
}

// ---------------------------------------------------------------------------
// step 5: tensor cores
// ---------------------------------------------------------------------------
// D (64 x 128) += A (64 x k) B (k x 128), both K-major, from shared memory.
#define PT_OPERANDS                                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define PT_ACC(C)                                                                          \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), C(d[8]),          \
      C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]),        \
      C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), C(d[24]),       \
      C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31]), C(d[32]),       \
      C(d[33]), C(d[34]), C(d[35]), C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]),       \
      C(d[41]), C(d[42]), C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]),       \
      C(d[49]), C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]),       \
      C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63])
#define PT_F "+f"
#define PT_R "+r"
#define PT_WGMMA_16(TY)                                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" PT_OPERANDS \
               "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                      \
               : PT_ACC(PT_F)                                                          \
               : "l"(da), "l"(db), "r"(1))
#define PT_WGMMA_S8()                                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" PT_OPERANDS       \
               "}, %64, %65, p;\n}\n"                                                  \
               : PT_ACC(PT_R)                                                          \
               : "l"(da), "l"(db), "r"(1))

template <typename T> struct Ptc;
template <> struct Ptc<__half> {
  typedef float Acc;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
    PT_WGMMA_16("f16");
  }
};
template <> struct Ptc<__nv_bfloat16> {
  typedef float Acc;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
    PT_WGMMA_16("bf16");
  }
};
template <> struct Ptc<int8_t> {
  typedef int Acc;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // bits as they are
  static __device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db) {
    PT_WGMMA_S8();
  }
};

// Shared memory of a tc CTA at leaf b: a ring of NS stages of 128 bytes of
// k, each the CTA's 128 rows of tile i (16 KiB) and the b rows of tile j
// (b / 128 boxes of 16 KiB), NK such stages a tile; then the CTA's 128
// rows of C, b floats a row with the 16-byte chunks of row r XOR-ed by
// r & 7 (a quarter warp's float2 reads of 8 rows then hit 32 banks);
// + 1 KiB to align the base to the swizzle's 1024-byte repeat. At b = 256
// in f16 two stages serve the four of k, so that C's 128 KiB fit beside
// them and arrive while the products run.
template <typename T, int B>
struct PtcShape {
  static constexpr int NB = B / PT_ROWS;                   // n128 blocks, cluster size
  static constexpr int NK = B * (int)sizeof(T) / PT_KBYTES;  // stages of k a tile
  static constexpr int NS = NK < 2 ? NK : 2;                 // stages in the ring
  static constexpr int KT = PT_KBYTES / (int)sizeof(T);      // k of a stage
  static constexpr int BOX = PT_ROWS * PT_KBYTES;          // bytes of one box
  static constexpr int STAGE = (1 + NB) * BOX;
  static constexpr int CBYTES = PT_ROWS * B * 4;
  static constexpr int SMEM = NS * STAGE + CBYTES + 1024;
  static_assert(SMEM <= 232448 - 256, "shared memory of one CTA");
};

template <typename Acc> __device__ __forceinline__ float acc_f32(Acc v) { return (float)v; }
// an f32 kept in an accumulator register (an s32 one by its bits)
template <typename Acc> __device__ __forceinline__ Acc put_f32(float v);
template <> __device__ __forceinline__ float put_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ int put_f32<int>(float v) { return __float_as_int(v); }
__device__ __forceinline__ float get_f32(float v) { return v; }
__device__ __forceinline__ float get_f32(int v) { return __int_as_float(v); }

// One b x b tile (i, j) per cluster of NB CTAs; CTA rank r owns rows
// 128 r .. 128 r + 127 of it; batch element blockIdx.y. items[p] = i << 16
// | j. map: the slot's codes, N m rows; alpha: the slot's per-row-tile
// scales, nt a batch element; sc: C's batch stride. rc: the pair name's
// rounding code.
template <typename T, int B>
__global__ void __launch_bounds__(PT_THREADS, 1)
panel_tc(const __grid_constant__ CUtensorMap map, const float* alpha, float* C, ll ldc, ll sc,
         const int* items, int rc, int rounding, int cvec, int m, int nt) {
  using S = PtcShape<T, B>;
  using Acc = typename Ptc<T>::Acc;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S::NS];
  __shared__ float red[PT_THREADS / 32];
  __shared__ float cta_max;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* cs = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + S::NS * S::STAGE);
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % S::NB;
  const int item = items[blockIdx.x / S::NB];
  const int ti = item >> 16, tj = item & 0xffff;
  const int b = B, z = blockIdx.y, zr = z * m;  // zr: the batch element's first row
  alpha += (ll)z * nt;
  float* Ct = C + (ll)z * sc + (ll)ti * b * ldc + (ll)tj * b;
  // k-stage kt of the tile into ring stage kt % NS
  auto load = [&](int kt) {
    const int s = kt % S::NS;
    const uint32_t st = base + s * S::STAGE, bar = smem_u32(&full[s]);
    bar_expect_tx(bar, S::STAGE);
    tma_load_2d(st, &map, bar, kt * S::KT, zr + ti * b + PT_ROWS * rank);
    for (int h = 0; h < S::NB; ++h)
      tma_load_2d(st + (1 + h) * S::BOX, &map, bar, kt * S::KT, zr + tj * b + PT_ROWS * h);
  };

  if (tid == 0) {
    for (int s = 0; s < S::NS; ++s) bar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int kt = 0; kt < S::NS; ++kt) load(kt);
  // The CTA's 128 rows of C come in by one burst of cp.async (128 KiB in
  // flight at b = 256) while the products run, 16 bytes a copy where C's
  // base and rows allow it (cvec)
  const float* crow = Ct + (ll)PT_ROWS * rank * ldc;
  if (cvec) {
    for (int v = tid; v < PT_ROWS * B / 4; v += PT_THREADS) {
      const int rr = v / (B / 4), ch = v % (B / 4);
      cp_async16(cs + rr * B + ((ch ^ (rr & 7)) << 2), crow + (ll)rr * ldc + 4 * ch);
    }
    cp_async_commit();
  } else {
    for (int v = tid; v < PT_ROWS * B; v += PT_THREADS) {
      const int rr = v / B, cc = v % B;
      cs[rr * B + ((((cc >> 2) ^ (rr & 7))) << 2) + (cc & 3)] = crow[(ll)rr * ldc + cc];
    }
  }

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128, lane = t % 32, warp = t / 32;
  Acc d[S::NB][64];
#pragma unroll
  for (int h = 0; h < S::NB; ++h)
#pragma unroll
    for (int e = 0; e < 64; ++e) d[h][e] = Acc(0);
  // K-major, 128-byte swizzle: 8-row groups 1024 bytes apart; one wgmma's
  // k (32 bytes) is 2 units of 16 bytes along the row
  const uint64_t da0 = gmma_desc(base + wg * 64 * PT_KBYTES, 16, 1024, 1);
  const uint64_t db0 = gmma_desc(base + S::BOX, 16, 1024, 1);
  for (int kt = 0; kt < S::NK; ++kt) {
    const int s = kt % S::NS;
    const uint64_t off = (uint64_t)((s * S::STAGE) >> 4);
    bar_wait(smem_u32(&full[s]), (kt / S::NS) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < PT_KBYTES / 32; ++kk)
#pragma unroll
      for (int h = 0; h < S::NB; ++h)
        Ptc<T>::mma(d[h], da0 + off + 2 * kk, db0 + off + h * (S::BOX >> 4) + 2 * kk);
    wg_commit();
    if (kt + S::NS < S::NK) {
      wg_wait<0>();     // this warpgroup's products have read stage s
      __syncthreads();  // and so have the other's: refill it
      if (tid == 0) load(kt + S::NS);
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int h = 0; h < S::NB; ++h) reg_fence<64>(d[h]);

  // register e of lane 4 g + q of warp w holds row 16 w + g + 8 ((e >> 1) & 1)
  // of the warpgroup's 64 and column 8 (e >> 2) + 2 q + (e & 1) of block h
  const float scale = alpha[ti] * alpha[tj];
  const int r0 = PT_ROWS * rank + 64 * wg + 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const bool diag = ti == tj;
  const bool scaled = rounding && rc_scaled(rc);
  const bool rnd = rounding && !rc_identity<float>(rc);
  if (cvec) cp_async_wait<0>();
  __syncthreads();  // every thread's part of C has landed
  // C's element (row, col) of the tile in shared memory
  auto cidx = [&](int row, int col) {
    const int lr = row - PT_ROWS * rank;
    return lr * B + (((col >> 2) ^ (lr & 7)) << 2) + (col & 3);
  };
  // the update takes the accumulator's place, PT_CHUNK values of C a
  // thread at a time: the empty asm with a memory clobber keeps the
  // compiler from hoisting every read of C (128 registers more at b = 256)
  float amax = 0.0f;
#pragma unroll
  for (int h = 0; h < S::NB; ++h)
#pragma unroll
    for (int e0 = 0; e0 < 64; e0 += PT_CHUNK) {
      float cv[PT_CHUNK];
#pragma unroll
      for (int k = 0; k < PT_CHUNK; ++k) {
        const int e = e0 + k;
        const int row = r0 + 8 * ((e >> 1) & 1), col = PT_ROWS * h + c0 + 8 * (e >> 2) + (e & 1);
        cv[k] = cs[cidx(row, col)];
      }
#pragma unroll
      for (int k = 0; k < PT_CHUNK; ++k) {
        const float u = __fsub_rn(cv[k], __fmul_rn(acc_f32(d[h][e0 + k]), scale));
        d[h][e0 + k] = put_f32<Acc>(u);
        amax = nan_max(amax, fabsf(u));
      }
      asm volatile("" ::: "memory");
    }
  int rcr = rc;
  float tile_alpha = 1.0f;
  if (scaled) {
    // the absmax of the whole b x b update: warp, CTA, then the cluster
    for (int o = 16; o; o >>= 1) amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) red[tid / 32] = amax;
    __syncthreads();
    if (tid == 0) {
      float m = red[0];
      for (int w = 1; w < PT_THREADS / 32; ++w) m = nan_max(m, red[w]);
      cta_max = m;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA's cta_max is written
    float m = cta_max;
    for (int p = 0; p < S::NB; ++p)
      if (p != rank) m = nan_max(m, *cluster.map_shared_rank(&cta_max, p));
    cluster.sync();  // no CTA leaves while a peer reads its cta_max
    tile_alpha = rc_alpha(rc, m);
    // f16(v / 1) * 1 is f16(v), bit for bit: no division where alpha is 1
    if (rc_name(rc) == NM_F16 && tile_alpha == 1.0f) rcr = NM_F16;
  }
  // The rounded update goes back into C's place in shared memory (each
  // thread writes the elements it read), then out in 16-byte stores along
  // whole rows, where the accumulator layout would store 4 bytes at a time
  // in 32-byte pieces; a diagonal tile's strict upper triangle is skipped.
#pragma unroll
  for (int h = 0; h < S::NB; ++h)
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int row = r0 + 8 * ((e >> 1) & 1), col = PT_ROWS * h + c0 + 8 * (e >> 2) + (e & 1);
      const float v = get_f32(d[h][e]);
      cs[cidx(row, col)] = rnd ? round_val<float>(v, rcr, tile_alpha) : v;
    }
  __syncthreads();
  float* orow = Ct + (ll)PT_ROWS * rank * ldc;
  for (int v = tid; v < PT_ROWS * B / 4; v += PT_THREADS) {
    const int rr = v / (B / 4), ch = v % (B / 4);
    const int row = PT_ROWS * rank + rr, col = 4 * ch;  // row and column in the tile
    const float* src = cs + rr * B + ((ch ^ (rr & 7)) << 2);
    float* dst = orow + (ll)rr * ldc + col;
    if (cvec && (!diag || col + 3 <= row)) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (!diag || col + q <= row) dst[q] = src[q];  // c's upper triangle stays as it was
    }
  }
}

template <typename T, int B>
static int launch_tc(const void* codes, int m, int nbatch, const float* alpha, float* C, ll ldc,
                     ll sc, const int* items, int npairs, int rc, int rounding,
                     cudaStream_t stream) {
  const int cvec = ((uintptr_t)C % 16 == 0) && (ldc % 4 == 0) && (sc % 4 == 0);
  using S = PtcShape<T, B>;
  if (const int err = dyn_smem<panel_tc<T, B>, S::SMEM>()) return err;
  // (N m rows, b codes of k) K-major, boxes of 128 rows x 128 bytes of k
  CUtensorMap map;
  const int err = encode_2d(&map, Ptc<T>::TYPE, codes, B, (uint64_t)m * nbatch,
                            (uint64_t)B * sizeof(T), S::KT, PT_ROWS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S::NB * npairs, nbatch);
  cfg.blockDim = dim3(PT_THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::NB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, panel_tc<T, B>, map, alpha, C, ldc, sc, items, rc,
                                 rounding, cvec, m, m / B);
}

template <typename T>
static int launch_tc_b(const void* codes, int m, int nbatch, int b, const float* alpha, float* C,
                       ll ldc, ll sc, const int* items, int npairs, int rc, int rounding,
                       cudaStream_t stream) {
  if (b == 256)
    return launch_tc<T, 256>(codes, m, nbatch, alpha, C, ldc, sc, items, npairs, rc, rounding,
                             stream);
  if (b == 128)
    return launch_tc<T, 128>(codes, m, nbatch, alpha, C, ldc, sc, items, npairs, rc, rounding,
                             stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// step 6: CUDA cores
// ---------------------------------------------------------------------------
// items[p] = {i << 16 | j, slot << 16 | rc << 8 | sub}: sub-block sub of the
// tile (row-major over (b / BT)^2), or SUB_ALL for the whole tile; batch
// element blockIdx.y (sl, sc: L21's and C's batch strides; a slot holds m b
// values a batch element).
template <typename T, int BT, int TM>
__global__ void __launch_bounds__(SG_THREADS)
panel_simt(const uint8_t* lq, ll slot_stride, const T* l21, ll lda, ll sl, const int* kinds,
           T* C, ll ldc, ll sc, const int2* items, int m, int b, int rounding, int cvec) {
  extern __shared__ __align__(16) uint8_t sm_raw[];
  constexpr int CX = BT / TM, CP = simt_cpitch<T, BT>(), VW = 16 / sizeof(T);
  // C's sub-block comes into shared memory by cp.async while the ring's
  // first steps load, so the epilogue waits on no load of C
  T* cs = reinterpret_cast<T*>(sm_raw + sg_async_smem<T, BT, BT, PS_ST, PS_BK>());
  const int2 it = items[blockIdx.x];
  const int ti = it.x >> 16, tj = it.x & 0xffff;
  const int slot = it.y >> 16, rc = (it.y >> 8) & 0xff, sub = it.y & 0xff;
  // the pair name's copy of L21 (rows b apart), or L21 itself
  const bool self = kinds[slot] == KIND_SELF;
  const ll z = blockIdx.y;
  const T* L = self ? l21 + z * sl : (const T*)(lq + slot * slot_stride) + z * m * b;
  const ll ld = self ? lda : b;
  const T* Li = L + (ll)ti * b * ld;
  const T* Lj = L + (ll)tj * b * ld;
  T* Ct = C + z * sc + (ll)ti * b * ldc + (ll)tj * b;
  const bool diag = ti == tj;
  const bool rnd = rounding && !rc_identity<T>(rc);
  const int tx = threadIdx.x % CX, ty = threadIdx.x / CX;
  const int nsub = b / BT;
  const int s0 = sub == SUB_ALL ? 0 : sub, s1 = sub == SUB_ALL ? nsub * nsub : sub + 1;
  T amax = T(0);
  for (int s = s0; s < s1; ++s) {
    const int m0 = (s / nsub) * BT, n0 = (s % nsub) * BT;
    T acc[TM][TM];
    __syncthreads();  // the ring's stages and cs are free again
    if (cvec) {
      for (int v = threadIdx.x; v < BT * BT / VW; v += SG_THREADS) {
        const int rr = v / (BT / VW), cc = (v % (BT / VW)) * VW;
        cp_async16(cs + rr * CP + cc, Ct + (ll)(m0 + rr) * ldc + n0 + cc);
      }
    } else {
      for (int v = threadIdx.x; v < BT * BT; v += SG_THREADS)
        cs[(v / BT) * CP + v % BT] = Ct[(ll)(m0 + v / BT) * ldc + n0 + v % BT];
    }
    cp_async_commit();
    sg_block_async<T, T, BT, BT, TM, TM, PS_ST, PS_BK>(acc, (T*)sm_raw, Li, ld, Lj, ld, b, b, m0,
                                                       n0, 0, b);
    __syncthreads();  // every thread's part of cs has landed
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TM; ++c) {
        const int row = m0 + ty + CX * r, col = n0 + tx + CX * c;
        const T v = sg_add(cs[(ty + CX * r) * CP + tx + CX * c], -acc[r][c]);
        if (sub == SUB_ALL) {
          amax = nan_max(amax, (T)fabs(v));
          if (!diag || col <= row) Ct[(ll)row * ldc + col] = v;
        } else if (!diag || col <= row) {
          Ct[(ll)row * ldc + col] = rnd ? round_val<T>(v, rc, 1.0f) : v;
        }
      }
  }
  if (sub != SUB_ALL) return;
  // a scaled name: the tile's absmax, then each thread rounds what it wrote
  const float alpha = rc_alpha(rc, (float)block_max(amax));
  for (int s = 0; s < nsub * nsub; ++s) {
    const int m0 = (s / nsub) * BT, n0 = (s % nsub) * BT;
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TM; ++c) {
        const int row = m0 + ty + CX * r, col = n0 + tx + CX * c;
        if (!diag || col <= row) {
          T* p = Ct + (ll)row * ldc + col;
          *p = round_val<T>(*p, rc, alpha);
        }
      }
  }
}

// Steps 2 and 6 at one tile shape, over nbatch matrices (sl, sa, sc: the
// batch strides of Linv, A21 and C; A_r is (nbatch, m, b) contiguous).
template <typename T, int BT, int TM>
static int launch_simt(const T* ar, const void* linv, ll ldlinv, ll sl, T* a21, ll lda, ll sa,
                       const uint8_t* lq, ll slot_stride, const int* kinds, T* c, ll ldc, ll sc,
                       const int2* items, int nitems, int m, int b, int nbatch, int rounding,
                       cudaStream_t stream) {
  constexpr int SM = simt_smem<T, BT, TM>(), SM_SOLVE = sg_async_smem<T, BT, BT, PS_ST, PS_BK>();
  int err = dyn_smem<panel_solve<T, BT, TM>, SM_SOLVE>();
  if (!err) err = dyn_smem<panel_simt<T, BT, TM>, SM>();
  if (err) return err;
  if (ar) {
    panel_solve<T, BT, TM><<<dim3(b / BT, m / BT, nbatch), SG_THREADS, SM_SOLVE, stream>>>(
        ar, b, (ll)m * b, (const T*)linv, ldlinv, sl, a21, lda, sa, m, b, b);
    return (int)cudaGetLastError();
  }
  constexpr int VW = 16 / sizeof(T);
  if (nitems > 0)
    panel_simt<T, BT, TM><<<dim3(nitems, nbatch), SG_THREADS, SM, stream>>>(
        lq, slot_stride, a21, lda, sa, kinds, c, ldc, sc, items, m, b, rounding,
        ((uintptr_t)c % 16 == 0) && (ldc % VW == 0) && (sc % VW == 0));
  return (int)cudaGetLastError();
}

// the CUDA cores' square tile bt: 128 (f32) or 64 (kernels/panel.py:simt_tile)
template <typename T>
static int simt(int b, int bt, const T* ar, const void* linv, ll ldlinv, ll sl, T* a21, ll lda,
                ll sa, const uint8_t* lq, ll slot_stride, const int* kinds, T* c, ll ldc, ll sc,
                const int2* items, int nitems, int m, int nbatch, int rounding,
                cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    if (bt == 128)
      return launch_simt<T, 128, 8>(ar, linv, ldlinv, sl, a21, lda, sa, lq, slot_stride, kinds, c,
                                    ldc, sc, items, nitems, m, b, nbatch, rounding, stream);
  }
  return launch_simt<T, 64, 4>(ar, linv, ldlinv, sl, a21, lda, sa, lq, slot_stride, kinds, c, ldc,
                               sc, items, nitems, m, b, nbatch, rounding, stream);
}

// ---------------------------------------------------------------------------
// the C entry: one panel
// ---------------------------------------------------------------------------
// nbatch matrices at batch strides sl (Linv), sa (A21), sc (C); a_r:
// (nbatch, m, b) scratch; lq: nslots slots of slot_stride bytes (the
// pair-name copies, m b values a batch element); alpha: nslots x nbatch x
// nt f32 scales; codes/kinds: the slots' rounding codes and kinds on the
// device, kinds_h the same on the host; tc_items: each tc slot's pairs,
// tc_off[s] .. tc_off[s + 1] (host offsets); simt_items: the simt route's
// items. Every matrix takes the same items.
template <typename T>
static int launch(const void* linv, ll ldlinv, ll sl, void* a21, ll lda, ll sa, void* c, ll ldc,
                  ll sc, int nbatch, void* a_r, void* lq, ll slot_stride, float* alpha,
                  const void* store_tab, const int* codes, const int* kinds, const int* codes_h,
                  const int* kinds_h, int nslots, const int* tc_items, const int* tc_off,
                  const void* simt_items, int nsimt, int nt, int b, int bt, int rounding,
                  void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const int m = nt * b;
  const ll mb = (ll)m * b;
  T* A21 = (T*)a21;
  T* Ar = (T*)a_r;
  const int* stab = (const int*)store_tab;
  const dim3 rows(nt, nbatch);
  int err = dyn_smem<panel_round_rows<T>, 0>();
  if (!err) err = dyn_smem<panel_copies<T>, 0>();
  if (err) return err;
  // 1. incoming panel at its storage names (a plain copy without rounding)
  panel_round_rows<T><<<rows, R_THREADS, 0, stream>>>(A21, lda, sa, Ar, b, mb, b, stab,
                                                       rounding ? -1 : NM_F64);
  // 2. L21 = A_r @ Linv^T over A21
  err = simt<T>(b, bt, Ar, linv, ldlinv, sl, A21, lda, sa, nullptr, 0, nullptr, nullptr, 0, 0,
                nullptr, 0, m, nbatch, rounding, stream);
  if (err) return err;
  // 3. L21 back onto its storage grid
  if (rounding)
    panel_round_rows<T><<<rows, R_THREADS, 0, stream>>>(A21, lda, sa, A21, lda, sa, b, stab, -1);
  // 4. one copy of L21 per pair name
  panel_copies<T><<<dim3(nt, nslots, nbatch), R_THREADS, 0, stream>>>(
      A21, lda, sa, (uint8_t*)lq, slot_stride, alpha, codes, kinds, nt, b);
  err = (int)cudaGetLastError();
  if (err) return err;
  // 5. the tensor cores' pairs, one launch per name
  for (int s = 0; s < nslots; ++s) {
    const int np = tc_off[s + 1] - tc_off[s];
    if (np == 0) continue;  // a CUDA-core slot has no pairs here
    if constexpr (sizeof(T) != 4) return (int)cudaErrorInvalidValue;
    const uint8_t* codes_s = (const uint8_t*)lq + s * slot_stride;
    const float* al = alpha + (ll)s * nbatch * nt;
    const int* items = tc_items + tc_off[s];
    if (kinds_h[s] == KIND_F16)
      err = launch_tc_b<__half>(codes_s, m, nbatch, b, al, (float*)c, ldc, sc, items, np,
                                codes_h[s], rounding, stream);
    else if (kinds_h[s] == KIND_BF16)
      err = launch_tc_b<__nv_bfloat16>(codes_s, m, nbatch, b, al, (float*)c, ldc, sc, items, np,
                                       codes_h[s], rounding, stream);
    else
      err = launch_tc_b<int8_t>(codes_s, m, nbatch, b, al, (float*)c, ldc, sc, items, np,
                                codes_h[s], rounding, stream);
    if (err) return err;
  }
  // 6. the CUDA cores' pairs
  return simt<T>(b, bt, nullptr, nullptr, 0, 0, A21, lda, sa, (const uint8_t*)lq, slot_stride,
                 kinds, (T*)c, ldc, sc, (const int2*)simt_items, nsimt, m, nbatch, rounding,
                 stream);
}

// (Linv, ldlinv, its batch stride, A21, lda, batch stride, C, ldc, batch
// stride, nbatch, ...): one panel of nbatch matrices (nbatch = 1: one).
#define PANEL_ENTRY(NAME, T)                                                                 \
  extern "C" int NAME(const void* linv, ll ldlinv, ll sl, void* a21, ll lda, ll sa, void* c, \
                      ll ldc, ll sc, int nbatch, void* a_r, void* lq, ll slot_stride,       \
                      void* alpha, const void* store_tab, const void* codes,                 \
                      const void* kinds, const int* codes_h, const int* kinds_h, int nslots, \
                      const void* tc_items, const int* tc_off, const void* simt_items,       \
                      int nsimt, int nt, int b, int bt, int rounding, void* stream) {       \
    if (b % 64 != 0 || nt <= 0 || nt > 0xffff || b % bt != 0 || nbatch <= 0 ||              \
        nbatch > 0xffff || (bt != 64 && !(bt == 128 && sizeof(T) == 4)))                     \
      return (int)cudaErrorInvalidValue;                                                     \
    return launch<T>(linv, ldlinv, sl, a21, lda, sa, c, ldc, sc, nbatch, a_r, lq,            \
                     slot_stride, (float*)alpha, store_tab, (const int*)codes,               \
                     (const int*)kinds, codes_h, kinds_h, nslots, (const int*)tc_items,      \
                     tc_off, simt_items, nsimt, nt, b, bt, rounding, stream);               \
  }

PANEL_ENTRY(panel_update_f32, float)
PANEL_ENTRY(panel_update_f64, double)
