// Register-blocked GEMM core on the CUDA cores (f32 and f64 stay IEEE: no
// tensor cores, which would round f32 operands to TF32), used by qgemm.cu's
// SIMT routes and by syrk.cu's f32 leaf.
//
// A CTA of 256 threads computes a BM x BN block of acc = A B over one
// k-range [kbeg, kend), in k-steps of BK (16 or more):
// - Both operand tiles sit in shared memory K-contiguous (row r of the A
//   tile is row m0 + r of A, its BK k-values in a row padded by 16 bytes).
// - sg_block reads an operand in one of three layouts, chosen by the
//   wrapper from its strides: LAY_K (unit k stride, 16-byte aligned rows:
//   16-byte loads along k, 16-byte shared stores), LAY_MN (unit row stride:
//   16-byte loads along the rows, scattered into the K-contiguous tile,
//   lanes laid out so the 32 stores of a warp hit 32 banks), LAY_ANY (any
//   strides: one element a load); a transposed view costs no copy. The
//   next k-step is loaded into registers while the current one is
//   multiplied, then stored into the other of two buffers, one block
//   barrier a step.
// - sg_block_async takes two K-major operands straight from global to
//   shared memory by cp.async into a ring of ST stages (ST - 1 steps in
//   flight), where one step in flight left the loads' latency exposed.
// - Thread (tx, ty) = (tid % (BN / TN), tid / (BN / TN)) owns rows
//   m0 + ty + (BM / TM) r and columns n0 + tx + (BN / TN) c. Each 16-byte
//   shared read takes VW = 16 / sizeof(Tin) k-values of one row; a warp's
//   A reads are broadcasts of two rows and its B reads 16 rows whose
//   16-byte slots lie in distinct banks (row pitch = 4 words mod 32).
//
// Summation order: every element is acc = fma(a_k, b_k, acc) for k = kbeg,
// kbeg + 1, ..., kend - 1 in order, from acc = +0, whatever the tile shape,
// BK, the layouts, the path or the element's position: so two launches
// with the same k-range give the same bits for a column, whatever N and
// the tile, and a k-split summed in chunk order is repeatable. Past kend a
// tile holds zeros, and fma(0, 0, acc) = acc (acc is never -0: it starts
// at +0 and an exact zero sum rounds to +0).
#pragma once

#include "common.cuh"

enum { LAY_ANY = 0, LAY_K = 1, LAY_MN = 2 };
constexpr int SG_BK = 16, SG_THREADS = 256;

template <typename T> struct alignas(16) SgVec { T e[16 / sizeof(T)]; };

__device__ __forceinline__ float sg_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double sg_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float sg_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double sg_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sg_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sg_add(double a, double b) { return __dadd_rn(a, b); }

// The epilogue, rounded as ref.qgemm_ref computes it (no contraction):
// (acc * scale) + (beta * c).
template <typename T>
__device__ __forceinline__ T sg_epilogue(T acc, T scale, T beta, const T* c) {
  const T v = sg_mul(acc, scale);
  return c ? sg_add(v, sg_mul(beta, *c)) : v;
}

// An R x BK operand tile: its global layout, loads into registers and
// stores into the K-contiguous shared tile of pitch LD.
template <typename Tin, int R, int BK = SG_BK>
struct SgTile {
  static constexpr int VW = 16 / sizeof(Tin);
  static constexpr int LD = BK + VW;
  static constexpr int NV = R * BK / VW;                          // 16-byte vectors
  static constexpr int PV = (NV + SG_THREADS - 1) / SG_THREADS;   // per thread
  static constexpr int NE = R * BK;                                // elements
  static constexpr int PE = (NE + SG_THREADS - 1) / SG_THREADS;
  static constexpr int REG = PV * VW;  // >= PE
  static_assert(REG >= PE, "registers of a tile load");

  // element (r, k) of the operand at P[r * s_r + k * s_k]; rows >= rows and
  // k >= kend read as zero
  static __device__ __forceinline__ void load(Tin (&reg)[REG], const Tin* __restrict__ P,
                                              ll s_r, ll s_k, int lay, int r0, int rows,
                                              int k0, int kend) {
    const int tid = threadIdx.x;
    if (lay == LAY_K) {
#pragma unroll
      for (int i = 0; i < PV; ++i) {
        const int v = tid + i * SG_THREADS;
        if (v >= NV) break;
        const int r = r0 + v / (BK / VW), k = k0 + (v % (BK / VW)) * VW;
        if (r < rows && k + VW <= kend) {
          const SgVec<Tin> x = *reinterpret_cast<const SgVec<Tin>*>(P + (ll)r * s_r + k);
#pragma unroll
          for (int j = 0; j < VW; ++j) reg[i * VW + j] = x.e[j];
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j)
            reg[i * VW + j] = (r < rows && k + j < kend) ? P[(ll)r * s_r + k + j] : Tin(0);
        }
      }
    } else if (lay == LAY_MN) {
#pragma unroll
      for (int i = 0; i < PV; ++i) {
        const int v = tid + i * SG_THREADS;
        if (v >= NV) break;
        const int k = k0 + v % BK, r = r0 + (v / BK) * VW;
        if (k < kend && r + VW <= rows) {
          const SgVec<Tin> x = *reinterpret_cast<const SgVec<Tin>*>(P + r + (ll)k * s_k);
#pragma unroll
          for (int j = 0; j < VW; ++j) reg[i * VW + j] = x.e[j];
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j)
            reg[i * VW + j] = (k < kend && r + j < rows) ? P[r + j + (ll)k * s_k] : Tin(0);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < PE; ++i) {
        const int e = tid + i * SG_THREADS;
        if (e >= NE) break;
        const int k = k0 + e % BK, r = r0 + e / BK;
        reg[i] = (r < rows && k < kend) ? P[(ll)r * s_r + (ll)k * s_k] : Tin(0);
      }
    }
  }

  static __device__ __forceinline__ void store(Tin* S, const Tin (&reg)[REG], int lay) {
    const int tid = threadIdx.x;
    if (lay == LAY_K) {
#pragma unroll
      for (int i = 0; i < PV; ++i) {
        const int v = tid + i * SG_THREADS;
        if (v >= NV) break;
        SgVec<Tin> x;
#pragma unroll
        for (int j = 0; j < VW; ++j) x.e[j] = reg[i * VW + j];
        *reinterpret_cast<SgVec<Tin>*>(S + (v / (BK / VW)) * LD + (v % (BK / VW)) * VW) = x;
      }
    } else if (lay == LAY_MN) {
#pragma unroll
      for (int i = 0; i < PV; ++i) {
        const int v = tid + i * SG_THREADS;
        if (v >= NV) break;
        const int k = v % BK, r = (v / BK) * VW;
#pragma unroll
        for (int j = 0; j < VW; ++j) S[(r + j) * LD + k] = reg[i * VW + j];
      }
    } else {
#pragma unroll
      for (int i = 0; i < PE; ++i) {
        const int e = tid + i * SG_THREADS;
        if (e >= NE) break;
        S[(e / BK) * LD + e % BK] = reg[i];
      }
    }
  }
};

// acc += the products of one BK-deep step of K-contiguous tiles as, bs
// (pitch BK + VW), in k order.
template <typename Tin, typename Tacc, int BM, int BN, int TM, int TN, int BK>
__device__ __forceinline__ void sg_mma(Tacc (&acc)[TM][TN], const Tin* as, const Tin* bs, int tx,
                                       int ty) {
  constexpr int VW = 16 / sizeof(Tin), LD = BK + VW, CX = BN / TN, RY = BM / TM;
#pragma unroll
  for (int kq = 0; kq < BK / VW; ++kq) {
    SgVec<Tin> a[TM], b[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
      a[r] = *reinterpret_cast<const SgVec<Tin>*>(as + (ty + RY * r) * LD + kq * VW);
#pragma unroll
    for (int c = 0; c < TN; ++c)
      b[c] = *reinterpret_cast<const SgVec<Tin>*>(bs + (tx + CX * c) * LD + kq * VW);
#pragma unroll
    for (int j = 0; j < VW; ++j)
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c)
          acc[r][c] = sg_fma((Tacc)a[r].e[j], (Tacc)b[c].e[j], acc[r][c]);
  }
}

// acc[r][c] = sum over k in [kbeg, kend) of A(m0 + ty + (BM/TM) r, k) *
// B(n0 + tx + (BN/TN) c, k), where A(m, k) = A[m sam + k sak] and
// B(n, k) = B[n sbn + k sbk] (B given as its N x K view).
template <typename Tin, typename Tacc, int BM, int BN, int TM, int TN, int BK = SG_BK>
__device__ __forceinline__ void sg_block(Tacc (&acc)[TM][TN], const Tin* __restrict__ A, ll sam,
                                         ll sak, int alay, const Tin* __restrict__ B, ll sbn,
                                         ll sbk, int blay, int M, int N, int m0, int n0,
                                         int kbeg, int kend) {
  using TA = SgTile<Tin, BM, BK>;
  using TB = SgTile<Tin, BN, BK>;
  constexpr int VW = TA::VW, LD = TA::LD, CX = BN / TN, RY = BM / TM;
  static_assert(CX * RY == SG_THREADS, "one thread per TM x TN micro-tile");
  __shared__ __align__(16) Tin As[2][BM * LD];
  __shared__ __align__(16) Tin Bs[2][BN * LD];
  const int tid = threadIdx.x, tx = tid % CX, ty = tid / CX;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = Tacc(0);
  const int nt = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  if (nt == 0) return;
  Tin ra[TA::REG], rb[TB::REG];
  TA::load(ra, A, sam, sak, alay, m0, M, kbeg, kend);
  TB::load(rb, B, sbn, sbk, blay, n0, N, kbeg, kend);
  TA::store(As[0], ra, alay);
  TB::store(Bs[0], rb, blay);
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const bool more = t + 1 < nt;
    if (more) {
      const int k0 = kbeg + (t + 1) * BK;
      TA::load(ra, A, sam, sak, alay, m0, M, k0, kend);
      TB::load(rb, B, sbn, sbk, blay, n0, N, k0, kend);
    }
    const Tin* as = As[t & 1];
    const Tin* bs = Bs[t & 1];
    sg_mma<Tin, Tacc, BM, BN, TM, TN, BK>(acc, as, bs, tx, ty);
    if (more) {
      TA::store(As[(t + 1) & 1], ra, alay);
      TB::store(Bs[(t + 1) & 1], rb, blay);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The same block with both operands K-major (LAY_K): the tiles go straight
// from global to shared memory by cp.async into a ring of ST stages of
// dynamic shared memory (sg_async_smem bytes), ST - 1 steps in flight, so
// the loads' latency hides behind ST - 1 steps of arithmetic (the register
// path above keeps one step in flight). Vectors that cross M, N or kend
// are written element by element (zeros past the edge) with plain stores.
// ---------------------------------------------------------------------------
template <typename Tin, int BM, int BN, int ST, int BK = SG_BK>
__host__ __device__ constexpr int sg_async_smem() {
  return ST * (BM + BN) * (BK + 16 / (int)sizeof(Tin)) * (int)sizeof(Tin);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows r0.. of a K-major operand (rows s_r apart), k in [k0, k0 + BK)
template <typename Tin, int R, int BK>
__device__ __forceinline__ void sg_issue(Tin* S, const Tin* __restrict__ P, ll s_r, int r0,
                                         int rows, int k0, int kend) {
  constexpr int VW = 16 / sizeof(Tin), LD = BK + VW, NV = R * BK / VW;
#pragma unroll
  for (int i = 0; i < (NV + SG_THREADS - 1) / SG_THREADS; ++i) {
    const int v = threadIdx.x + i * SG_THREADS;
    if (v >= NV) break;
    const int rr = v / (BK / VW), kk = (v % (BK / VW)) * VW;
    const int r = r0 + rr, k = k0 + kk;
    Tin* d = S + rr * LD + kk;
    if (r < rows && k + VW <= kend) {
      cp_async16(d, P + (ll)r * s_r + k);
    } else {
#pragma unroll
      for (int j = 0; j < VW; ++j) d[j] = (r < rows && k + j < kend) ? P[(ll)r * s_r + k + j] : Tin(0);
    }
  }
}

template <typename Tin, typename Tacc, int BM, int BN, int TM, int TN, int ST, int BK = SG_BK>
__device__ __forceinline__ void sg_block_async(Tacc (&acc)[TM][TN], Tin* smem,
                                               const Tin* __restrict__ A, ll sam,
                                               const Tin* __restrict__ B, ll sbn, int M, int N,
                                               int m0, int n0, int kbeg, int kend) {
  constexpr int LD = BK + 16 / sizeof(Tin), CX = BN / TN;
  Tin* As = smem;                 // stage s: As + s BM LD
  Tin* Bs = smem + ST * BM * LD;  // stage s: Bs + s BN LD
  const int tid = threadIdx.x, tx = tid % CX, ty = tid / CX;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = Tacc(0);
  const int nt = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  auto issue = [&](int t) {
    if (t < nt) {
      const int s = t % ST, k0 = kbeg + t * BK;
      sg_issue<Tin, BM, BK>(As + s * BM * LD, A, sam, m0, M, k0, kend);
      sg_issue<Tin, BN, BK>(Bs + s * BN * LD, B, sbn, n0, N, k0, kend);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) issue(t);
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<ST - 2>();  // step t has landed (this thread's part)
    __syncthreads();          // everyone's part; step t - 1's stage is free
    issue(t + ST - 1);
    const int s = t % ST;
    sg_mma<Tin, Tacc, BM, BN, TM, TN, BK>(acc, As + s * BM * LD, Bs + s * BN * LD, tx, ty);
  }
  cp_async_wait<0>();
}
