// potrf_leaf: lower Cholesky factor of one SPD (b, b) tile, upper zeroed.
//
// Replaces the Pallas kernel repro/kernels/potrf.py:potrf_leaf (one leaf
// per diagonal tile of both engines, b = leaf = 128 .. 512). The work is
// b^3 / 3 flops on one tile. Against the whole card it is bound by bytes
// (the lower triangle read once, b (b + 1) / 2 elements, and b^2 written:
// 0.000118 ms at b = 256 in f32, 0.000235 ms in f64), but the right-looking
// dependence chain keeps it inside one CTA, so the yardstick that fits is
// one SM's share of the card's rate: b^3 / 3 at 67 / 132 TFLOP/s (f32 on
// the CUDA cores; f64 on the tensor cores, DMMA), 0.011 ms at b = 256 in
// either type. This kernel's f64 runs on the CUDA cores, whose f64 rate is
// half that (0.022 ms). What bounds a one-CTA factor is latency: the
// 32-column pivots in sequence, the barriers between steps, and shared
// memory traffic. The design:
//   - the tile's lower triangle is read ONCE into shared memory (cp.async,
//     16 bytes a thread) as 32 x 32 blocks, each row's 16-byte slots
//     swizzled (common.cuh: Blk), and stays there until L is written once
//     to `out`, upper triangle zeroed;
//   - right-looking over 32-wide panels p. Warp 0 factors the diagonal
//     block in registers (a lane per row, the column's pivot and entries
//     by shuffles) and leaves L_pp^T with 1 / diag in a small buffer; the
//     rows below then solve against it, one thread a row, in registers;
//   - the trailing triangle takes its rank-32 update blocked in registers
//     (common.cuh: nt_sub, a 4 x 4 micro-tile a thread, 16-byte operand
//     reads, 16 multiply-adds per vector read in f32);
//   - look-ahead: warps 0 and 1 give the next diagonal block its update
//     first, then warp 0 factors it while the other fifteen warps update
//     the rest of the trailing triangle. That is two block barriers per
//     panel (after the row solve, after the update), and the pivots'
//     latency hides behind the update while the triangle is large.
// No atomics; every sum runs in an order fixed by b, so the same input
// gives the same bits on every call.
// Tiles whose triangle does not fit in shared memory with the 32 x 32
// buffer (f32 above b = 320, f64 above b = 192; on the paths f32 at
// b = 384 and 512 and f64 at b = 256) start in `out`: the input is copied
// there, upper zeroed, and the first panels run on it through ldo with the
// same register-blocked update (global memory / L2). As soon as the
// trailing triangle fits (f64 b = 256 and f32 b = 384 after 2 panels,
// f32 b = 512 after 6), it moves into shared memory and the rest runs as
// above; it is written back once.
// A pivot that is not positive (or NaN) marks the tile, and a marked tile
// comes out NaN on and below the diagonal, as jnp.linalg.cholesky and the
// plain version (cholesky_ex + where) give it.
// The input is read through its leading dimension; `out` may be `a`.
// potrf_{f32,f64} factor T tiles at tile strides in one launch, one CTA a
// tile (potrf_leaf_batched: the K-FAC refactor's diagonal tiles of every
// block at once; a single tile is T = 1): each tile's bits equal a single
// launch's.
#include "common.cuh"

constexpr int POTRF_THREADS = 512;
constexpr int POTRF_WARPS = POTRF_THREADS / 32;

// Warp: factor the diagonal block D in place (lane = row) and leave in U
// (32 x 32, row-major) U[c][c] = 1 / L[c][c] and U[c][k] = L[k][c] for
// k > c. The chain from one pivot to the next is one shuffle, one
// reciprocal square root (r = rsqrt(pivot): L[c][c] = pivot r and the
// column below is scaled by r), one shuffle and one multiply-add, so no
// division or IEEE square root sits on it. Returns true if a pivot was not
// positive (the same in every lane).
template <typename T, class B>
__device__ bool factor_diag(const B& D, T* U, int lane) {
  constexpr int VW = B::VW;
  T a[LB];
#pragma unroll
  for (int v = 0; v < LB; v += VW) {
    const Vec<T> x = D.ldv(lane, v);
#pragma unroll
    for (int i = 0; i < VW; ++i) a[v + i] = x.e[i];
  }
  bool bad = false;
  // entries above the diagonal (k > lane) are never read by a lower entry
#pragma unroll
  for (int c = 0; c < LB; ++c) {
    const T piv = __shfl_sync(0xffffffffu, a[c], c);
    bad |= !(piv > T(0));
    const T r = rsqrt(piv);
    a[c] = (lane == c) ? piv * r : a[c] * r;
#pragma unroll
    for (int k = c + 1; k < LB; ++k) a[k] -= a[c] * __shfl_sync(0xffffffffu, a[c], k);
    U[c * LB + lane] = (lane > c) ? a[c] : (lane == c ? r : T(0));
  }
#pragma unroll
  for (int k = 0; k < LB; ++k)
    if (k > lane) a[k] = T(0);
#pragma unroll
  for (int v = 0; v < LB; v += VW) {
    Vec<T> x;
#pragma unroll
    for (int i = 0; i < VW; ++i) x.e[i] = a[v + i];
    D.stv(lane, v, x);
  }
  return bad;
}

// Row r of panel block P: x L_pp^T = p, in registers, against U.
template <typename T, class B>
__device__ __forceinline__ void solve_row(const B& P, int r, const T* U) {
  constexpr int VW = B::VW;
  T x[LB];
#pragma unroll
  for (int v = 0; v < LB; v += VW) {
    const Vec<T> y = P.ldv(r, v);
#pragma unroll
    for (int i = 0; i < VW; ++i) x[v + i] = y.e[i];
  }
#pragma unroll
  for (int c = 0; c < LB; ++c) {
    Vec<T> u[LB / VW];  // U row c (broadcast reads; the unused ones drop)
#pragma unroll
    for (int v = 0; v < LB / VW; ++v) u[v] = reinterpret_cast<const Vec<T>*>(U + c * LB)[v];
    x[c] *= u[c / VW].e[c % VW];
#pragma unroll
    for (int k = c + 1; k < LB; ++k) x[k] -= x[c] * u[k / VW].e[k % VW];
  }
#pragma unroll
  for (int v = 0; v < LB; v += VW) {
    Vec<T> y;
#pragma unroll
    for (int i = 0; i < VW; ++i) y.e[i] = x[v + i];
    P.stv(r, v, y);
  }
}

// Rank-32 update with panel p of the blocks (I, J), p < J, J <= I < nb,
// but the diagonal block (p + 1, p + 1): two warp tasks (64 threads) a
// block, taken by warps w, w + nw, ... in column order.
template <typename T, class S>
__device__ __forceinline__ void trailing(const S& st, int nb, int p, int w, int nw, int lane) {
  const int m = nb - 1 - p, total = m * (m + 1) / 2 - 1;
  for (int t = w; t < 2 * total; t += nw) {
    int k = (t >> 1) + 1, J = p + 1;  // k-th block of the trailing triangle
    while (k >= nb - J) {
      k -= nb - J;
      ++J;
    }
    const int I = J + k;
    nt_sub<T>(st.blk(I, J), st.blk(I, p), st.blk(J, p), ((t & 1) << 5) | lane);
  }
}

// Panels p0 .. p1 - 1 of the right-looking loop on the triangle st of nb
// block rows. On entry diagonal block p0 is factored and U holds it; each
// panel p solves the rows below diagonal block p against U, then gives
// every trailing block its rank-32 update and factors diagonal block p + 1
// into U. Two block barriers a panel.
template <typename T, class S>
__device__ void panels(const S& st, int nb, int p0, int p1, T* U, int* bad) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int p = p0; p < p1; ++p) {
    // the rows below the diagonal block (at most b - 32 < POTRF_THREADS:
    // one pass, so nothing of U is hoisted out of a loop into registers)
    if (tid < (nb - 1 - p) * LB) solve_row(st.blk(p + 1 + tid / LB, p), tid % LB, U);
    __syncthreads();
    // warps 0 and 1 update the next diagonal block, then warp 0 factors it
    // while warp 1 joins the other fourteen on the rest of the triangle
    if (warp < 2) {
      const auto D = st.blk(p + 1, p + 1), P = st.blk(p + 1, p);
      nt_sub<T>(D, P, P, tid);
      asm volatile("bar.sync 1, 64;\n" ::: "memory");
      if (warp == 0 && factor_diag(D, U, lane) && lane == 0) *bad = 1;
    }
    if (warp > 0) trailing<T>(st, nb, p, warp - 1, POTRF_WARPS - 1, lane);
    __syncthreads();
  }
}

// RES: the whole lower triangle in shared memory. Otherwise the tile is
// factored in `out` (global memory) for panels 0 .. ps - 1, and the
// trailing triangle of block rows ps .. nb - 1, which then fits, moves
// into shared memory for the rest.
template <typename T, bool RES, bool VEC>
__global__ void __launch_bounds__(POTRF_THREADS)
potrf_kernel(const T* A, ll lda, ll sa, T* O, ll ldo, ll so, int b, int ps) {
  constexpr int VW = 16 / sizeof(T);
  A += (ll)blockIdx.x * sa;
  O += (ll)blockIdx.x * so;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* U = reinterpret_cast<T*>(smem_raw);  // LB x LB, then the triangle
  __shared__ int bad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = b / LB, r0 = ps * LB;  // r0: the shared triangle's first row
  const TriStore<T, true, VEC> sh{U + LB * LB, LB};
  if (tid == 0) bad = 0;

  // rows of the tile, a warp a row, 16 bytes a lane
  if constexpr (RES) {  // the lower blocks, once, into shared memory
    for (int i = warp; i < b; i += POTRF_WARPS)
      for (int c = lane * VW; c < (i / LB + 1) * LB; c += 32 * VW)
        copy_in<T, VEC>(sh.blk(i / LB, c / LB), i % LB, c % LB, A + (ll)i * lda + c);
    copy_in_wait();
    __syncthreads();
    if (warp == 0 && factor_diag(sh.blk(0, 0), U, lane) && lane == 0) bad = 1;
    __syncthreads();
  } else {  // the tile into `out`, upper blocks zeroed (a no-op copy if O == A)
    for (int i = warp; i < b; i += POTRF_WARPS)
      for (int c = lane * VW; c < b; c += 32 * VW) {
        Vec<T> v;
#pragma unroll
        for (int x = 0; x < VW; ++x) v.e[x] = (c / LB <= i / LB) ? A[(ll)i * lda + c + x] : T(0);
        store_row<T, VEC>(O + (ll)i * ldo + c, v);
      }
    const TriStore<T, false, VEC> gl{O, ldo};
    __syncthreads();
    if (warp == 0 && factor_diag(gl.blk(0, 0), U, lane) && lane == 0) bad = 1;
    __syncthreads();
    panels<T>(gl, nb, 0, ps, U, &bad);
    for (int i = r0 + warp; i < b; i += POTRF_WARPS)  // the trailing triangle
      for (int c = r0 + lane * VW; c < (i / LB + 1) * LB; c += 32 * VW)
        copy_in<T, VEC>(sh.blk(i / LB - ps, c / LB - ps), i % LB, c % LB, O + (ll)i * ldo + c);
    copy_in_wait();
    __syncthreads();
  }
  panels<T>(sh, nb - ps, 0, nb - ps - 1, U, &bad);

  // L to `out`: the shared triangle once (and, resident, the zero upper
  // blocks); NaN on and below the diagonal of the whole tile if marked
  const bool failed = bad != 0;
  for (int i = (failed ? 0 : r0) + warp; i < b; i += POTRF_WARPS)
    for (int c = (failed ? 0 : r0) + lane * VW; c < b; c += 32 * VW) {
      const bool lower = c / LB <= i / LB;
      if (!RES && !failed && !lower) continue;  // already zero in `out`
      Vec<T> v;
      if (failed || !lower) {
#pragma unroll
        for (int x = 0; x < VW; ++x) v.e[x] = (failed && c + x <= i) ? qnan<T>() : T(0);
      } else {
        v = sh.blk(i / LB - ps, c / LB - ps).ldv(i % LB, c % LB);
      }
      store_row<T, VEC>(O + (ll)i * ldo + c, v);
    }
}

template <typename T, bool RES, bool VEC>
static int launch_variant(const T* A, ll lda, ll sa, T* O, ll ldo, ll so, int b, int ps,
                          int ntiles, size_t smem, cudaStream_t stream) {
  if (const int err = dyn_smem_upto<potrf_kernel<T, RES, VEC>, LEAF_SMEM_BOUND>(smem))
    return err;
  potrf_kernel<T, RES, VEC><<<ntiles, POTRF_THREADS, smem, stream>>>(A, lda, sa, O, ldo, so, b,
                                                                     ps);
  RETURN_LAUNCH_STATUS();
}

template <typename T>
static int launch(const void* A, ll lda, ll sa, void* O, ll ldo, ll so, int b, int ntiles,
                  void* stream) {
  if (b <= 0 || b % LB != 0 || b > 512 || ntiles <= 0 || ntiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  constexpr int VW = 16 / sizeof(T);
  const int nb = b / LB;
  const size_t u = LB * LB * sizeof(T), limit = leaf_smem_limit();
  int ps = 0;  // the first panel from which the trailing triangle fits
  while (u + tri_bytes(nb - ps, sizeof(T)) > limit) ++ps;
  const size_t smem = u + tri_bytes(nb - ps, sizeof(T));
  const bool vec = ((uintptr_t)A % 16 == 0) && ((uintptr_t)O % 16 == 0) && lda % VW == 0 &&
                   ldo % VW == 0 && sa % VW == 0 && so % VW == 0;
  const T* a = (const T*)A;
  T* o = (T*)O;
  cudaStream_t s = (cudaStream_t)stream;
  if (ps == 0) {
    return vec ? launch_variant<T, true, true>(a, lda, sa, o, ldo, so, b, 0, ntiles, smem, s)
               : launch_variant<T, true, false>(a, lda, sa, o, ldo, so, b, 0, ntiles, smem, s);
  }
  return vec ? launch_variant<T, false, true>(a, lda, sa, o, ldo, so, b, ps, ntiles, smem, s)
             : launch_variant<T, false, false>(a, lda, sa, o, ldo, so, b, ps, ntiles, smem, s);
}

// (A, lda, tile stride, O, ldo, tile stride, b, tiles, stream)
extern "C" int potrf_f32(const void* A, ll lda, ll sa, void* O, ll ldo, ll so, int b,
                         int ntiles, void* s) {
  return launch<float>(A, lda, sa, O, ldo, so, b, ntiles, s);
}
extern "C" int potrf_f64(const void* A, ll lda, ll sa, void* O, ll ldo, ll so, int b,
                         int ntiles, void* s) {
  return launch<double>(A, lda, sa, O, ldo, so, b, ntiles, s);
}
