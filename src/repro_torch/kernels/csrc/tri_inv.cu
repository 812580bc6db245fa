// tri_inv_leaf: X = L^-1 for lower-triangular (b, b) tiles, one CTA a tile.
//
// Replaces the Pallas kernel repro/kernels/potrf.py:tri_inv_leaf (the
// L11^-1 operand of every panel update, the diagonal inverses both solve
// sweeps reuse, and the leaves of the tree engine's triangular solves).
// The work is b^3 / 3 flops on one tile: bound by bytes against the whole
// card (the lower triangle read once and b^2 written: 0.000118 ms at
// b = 256 in f32, 0.000235 ms in f64), and for one CTA by one SM's share
// of the card's rate, 67 / 132 TFLOP/s in f32 and in f64 (DMMA): 0.011 ms
// at b = 256 (0.022 ms at the CUDA cores' f64 rate, which this kernel's
// f64 runs on). A substitution
// is a chain of dependent steps; what bounds one CTA is their latency and
// the shared-memory traffic of the products. The design:
//   - the lower triangle is read ONCE into shared memory (cp.async) as
//     32 x 32 blocks with swizzled rows (common.cuh: Blk) and inverted
//     there in place; X is written once, its strict upper triangle zero;
//   - warp w inverts diagonal block w in registers (a lane per column,
//     right-looking over the block's 32 rows), all blocks at once;
//   - then the doubling scheme over 1 -> 2 -> 4 -> ... blocks:
//         [[A, 0], [C, B]]^-1 = [[A^-1, 0], [-B^-1 C A^-1, B^-1]],
//     every pair of a level at once: T1 = C A^-1 into a scratch, then
//     X_BA = -B^-1 T1 over C's blocks. Both are triangular-times-dense
//     products of 32 x 32 blocks, blocked in registers (common.cuh: nn_acc,
//     a 4 x 4 micro-tile a thread, 16-byte operand reads) and read only
//     from shared memory. Two block barriers a level: log2(b / 32) levels,
//     each with up to (b / 64)^2 blocks of output, so all sixteen warps
//     have work at every level (the block-column order of LAPACK's trtri
//     would run b / 32 - 1 steps, most of them a few blocks wide).
// No atomics; every sum runs in an order fixed by b, so the same input
// gives the same bits on every call.
// Tiles whose triangle and scratch (at b = 256: 36 + 16 blocks, 208 KiB in
// f32) do not fit in shared memory (f32 above b = 256, f64 above b = 160;
// on the paths f32 at b = 384 and 512 and f64 at b = 256) take the same
// steps on X held in `out` (global memory / L2): L's lower blocks are
// copied there first, each level's T1 block (I, J) is kept in X's block
// (J, I) of the upper triangle, which is zeroed at the end.
// tri_inv_{f32,f64} inverts T tiles at tile strides in one launch, one CTA
// a tile (a single tile is T = 1): each tile's bits equal a single launch.
// `out` must not alias the input.
#include "common.cuh"

constexpr int TI_THREADS = 512;
constexpr int TI_WARPS = TI_THREADS / 32;

// Warp: invert the lower-triangular block D in place, lane = column. The
// reciprocals of the diagonal do not depend on x, so they are taken off the
// substitution's chain, which is multiply-adds only.
template <typename T, class B>
__device__ void invert_diag(const B& D, int lane) {
  T x[LB];
#pragma unroll
  for (int i = 0; i < LB; ++i) x[i] = (i == lane) ? T(1) : T(0);
#pragma unroll
  for (int i = 0; i < LB; ++i) {
    // above the diagonal x stays exactly 0, even for a tile holding NaN
    x[i] = (i < lane) ? T(0) : x[i] * (T(1) / D.at(i, i));
#pragma unroll
    for (int k = i + 1; k < LB; ++k) x[k] -= D.at(k, i) * x[i];
  }
  __syncwarp();  // every lane has read D
#pragma unroll
  for (int i = 0; i < LB; ++i) D.at(i, lane) = x[i];  // 0 above the diagonal
}

// Pairs of the doubling level with half width h blocks: pair s has
// A = [2hs, 2hs + h) and B = [2hs + h, min(2hs + 2h, nb)); only pairs with
// a non-empty B count. Scratch block of T1 (i, j), i < |B|, j < h, of pair
// s: (s h + i) h + j.
__host__ __device__ inline int level_pairs(int nb, int h) {
  return nb > h ? (nb - h - 1) / (2 * h) + 1 : 0;
}
__host__ __device__ inline int scratch_blocks(int nb) {
  int most = 0;
  for (int h = 1; h < nb; h *= 2) {
    const int np = level_pairs(nb, h);
    const int last_b = nb - (2 * h * (np - 1) + h);
    const int need = ((np - 1) * h + (last_b < h ? last_b : h)) * h;
    if (need > most) most = need;
  }
  return most;
}

// Warp task t -> block k of a level's list of n blocks (two tasks, 64
// threads, a block): the warps take the list in rounds of TI_WARPS / 2
// blocks, every other round backwards, so with the list sorted longest
// first each warp's rounds add up to about the same number of products.
__device__ __forceinline__ int snake(int t, int n) {
  constexpr int per_round = TI_WARPS / 2;
  const int r = t / TI_WARPS, pos = (t % TI_WARPS) >> 1;
  const int in_round = min(per_round, n - r * per_round);
  return r * per_round + ((r & 1) ? in_round - 1 - pos : pos);
}

template <typename T, bool RES, bool VEC>
__global__ void __launch_bounds__(TI_THREADS)
tri_inv_kernel(const T* L, ll ldl, ll sl, T* X, ll ldx, ll sx, int b) {
  constexpr int VW = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  L += (ll)blockIdx.x * sl;
  X += (ll)blockIdx.x * sx;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = b / LB;
  T* tri = reinterpret_cast<T*>(smem_raw);
  T* scratch = tri + (size_t)nb * (nb + 1) / 2 * LB * LB;  // resident route only
  const TriStore<T, RES, VEC> st{RES ? tri : X, RES ? (ll)LB : ldx};

  // L's lower blocks, a warp a row, 16 bytes a lane (the diagonal blocks
  // whole: their upper halves are overwritten by invert_diag)
  for (int i = warp; i < b; i += TI_WARPS)
    for (int c = lane * VW; c < (i / LB + 1) * LB; c += 32 * VW) {
      const T* src = L + (ll)i * ldl + c;
      if constexpr (RES) {
        copy_in<T, VEC>(st.blk(i / LB, c / LB), i % LB, c % LB, src);
      } else {
        Vec<T> v;
#pragma unroll
        for (int x = 0; x < VW; ++x) v.e[x] = src[x];
        store_row<T, VEC>(X + (ll)i * ldx + c, v);
      }
    }
  if constexpr (RES) copy_in_wait();
  __syncthreads();
  if (warp < nb) invert_diag<T>(st.blk(warp, warp), lane);  // nb <= 16 warps
  __syncthreads();

  // T1 block (i, j) of pair s at level h: in the scratch (resident), or in
  // X's block (J, I) = (2hs + j, 2hs + h + i) of the upper triangle
  const auto t1 = [&](int h, int s, int i, int j) {
    if constexpr (RES)
      return Blk<T, true, VEC>{scratch + (ll)((s * h + i) * h + j) * LB * LB, LB};
    else
      return st.blk(2 * h * s + j, 2 * h * s + h + i);
  };
  for (int h = 1; h < nb; h *= 2) {
    const int np = level_pairs(nb, h), ntask = 2 * np * h * h;
    // T1 = C A^-1: T1(I, J) = sum_{J <= K < b0} X(I, K) X(K, J), h - j terms:
    // blocks taken in order of j, the longest first
    for (int t = warp; t < ntask; t += TI_WARPS) {
      const int k = snake(t, np * h * h), j = k / (np * h), s = (k / h) % np, i = k % h;
      const int a0 = 2 * h * s, b0 = a0 + h, I = b0 + i, J = a0 + j;
      if (I >= nb) continue;
      const int q = ((t & 1) << 5) | lane;
      T acc[4][4] = {};
      for (int K = J; K < b0; ++K) nn_acc(acc, st.blk(I, K), st.blk(K, J), q);
      nn_store(t1(h, s, i, j), acc, T(1), q);
    }
    __syncthreads();
    // X_BA = -B^-1 T1: X(I, J) = -sum_{b0 <= K <= I} X(I, K) T1(K, J),
    // i + 1 terms: blocks taken in order of i, the longest first
    for (int t = warp; t < ntask; t += TI_WARPS) {
      const int k = snake(t, np * h * h), i = h - 1 - k / (np * h), s = (k / h) % np, j = k % h;
      const int a0 = 2 * h * s, b0 = a0 + h, I = b0 + i, J = a0 + j;
      if (I >= nb) continue;
      const int q = ((t & 1) << 5) | lane;
      T acc[4][4] = {};
      for (int K = b0; K <= I; ++K) nn_acc(acc, st.blk(I, K), t1(h, s, K - b0, j), q);
      nn_store(st.blk(I, J), acc, T(-1), q);
    }
    __syncthreads();
  }

  // X once to `out` (resident), or the upper blocks of `out` zeroed
  for (int i = warp; i < b; i += TI_WARPS)
    for (int c = lane * VW; c < b; c += 32 * VW) {
      if (!RES && c / LB <= i / LB) continue;
      Vec<T> v;
      if (RES && c / LB <= i / LB) {
        v = st.blk(i / LB, c / LB).ldv(i % LB, c % LB);
      } else {
#pragma unroll
        for (int x = 0; x < VW; ++x) v.e[x] = T(0);
      }
      store_row<T, VEC>(X + (ll)i * ldx + c, v);
    }
}

template <typename T, bool RES, bool VEC>
static int launch_variant(const T* L, ll ldl, ll sl, T* X, ll ldx, ll sx, int b, int ntiles,
                          size_t smem, cudaStream_t stream) {
  if (const int err = dyn_smem_upto<tri_inv_kernel<T, RES, VEC>, LEAF_SMEM_BOUND>(smem))
    return err;
  tri_inv_kernel<T, RES, VEC><<<ntiles, TI_THREADS, smem, stream>>>(L, ldl, sl, X, ldx, sx, b);
  RETURN_LAUNCH_STATUS();
}

template <typename T>
static int launch(const void* Lp, ll ldl, ll sl, void* Xp, ll ldx, ll sx, int b, int ntiles,
                  void* stream) {
  if (b <= 0 || b % LB != 0 || b > 512 || ntiles <= 0) return (int)cudaErrorInvalidValue;
  constexpr int VW = 16 / sizeof(T);
  const int nb = b / LB;
  const size_t smem = tri_bytes(nb, sizeof(T)) + (size_t)scratch_blocks(nb) * LB * LB * sizeof(T);
  const bool res = smem <= leaf_smem_limit();
  const bool vec = ((uintptr_t)Lp % 16 == 0) && ((uintptr_t)Xp % 16 == 0) && ldl % VW == 0 &&
                   ldx % VW == 0 && sl % VW == 0 && sx % VW == 0;
  const T* l = (const T*)Lp;
  T* x = (T*)Xp;
  cudaStream_t s = (cudaStream_t)stream;
  if (res) {
    return vec ? launch_variant<T, true, true>(l, ldl, sl, x, ldx, sx, b, ntiles, smem, s)
               : launch_variant<T, true, false>(l, ldl, sl, x, ldx, sx, b, ntiles, smem, s);
  }
  return vec ? launch_variant<T, false, true>(l, ldl, sl, x, ldx, sx, b, ntiles, 0, s)
             : launch_variant<T, false, false>(l, ldl, sl, x, ldx, sx, b, ntiles, 0, s);
}

// T tiles: tile t at L + t sl (leading dimension ldl) -> X + t sx (ldx);
// one tile is ntiles = 1, sl = sx = 0
extern "C" int tri_inv_f32(const void* L, ll ldl, ll sl, void* X, ll ldx, ll sx, int b,
                           int ntiles, void* s) {
  return launch<float>(L, ldl, sl, X, ldx, sx, b, ntiles, s);
}
extern "C" int tri_inv_f64(const void* L, ll ldl, ll sl, void* X, ll ldx, ll sx, int b,
                           int ntiles, void* s) {
  return launch<double>(L, ldl, sl, X, ldx, sx, b, ntiles, s);
}
