// panel_update: the blocked Cholesky's fused panel step, in place.
//
//   L21 = A21 @ L11^-T        (panel TRSM through the precomputed inverse)
//   C  -= L21 @ L21^T         (trailing update, lower tiles only)
//
// with the precision plan's per-tile roundings. Replaces the Pallas kernel
// repro/kernels/panel.py:panel_update. This is the O(n^3) part of the
// factorization: 2 b^3 flops per lower trailing tile pair, on f32 (or f64)
// data that must stay IEEE, so the bound is the CUDA cores' FP32 rate (no
// tensor cores: TF32 would round the operands).
//
// Design, one panel = six launches on the caller's stream:
//   1. round_rows:  A_r = round(A21) per (b, b) row tile at its storage name
//   2. gemm_plain:  L21 = A_r @ Linv^T, written over A21
//   3. round_rows:  L21 rounded again at its storage names (in place)
//   4. round_rows:  one copy of L21 per distinct pair name, rounded at that
//                   name (at most len(levels) copies). L21 is computed once
//                   per panel; the Pallas kernel recomputes both of a pair's
//                   L21 tiles for every pair, which triples the flops.
//   5. trail_gemm:  every lower tile pair (i, j) on a triangular grid (an
//                   integer decode of the pair index), 64 x 64 sub-blocks,
//                   C_ij - Lq_i Lq_j^T with the pair name's copy. Strictly
//                   lower tiles are written in place, unrounded. A diagonal
//                   tile is written in full to scratch D: its strict upper
//                   half, c_upper - (l l^T)_upper from c's stale upper values,
//                   enters the absmax exactly as in the reference.
//   6. commit:      per tile, the absmax over the whole b x b update (int8 and
//                   quantized f16 scale by it), then the rounding; a diagonal
//                   tile keeps only its lower triangle, so c's upper triangle
//                   is never written.
// The roundings need a whole tile's absmax after its GEMM. A tile is
// b x b = 256 KiB in f32 at b = 256, more than a block's shared memory, so
// the simple right answer is the two passes above (GEMM, then absmax and
// round), at the price of one extra read and write of each updated tile.
// With rounding off, steps 1 and 3 copy / skip and step 6 only commits the
// diagonal tiles' lower halves; step 4 still rounds L21 at the pair names,
// as the reference does.
#include "common.cuh"

constexpr int R_THREADS = 256;

// Round row tile i (rows i*b .. i*b+b-1, b columns) of src into dst.
// code < 0: the tile's code comes from codes[i].
template <typename T>
__global__ void __launch_bounds__(R_THREADS)
round_rows(const T* src, ll lds, T* dst, ll ldd, int b, const int* codes, int code) {
  const int i = blockIdx.x;
  const int rc = code >= 0 ? code : codes[i];
  const T* s = src + (ll)i * b * lds;
  T* d = dst + (ll)i * b * ldd;
  float alpha = 1.0f;
  if (!rc_identity<T>(rc) && rc_scaled(rc)) alpha = rc_alpha(rc, tile_absmax(s, lds, b));
  const bool ident = rc_identity<T>(rc);
  for (int r = 0; r < b; ++r)
    for (int c = threadIdx.x; c < b; c += blockDim.x) {
      const T v = s[r * lds + c];
      d[r * ldd + c] = ident ? v : round_val<T>(v, rc, alpha);
    }
}

// O (M x N) = A (M x K) @ B (K x N), both read through strides.
template <typename T>
__global__ void __launch_bounds__(G_THREADS)
gemm_plain(const T* A, ll sam, ll sak, const T* B, ll sbk, ll sbn, T* O, ll ldo,
           int M, int N, int K) {
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;
  T acc[4][4];
  gemm_block<T, T>(acc, A, sam, sak, B, sbk, sbn, M, N, K, m0, n0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gm = m0 + ty + 16 * r, gn = n0 + tx + 16 * c;
      if (gm < M && gn < N) O[gm * ldo + gn] = acc[r][c];
    }
}

// grid (sub-blocks of a tile, lower tile pairs)
template <typename T>
__global__ void __launch_bounds__(G_THREADS)
trail_gemm(const T* lq, ll slot_stride, T* C, ll ldc, T* D, const int* pair_tab,
           int nt, int b) {
  int i, j;
  tri_decode(blockIdx.y, i, j);
  const int slot = pair_tab[i * nt + j] >> 8;
  const int sub = b / GB_M;
  const int m0 = (blockIdx.x / sub) * GB_M, n0 = (blockIdx.x % sub) * GB_N;
  const T* L = lq + slot * slot_stride;
  T acc[4][4];
  // A = Lq rows of tile i (ld b); B = (Lq rows of tile j)^T
  gemm_block<T, T>(acc, L + (ll)i * b * b, b, 1, L + (ll)j * b * b, 1, b, b, b, b, m0, n0);
  const T* cin = C + (ll)i * b * ldc + (ll)j * b;
  T* out = (i == j) ? D + (ll)i * b * b : C + (ll)i * b * ldc + (ll)j * b;
  const ll ldo = (i == j) ? b : ldc;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int rr = m0 + ty + 16 * r, cc = n0 + tx + 16 * c;
      out[rr * ldo + cc] = cin[rr * ldc + cc] - acc[r][c];
    }
}

// grid (lower tile pairs): absmax, rounding, and the diagonal tiles' commit.
template <typename T>
__global__ void __launch_bounds__(R_THREADS)
commit(T* C, ll ldc, const T* D, const int* pair_tab, int nt, int b, int rounding) {
  int i, j;
  tri_decode(blockIdx.x, i, j);
  const int rc = rounding ? (pair_tab[i * nt + j] & 0xff) : NM_F64;
  const bool ident = rc_identity<T>(rc);
  if (i != j && ident) return;  // already final in place
  const T* src = (i == j) ? D + (ll)i * b * b : C + (ll)i * b * ldc + (ll)j * b;
  const ll lds = (i == j) ? b : ldc;
  T* dst = C + (ll)i * b * ldc + (ll)j * b;
  float alpha = 1.0f;
  if (!ident && rc_scaled(rc)) alpha = rc_alpha(rc, tile_absmax(src, lds, b));
  for (int r = 0; r < b; ++r) {
    const int cend = (i == j) ? r + 1 : b;  // c's upper triangle stays as it was
    for (int c = threadIdx.x; c < cend; c += blockDim.x) {
      const T v = src[r * lds + c];
      dst[r * ldc + c] = ident ? v : round_val<T>(v, rc, alpha);
    }
  }
}

template <typename T>
static int launch(const void* linv, ll ldlinv, void* a21, ll lda, void* c, ll ldc,
                  void* a_r, void* lq, void* diag, const void* store_tab,
                  const void* pair_tab, const int* slot_codes, int nslots, int nt,
                  int b, int rounding, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const int m = nt * b;
  const ll slot_stride = (ll)m * b;
  T* A21 = (T*)a21;
  T* Ar = (T*)a_r;
  T* Lq = (T*)lq;
  const int* stab = (const int*)store_tab;
  const int* ptab = (const int*)pair_tab;
  // 1. incoming panel at its storage names (a plain copy without rounding)
  round_rows<T><<<nt, R_THREADS, 0, stream>>>(A21, lda, Ar, b, b, stab,
                                               rounding ? -1 : NM_F64);
  // 2. L21 = A_r @ Linv^T over A21
  dim3 g2((b + GB_N - 1) / GB_N, (m + GB_M - 1) / GB_M);
  gemm_plain<T><<<g2, G_THREADS, 0, stream>>>(Ar, b, 1, (const T*)linv, 1, ldlinv, A21,
                                              lda, m, b, b);
  // 3. L21 back onto its storage grid
  if (rounding) round_rows<T><<<nt, R_THREADS, 0, stream>>>(A21, lda, A21, lda, b, stab, -1);
  // 4. one rounded copy of L21 per pair name
  for (int s = 0; s < nslots; ++s)
    round_rows<T><<<nt, R_THREADS, 0, stream>>>(A21, lda, Lq + s * slot_stride, b, b,
                                                 nullptr, slot_codes[s]);
  // 5. trailing update of every lower tile pair
  const int ntri = nt * (nt + 1) / 2;
  dim3 g5((b / GB_M) * (b / GB_N), ntri);
  trail_gemm<T><<<g5, G_THREADS, 0, stream>>>(Lq, slot_stride, (T*)c, ldc, (T*)diag, ptab,
                                              nt, b);
  // 6. per-tile absmax + rounding, diagonal tiles' lower halves
  commit<T><<<ntri, R_THREADS, 0, stream>>>((T*)c, ldc, (const T*)diag, ptab, nt, b,
                                            rounding);
  RETURN_LAUNCH_STATUS();
}

#define PANEL_ENTRY(NAME, T)                                                              \
  extern "C" int NAME(const void* linv, ll ldlinv, void* a21, ll lda, void* c, ll ldc,    \
                      void* a_r, void* lq, void* diag, const void* store_tab,             \
                      const void* pair_tab, const int* slot_codes, int nslots, int nt,    \
                      int b, int rounding, void* stream) {                                \
    if (b % GB_M != 0 || nt <= 0) return (int)cudaErrorInvalidValue;                      \
    return launch<T>(linv, ldlinv, a21, lda, c, ldc, a_r, lq, diag, store_tab, pair_tab, \
                     slot_codes, nslots, nt, b, rounding, stream);                        \
  }

PANEL_ENTRY(panel_update_f32, float)
PANEL_ENTRY(panel_update_f64, double)
