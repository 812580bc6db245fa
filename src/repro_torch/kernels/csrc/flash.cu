// flash_attention, the f32 route: causal (or full) GQA attention with an
// online softmax in IEEE f32 on the CUDA cores.
//
// Replaces the Pallas kernel repro/kernels/flash.py:flash_attention (and its
// batched wrapper flash_attention_bshd), the prefill attention of the model
// zoo's dense family (models/attention.py), for f32 operands; bf16 and f16
// operands go to the tensor-core kernel in flash_tc.cuh (kernels/flash.py
// routes by dtype). q is [B, S, H, hd], k and v are
// [B, T, KV, hd] with H = KV * G; query head h reads kv head h / G, so
// repeated K/V are never materialized. Every operand is read, and the
// output written, through its batch, sequence and head strides with a unit
// head-dim stride: the [B, S, H, hd] activations of the model need no
// transposed copy, and the [H, S, hd] layout of the TPU kernel is the same
// call with B = 1.
//
// What it computes is the body of the Pallas kernel: s = (q * hd^-0.5) k^T
// in f32, masked with -1e30 (not -inf) where k_index > q_index (the causal
// mask is top-left aligned, both indices from 0, also when S != T) and where
// k_index >= T; the running max m, corr = exp(m_prev - m_new), the row sum l
// and the accumulator acc all in f32, with p kept in f32 for p v; the output
// acc / max(l, 1e-30).
//
// Bound on this card: at the model's prefill shapes the work is
// 4 B H hd S (S + 1) / 2 operations (the causal half of QK^T and PV) on
// 4 (B S H + 2 B T KV) hd bytes: at gemma-2b's B = 4, S = 2048, H = 8,
// hd = 256 that is 68.7 GFLOP on 84 MB, so operations bound it (1.0 ms at
// the f32 CUDA-core rate).
//
// Design, simple and right first: one CTA of 256 threads per (batch * head,
// 64-row q block). The q tile, pre-scaled in f32, stays in shared memory
// (transposed, so that the 16 threads of a row read it as a broadcast); the
// CTA walks the 64-row kv blocks up to the diagonal (blocks past it are
// skipped, as the TPU kernel skips them with pl.when). Each kv block goes
// through one shared buffer twice: first K (transposed) for the 64 x 64
// score tile, then V for the 64 x hd update. Thread (tx, ty) owns rows
// ty + 16 r (r < 4) of the tile: 4 x 4 scores and 4 x hd/16 accumulator
// columns tx + 16 c, all in registers, with f32 SIMT FMAs; the row max and
// sum are reduced across the 16 threads of a row with shuffles. At hd = 256
// the shared memory is 146 KiB (the q tile and the k/v buffer 65 KiB each,
// p 16 KiB), above the 48 KiB default, hence cudaFuncSetAttribute. f32 on
// the tensor cores (TF32) would round q, k, p and v to 10 bits, so this
// route stays on the CUDA cores.
#include "common.cuh"

namespace {

constexpr int FB_Q = 64, FB_K = 64, F_THREADS = 256;
constexpr int LQ = FB_Q + 1, LK = FB_K + 1;  // padded rows: no bank conflicts
constexpr float F_NEG_INF = -1e30f;

template <int HD> constexpr size_t smem_bytes() {
  return sizeof(float) * (HD * LQ + HD * LK + FB_Q * LK);
}

template <int HD>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_kernel(const float* __restrict__ q, ll qsb, ll qss, ll qsh,
             const float* __restrict__ k, ll ksb, ll kss, ll ksh,
             const float* __restrict__ v, ll vsb, ll vss, ll vsh,
             float* __restrict__ o, ll osb, ll oss, ll osh,
             int H, int G, int S, int Tk, float scale, int causal) {
  static_assert(HD % 16 == 0 && FB_K * HD <= HD * LK, "tile shapes");
  constexpr int NC = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;            // Qt[d * LQ + i] = q[q0 + i][d] * scale
  float* KV = Qt + HD * LQ;    // Kt[d * LK + j] = k[k0 + j][d]; then V[j * HD + d]
  float* Ps = KV + HD * LK;    // Ps[i * LK + j] = p[i][j]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, kh = h / G;
  const int q0 = blockIdx.x * FB_Q;
  const float* qp = q + b * qsb + h * qsh;
  const float* kp = k + b * ksb + kh * ksh;
  const float* vp = v + b * vsb + kh * vsh;

  // q * scale rounded in f32, as the reference scales before its product
  for (int e = tid; e < FB_Q * HD; e += F_THREADS) {
    const int i = e / HD, d = e - i * HD, gi = q0 + i;
    Qt[d * LQ + i] = gi < S ? qp[(ll)gi * qss + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = F_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  // keys past the last row of this q block are all masked: stop there
  const int kend = causal ? min(Tk, q0 + FB_Q) : Tk;
  for (int k0 = 0; k0 < kend; k0 += FB_K) {
    __syncthreads();  // Qt written; the previous block's V and p read
    for (int e = tid; e < FB_K * HD; e += F_THREADS) {
      const int j = e / HD, d = e - j * HD, gj = k0 + j;
      KV[d * LK + j] = gj < Tk ? kp[(ll)gj * kss + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Qt[d * LQ + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bk[c] = KV[d * LK + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
    }

    // online softmax; the 16 threads of a row are one half-warp
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
      float mx = F_NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        if (kj >= Tk || (causal && kj > qi)) s[r][c] = F_NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float corr = expf(m[r] - mn);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - mn);
        ps += s[r][c];
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * corr + ps;
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(ty + 16 * r) * LK + tx + 16 * c] = s[r][c];
    }
    __syncthreads();  // every thread is done with K

    for (int e = tid; e < FB_K * HD; e += F_THREADS) {
      const int j = e / HD, d = e - j * HD, gj = k0 + j;
      KV[j * HD + d] = gj < Tk ? vp[(ll)gj * vss + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < FB_K; ++j) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Ps[(ty + 16 * r) * LK + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = KV[j * HD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(a[r], vv, acc[r][c]);
      }
    }
  }

  float* op = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) op[(ll)qi * oss + tx + 16 * c] = acc[r][c] / den;
  }
}

template <int HD>
int launch(const void* q, ll qsb, ll qss, ll qsh, const void* k, ll ksb, ll kss, ll ksh,
           const void* v, ll vsb, ll vss, ll vsh, void* o, ll osb, ll oss, ll osh, int B,
           int H, int KV, int S, int Tk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  if (const int err = dyn_smem<flash_kernel<HD>, (int)smem>()) return err;
  const dim3 grid((S + FB_Q - 1) / FB_Q, B * H);
  flash_kernel<HD><<<grid, F_THREADS, smem, stream>>>(
      (const float*)q, qsb, qss, qsh, (const float*)k, ksb, kss, ksh, (const float*)v, vsb,
      vss, vsh, (float*)o, osb, oss, osh, H, H / KV, S, Tk, scale, causal);
  RETURN_LAUNCH_STATUS();
}

}  // namespace

// hd is one of the dense configs' head dims (DISPATCH_HEAD_DIM); any other
// returns cudaErrorInvalidValue.
extern "C" int flash_attention_f32(const void* q, ll qsb, ll qss, ll qsh, const void* k,
                                   ll ksb, ll kss, ll ksh, const void* v, ll vsb, ll vss,
                                   ll vsh, void* o, ll osb, ll oss, ll osh, int B, int H,
                                   int KV, int S, int Tk, int hd, float scale, int causal,
                                   void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_HEAD_DIM(hd, launch<HD>(q, qsb, qss, qsh, k, ksb, kss, ksh, v, vsb, vss, vsh, o,
                                   osb, oss, osh, B, H, KV, S, Tk, scale, causal, st))
}
