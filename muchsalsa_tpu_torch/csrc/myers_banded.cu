// Banded Myers bit-parallel edit distance with a static band, one thread per
// problem (Hopper, sm_90a).
//
// Replaces the TPU kernel muchsalsa_tpu/ops/myers_pallas.py::_kernel
// (launched by myers_banded_pallas), together with the XLA epilogue that
// follows it there (myers_pallas.py:246-263).  Contract, identical to
// myers_banded_pallas:
//
//   q (P, M) uint8 padded with 5, t (P, N) uint8 padded with 4, int32
//   lengths m, n.  Static geometry for WB window words (_geometry):
//   khi = 32 (WB / 2) + 1, klo = khi - 32 WB + 1, h = (khi - 1) / 32;
//   n_words = max(ceil(M / 32), WB) + WB + 2 and max_wb = n_words - WB
//   depend on the batch's padded M.  A problem is in the band when
//   n - m - klo >= 32, khi - (n - m) >= 32, m > 0 and n > 0; otherwise it
//   runs no column and returns -1.
//   The window VP/VN (WB words, all ones / zero) starts at the bottom-row
//   score 32 WB.  Text column j = 32 b + col + 1 of block b runs the block
//   step over the WB words of PEq window clip(b - h, 0, max_wb) while
//   j <= n; at the start of block b with h < b <= h + max_wb and
//   32 b + 1 <= n the window moves up one word (a fresh all-ones / zero
//   word enters at the bottom).  The score moves by the bottom word's
//   horizontal output.  Afterwards wb_p = clip(max(0, n - khi) / 32, 0,
//   max_wb): score += 32 wb_p, then minus the VP bits and plus the VN bits
//   of the window's rows below m - 1; -1 unless the window reached row m-1.
//
// What bounds it on the card: the same serial recurrence as the exact
// kernel, but over WB <= 8 words, so the state (VP, VN and the 4 x WB PEq
// words of the current window) fits in registers and each column is ~20 WB
// dependent integer ops with one text byte read.  Parallelism is across
// problems only.
//
// What the design does about it: one thread per problem, VP/VN and the PEq
// window in registers (the template on WB unrolls every word loop), PEq read
// from device memory once per 32-column block, [c][word][problem] so a warp's
// loads are coalesced.  The text is read byte by byte from the thread's own
// row; a thread stops at its own last column.  The epilogue (window-advance
// bookkeeping and the popcount walk) runs in the kernel.  There is no
// materialised per-block PEq window as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

#include "myers_common.cuh"

namespace {

using ms::kThreads;

template <int WB>
__global__ void __launch_bounds__(kThreads)
myers_banded_kernel(const uint8_t* __restrict__ t,
                    const int32_t* __restrict__ q_len,
                    const int32_t* __restrict__ t_len,
                    const uint32_t* __restrict__ peq,
                    int32_t* __restrict__ out,
                    int P, int N, int n_words, int n_blocks, int klo, int khi, int h) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int m = q_len[p];
  const int n = t_len[p];
  const int diff = n - m;
  const bool in_band = (diff - klo >= 32) && (khi - diff >= 32) && m > 0 && n > 0;
  if (!in_band) {
    out[p] = -1;
    return;
  }
  const int max_wb = n_words - WB;
  const long long plane = static_cast<long long>(n_words) * P;
  const uint8_t* row = t + static_cast<long long>(p) * N;

  uint32_t vp[WB], vn[WB], pe[4][WB];
#pragma unroll
  for (int w = 0; w < WB; ++w) {
    vp[w] = 0xFFFFFFFFu;
    vn[w] = 0u;
  }
  int score = WB * 32;
  for (int b = 0; b < n_blocks && 32 * b + 1 <= n; ++b) {
    if (b > h && b <= h + max_wb) {
#pragma unroll
      for (int w = 0; w + 1 < WB; ++w) {
        vp[w] = vp[w + 1];
        vn[w] = vn[w + 1];
      }
      vp[WB - 1] = 0xFFFFFFFFu;
      vn[WB - 1] = 0u;
    }
    int wb = b - h;
    wb = wb < 0 ? 0 : (wb > max_wb ? max_wb : wb);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int w = 0; w < WB; ++w)
        pe[c][w] = peq[c * plane + static_cast<long long>(wb + w) * P + p];
    }
    const int j_end = min(32 * b + 32, n);
    for (int j = 32 * b + 1; j <= j_end; ++j) {
      const int c = row[j - 1];
      int hin = 1;
#pragma unroll
      for (int w = 0; w < WB; ++w) {
        const uint32_t eq = c == 0 ? pe[0][w] : c == 1 ? pe[1][w]
                          : c == 2 ? pe[2][w] : c == 3 ? pe[3][w] : 0u;
        uint32_t ph, mh;
        hin = ms::myers_word_step(eq, hin, vp[w], vn[w], ph, mh);
      }
      score += hin;  // the bottom word's horizontal output
    }
  }

  int wb_p = (n - khi > 0 ? n - khi : 0) / 32;
  wb_p = wb_p > max_wb ? max_wb : wb_p;
  score += wb_p * 32;
  // rows of window word w are 32 (wb_p + w) + bit; count those below m - 1
#pragma unroll
  for (int w = 0; w < WB; ++w) {
    const int below = m - 1 - 32 * (wb_p + w);  // bits <= below lie above row m
    const uint32_t mask = below < 0 ? 0xFFFFFFFFu
                        : (below >= 31 ? 0u : (0xFFFFFFFFu << (below + 1)));
    score += __popc(vn[w] & mask) - __popc(vp[w] & mask);
  }
  const int bottom_row = (wb_p + WB) * 32 - 1;
  const bool ok = bottom_row >= m - 1 && m - 1 >= wb_p * 32 - 1;
  out[p] = ok ? score : -1;
}

template <int WB>
cudaError_t launch(const uint8_t* t, const int32_t* q_len, const int32_t* t_len,
                   const uint32_t* peq, int32_t* out, int P, int N, int n_words,
                   int n_blocks, int klo, int khi, int h, cudaStream_t s) {
  myers_banded_kernel<WB><<<(P + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      t, q_len, t_len, peq, out, P, N, n_words, n_blocks, klo, khi, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the PEq build and the banded kernel on `stream` (a cudaStream_t).
// peq is uint32 scratch of 4 * n_words * P words that the caller allocates;
// out is (P,) int32.  window_words in 1..8.  Returns cudaGetLastError() after
// the launches: 0 when both were accepted.
int ms_myers_banded(const void* q, const void* q_len, const void* t, const void* t_len,
                    void* out, void* peq, int P, int M, int N, int n_words,
                    int window_words, int n_blocks, int klo, int khi, int h,
                    void* stream) {
  if (P < 1 || M < 0 || N < 0 || n_blocks < 1 || window_words < 1 || window_words > 8 ||
      n_words < window_words || n_words * 32 < M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(P) * n_words;
  ms::build_peq_kernel<<<static_cast<unsigned>((cells + kThreads - 1) / kThreads),
                         kThreads, 0, s>>>(
      static_cast<const uint8_t*>(q), static_cast<uint32_t*>(peq), P, M, n_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* tt = static_cast<const uint8_t*>(t);
  const auto* ql = static_cast<const int32_t*>(q_len);
  const auto* tl = static_cast<const int32_t*>(t_len);
  const auto* pq = static_cast<const uint32_t*>(peq);
  auto* o = static_cast<int32_t*>(out);
  switch (window_words) {
    case 1: err = launch<1>(tt, ql, tl, pq, o, P, N, n_words, n_blocks, klo, khi, h, s); break;
    case 2: err = launch<2>(tt, ql, tl, pq, o, P, N, n_words, n_blocks, klo, khi, h, s); break;
    case 3: err = launch<3>(tt, ql, tl, pq, o, P, N, n_words, n_blocks, klo, khi, h, s); break;
    case 4: err = launch<4>(tt, ql, tl, pq, o, P, N, n_words, n_blocks, klo, khi, h, s); break;
    case 5: err = launch<5>(tt, ql, tl, pq, o, P, N, n_words, n_blocks, klo, khi, h, s); break;
    case 6: err = launch<6>(tt, ql, tl, pq, o, P, N, n_words, n_blocks, klo, khi, h, s); break;
    case 7: err = launch<7>(tt, ql, tl, pq, o, P, N, n_words, n_blocks, klo, khi, h, s); break;
    default: err = launch<8>(tt, ql, tl, pq, o, P, N, n_words, n_blocks, klo, khi, h, s); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
