// Exact (unbanded) Myers bit-parallel edit distance, one thread per problem
// (Hopper, sm_90a).
//
// Replaces the TPU kernel muchsalsa_tpu/ops/myers_full_pallas.py::_kernel
// (launched by myers_edit_distance_pallas).  Contract, identical to
// muchsalsa_tpu/ops/myers_jax.py::myers_edit_distance:
//
//   q (P, M) uint8 codes padded with 5, t (P, N) uint8 padded with 4,
//   m = q_len[p], n = t_len[p] (int32, m <= M, n <= N).
//   PEq[c] has bit i % 32 of word i / 32 set where q[i] == c, c in 0..3, so
//   code 4 (N) matches nothing.  VP starts all ones, VN zero, score = m.
//   For text columns j < min(n, cols): one Myers 1999 block step per
//   pattern word, the horizontal carry running from word 0 (hin = +1) to the
//   last; the score moves by the +1/-1 horizontal delta at pattern row m-1
//   (bit (m-1) % 32 of word (m-1) / 32, read before the shift).
//   m == 0 gives n.
//
// What bounds it on the card: the recurrence is serial in the text columns
// and, inside a column, in the pattern words (the horizontal carry), so each
// problem is one dependent chain of ~20 integer ops per (column, word) and
// the card's parallelism is across problems only.  Each (column, word) step
// reads and writes 8 bytes of VP/VN and reads 4 bytes of PEq: for patterns of
// up to a few kb the state does not fit in registers.
//
// What the design does about it: one thread per problem.  Up to 32 words
// (patterns of up to 1 kb, the 1 kb unitig regions of refinement), VP/VN live
// in registers (a template on the word count rounded up to a power of two, so
// the word loop unrolls and the column's PEq loads are all independent and
// in flight together).  Longer patterns keep VP/VN in a global scratch laid
// out [word][problem]; the word count has no compile-time cap.  PEq is
// [c][word][problem] in device memory, so the 32 threads of a warp touch 32
// neighbouring words at every step (one 128-byte transaction), and for a
// batch of tens of thousands of 1 kb patterns (tens of MB) it stays largely
// in the 50 MB L2.  A thread stops at its own last column min(n, cols), and
// runs only the words up to the one that holds row m-1: rows below it never
// feed the score (the carry flows down), so the result is the same.  Text
// bytes are read per thread from its own row.  Faster designs (a warp per
// long pattern, coalesced text tiles in shared memory, PEq in shared
// memory) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "myers_common.cuh"

namespace {

using ms::kThreads;

__global__ void __launch_bounds__(kThreads)
myers_full_kernel(const uint8_t* __restrict__ t,
                  const int32_t* __restrict__ q_len,
                  const int32_t* __restrict__ t_len,
                  const uint32_t* __restrict__ peq,
                  uint32_t* __restrict__ vp_s, uint32_t* __restrict__ vn_s,
                  int32_t* __restrict__ out,
                  int P, int N, int n_words, int cols) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int m = q_len[p];
  const int n = t_len[p];
  if (m <= 0) {
    out[p] = n;
    return;
  }
  const int last_word = (m - 1) / 32;
  const int last_bit = (m - 1) % 32;
  const long long plane = static_cast<long long>(n_words) * P;
  for (int w = 0; w <= last_word; ++w) {
    vp_s[static_cast<long long>(w) * P + p] = 0xFFFFFFFFu;
    vn_s[static_cast<long long>(w) * P + p] = 0u;
  }
  const uint8_t* row = t + static_cast<long long>(p) * N;
  const int last_col = n < cols ? n : cols;
  int score = m;
  for (int j = 0; j < last_col; ++j) {
    const int c = row[j];
    const uint32_t* peq_c = peq + (c < 4 ? c : 0) * plane + p;
    int hin = 1;
    for (int w = 0; w <= last_word; ++w) {
      const long long at = static_cast<long long>(w) * P;
      uint32_t vp = vp_s[at + p];
      uint32_t vn = vn_s[at + p];
      uint32_t ph, mh;
      const int hout = ms::myers_word_step(c < 4 ? peq_c[at] : 0u, hin, vp, vn, ph, mh);
      if (w == last_word) {
        score += static_cast<int>((ph >> last_bit) & 1u) -
                 static_cast<int>((mh >> last_bit) & 1u);
      }
      vp_s[at + p] = vp;
      vn_s[at + p] = vn;
      hin = hout;
    }
  }
  out[p] = score;
}

// The same recurrence with VP/VN in registers, for n_words <= W <= 32.
template <int W>
__global__ void __launch_bounds__(kThreads)
myers_full_regs_kernel(const uint8_t* __restrict__ t,
                       const int32_t* __restrict__ q_len,
                       const int32_t* __restrict__ t_len,
                       const uint32_t* __restrict__ peq,
                       int32_t* __restrict__ out,
                       int P, int N, int n_words, int cols) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int m = q_len[p];
  const int n = t_len[p];
  if (m <= 0) {
    out[p] = n;
    return;
  }
  const int last_word = (m - 1) / 32;
  const int last_bit = (m - 1) % 32;
  const long long plane = static_cast<long long>(n_words) * P;
  uint32_t vp[W], vn[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    vp[w] = 0xFFFFFFFFu;
    vn[w] = 0u;
  }
  const uint8_t* row = t + static_cast<long long>(p) * N;
  const int last_col = n < cols ? n : cols;
  int score = m;
  for (int j = 0; j < last_col; ++j) {
    const int c = row[j];
    const uint32_t* peq_c = peq + (c < 4 ? c : 0) * plane + p;
    int hin = 1;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (w <= last_word) {
        uint32_t ph, mh;
        const int hout = ms::myers_word_step(
            c < 4 ? peq_c[static_cast<long long>(w) * P] : 0u, hin, vp[w], vn[w], ph, mh);
        if (w == last_word) {
          score += static_cast<int>((ph >> last_bit) & 1u) -
                   static_cast<int>((mh >> last_bit) & 1u);
        }
        hin = hout;
      }
    }
  }
  out[p] = score;
}

template <int W>
cudaError_t launch_regs(const uint8_t* t, const int32_t* ql, const int32_t* tl,
                        const uint32_t* peq, int32_t* out, int P, int N, int n_words,
                        int cols, cudaStream_t s) {
  myers_full_regs_kernel<W><<<(P + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      t, ql, tl, peq, out, P, N, n_words, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the PEq build and the distance kernel on `stream` (a
// cudaStream_t).  peq (4 * n_words * P), vp and vn (n_words * P each) are
// uint32 scratch that the caller allocates (vp and vn are used only when
// n_words > 32); out is (P,) int32.  Returns
// cudaGetLastError() after the launches: 0 when both were accepted.
int ms_myers_full(const void* q, const void* q_len, const void* t, const void* t_len,
                  void* out, void* peq, void* vp, void* vn,
                  int P, int M, int N, int n_words, int cols, void* stream) {
  if (P < 1 || M < 0 || N < 0 || n_words < 1 || n_words * 32 < M || cols < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(P) * n_words;
  ms::build_peq_kernel<<<static_cast<unsigned>((cells + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(q), static_cast<uint32_t*>(peq), P, M, n_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* tt = static_cast<const uint8_t*>(t);
  const auto* ql = static_cast<const int32_t*>(q_len);
  const auto* tl = static_cast<const int32_t*>(t_len);
  const auto* pq = static_cast<const uint32_t*>(peq);
  auto* o = static_cast<int32_t*>(out);
  if (n_words <= 1) return static_cast<int>(launch_regs<1>(tt, ql, tl, pq, o, P, N, n_words, cols, s));
  if (n_words <= 2) return static_cast<int>(launch_regs<2>(tt, ql, tl, pq, o, P, N, n_words, cols, s));
  if (n_words <= 4) return static_cast<int>(launch_regs<4>(tt, ql, tl, pq, o, P, N, n_words, cols, s));
  if (n_words <= 8) return static_cast<int>(launch_regs<8>(tt, ql, tl, pq, o, P, N, n_words, cols, s));
  if (n_words <= 16) return static_cast<int>(launch_regs<16>(tt, ql, tl, pq, o, P, N, n_words, cols, s));
  if (n_words <= 32) return static_cast<int>(launch_regs<32>(tt, ql, tl, pq, o, P, N, n_words, cols, s));
  myers_full_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      tt, ql, tl, pq, static_cast<uint32_t*>(vp), static_cast<uint32_t*>(vn), o,
      P, N, n_words, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
