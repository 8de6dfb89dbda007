// Banded Myers bit-parallel edit distance with a static band, one thread per
// problem, the window's PEq built in registers and the problems ordered on
// the card (Hopper, sm_90a).
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
// What bounds it on the card: int32 issue.  A (column, word) step is ~15
// int32 ops, WB words a column, each problem one dependent chain along the
// columns and, inside a column, along the words (the horizontal carry); the
// bytes are far below.  The previous design also ran a problem on one
// thread (1,775 warps at the refinement batch of P 56,795, ~13 an SM), but
// a separate pass wrote a 4 x n_words x P PEq scratch that every thread read
// back, 32 words a block; each lane read its text a byte at a time from its
// own row; and a warp ran to its longest problem while finished lanes idled.
//
// What the design does about it:
// - No PEq pass and no scratch: a window slot holds VP, VN and the four PEq
//   words of its pattern word in registers (WB unrolls every word loop); at
//   a window advance the slots shift and the entering word builds its PEq
//   from its 32 query bytes.
// - The launch first orders the problems on the card (a counting sort by
//   32-column blocks of work, two passes of block-local histograms, no
//   sync), so a warp's problems end together and out-of-band ones, with no
//   work, come last; each result goes to its problem's own slot.
// - The warp stages each block's text, 32 rows x 32 columns, through shared
//   memory with one coalesced load a row, instead of 32 lanes loading a
//   byte each from 32 rows.
// - The epilogue (window-advance bookkeeping and the popcount walk) runs in
//   the kernel.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, at the refinement batch
// (P 56,795, M 1,000, N 2,906, 8 words; PERF.md §6), device time: 0.589 ms
// and 0.007 ms of ordering, against the previous design's 0.696 ms and
// 0.102 ms for its PEq pass.
// Tried and dropped, in probes not kept: a problem on L lanes of a warp
// (WB / L words a lane, pipelined along anti-diagonals, with a bubble step
// a block so that a lane can take the next lane's first slot at a window
// advance).  More lanes hide the carry chain's latency with more warps, but
// every lane pays a step's fixed cost (shuffle, code, checks) over fewer
// words: it was slower at every L > 1, the more so the more lanes.  An
// order built with torch's argsort cost more host work in the wrapper's
// call than the whole ordering on the card.  ptxas (sm_90a): 128 registers
// at WB = 8, no spill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kTop = 0x80000000u;

// One Myers 1999 block step of one pattern word for one text column.  eq is
// the word's PEq for the column's code; nmask is all ones for codes 0-3 and
// zero for N.  The horizontal delta entering the word is +1 where bit 31 of
// hp_in is set, -1 where bit 31 of hn_in is set (never both), else 0.
// Updates vp and vn and gives ph and mh before the shift, whose bit 31 is the
// word's output delta.  uint32 arithmetic wraps as the reference's masked
// sum does.
__device__ __forceinline__ void word_step(uint32_t eq, uint32_t nmask, uint32_t hp_in,
                                          uint32_t hn_in, uint32_t& vp, uint32_t& vn,
                                          uint32_t& ph, uint32_t& mh) {
  eq = (eq & nmask) | (hn_in >> 31);
  const uint32_t xv = eq | vn;
  const uint32_t xh = (((eq & vp) + vp) ^ vp) | eq;
  ph = vn | ~(xh | vp);
  mh = vp & xh;
  const uint32_t phs = __funnelshift_l(hp_in, ph, 1);  // (ph << 1) | (hp_in >> 31)
  const uint32_t mhs = __funnelshift_l(hn_in, mh, 1);
  vp = mhs | ~(xv | phs);
  vn = phs & xv;
}

// The PEq word of code c in 0..7 (codes 4-7 pick a word that nmask clears).
__device__ __forceinline__ uint32_t select_eq(int c, uint32_t e0, uint32_t e1, uint32_t e2,
                                              uint32_t e3) {
  const uint32_t lo = (c & 1) ? e1 : e0;
  const uint32_t hi = (c & 1) ? e3 : e2;
  return (c & 2) ? hi : lo;
}

// One window slot: VP, VN and the PEq words of its pattern word.
struct Slot {
  uint32_t vp, vn, e0, e1, e2, e3;
};

// A fresh slot for pattern word `word` of a query row of width M (positions
// >= M count as the padding code 5 and match nothing): VP all ones, VN zero.
__device__ __forceinline__ Slot fresh_slot(const uint8_t* qrow, int M, int word) {
  Slot x = {~0u, 0u, 0u, 0u, 0u, 0u};
  const int base = word * 32;
#pragma unroll 8
  for (int b = 0; b < 32; ++b) {
    const int i = base + b;
    const int c = i < M ? qrow[i] : 5;
    const uint32_t bit = 1u << b;
    x.e0 |= c == 0 ? bit : 0u;
    x.e1 |= c == 1 ? bit : 0u;
    x.e2 |= c == 2 ? bit : 0u;
    x.e3 |= c == 3 ? bit : 0u;
  }
  return x;
}

template <int WB>
__global__ void __launch_bounds__(kThreads)
myers_banded_kernel(const uint8_t* __restrict__ q, const int32_t* __restrict__ q_len,
                    const uint8_t* __restrict__ t, const int32_t* __restrict__ t_len,
                    const int32_t* __restrict__ order, int32_t* __restrict__ out, int P, int M,
                    int N, int n_words, int n_blocks, int klo, int khi, int h) {
  // the warp's 32 text rows of the current block
  __shared__ uint8_t tile[kWarpsPerBlock][32][33];
  const int lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) * 32;
  // warps never synchronise across the block, so a whole warp may leave
  if (first >= P) return;
  const bool has = first + lane < P;
  const int p = has ? order[first + lane] : 0;
  const int m = has ? q_len[p] : 0;
  const int n = has ? t_len[p] : 0;
  const int diff = n - m;
  const bool in_band = has && (diff - klo >= 32) && (khi - diff >= 32) && m > 0 && n > 0;
  const int max_wb = n_words - WB;
  // columns 0 .. cols - 1 of this problem: blocks b < n_blocks, columns < n
  const int cols = in_band ? min(n, 32 * n_blocks) : 0;
  const int blocks = __reduce_max_sync(kFull, (cols + 31) / 32);

  const uint8_t* qrow = q + static_cast<long long>(p) * M;
  Slot s[WB];
#pragma unroll
  for (int i = 0; i < WB; ++i)
    s[i] = cols > 0 ? fresh_slot(qrow, M, i) : Slot{~0u, 0u, 0u, 0u, 0u, 0u};

  uint8_t(*rows)[33] = tile[threadIdx.x >> 5];
  int acc = 0;  // the bottom word's outputs
  for (int b = 0; b < blocks; ++b) {
    // block b's text, row by row, one coalesced load a row (not a byte
    // from each of 32 rows at once)
    __syncwarp();
    for (int r = 0; r < 32; ++r) {
      const int pr = __shfl_sync(kFull, p, r);
      const int jr = 32 * b + lane;
      rows[r][lane] = jr < __shfl_sync(kFull, cols, r) ? t[static_cast<long long>(pr) * N + jr]
                                                        : 4;
    }
    __syncwarp();
    const int end = min(32, cols - 32 * b);
    if (end <= 0) continue;
    if (b > h && b <= h + max_wb) {
      // the window moves up one word; the entering one is clip(b - h) + WB - 1
#pragma unroll
      for (int i = 0; i + 1 < WB; ++i) s[i] = s[i + 1];
      s[WB - 1] = fresh_slot(qrow, M, b - h + WB - 1);
    }
    for (int col = 0; col < end; ++col) {
      const int c = rows[lane][col];
      const uint32_t nmask = c < 4 ? ~0u : 0u;
      uint32_t hp = kTop, hn = 0u;  // +1 enters the top word
#pragma unroll
      for (int i = 0; i < WB; ++i) {
        uint32_t ph, mh;
        word_step(select_eq(c, s[i].e0, s[i].e1, s[i].e2, s[i].e3), nmask, hp, hn, s[i].vp,
                  s[i].vn, ph, mh);
        hp = ph;
        hn = mh;
      }
      acc += (hp & kTop) ? 1 : ((hn & kTop) ? -1 : 0);
    }
  }
  if (!has) return;

  // the epilogue: window bookkeeping and the rows below m - 1
  int wb_p = (n - khi > 0 ? n - khi : 0) / 32;
  wb_p = wb_p > max_wb ? max_wb : wb_p;
  int score = WB * 32 + wb_p * 32 + acc;
#pragma unroll
  for (int i = 0; i < WB; ++i) {
    // rows of window word i are 32 (wb_p + i) + bit; count those below m - 1
    const int below = m - 1 - 32 * (wb_p + i);  // bits <= below lie above row m
    const uint32_t mask = below < 0 ? ~0u : (below >= 31 ? 0u : (~0u << (below + 1)));
    score += __popc(s[i].vn & mask) - __popc(s[i].vp & mask);
  }
  const int bottom_row = (wb_p + WB) * 32 - 1;
  const bool ok = in_band && bottom_row >= m - 1 && m - 1 >= wb_p * 32 - 1;
  out[p] = ok ? score : -1;
}

// The warps' problem order: a counting sort of the problems by their 32-column
// blocks of work, the most first; a problem outside the band's n - m has
// none and comes last.  Past kMaxBuckets - 1 blocks a bucket spans `step`
// blocks.  Within a bucket the order is that of the atomics.
constexpr int kMaxBuckets = 1024;

__device__ __forceinline__ int order_bucket(const int32_t* q_len, const int32_t* t_len, int p,
                                            int lo, int hi, int n_blocks, int step) {
  const int n = t_len[p];
  const int diff = n - q_len[p];
  const int work = diff >= lo && diff <= hi ? min(n, 32 * n_blocks) : 0;
  return (n_blocks - (work + 31) / 32) / step;
}

// Each block counts its problems per bucket in shared memory; with `order`
// null it adds its counts to counts[], else it takes a range of each
// bucket's slots from offsets[] (= counts after the prefix sum) and places
// its problems there.
__global__ void __launch_bounds__(kThreads)
order_pass(const int32_t* __restrict__ q_len, const int32_t* __restrict__ t_len,
           int32_t* __restrict__ counts, int32_t* __restrict__ order, int P, int lo, int hi,
           int n_blocks, int step, int buckets) {
  __shared__ int32_t local[kMaxBuckets];
  for (int i = threadIdx.x; i < buckets; i += kThreads) local[i] = 0;
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int bucket = p < P ? order_bucket(q_len, t_len, p, lo, hi, n_blocks, step) : 0;
  const int rank = p < P ? atomicAdd(&local[bucket], 1) : 0;
  __syncthreads();
  for (int i = threadIdx.x; i < buckets; i += kThreads) {
    const int c = local[i];
    if (c) local[i] = atomicAdd(&counts[i], c);  // the block's first slot of bucket i
  }
  __syncthreads();
  if (order != nullptr && p < P) order[local[bucket] + rank] = p;
}

// counts[0 .. n) -> their exclusive prefix sums, in one thread
__global__ void order_offsets(int32_t* __restrict__ counts, int n) {
  int sum = 0;
  for (int i = 0; i < n; ++i) {
    const int c = counts[i];
    counts[i] = sum;
    sum += c;
  }
}

// Writes the order to scratch[0 .. P), with scratch[P .. P + kMaxBuckets)
// the bucket counters.
cudaError_t launch_order(const int32_t* ql, const int32_t* tl, int32_t* scratch, int P,
                         int n_blocks, int lo, int hi, cudaStream_t s) {
  const int step = n_blocks / kMaxBuckets + 1;
  const int buckets = n_blocks / step + 1;
  int32_t* counts = scratch + P;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * buckets, s);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((P + kThreads - 1) / kThreads);
  order_pass<<<blocks, kThreads, 0, s>>>(ql, tl, counts, nullptr, P, lo, hi, n_blocks, step,
                                         buckets);
  order_offsets<<<1, 1, 0, s>>>(counts, buckets);
  order_pass<<<blocks, kThreads, 0, s>>>(ql, tl, counts, scratch, P, lo, hi, n_blocks, step,
                                         buckets);
  return cudaGetLastError();
}

template <int WB>
cudaError_t launch(const uint8_t* q, const int32_t* ql, const uint8_t* t, const int32_t* tl,
                   const int32_t* order, int32_t* out, int P, int M, int N, int n_words,
                   int n_blocks, int klo, int khi, int h, cudaStream_t s) {
  const long long warps = (static_cast<long long>(P) + 31) / 32;
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  myers_banded_kernel<WB><<<blocks, kThreads, 0, s>>>(q, ql, t, tl, order, out, P, M, N,
                                                     n_words, n_blocks, klo, khi, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the ordering kernels and the banded kernel on `stream` (a
// cudaStream_t).  scratch is (P + 1024,) int32 for the problems' order and
// its counters; out is (P,) int32.  window_words in 1..8.  Returns
// cudaGetLastError() after the launches: 0 when all were accepted.
int ms_myers_banded(const void* q, const void* q_len, const void* t, const void* t_len,
                    void* scratch, void* out, int P, int M, int N, int n_words,
                    int window_words, int n_blocks, int klo, int khi, int h, void* stream) {
  if (P < 1 || M < 0 || N < 0 || n_blocks < 1 || window_words < 1 || window_words > 8 ||
      n_words < window_words || n_words * 32 < M)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qq = static_cast<const uint8_t*>(q);
  const auto* tt = static_cast<const uint8_t*>(t);
  const auto* ql = static_cast<const int32_t*>(q_len);
  const auto* tl = static_cast<const int32_t*>(t_len);
  auto* od = static_cast<int32_t*>(scratch);
  auto* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_order(ql, tl, od, P, n_blocks, klo + 32, khi - 32, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (window_words) {
#define MS_BANDED_WB(WB) \
  case WB:               \
    return static_cast<int>(                                                              \
        launch<WB>(qq, ql, tt, tl, od, o, P, M, N, n_words, n_blocks, klo, khi, h, s));
    MS_BANDED_WB(1)
    MS_BANDED_WB(2)
    MS_BANDED_WB(3)
    MS_BANDED_WB(4)
    MS_BANDED_WB(5)
    MS_BANDED_WB(6)
    MS_BANDED_WB(7)
    MS_BANDED_WB(8)
#undef MS_BANDED_WB
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
