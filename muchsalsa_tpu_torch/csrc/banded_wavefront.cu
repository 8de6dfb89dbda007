// Banded Levenshtein wavefront, one warp per problem (Hopper, sm_90a).
//
// Replaces the TPU kernel muchsalsa_tpu/ops/align_pallas.py::_kernel
// (launched by banded_edit_distance_pallas).  Contract, identical to the XLA
// function muchsalsa_tpu/ops/align.py::banded_edit_distance (rows = max_m
// or M, without the Pallas kernel's round-up of rows to its chunk):
//
//   q (P, M) uint8 padded with 5, t (P, N) uint8 padded with 4, int32
//   lengths m, n; band B.  diff = n - m, klo = min(0, diff) -
//   (B - 1 - |diff|) / 2; band cell x in [0, B) is diagonal k = klo + x,
//   column j = i + k of row i.  Row 0: R[x] = k where 0 <= k <= n, else
//   INF = 2^20.  Rows i = 1..m:
//     cand[x] = min(R[x] + (q[i-1] != t[j-1]), R[x+1] + 1)  (R[B] = INF)
//     cand = i where j == 0;  INF where j < 0 or j > n
//     R[x] = min(min_{y <= x}(cand[y] - y) + x, INF), INF outside 0..n
//   Codes compare as bytes (t outside 0..N-1 reads as 4).  The result is
//   R[clip(diff - klo, 0, B-1)], or -1 when |diff| >= B, m == 0, n == 0 or
//   m > rows.
//
// What bounds it on the card: each row depends on the whole previous row
// (the min-plus prefix scan along the band), so a problem is m dependent
// steps of O(B) work, and every row reads B target bytes and one query byte.
// The arithmetic is a few integer ops per cell; the serial scan, not the
// bytes, sets the pace.
//
// What the design does about it: one warp owns one problem and keeps the
// band in registers, C = B / 32 consecutive cells per lane (C in 1..16 as a
// template parameter, so every cell loop unrolls).  The R[x+1] neighbour of
// a lane's last cell comes from the next lane by one shuffle.  The prefix
// min of a row is a scan within each lane, a 5-step shuffle scan of the lane
// totals, and one more shuffle for the exclusive prefix.  A lane reads its C
// target bytes as consecutive addresses, so a warp's row read is one
// contiguous stretch of B bytes.  Several warps per block (independent
// problems) hide each other's latency.  Problems that return -1 run no row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kInf = 1 << 20;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
wavefront_kernel(const uint8_t* __restrict__ q, const int32_t* __restrict__ q_len,
                 const uint8_t* __restrict__ t, const int32_t* __restrict__ t_len,
                 int32_t* __restrict__ out, int P, int M, int N, int rows) {
  constexpr int B = 32 * C;
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  // warps never synchronise across the block, so a whole warp may leave
  if (p >= P) return;
  const int m = q_len[p];
  const int n = t_len[p];
  const int diff = n - m;
  const int adiff = diff < 0 ? -diff : diff;
  if (!(adiff < B && m > 0 && n > 0 && m <= rows)) {
    if (lane == 0) out[p] = -1;
    return;
  }
  const int klo = (diff < 0 ? diff : 0) - (B - 1 - adiff) / 2;  // numerator >= 0
  const int x0 = lane * C;  // this lane's first band cell
  const uint8_t* qrow = q + p * M;
  const uint8_t* trow = t + p * N;

  int R[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = klo + x0 + c;
    R[c] = (k >= 0 && k <= n) ? k : kInf;
  }
  for (int i = 1; i <= m; ++i) {
    const int qc = qrow[i - 1];
    int up_next = __shfl_down_sync(kFull, R[0], 1);
    if (lane == 31) up_next = kInf;
    int v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int x = x0 + c;
      const int j = i + klo + x;
      const int tc = (j >= 1 && j <= N) ? trow[j - 1] : 4;
      const int up = (c + 1 < C ? R[c + 1] : up_next) + 1;
      int cand = R[c] + (qc == tc ? 0 : 1);
      cand = cand < up ? cand : up;
      if (j == 0) cand = i;
      if (j < 0 || j > n) cand = kInf;
      v[c] = cand - x;
      if (c > 0) v[c] = min(v[c], v[c > 0 ? c - 1 : 0]);  // in-lane prefix min
    }
    // inclusive min-scan of the lane totals, then the exclusive prefix
    int tot = v[C - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, tot, off);
      if (lane >= off && o < tot) tot = o;
    }
    int before = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) before = 0x7FFFFFFF;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int x = x0 + c;
      const int j = i + klo + x;
      int r = (v[c] < before ? v[c] : before) + x;
      r = r < kInf ? r : kInf;
      R[c] = (j < 0 || j > n) ? kInf : r;
    }
  }
  int idx = diff - klo;
  idx = idx < 0 ? 0 : (idx > B - 1 ? B - 1 : idx);
  int mine = kInf;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c == idx % C) mine = R[c];
  const int val = __shfl_sync(kFull, mine, idx / C);
  if (lane == 0) out[p] = val;
}

template <int C>
cudaError_t launch(const uint8_t* q, const int32_t* ql, const uint8_t* t, const int32_t* tl,
                   int32_t* out, int P, int M, int N, int rows, cudaStream_t s) {
  const int blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  wavefront_kernel<C><<<blocks, kWarpsPerBlock * 32, 0, s>>>(q, ql, t, tl, out, P, M, N, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the wavefront on `stream` (a cudaStream_t); out is (P,) int32.
// band is a multiple of 32 in [32, 512].  Returns cudaGetLastError() after
// the launch: 0 when it was accepted.
int ms_banded_wavefront(const void* q, const void* q_len, const void* t, const void* t_len,
                        void* out, int P, int M, int N, int band, int rows, void* stream) {
  if (P < 1 || M < 0 || N < 0 || rows < 0 || band < 32 || band > 512 || band % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qq = static_cast<const uint8_t*>(q);
  const auto* ql = static_cast<const int32_t*>(q_len);
  const auto* tt = static_cast<const uint8_t*>(t);
  const auto* tl = static_cast<const int32_t*>(t_len);
  auto* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (band / 32) {
#define MS_WAVEFRONT_CASE(C) \
    case C: err = launch<C>(qq, ql, tt, tl, o, P, M, N, rows, s); break;
    MS_WAVEFRONT_CASE(1) MS_WAVEFRONT_CASE(2) MS_WAVEFRONT_CASE(3) MS_WAVEFRONT_CASE(4)
    MS_WAVEFRONT_CASE(5) MS_WAVEFRONT_CASE(6) MS_WAVEFRONT_CASE(7) MS_WAVEFRONT_CASE(8)
    MS_WAVEFRONT_CASE(9) MS_WAVEFRONT_CASE(10) MS_WAVEFRONT_CASE(11) MS_WAVEFRONT_CASE(12)
    MS_WAVEFRONT_CASE(13) MS_WAVEFRONT_CASE(14) MS_WAVEFRONT_CASE(15) MS_WAVEFRONT_CASE(16)
#undef MS_WAVEFRONT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
