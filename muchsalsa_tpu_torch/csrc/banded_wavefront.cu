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
// What bounds it on the card: integer instruction issue.  Each row depends
// on the whole previous row (the min-plus prefix scan along the band), so a
// problem is m dependent steps of B cells, and a band cell is a handful of
// integer instructions against one byte of a target row that is read again
// by the next B rows.  The work is Σ m × B cells (1.3·10^10 on the
// refinement batch at band 256) at 5 int32 ops a cell (a compare, two adds,
// two mins), at least 3 int32 issue slots on sm_90a (the compare, then DPX
// fuses each add with a min), so the int32 pipe (64 lanes a clock an SM),
// not the bytes, sets the time.
//
// What the design does about it: one warp owns one problem and keeps the
// band in registers, C = B / 32 consecutive cells per lane (C in 1..16 as a
// template parameter, so every cell loop unrolls).  The band is kept in
// shifted coordinates S[x] = R[x] - x, in which a row is
//
//   S'[x] = min_{y <= x} min(S[y] + cost[y], S[y+1] + 2),  S[B] = INF - B,
//
// with no range test, no j == 0 case, no -x/+x and no clamp inside the row:
//   * a cell with j < 0 starts at INF and reads only cells with j < 0 (or
//     the INF above the band), so it never falls below INF;
//   * the cell at j == 0 then comes out as i from the cell above it, which
//     is in the band for every row i >= 1;
//   * a cell with j > n feeds no cell with j <= n (diag, up and left all
//     lie at a column <= j), so whatever it holds, and whatever target byte
//     it compares, never reaches the answer;
//   * every band cell with 0 <= j <= n is reachable inside the band, so it
//     stays below INF and the min picks it over any cell with j < 0.
// So the target byte of a cell with j <= 0 or j > n is never needed: the
// row loop reads every byte with no bounds test, and the answer cell is
// clamped to INF once, at the end.  (nvcc fuses min(a + 2, b) into one DPX
// VIADDMNMX on sm_90a by itself; the DPX intrinsics written out gave the
// same instructions a cell and no gain.)
//
// The bytes come from shared memory.  A warp stages the query bytes and the
// target span of a chunk of 64 rows (64 + B bytes, a code 4 outside the
// problem's row) with a lane-strided byte copy: the rows of width M and N
// are not 4-byte aligned in general (cp.async copies 4, 8 or 16 aligned
// bytes), and 2 + (64 + B) / 32 bytes a lane each 64 rows cost the sweep
// little.  The next chunk is loaded into registers while this one
// is swept, then written over it.  The shared memory a block needs depends
// on B alone (at most 4 x 640 bytes), not on M or N.
//
// The up neighbour of a lane's last cell comes from the next lane by one
// shuffle.  The prefix min of a row is a scan within each lane, a 5-step
// shuffle scan of the lane totals (a lane below the shuffle distance gets
// its own total back, which the min leaves alone), and one more shuffle for
// the exclusive prefix.  Several warps per block (independent problems)
// hide each other's latency.  Problems that return -1 run no row.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kChunk = 64;  // rows whose query and target bytes a warp stages at once
constexpr int kInf = 1 << 20;
constexpr unsigned kFull = 0xFFFFFFFFu;

// A warp's staging of one chunk of rows i0 .. i0 + kChunk - 1: the target
// columns c0 = i0 - 1 + klo .. c0 + kChunk + B - 2 that those rows read (4
// outside [0, N)) and their query bytes (5 past m), kChunk + B and kChunk
// bytes, one lane-strided byte a lane and step, so a warp reads 32
// consecutive bytes and nothing outside the problem's own rows.
template <int C>
struct Chunk {
  static constexpr int kT = (kChunk + 32 * C) / 32;  // target bytes a lane
  static constexpr int kQ = kChunk / 32;             // query bytes a lane
  int t[kT];
  int q[kQ];

  __device__ __forceinline__ void fetch(const uint8_t* __restrict__ qrow,
                                        const uint8_t* __restrict__ trow, int m, int N, int i0,
                                        int klo, int lane) {
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      const int col = i0 - 1 + klo + lane + 32 * k;
      t[k] = static_cast<unsigned>(col) < static_cast<unsigned>(N) ? trow[col] : 4;
    }
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const int row = i0 - 1 + lane + 32 * k;
      q[k] = row < m ? qrow[row] : 5;
    }
  }

  __device__ __forceinline__ void store(uint8_t* tring, uint8_t* qring, int lane) const {
#pragma unroll
    for (int k = 0; k < kT; ++k) tring[lane + 32 * k] = static_cast<uint8_t>(t[k]);
#pragma unroll
    for (int k = 0; k < kQ; ++k) qring[lane + 32 * k] = static_cast<uint8_t>(q[k]);
  }
};

// Rows i0 .. i0 + rows - 1 of one problem, from the staged chunk: row i0 + r
// compares the query byte qring[r] with this lane's target bytes
// tring[r + x0 + c].
template <int C>
__device__ __forceinline__ void sweep(int (&S)[C], const uint8_t* qring, const uint8_t* tlane,
                                      int rows, int lane) {
  constexpr int B = 32 * C;
  for (int r = 0; r < rows; ++r) {
    const int qc = qring[r];
    const uint8_t* tr = tlane + r;
    int above = __shfl_down_sync(kFull, S[0], 1);
    if (lane == 31) above = kInf - B;  // S[B]: the cell above the band
    int v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int tc = tr[c];
      const int up = (c + 1 < C ? S[c + 1 < C ? c + 1 : 0] : above) + 2;
      const int cand = min(S[c] + (qc != tc ? 1 : 0), up);
      v[c] = c > 0 ? min(cand, v[c > 0 ? c - 1 : 0]) : cand;  // in-lane prefix min
    }
    // inclusive min-scan of the lane totals, then the exclusive prefix
    int tot = v[C - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) tot = min(tot, __shfl_up_sync(kFull, tot, d));
    int before = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) before = INT_MAX;
#pragma unroll
    for (int c = 0; c < C; ++c) S[c] = min(v[c], before);
  }
}

template <int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
wavefront_kernel(const uint8_t* __restrict__ q, const int32_t* __restrict__ q_len,
                 const uint8_t* __restrict__ t, const int32_t* __restrict__ t_len,
                 int32_t* __restrict__ out, int P, int M, int N, int rows) {
  constexpr int B = 32 * C;
  __shared__ uint8_t ring[kWarpsPerBlock][Chunk<C>::kT * 32 + kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long p = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
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
  const int klo = (diff < 0 ? diff : 0) - (B - 1 - adiff) / 2;  // numerator >= 0, klo <= 0
  const int x0 = lane * C;  // this lane's first band cell
  const uint8_t* qrow = q + p * M;
  const uint8_t* trow = t + p * N;
  uint8_t* tring = ring[warp];
  uint8_t* qring = tring + Chunk<C>::kT * 32;

  int S[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = klo + x0 + c;
    S[c] = ((k >= 0 && k <= n) ? k : kInf) - (x0 + c);
  }
  // the next chunk is loaded into registers while this one is swept
  Chunk<C> next;
  next.fetch(qrow, trow, m, N, 1, klo, lane);
  for (int i0 = 1; i0 <= m; i0 += kChunk) {
    __syncwarp();  // every lane is done with the previous chunk
    next.store(tring, qring, lane);
    __syncwarp();
    if (i0 + kChunk <= m) next.fetch(qrow, trow, m, N, i0 + kChunk, klo, lane);
    sweep<C>(S, qring, tring + x0, min(kChunk, m - i0 + 1), lane);
  }

  int idx = diff - klo;
  idx = idx < 0 ? 0 : (idx > B - 1 ? B - 1 : idx);
  int mine = INT_MAX;
#pragma unroll
  for (int c = 0; c < C; ++c) mine = min(mine, c == idx % C ? S[c] + x0 + c : INT_MAX);
  const int val = __shfl_sync(kFull, mine, idx / C);
  if (lane == 0) out[p] = min(val, kInf);
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
