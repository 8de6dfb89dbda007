// Refinement's padded batch built on the card from the mappings'
// coordinates (Hopper, sm_90a).
//
// Replaces no TPU kernel.  The JAX package packs refinement's problems on the
// host with numpy (muchsalsa_tpu/ops/align.py::pack_problems after a Python
// loop that slices each unitig and read and reverse-complements the minus
// strand), and so did the port; at an E. coli map stage (~57,000 mappings of
// 0.5-10 kb) that host work took ~12 s of a ~16.5 s job while the
// edit-distance kernel it fed took 0.08 s (NVIDIA H100 80GB HBM3 at 700 W,
// and its host).  This kernel takes the raw bytes of the reads and unitigs
// involved (two blobs) and each problem's coordinates, and writes the padded
// batch the edit-distance kernels read.
//
// Contract (ops/align_torch.py::gather_problems, plain version
// gather_problems_reference; both give what pack_problems gives for the
// pairs sliced on the host):
//
//   q_codes[p, i] = fwd[q_blob[q_off[p] + q_start[p] + i]]   for i < q_len[p]
//                 = 5 (align_torch.Q_PAD)                    for q_len[p] <= i < M
//   t_codes[p, i] = fwd[t_blob[t_off[p] + t_start[p] + i]]   plus strand
//                 = rc[t_blob[t_off[p] + t_start[p] + t_len[p] - 1 - i]]
//                                                            minus strand
//                 = 4 (align_torch.T_PAD)                    for t_len[p] <= i < N
//
// with fwd and rc the two 256-entry tables the wrapper passes, 512 bytes:
// fwd[b] is encode_2bit's code of byte b, rc[b] the code of its complement
// as reverse_complement gives it (upper-case ACGT swapped, every other byte
// kept, so a lower-case base keeps its own code and `3 - c` would be wrong).
// The wrapper checks that every range lies inside its blob and every length
// inside its width.
//
// What bounds it on the card: bytes.  A call reads sum(q_len + t_len) bytes
// of the blobs and writes P (M + N) bytes of codes, ~1.5 GB at an E. coli
// map stage's batch (P 57,000, M 10,000, N 9,200), 0.45 ms at 3.35 TB/s; a
// code costs a table lookup and a few integer ops, far below the card's
// issue rate.  Measured on that card at that size: 1.25 ms, 36 % of the
// bound (a byte load a code from the blobs is what is left to win).
//
// What the design does about it:
// - One block per (problem, side): grid (P, 2).  The block walks its row in
//   16-byte chunks, one chunk a thread a step, so the stores are 16 bytes
//   wide and a warp's stores cover 512 contiguous bytes.  Each row's first
//   bytes up to a 16-byte boundary of the output, and its last bytes past
//   the final one, are stored a byte at a time, so any width M or N works.
// - A chunk wholly past the row's length is the pad code in all 16 bytes
//   and reads nothing; the pad is written in the same pass, so the output
//   is never filled first.
// - The reads of the blob are consecutive across a warp's lanes (descending
//   for a minus-strand target), a thread's 16 bytes sharing L1 lines.
// - The two tables sit in shared memory, loaded with one 4-byte load a
//   thread; a base's bytes (A, C, G, T and their lower case) fall in few
//   banks' words, which the lanes read as broadcasts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTableBytes = 512;
static_assert(kThreads * 4 == kTableBytes, "one 4-byte word of the tables a thread");
constexpr uint8_t kQPad = 5;  // align_torch.Q_PAD
constexpr uint8_t kTPad = 4;  // align_torch.T_PAD

struct Side {
  const uint8_t* blob;
  const int64_t* off;
  const int64_t* start;
  const int32_t* len;
  uint8_t* out;
  int width;
};

__global__ void __launch_bounds__(kThreads)
    refine_gather(Side q, Side t, const uint8_t* __restrict__ minus,
                  const uint32_t* __restrict__ tables) {
  __shared__ uint32_t lut_words[kThreads];
  lut_words[threadIdx.x] = tables[threadIdx.x];
  __syncthreads();

  const int64_t p = blockIdx.x;
  const bool target = blockIdx.y != 0;
  const Side s = target ? t : q;
  const uint8_t pad = target ? kTPad : kQPad;
  const int W = s.width;
  const int n = s.len[p];
  const uint8_t* __restrict__ src = s.blob + s.off[p] + s.start[p];
  const bool rev = target && minus[p] != 0;
  const uint8_t* lut = reinterpret_cast<const uint8_t*>(lut_words) + (rev ? 256 : 0);
  uint8_t* row = s.out + p * W;

  // the code of column c of this row (block-uniform branches: rev, the side)
  auto code = [&](int c) -> uint32_t {
    if (c >= n) return pad;
    return lut[rev ? src[n - 1 - c] : src[c]];
  };

  const int head = min(static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15), W);
  const int chunks = (W - head) / 16;
  const int tail = head + 16 * chunks;
  if (threadIdx.x < head) row[threadIdx.x] = code(threadIdx.x);
  if (tail + static_cast<int>(threadIdx.x) < W) row[tail + threadIdx.x] = code(tail + threadIdx.x);

  const uint32_t pad4 = pad * 0x01010101u;
  uint4* body = reinterpret_cast<uint4*>(row + head);
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    const int c0 = head + 16 * k;
    uint4 v = make_uint4(pad4, pad4, pad4, pad4);
    if (c0 < n) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t x = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) x |= code(c0 + 4 * j + b) << (8 * b);
        w[j] = x;
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    body[k] = v;
  }
}

}  // namespace

extern "C" {

// Launches the gather on `stream` (a cudaStream_t): q_out is (P, M) and
// t_out (P, N) uint8; t_minus is P bytes, nonzero for a minus-strand target;
// tables the 512 bytes fwd then rc, 4-byte aligned.  Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
int ms_refine_gather(const void* q_blob, const void* q_off, const void* q_start,
                     const void* q_len, const void* t_blob, const void* t_off,
                     const void* t_start, const void* t_len, const void* t_minus,
                     const void* tables, void* q_out, void* t_out, int P, int M, int N,
                     void* stream) {
  if (P < 1 || M < 0 || N < 0 || (reinterpret_cast<uintptr_t>(tables) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const Side q = {static_cast<const uint8_t*>(q_blob), static_cast<const int64_t*>(q_off),
                  static_cast<const int64_t*>(q_start), static_cast<const int32_t*>(q_len),
                  static_cast<uint8_t*>(q_out), M};
  const Side t = {static_cast<const uint8_t*>(t_blob), static_cast<const int64_t*>(t_off),
                  static_cast<const int64_t*>(t_start), static_cast<const int32_t*>(t_len),
                  static_cast<uint8_t*>(t_out), N};
  refine_gather<<<dim3(P, 2), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, t, static_cast<const uint8_t*>(t_minus), static_cast<const uint32_t*>(tables));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
