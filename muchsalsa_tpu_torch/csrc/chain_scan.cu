// Anchor-chaining DP on Hopper (sm_90a): the compatibility build fused into
// the forward scan (ms_chain_dp), and the scan alone over a given matrix
// (ms_chain_scan).  A problem runs on a segment of a warp.
//
// Replaces the TPU kernel muchsalsa_tpu/ops/chaining_pallas.py::_kernel
// (launched by chain_scan_pallas) and the compatibility build before it
// (muchsalsa_tpu/ops/chaining_jax.py::compat_init_batch, whose port is
// ops/chain_scan.py::compat_init_batch).  The scan's contract, identical to
// the Pallas kernel's:
//
//   compat (B, K, K), [b, l, k] != 0 means anchor k may precede l
//   init   (B, K) float64, padding anchors hold -1e30
//   for l = 0 .. K-1:
//     best = max(score[k]) over k < l with compat[b, l, k]
//     if best > -1e30: score[l] = init[l] + best, bp[l] = smallest k attaining best
//     else:            score[l] unchanged,        bp[l] = -1
//
// ms_chain_dp builds row l's mask itself from the packed batch of state.py,
// admitting k < l where compat_init_batch's entry [b, k, l] holds: the pair
// (anchor k, anchor l), the order of the JAX package's chain_dp_batch
// (compat[:, l]) and of the host oracle's check_compatibility(k, l).  The
// two orders differ where a corrected range inverts.  Its input is the N
// valid anchors only, problem by problem, as 13 float64
// planes of N (v_ns, v_ne, v_is, v_ie, v_rr, w_ns, w_ne, w_is, w_ie, w_rr,
// ov_s, ov_e, score), a flag byte an anchor (bit 0 v_dir, 1 w_dir, 2 its
// problem's cls_dir) and B + 1 int32 offsets (problem b's anchors are
// offsets[b] .. offsets[b + 1], at most K); it writes the (B, K) scores and
// backpointers of the padded batch, -1e30 and -1 past each problem's
// anchors.  Pair (a, b) = (anchor k, anchor l) follows compat_init_batch's
// expressions in the same order: the corrected ranges (ov_s - is) / rr, the
// orientation codes and gap diffs b_hi - a_lo + 1.0 (and the like), the
// vertex aborts, diff * 100.0 / mx (never <= 15 where mx == 0),
// d1 + d2 <= wiggle_room, rel <= 15.0.  The build passes --fmad=false, so no
// product is contracted into an FMA, and float64 division is IEEE-rounded:
// results are bit-equal to the plain version.  Maxima propagate NaN as
// torch.maximum does.
//
// What bounds it on the card: bytes, then float64 division.  The function
// must read 105 bytes an anchor and the offsets and write 12 bytes a slot:
// 55.1 MB at the core's batch (B 131072, K 8, 400,393 anchors), 16.5 us at
// 3.35 TB/s.  The work, K (K - 1) / 2 pair tests of ~35 float64 compares
// and adds and K dependent scan steps a problem, is below that on the
// card's 34 TFLOP/s of float64; but the four IEEE divisions an anchor are
// long instruction sequences.  The first fused design (PERF.md §6) read a
// padded (13, B, K) batch, whose 64-byte rows a DRAM access fetches whole
// even where only the first anchors of a row are valid.
//
// What the design does about it:
// - A problem of K <= 32 anchors runs on a segment of G lanes (G the power
//   of two >= K), 32 / G problems a warp (4 at K = 8); lane j holds anchor
//   j.  Consecutive problems' anchors are consecutive in each plane, so a
//   warp's loads are contiguous and read no padding.
// - Each lane corrects its anchor's ranges (a zero numerator, most trims,
//   skips its division) and puts the eight values a pair test needs in
//   shared memory.  The warp lists the pairs (l, k), k < l, of each of its
//   problems, a warp prefix sum giving each row owner its place, and its 32
//   lanes test them 32 a round (one round at the core's K = 8, against up to
//   7 when each lane tested its own row), setting the rows' bit masks in
//   shared memory by atomics.  The K x K matrix never leaves the SM.
// - The scan: at step l the row's owner lane shuffles its mask to the
//   segment, every lane offers its own admitted scores, a segmented
//   butterfly of shuffles takes the maximum, and one ballot gives the
//   smallest index attaining it; the owner adds its initial score.  Scores
//   stay in registers; a step whose row admits nothing in any problem of
//   the warp is skipped.
// - At 32 < K <= 128 a warp holds one problem, C = ceil(K / 32) anchors a
//   lane, each lane testing its rows against every earlier anchor in series.
// - ms_chain_scan builds the same masks from the compat bytes (row l of
//   problem b is contiguous) and runs the same scan.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W at the core's batch
// (PERF.md §6, scripts/torch_chain_ab.py and scripts/torch_chain_phases.py):
// 0.038 ms of device time, 43 % of the byte bound; the anchors' loads and
// the stores alone take 0.022 ms, about the card's measured copy rate, and
// the kernel without its divisions 0.027 ms.  On the way: the first fused
// design (padded batch, a lane a row's pair tests) 0.063 ms; listing the
// pairs 0.053 ms; the batch without padding 0.048 ms; skipping zero-trim
// divisions 0.038 ms.  Against 4.1-4.5 ms for compat_init_batch + the scan
// before.  The scan alone (ms_chain_scan): 0.0195 ms against the first
// design's 0.172 ms.  ptxas (sm_90a): the segment kernel 48-50 registers,
// no spill; the K > 32 kernel 72-108 registers, a 4-byte spill at
// 33 <= K <= 64; ms_chain_scan 14-40 registers, no spill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxK = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr double kNeg = -1e30;

// the packed batch's planes (state.FLOAT_FIELDS) and flag bits
enum Field { kVNs, kVNe, kVIs, kVIe, kVRr, kWNs, kWNe, kWIs, kWIe, kWRr, kOvS, kOvE, kScore };
constexpr unsigned kVDir = 1u, kWDir = 2u, kClsDir = 4u;

// What a pair test needs of one anchor: its corrected ranges (lo, hi) and
// its uncorrected ones (ns, ne) on both vertices.
constexpr int kPairValues = 8;
struct Anchor {
  double v_lo, v_hi, w_lo, w_hi, v_ns, v_ne, w_ns, w_ne;
};

// torch.maximum / torch.minimum: NaN wins
__device__ __forceinline__ double max_nan(double a, double b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ double min_nan(double a, double b) {
  return (a < b || a != a) ? a : b;
}

// A lane's place: problem b of the warp's 32 / G, position j in its segment.
template <int G>
struct Place {
  int lane, j;
  long long b;
  bool has;  // b < B
  unsigned seg;  // the segment's lanes
};

template <int G>
__device__ __forceinline__ Place<G> place(long long first, int B) {
  Place<G> p;
  p.lane = threadIdx.x & 31;
  p.j = p.lane % G;
  p.b = first + p.lane / G;
  p.has = p.b < B;
  p.seg = G == 32 ? kFull : ((1u << (G & 31)) - 1u) << (p.lane - p.j);
  return p;
}

// The first problem of this thread's warp.
template <int G>
__device__ __forceinline__ long long warp_first() {
  return (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / G);
}

// The forward DP of each problem on its segment.  Lane j holds anchors
// c G + j (c < C) with initial scores init[c] and rows mask[c][w] (bit t of
// word w: anchor w G + t may precede anchor c G + j; only earlier anchors
// are set).  Gives each anchor's score and backpointer.
template <int G, int C>
__device__ __forceinline__ void scan(const Place<G>& p, const uint32_t (&mask)[C][C],
                                     const double (&init)[C], int K, double (&score)[C],
                                     int (&bp)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    score[c] = init[c];
    bp[c] = -1;
  }
#pragma unroll
  for (int lc = 0; lc < C; ++lc) {
    for (int lj = 0; lj < G; ++lj) {
      const int l = lc * G + lj;
      if (l >= K) break;
      // a step whose row admits nothing in every problem of the warp keeps
      // init and -1, as set above
      uint32_t row_any = 0u;
#pragma unroll
      for (int c = 0; c < C; ++c) row_any |= mask[lc][c];
      if (!__any_sync(kFull, p.j == lj && row_any != 0u)) continue;
      // row l from its owner; each lane offers the anchors it admits
      double cand[C];
      double best = kNeg;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint32_t row = __shfl_sync(kFull, mask[lc][c], lj, G);
        cand[c] = (row >> p.j) & 1u ? score[c] : kNeg;
        best = max_nan(best, cand[c]);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        best = max_nan(best, __shfl_xor_sync(kFull, best, off, G));
      // the smallest index attaining the maximum: the lowest slot, then lane
      int arg = -1;
#pragma unroll
      for (int c = C - 1; c >= 0; --c) {
        const unsigned hit = (__ballot_sync(kFull, cand[c] == best) & p.seg) >> (p.lane - p.j);
        if (hit) arg = c * G + __ffs(hit) - 1;
      }
      if (p.j == lj) {
        const bool ok = best > kNeg;
        if (ok) score[lc] = init[lc] + best;
        bp[lc] = ok ? arg : -1;
      }
    }
  }
}

template <int G, int C>
__device__ __forceinline__ void store(const Place<G>& p, const double (&score)[C],
                                      const int (&bp)[C], double* __restrict__ scores,
                                      int32_t* __restrict__ bps, int K) {
  if (!p.has) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int a = c * G + p.j;
    if (a < K) {
      scores[p.b * K + a] = score[c];
      bps[p.b * K + a] = bp[c];
    }
  }
}

// Orientation code in {-2, -1, 0, 1, 2} and gap diff of anchors (a, b) on
// one vertex (mpp.cpp:67-91; _pair_orientation).
__device__ __forceinline__ void orientation(double a_lo, double a_hi, double b_lo, double b_hi,
                                            int& ori, double& diff) {
  const bool intersect = a_lo <= b_hi && b_lo <= a_hi;
  const bool fwd = a_lo < b_lo && a_hi < b_hi;
  const bool bwd = a_lo > b_lo && a_hi > b_hi;
  if (intersect) {
    ori = bwd ? -2 : (fwd ? 2 : 0);
    diff = bwd ? b_hi - a_lo + 1.0 : (fwd ? a_hi - b_lo + 1.0 : 0.0);
  } else {
    const bool lt = a_lo < b_lo;
    ori = lt ? 1 : -1;
    diff = lt ? b_lo - a_hi + 1.0 : a_lo - b_hi + 1.0;
  }
}

// Corrected and uncorrected orientations disagree in sign over
// intersecting uncorrected ranges (mpp.cpp:93-109; _vertex_abort).
__device__ __forceinline__ bool vertex_abort(double a_s, double a_e, double b_s, double b_e,
                                             int ori) {
  const bool intersect = a_s <= b_e && b_s <= a_e;
  const bool fwd = a_s < b_s && a_e < b_e;
  const bool bwd = a_s > b_s && a_e > b_e;
  const int uco = bwd ? -2 : (fwd ? 2 : 0);
  return intersect && ((ori < 0 && uco >= 0) || (ori > 0 && uco <= 0));
}

// compat_init_batch's entry for the pair (a, b) of two valid anchors.
__device__ __forceinline__ bool compatible(const Anchor& a, const Anchor& b, bool cls_dir,
                                           double wiggle) {
  int o1, o2;
  double d1, d2;
  orientation(a.v_lo, a.v_hi, b.v_lo, b.v_hi, o1, d1);
  orientation(a.w_lo, a.w_hi, b.w_lo, b.w_hi, o2, d2);
  if (vertex_abort(a.v_ns, a.v_ne, b.v_ns, b.v_ne, o1) ||
      vertex_abort(a.w_ns, a.w_ne, b.w_ns, b.w_ne, o2))
    return false;
  if (!cls_dir) o2 = -o2;
  if (o1 == o2 && o1 != 0) {
    const double mx = max_nan(d1, d2);
    const double diff = mx - min_nan(d1, d2);
    if (diff <= wiggle) return true;
    // the plain version's rel is inf where mx == 0, never <= 15
    return mx != 0.0 && diff * 100.0 / mx <= 15.0;
  }
  return ((o1 < 0 && o2 < 0) || (o1 > 0 && o2 > 0)) && d1 + d2 <= wiggle;
}

// num / rr, IEEE-rounded.  A zero numerator over a positive divisor is the
// quotient itself (+0 or -0, as the division gives) and skips the division,
// whose fast path leaves zero quotients to its slow one; most trims are 0.
__device__ __forceinline__ double div_rn(double num, double rr) {
  if (num == 0.0 && rr > 0.0) return num;
  return num / rr;
}

// An anchor's range corrected by rRatio-projected overlap trimming.
__device__ __forceinline__ void corrected(double ns, double ne, double is, double ie, double rr,
                                          bool dir, double ov_s, double ov_e, double& lo,
                                          double& hi) {
  const double ncl = div_rn(ov_s - is, rr);
  const double ncr = div_rn(ie - ov_e, rr);
  lo = ns + (dir ? ncl : ncr);
  hi = ne - (dir ? ncr : ncl);
}

// A problem's anchors in the packed batch: offsets[b] .. offsets[b + 1],
// their count clamped to 0..K, no anchor past N.
struct Span {
  int start, n;
  __device__ __forceinline__ bool holds(int a, int N) const {
    return start >= 0 && a < n && static_cast<long long>(start) + a < N;
  }
};

__device__ __forceinline__ Span problem_span(bool has, long long b, const int32_t* offsets,
                                             int K) {
  if (!has) return {0, 0};
  const int start = offsets[b];
  const int n = offsets[b + 1] - start;
  return {start, n < 0 ? 0 : (n > K ? K : n)};
}

// An anchor's place in the warp's shared arrays: its lane.  What a pair
// test needs of it goes to shared memory (kPairValues planes of 32).
__device__ __forceinline__ void put_anchor(double (*nb)[32], int slot, const Anchor& x) {
  nb[0][slot] = x.v_lo;
  nb[1][slot] = x.v_hi;
  nb[2][slot] = x.w_lo;
  nb[3][slot] = x.w_hi;
  nb[4][slot] = x.v_ns;
  nb[5][slot] = x.v_ne;
  nb[6][slot] = x.w_ns;
  nb[7][slot] = x.w_ne;
}

__device__ __forceinline__ Anchor get_anchor(const double (*nb)[32], int slot) {
  return {nb[0][slot], nb[1][slot], nb[2][slot], nb[3][slot],
          nb[4][slot], nb[5][slot], nb[6][slot], nb[7][slot]};
}

// The fused kernel at K <= 32: a problem on a segment of G lanes, lane j
// holding anchor j.  The warp lists the pairs (l, k), k < l, of two valid
// anchors of each of its problems (a warp prefix sum of the pairs each row
// owns), and its 32 lanes test them 32 a round, so that a round is skipped
// by no lane while any listed pair waits; the results go to the rows' masks
// by shared-memory atomics.
template <int G>
__global__ void __launch_bounds__(kThreads)
chain_dp_segment_kernel(const double* __restrict__ fields, const uint8_t* __restrict__ flags,
                        const int32_t* __restrict__ offsets, double* __restrict__ scores,
                        int32_t* __restrict__ bps, int B, int K, int N, double wiggle) {
  constexpr int kMaxPairs = G > 1 ? (32 / G) * (G * (G - 1) / 2) : 1;
  __shared__ double sh[kWarpsPerBlock][kPairValues][32];
  __shared__ uint16_t sh_pairs[kWarpsPerBlock][kMaxPairs];
  __shared__ uint32_t sh_mask[kWarpsPerBlock][32];
  const long long first = warp_first<G>();
  // warps never synchronise across the block, so a whole warp may leave
  if (first >= B) return;
  const Place<G> p = place<G>(first, B);
  const int w = threadIdx.x >> 5;
  const long long plane = N;

  const Span span = problem_span(p.has, p.b, offsets, K);
  const bool valid = span.holds(p.j, N);
  const long long at = static_cast<long long>(span.start) + p.j;
  const unsigned fl = valid ? flags[at] : 0u;
  Anchor x = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double init[1] = {kNeg};
  if (valid) {
    const double* f = fields + at;
    const double ov_s = f[kOvS * plane], ov_e = f[kOvE * plane];
    x.v_ns = f[kVNs * plane];
    x.v_ne = f[kVNe * plane];
    x.w_ns = f[kWNs * plane];
    x.w_ne = f[kWNe * plane];
    corrected(x.v_ns, x.v_ne, f[kVIs * plane], f[kVIe * plane], f[kVRr * plane],
              (fl & kVDir) != 0, ov_s, ov_e, x.v_lo, x.v_hi);
    corrected(x.w_ns, x.w_ne, f[kWIs * plane], f[kWIe * plane], f[kWRr * plane],
              (fl & kWDir) != 0, ov_s, ov_e, x.w_lo, x.w_hi);
    init[0] = f[kScore * plane];
  }
  put_anchor(sh[w], p.lane, x);
  sh_mask[w][p.lane] = 0u;
  // row j's pairs: the valid anchors before it in its segment
  const unsigned seg0 = p.lane - p.j;
  const unsigned seg_valid = (__ballot_sync(kFull, valid) & p.seg) >> seg0;
  const unsigned cls_bits = __ballot_sync(kFull, (fl & kClsDir) != 0);
  const unsigned below = valid ? seg_valid & ((1u << p.j) - 1u) : 0u;
  const int mine = __popc(below);
  int offset = mine;  // inclusive prefix sum over the warp's lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, offset, d);
    if (p.lane >= d) offset += o;
  }
  const int total = __shfl_sync(kFull, offset, 31);
  offset -= mine;
  for (unsigned bits = below; bits; bits &= bits - 1u)
    sh_pairs[w][offset++] = static_cast<uint16_t>((p.lane << 8) | (seg0 + __ffs(bits) - 1));
  __syncwarp();

  for (int r = p.lane; r < total; r += 32) {
    const unsigned pair = sh_pairs[w][r];
    const int sl = static_cast<int>(pair >> 8), sk = static_cast<int>(pair & 0xFFu);
    if (compatible(get_anchor(sh[w], sk), get_anchor(sh[w], sl), (cls_bits >> sl) & 1u, wiggle))
      atomicOr(&sh_mask[w][sl], 1u << (sk % G));
  }
  __syncwarp();

  const uint32_t mask[1][1] = {{sh_mask[w][p.lane]}};
  double score[1];
  int bp[1];
  scan<G, 1>(p, mask, init, K, score, bp);
  store<G, 1>(p, score, bp, scores, bps, K);
}

// The fused kernel at 32 < K <= 128: a warp a problem, lane j holding
// anchors c 32 + j (c < C), each row's pair tests in series.
template <int G, int C>
__global__ void __launch_bounds__(kThreads)
chain_dp_kernel(const double* __restrict__ fields, const uint8_t* __restrict__ flags,
                const int32_t* __restrict__ offsets, double* __restrict__ scores,
                int32_t* __restrict__ bps, int B, int K, int N, double wiggle) {
  constexpr int kSlots = 32 * C;  // anchors of a warp
  __shared__ double sh[kWarpsPerBlock][kPairValues][kSlots];
  __shared__ uint8_t sh_valid[kWarpsPerBlock][kSlots];
  const long long first = warp_first<G>();
  // warps never synchronise across the block, so a whole warp may leave
  if (first >= B) return;
  const Place<G> p = place<G>(first, B);
  double (*nb)[kSlots] = sh[threadIdx.x >> 5];
  uint8_t* nv = sh_valid[threadIdx.x >> 5];
  const int seg0 = (p.lane / G) * G * C;  // the segment's first slot
  const long long plane = N;
  const Span span = problem_span(p.has, p.b, offsets, K);

  Anchor me[C];
  double init[C];
  bool valid[C];
  bool cls = false;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int a = c * G + p.j;
    valid[c] = span.holds(a, N);
    const long long at = static_cast<long long>(span.start) + a;
    const unsigned fl = valid[c] ? flags[at] : 0u;
    cls = cls || (fl & kClsDir) != 0;
    Anchor x = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    init[c] = kNeg;
    if (valid[c]) {
      const double* f = fields + at;
      const double ov_s = f[kOvS * plane], ov_e = f[kOvE * plane];
      x.v_ns = f[kVNs * plane];
      x.v_ne = f[kVNe * plane];
      x.w_ns = f[kWNs * plane];
      x.w_ne = f[kWNe * plane];
      corrected(x.v_ns, x.v_ne, f[kVIs * plane], f[kVIe * plane], f[kVRr * plane],
                (fl & kVDir) != 0, ov_s, ov_e, x.v_lo, x.v_hi);
      corrected(x.w_ns, x.w_ne, f[kWIs * plane], f[kWIe * plane], f[kWRr * plane],
                (fl & kWDir) != 0, ov_s, ov_e, x.w_lo, x.w_hi);
      init[c] = f[kScore * plane];
    }
    me[c] = x;
    const int s = seg0 + a;
    nb[0][s] = x.v_lo;
    nb[1][s] = x.v_hi;
    nb[2][s] = x.w_lo;
    nb[3][s] = x.w_hi;
    nb[4][s] = x.v_ns;
    nb[5][s] = x.v_ne;
    nb[6][s] = x.w_ns;
    nb[7][s] = x.w_ne;
    nv[s] = valid[c];
  }
  __syncwarp();

  // row c G + j against the earlier anchors w G + t of its problem
  uint32_t mask[C][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int w = 0; w < C; ++w) {
      uint32_t bits = 0u;
      if (w <= c) {
        const int t_end = w < c ? G : p.j;
        for (int t = 0; t < G; ++t) {
          const int k = w * G + t;
          if (k >= K - 1) break;
          if (valid[c] && t < t_end && nv[seg0 + k]) {
            const int s = seg0 + k;
            const Anchor o = {nb[0][s], nb[1][s], nb[2][s], nb[3][s],
                              nb[4][s], nb[5][s], nb[6][s], nb[7][s]};
            bits |= static_cast<uint32_t>(compatible(o, me[c], cls, wiggle)) << t;
          }
        }
      }
      mask[c][w] = bits;
    }
  }

  double score[C];
  int bp[C];
  scan<G, C>(p, mask, init, K, score, bp);
  store<G, C>(p, score, bp, scores, bps, K);
}

template <int G, int C>
__global__ void __launch_bounds__(kThreads)
chain_scan_kernel(const uint8_t* __restrict__ compat, const double* __restrict__ init_in,
                  double* __restrict__ scores, int32_t* __restrict__ bps, int B, int K) {
  const long long first = warp_first<G>();
  if (first >= B) return;
  const Place<G> p = place<G>(first, B);

  double init[C];
  uint32_t mask[C][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int a = c * G + p.j;
    const bool ok = p.has && a < K;
    init[c] = ok ? init_in[p.b * K + a] : kNeg;
    const uint8_t* row = compat + (p.b * K + a) * K;
#pragma unroll
    for (int w = 0; w < C; ++w) {
      uint32_t bits = 0u;
      if (w <= c) {
        for (int t = 0; t < G; ++t) {
          const int k = w * G + t;
          if (k >= K - 1) break;
          if (ok && k < a && row[k] != 0) bits |= 1u << t;
        }
      }
      mask[c][w] = bits;
    }
  }

  double score[C];
  int bp[C];
  scan<G, C>(p, mask, init, K, score, bp);
  store<G, C>(p, score, bp, scores, bps, K);
}

template <int G, int C>
struct Shape {
  static constexpr int kG = G, kC = C;
};

// Calls f(Shape<G, C>{}) with the segment and slots of problems of K
// anchors: G the power of two >= K up to 32 lanes, then C anchors a lane.
template <typename F>
cudaError_t dispatch(int K, F&& f) {
  if (K <= 1) return f(Shape<1, 1>{});
  if (K <= 2) return f(Shape<2, 1>{});
  if (K <= 4) return f(Shape<4, 1>{});
  if (K <= 8) return f(Shape<8, 1>{});
  if (K <= 16) return f(Shape<16, 1>{});
  if (K <= 32) return f(Shape<32, 1>{});
  if (K <= 64) return f(Shape<32, 2>{});
  if (K <= 96) return f(Shape<32, 3>{});
  return f(Shape<32, 4>{});
}

unsigned blocks_for(int B, int G) {
  const long long warps = (static_cast<long long>(B) + 32 / G - 1) / (32 / G);
  return static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// Launches the scan over compat (B, K, K) uint8 on `stream` (a
// cudaStream_t).  Returns cudaGetLastError() after the launch: 0 when the
// launch was accepted.  B >= 1, 1 <= K <= 128.
int ms_chain_scan(const void* compat, const void* init, void* scores, void* bps,
                  int B, int K, void* stream) {
  if (B < 1 || K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(K, [&](auto shape) {
    using S = decltype(shape);
    chain_scan_kernel<S::kG, S::kC><<<blocks_for(B, S::kG), kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(compat), static_cast<const double*>(init),
        static_cast<double*>(scores), static_cast<int32_t*>(bps), B, K);
    return cudaGetLastError();
  }));
}

// Launches the fused chaining DP over the packed batch (state.py: fields,
// 13 float64 planes of N anchors; flags, N uint8; offsets, B + 1 int32) on
// `stream`.  scores (B, K) float64 and bps (B, K) int32 are written.
// Returns cudaGetLastError() after the launch.  B >= 1, 1 <= K <= 128,
// N >= 0.
int ms_chain_dp(const void* fields, const void* flags, const void* offsets, void* scores,
                void* bps, int B, int K, int N, double wiggle_room, void* stream) {
  if (B < 1 || K < 1 || K > kMaxK || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(K, [&](auto shape) {
    using S = decltype(shape);
    const auto* f = static_cast<const double*>(fields);
    const auto* g = static_cast<const uint8_t*>(flags);
    const auto* o = static_cast<const int32_t*>(offsets);
    auto* s = static_cast<double*>(scores);
    auto* b = static_cast<int32_t*>(bps);
    const auto st = static_cast<cudaStream_t>(stream);
    if constexpr (S::kC == 1)
      chain_dp_segment_kernel<S::kG><<<blocks_for(B, S::kG), kThreads, 0, st>>>(
          f, g, o, s, b, B, K, N, wiggle_room);
    else
      chain_dp_kernel<S::kG, S::kC><<<blocks_for(B, S::kG), kThreads, 0, st>>>(
          f, g, o, s, b, B, K, N, wiggle_room);
    return cudaGetLastError();
  }));
}

const char* ms_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
