// Exact (unbanded) Myers bit-parallel edit distance: one warp segment per
// problem, K pattern words per lane, pipelined along anti-diagonals
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
// What bounds it on the card: int32 issue.  One (column, word) step is ~15
// integer ops (the word step below, with three-input logic fused), so a
// batch needs 15 * sum_p ceil(m_p / 32) * min(n_p, cols) of them, at 64
// int32 ops per clock per SM.  Each problem is one dependent chain along the
// columns, and inside a column along the words (the horizontal carry); the
// bytes (each code read once) are ~100x below the ops on this card.
//
// What the design does about it:
// - A problem of W words runs on L = ceil(W / K) consecutive lanes of a
//   warp, lane w holding words w*K .. w*K + K-1 (K in {1, 2, 4, 8}), and a
//   warp holds floor(32 / L) problems.  At step s lane w runs text column
//   j = s - w over its K words in order; the horizontal delta that enters
//   its first word is the one lane w - 1 produced for column j one step
//   earlier, taken with one __shfl_sync, and the column's code rides in the
//   same word, so only a problem's first lane takes the text (a byte a
//   step, in order; every lane loads it, branch-free, at the problem's one
//   address) and +1.  A problem takes min(n, cols) + L - 1 steps.
// - A lane's step costs a fixed part (the shuffle, the text, the loop) plus
//   K word steps, so the wrapper picks, per problem, the K that needs the
//   fewest issue slots over its L lanes, and sorts the problems by
//   descending K, L and columns: a warp's problems end together, one
//   launch runs every class, and the warps with the longest steps start
//   first.  Each result goes to its problem's own slot.
// - Between the ramps, the steps at which every lane whose state counts is
//   inside its columns run without the per-lane column check (no
//   convergence barrier per step).
// - Each lane builds the PEq words of its own pattern words from q and keeps
//   them, with VP and VN, in registers: no PEq pass, no PEq tensor.
// - The score is not tracked per column: after the last column it is
//   min(n, cols) + popc(VP) - popc(VN) over the rows 0..m-1 (the vertical
//   deltas of the last column, from row 0 where D[0][j] = j), summed over
//   the problem's lanes by a segmented shuffle reduction.
// - Past 256 words (8,192 rows) a problem takes a whole warp,
//   k = ceil(W / 32) words per lane, with VP, VN and PEq in device-memory
//   scratch laid out so that the warp's 32 lanes touch 32 neighbouring
//   words: no length is refused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kTop = 0x80000000u;
constexpr int kClasses = 5;     // K = 1, 2, 4, 8 in registers; device memory
constexpr int kStateClass = kClasses - 1;
constexpr int kMaxGroups = 4 * 32 + 1;  // (class, lanes per problem) pairs

// The problems of the launch: groups of one class and segment length (lanes
// per problem), each a run of slots of `order`; group i's warps are
// [warp0[i], warp0[i + 1]).  The state class is one group.
struct Groups {
  int n;
  uint8_t cls[kMaxGroups];
  uint8_t seg[kMaxGroups];
  int start[kMaxGroups];
  int count[kMaxGroups];
  int warp0[kMaxGroups + 1];
};

struct WarpJob {
  int cls;
  int seg;          // lanes per problem
  int first;        // first slot of `order`
  int count;        // problems of this warp (32 / seg, fewer in a group's last warp)
  int class_warp0;  // the group's first warp, and its warp count
  int class_warps;
};

__device__ __forceinline__ bool warp_job(const Groups& g, int gw, WarpJob& job) {
  for (int i = 0; i < g.n; ++i) {
    if (gw < g.warp0[i + 1]) {
      const int per = 32 / g.seg[i];
      job.cls = g.cls[i];
      job.seg = g.seg[i];
      job.first = g.start[i] + (gw - g.warp0[i]) * per;
      const int left = g.start[i] + g.count[i] - job.first;
      job.count = left < per ? left : per;
      job.class_warp0 = g.warp0[i];
      job.class_warps = g.warp0[i + 1] - g.warp0[i];
      return true;
    }
  }
  return false;
}

// PEq of one 32-bit pattern word: e[c] has bit b set where position
// 32 * word + b of a query row of width M holds code c (positions >= M
// count as the padding code 5).
struct Peq {
  uint32_t e[4];
};

__device__ __forceinline__ Peq build_peq(const uint8_t* qrow, int M, int word) {
  Peq p = {{0u, 0u, 0u, 0u}};
  const int base = word * 32;
#pragma unroll 8
  for (int b = 0; b < 32; ++b) {
    const int i = base + b;
    const int c = i < M ? qrow[i] : 5;
    const uint32_t bit = 1u << b;
#pragma unroll
    for (int k = 0; k < 4; ++k) p.e[k] |= c == k ? bit : 0u;
  }
  return p;
}

// The rows of pattern word `word` that lie above row m: all ones before the word
// holding row m - 1, its low bits there, zero past it.
__device__ __forceinline__ uint32_t row_mask(int word, int m) {
  const int rows = m - word * 32;
  return rows >= 32 ? ~0u : (rows <= 0 ? 0u : (1u << rows) - 1u);
}

// One Myers 1999 block step of one pattern word for one text column.  eq is
// the word's PEq for the column's code; nmask is all ones for codes 0-3 and
// zero for N.  The horizontal delta entering the word is +1 where bit 31 of
// hp_in is set, -1 where bit 31 of hn_in is set (never both), else 0.
// Updates vp and vn and gives ph and mh before the shift, whose bit 31 is
// the word's output delta (ph and mh are disjoint, as vp and vn are).  uint32
// arithmetic wraps as the reference's masked sum does.
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

// The word a lane hands to the next lane: bit 31 its +1 output, bit 30 its
// -1 output, bits 0-2 the column's code.
__device__ __forceinline__ uint32_t pack_carry(uint32_t ph, uint32_t mh, int c) {
  return (ph & kTop) | ((mh >> 1) & (kTop >> 1)) | static_cast<uint32_t>(c);
}

// One step's input of a lane: the column's code and the entering delta.  A
// problem's first lane reads the code itself and takes +1.
struct StepIn {
  int c;
  uint32_t hp, hn, nmask;
};

__device__ __forceinline__ StepIn step_in(uint32_t in, bool first, int own_code) {
  StepIn x;
  x.c = first ? own_code : static_cast<int>(in & 7u);
  x.hp = first ? kTop : in;
  x.hn = first ? 0u : in << 1;
  x.nmask = x.c < 4 ? ~0u : 0u;
  return x;
}

// The PEq word of code c in 0..7 (codes 4-7 pick a word that nmask then
// clears).
__device__ __forceinline__ uint32_t select_eq(int c, uint32_t e0, uint32_t e1, uint32_t e2,
                                              uint32_t e3) {
  const uint32_t lo = (c & 1) ? e1 : e0;
  const uint32_t hi = (c & 1) ? e3 : e2;
  return (c & 2) ? hi : lo;
}

// The code of text column j of a lane's row, 4 (N) at and past `cols`;
// branch-free, so every lane loads (a problem's lanes share the address).
// `last` is max(cols - 1, 0): the load stays inside the row.
__device__ __forceinline__ int text_code(const uint8_t* trow, int j, int cols, int last) {
  const int b = trow[j < last ? j : last];
  return j < cols && b < 4 ? b : 4;
}

// What a lane knows about its problem.
struct Lane {
  int lane, w;  // lane of the warp; word-lane within the problem
  int p;        // problem index (0 when the lane has none)
  bool keep;    // the lane's state makes a result: it has a problem and m > 0
  bool has;     // the lane belongs to a problem
  int m, n;
  int cols;     // columns this lane runs: min(n, cols) on a used lane, else 0
};

__device__ __forceinline__ Lane lane_setup(const WarpJob& job, const int32_t* __restrict__ order,
                                           const int32_t* __restrict__ q_len,
                                           const int32_t* __restrict__ t_len, int cols, int k) {
  Lane L;
  L.lane = threadIdx.x & 31;
  const int sub = L.lane / job.seg;
  L.w = L.lane - sub * job.seg;
  L.has = sub < job.count;
  L.p = L.has ? order[job.first + sub] : 0;
  L.m = L.has ? q_len[L.p] : 0;
  L.n = L.has ? t_len[L.p] : 0;
  L.keep = L.has && L.m > 0;
  const int used = L.m > 0 ? ((L.m + 31) / 32 + k - 1) / k : 0;
  L.cols = L.w < used ? (L.n < cols ? L.n : cols) : 0;
  return L;
}

// Sum of v over the lanes of each problem's segment, in the segment's first
// lane.
__device__ __forceinline__ int segment_sum(int v, int w, int seg) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_down_sync(kFull, v, off);
    if (w + off < seg) v += u;
  }
  return v;
}

__device__ __forceinline__ void write_result(const Lane& L, int delta, int cols, int32_t* out) {
  if (L.has && L.w == 0) {
    const int last_col = L.n < cols ? L.n : cols;
    out[L.p] = L.m > 0 ? last_col + delta : L.n;
  }
}

// A lane's state in registers: K words' PEq, VP and VN, the carry it hands
// on and the next column's code (read ahead by one step).
template <int K>
struct Words {
  uint32_t e0[K], e1[K], e2[K], e3[K], vp[K], vn[K];
  uint32_t carry;
  int next_code;
};

// One step s of a lane: column s - w over its K words.  kChecked runs the
// words only where that column is one of the lane's (the ramps); in the
// steady stretch every lane whose state counts is inside its columns, and
// the others compute what nobody reads.
template <int K, bool kChecked>
__device__ __forceinline__ void lane_step(int s, const Lane& L, bool first, int src,
                                          const uint8_t* trow, int last, Words<K>& st) {
  const uint32_t in = __shfl_sync(kFull, st.carry, src);
  const StepIn x = step_in(in, first, st.next_code);
  st.next_code = text_code(trow, s + 1, L.cols, last);
  if (!kChecked || static_cast<unsigned>(s - L.w) < static_cast<unsigned>(L.cols)) {
    uint32_t hp = x.hp, hn = x.hn;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      uint32_t ph, mh;
      word_step(select_eq(x.c, st.e0[i], st.e1[i], st.e2[i], st.e3[i]), x.nmask, hp, hn,
                st.vp[i], st.vn[i], ph, mh);
      hp = ph;
      hn = mh;
    }
    st.carry = pack_carry(hp, hn, x.c);
  }
}

// A warp's problems with K words per lane, VP, VN and PEq in registers.
template <int K>
__device__ __forceinline__ void run_registers(const WarpJob& job, const uint8_t* __restrict__ q,
                                              const int32_t* __restrict__ q_len,
                                              const uint8_t* __restrict__ t,
                                              const int32_t* __restrict__ t_len,
                                              const int32_t* __restrict__ order,
                                              int32_t* __restrict__ out, int M, int N, int cols) {
  const Lane L = lane_setup(job, order, q_len, t_len, cols, K);
  const int T = __reduce_max_sync(kFull, L.cols > 0 ? L.cols + L.w : 0);
  // the steps at which every lane whose state counts is inside its columns
  const int lo = __reduce_max_sync(kFull, L.keep ? L.w : 0);
  const int hi = min(T, static_cast<int>(__reduce_min_sync(
                            kFull, L.keep ? static_cast<unsigned>(L.cols + L.w) : 0x7FFFFFFFu)));

  Words<K> st;
  const uint8_t* qrow = q + static_cast<long long>(L.p) * M;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const Peq e = L.cols > 0 ? build_peq(qrow, M, L.w * K + i) : Peq{{0u, 0u, 0u, 0u}};
    st.e0[i] = e.e[0];
    st.e1[i] = e.e[1];
    st.e2[i] = e.e[2];
    st.e3[i] = e.e[3];
    st.vp[i] = ~0u;
    st.vn[i] = 0u;
  }

  const uint8_t* trow = t + static_cast<long long>(L.p) * N;
  const int last = L.cols > 0 ? L.cols - 1 : 0;
  const bool first = L.w == 0;
  const int src = L.lane > 0 ? L.lane - 1 : 0;
  st.carry = 0u;
  st.next_code = L.cols > 0 ? text_code(trow, 0, L.cols, last) : 4;
  int s = 0;
  for (; s < T && s < lo; ++s) lane_step<K, true>(s, L, first, src, trow, last, st);
  for (; s < hi; ++s) lane_step<K, false>(s, L, first, src, trow, last, st);
  for (; s < T; ++s) lane_step<K, true>(s, L, first, src, trow, last, st);

  int delta = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const uint32_t rows = row_mask(L.w * K + i, L.m);
    delta += __popc(st.vp[i] & rows) - __popc(st.vn[i] & rows);
  }
  write_result(L, segment_sum(delta, L.w, job.seg), cols, out);
}

// A problem past 256 words: the whole warp, k = ceil(words / 32)
// consecutive words per lane, VP, VN and PEq in device memory laid out
// [plane][i][warp][lane] (plane stride kmax * n_warps * 32 words; gw is the
// warp's index among those n_warps).
__device__ __forceinline__ void run_state(const WarpJob& job, const uint8_t* __restrict__ q,
                                          const int32_t* __restrict__ q_len,
                                          const uint8_t* __restrict__ t,
                                          const int32_t* __restrict__ t_len,
                                          const int32_t* __restrict__ order,
                                          int32_t* __restrict__ out, uint32_t* __restrict__ state,
                                          int M, int N, int cols, int kmax, int gw, int n_warps) {
  const int m0 = q_len[order[job.first]];
  const int k = ((m0 + 31) / 32 + 31) / 32;
  const Lane L = lane_setup(job, order, q_len, t_len, cols, k);
  const int T = __reduce_max_sync(kFull, L.cols > 0 ? L.cols + L.w : 0);

  const long long plane = static_cast<long long>(kmax) * n_warps * 32;
  auto at = [&](int pl, int i) {
    return pl * plane + (static_cast<long long>(i) * n_warps + gw) * 32 + L.lane;
  };
  const uint8_t* qrow = q + static_cast<long long>(L.p) * M;
  for (int i = 0; i < k; ++i) {
    const Peq e = L.cols > 0 ? build_peq(qrow, M, L.w * k + i) : Peq{{0u, 0u, 0u, 0u}};
    state[at(0, i)] = ~0u;
    state[at(1, i)] = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) state[at(2 + c, i)] = e.e[c];
  }

  const uint8_t* trow = t + static_cast<long long>(L.p) * N;
  const int last = L.cols > 0 ? L.cols - 1 : 0;
  const bool first = L.w == 0;
  const int src = L.lane > 0 ? L.lane - 1 : 0;
  uint32_t carry = 0u;
  int next_code = L.cols > 0 ? text_code(trow, 0, L.cols, last) : 4;
  for (int s = 0; s < T; ++s) {
    const uint32_t in = __shfl_sync(kFull, carry, src);
    const StepIn x = step_in(in, first, next_code);
    next_code = text_code(trow, s + 1, L.cols, last);
    if (static_cast<unsigned>(s - L.w) < static_cast<unsigned>(L.cols)) {
      uint32_t hp = x.hp, hn = x.hn;
      for (int i = 0; i < k; ++i) {
        uint32_t vp = state[at(0, i)];
        uint32_t vn = state[at(1, i)];
        const uint32_t eq = state[at(2 + (x.c & 3), i)];
        uint32_t ph, mh;
        word_step(eq, x.nmask, hp, hn, vp, vn, ph, mh);
        state[at(0, i)] = vp;
        state[at(1, i)] = vn;
        hp = ph;
        hn = mh;
      }
      carry = pack_carry(hp, hn, x.c);
    }
  }

  int delta = 0;
  for (int i = 0; i < k; ++i) {
    const uint32_t rows = row_mask(L.w * k + i, L.m);
    delta += __popc(state[at(0, i)] & rows) - __popc(state[at(1, i)] & rows);
  }
  write_result(L, segment_sum(delta, L.w, job.seg), cols, out);
}

// Every class in one launch, the warps of each group in the groups' order
// (the planner puts the longest steps first).
__global__ void __launch_bounds__(kThreads)
myers_full_kernel(const uint8_t* __restrict__ q, const int32_t* __restrict__ q_len,
                  const uint8_t* __restrict__ t, const int32_t* __restrict__ t_len,
                  const int32_t* __restrict__ order, int32_t* __restrict__ out,
                  uint32_t* __restrict__ state, int M, int N, int cols, int kmax,
                  Groups groups) {
  WarpJob job;
  const int gw = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  // warps never synchronise across the block, so a whole warp may leave
  if (!warp_job(groups, gw, job)) return;
  switch (job.cls) {
    case 0: run_registers<1>(job, q, q_len, t, t_len, order, out, M, N, cols); break;
    case 1: run_registers<2>(job, q, q_len, t, t_len, order, out, M, N, cols); break;
    case 2: run_registers<4>(job, q, q_len, t, t_len, order, out, M, N, cols); break;
    case 3: run_registers<8>(job, q, q_len, t, t_len, order, out, M, N, cols); break;
    default:
      run_state(job, q, q_len, t, t_len, order, out, state, M, N, cols, kmax,
                gw - job.class_warp0, job.class_warps);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t).  order (P,) int32 is
// the schedule; groups is a host array of n_groups rows (class, lanes per
// problem, first slot, count) in launch order, classes 0-3 holding K = 1,
// 2, 4, 8 words per lane in registers and class 4 (one group, one problem
// per warp, lanes 32) the longer patterns, whose state (6 * kmax * its
// problem count * 32 uint32) the caller allocates.  out is (P,) int32.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
int ms_myers_full(const void* q, const void* q_len, const void* t, const void* t_len,
                  const void* order, void* out, void* state, const int* groups, int n_groups,
                  int P, int M, int N, int cols, int kmax, void* stream) {
  if (P < 1 || M < 0 || N < 0 || cols < 0 || cols > N || kmax < 0 || n_groups < 1 ||
      n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  Groups g = {};
  int covered = 0, state_groups = 0;
  for (int r = 0; r < n_groups; ++r) {
    const int cls = groups[4 * r], seg = groups[4 * r + 1];
    const int start = groups[4 * r + 2], count = groups[4 * r + 3];
    const bool seg_ok = seg >= 1 && seg <= 32 && (cls < kStateClass || seg == 32);
    if (cls < 0 || cls >= kClasses || !seg_ok || count < 1 || start != covered ||
        (cls == kStateClass && (kmax < 1 || state_groups++ > 0)))
      return static_cast<int>(cudaErrorInvalidValue);
    g.cls[r] = static_cast<uint8_t>(cls);
    g.seg[r] = static_cast<uint8_t>(seg);
    g.start[r] = start;
    g.count[r] = count;
    g.warp0[r + 1] = g.warp0[r] + (count + 32 / seg - 1) / (32 / seg);
    covered += count;
  }
  g.n = n_groups;
  if (covered != P) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = g.warp0[n_groups];
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  myers_full_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const int32_t*>(q_len),
      static_cast<const uint8_t*>(t), static_cast<const int32_t*>(t_len),
      static_cast<const int32_t*>(order), static_cast<int32_t*>(out),
      static_cast<uint32_t*>(state), M, N, cols, kmax, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
