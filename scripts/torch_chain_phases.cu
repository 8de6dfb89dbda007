// The fused chaining kernel's segment path (K = 8) with parts of its work
// left out, to time them apart: scripts/torch_chain_phases.py builds this
// file with the kernel source included and launches each variant.
//
//   0 full         the kernel as shipped
//   1 no_pairs     no pair tests: each row admits every earlier anchor, so
//                  of an anchor's fields only its score is read
//   2 no_scan      no scan: the rows' masks stored instead
//   3 loads        the anchors' loads and the stores only
//   4 corrected    the loads, the corrected ranges (four divisions an
//                  anchor) and the stores
//   5 full_no_div  the kernel with the corrected ranges replaced by sums
#include "../muchsalsa_tpu_torch/csrc/chain_scan.cu"

namespace {
template <int G, int MODE>
__global__ void __launch_bounds__(kThreads)
phase_kernel(const double* __restrict__ fields, const uint8_t* __restrict__ flags,
           const int32_t* __restrict__ offsets, double* __restrict__ scores,
           int32_t* __restrict__ bps, int B, int K, int N, double wiggle) {
  constexpr int kMaxPairs = G > 1 ? (32 / G) * (G * (G - 1) / 2) : 1;
  __shared__ double sh[kWarpsPerBlock][kPairValues][32];
  __shared__ uint16_t sh_pairs[kWarpsPerBlock][kMaxPairs];
  __shared__ uint32_t sh_mask[kWarpsPerBlock][32];
  const long long first = warp_first<G>();
  if (first >= B) return;
  const Place<G> p = place<G>(first, B);
  const int w = threadIdx.x >> 5;
  const long long plane = N;
  const Span span = problem_span(p.has, p.b, offsets, K);
  const bool valid = span.holds(p.j, N);
  const long long at = static_cast<long long>(span.start) + p.j;
  const unsigned fl = valid ? flags[at] : 0u;
  const long long out = p.b * K + p.j;
  Anchor x = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double init[1] = {kNeg};
  if (valid) {
    const double* f = fields + at;
    const double ov_s = f[kOvS * plane], ov_e = f[kOvE * plane];
    x.v_ns = f[kVNs * plane];
    x.v_ne = f[kVNe * plane];
    x.w_ns = f[kWNs * plane];
    x.w_ne = f[kWNe * plane];
    if (MODE == 3 || MODE == 5) {
      x.v_lo = f[kVIs * plane] + f[kVIe * plane] + f[kVRr * plane] + ov_s;
      x.w_lo = f[kWIs * plane] + f[kWIe * plane] + f[kWRr * plane] + ov_e;
    } else {
      corrected(x.v_ns, x.v_ne, f[kVIs * plane], f[kVIe * plane], f[kVRr * plane],
                (fl & kVDir) != 0, ov_s, ov_e, x.v_lo, x.v_hi);
      corrected(x.w_ns, x.w_ne, f[kWIs * plane], f[kWIe * plane], f[kWRr * plane],
                (fl & kWDir) != 0, ov_s, ov_e, x.w_lo, x.w_hi);
    }
    init[0] = f[kScore * plane];
  }
  if (MODE == 3 || MODE == 4) {  // loads (4: and corrections) only
    if (p.has && p.j < K) {
      scores[out] = init[0] + x.v_lo + x.v_hi + x.w_lo + x.w_hi + x.v_ns + x.v_ne + x.w_ns + x.w_ne;
      bps[out] = -1;
    }
    return;
  }
  put_anchor(sh[w], p.lane, x);
  sh_mask[w][p.lane] = 0u;
  const unsigned seg0 = p.lane - p.j;
  const unsigned seg_valid = (__ballot_sync(kFull, valid) & p.seg) >> seg0;
  const unsigned cls_bits = __ballot_sync(kFull, (fl & kClsDir) != 0);
  const unsigned below = valid ? seg_valid & ((1u << p.j) - 1u) : 0u;
  uint32_t m;
  if (MODE == 1) {  // no pair tests: every earlier valid anchor admitted
    m = below;
  } else {
    const int mine = __popc(below);
    int offset = mine;
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
      if (compatible(get_anchor(sh[w], sl), get_anchor(sh[w], sk), (cls_bits >> sl) & 1u, wiggle))
        atomicOr(&sh_mask[w][sl], 1u << (sk % G));
    }
    __syncwarp();
    m = sh_mask[w][p.lane];
  }
  if (MODE == 2) {  // no scan
    if (p.has && p.j < K) {
      scores[out] = init[0];
      bps[out] = static_cast<int>(m);
    }
    return;
  }
  const uint32_t mask[1][1] = {{m}};
  double score[1];
  int bp[1];
  scan<G, 1>(p, mask, init, K, score, bp);
  store<G, 1>(p, score, bp, scores, bps, K);
}
}  // namespace

extern "C" int ms_chain_phase(int mode, const void* fields, const void* flags,
                              const void* offsets, void* scores, void* bps, int B, int K, int N,
                              double wiggle, void* stream) {
  if (K != 8) return static_cast<int>(cudaErrorInvalidValue);
  const auto* f = static_cast<const double*>(fields);
  const auto* g = static_cast<const uint8_t*>(flags);
  const auto* o = static_cast<const int32_t*>(offsets);
  auto* s = static_cast<double*>(scores);
  auto* b = static_cast<int32_t*>(bps);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(B, 8);
#define MS_PHASE(M)                                                              \
  case M:                                                                        \
    phase_kernel<8, M><<<blocks, kThreads, 0, st>>>(f, g, o, s, b, B, K, N, wiggle); \
    break;
  switch (mode) {
    MS_PHASE(0)
    MS_PHASE(1)
    MS_PHASE(2)
    MS_PHASE(3)
    MS_PHASE(4)
    MS_PHASE(5)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MS_PHASE
  return static_cast<int>(cudaGetLastError());
}
