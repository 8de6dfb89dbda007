// Pieces of the banded Myers kernel (myers_banded.cu): the PEq build and one
// Myers 1999 block step of one 32-bit pattern word.
// Everything here has internal linkage, so each kernel source gets its own
// copy and the shared library links without duplicate symbols.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ms {
namespace {

constexpr int kThreads = 128;

// PEq[c][w][p] (uint32, c in 0..3) from the padded query codes (P, M): bit
// b of word w is set where q[p, 32 w + b] == c; positions >= M count as the
// padding code 5 and set nothing.  One thread per (word, problem), the
// problem index fastest, so the four stores of a warp are coalesced.
__global__ void __launch_bounds__(kThreads)
build_peq_kernel(const uint8_t* __restrict__ q, uint32_t* __restrict__ peq,
                 int P, int M, int n_words) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid >= static_cast<long long>(P) * n_words) return;
  const int p = static_cast<int>(tid % P);
  const int w = static_cast<int>(tid / P);
  uint32_t bits[4] = {0u, 0u, 0u, 0u};
  const uint8_t* row = q + static_cast<long long>(p) * M;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int i = w * 32 + b;
    const int c = i < M ? row[i] : 5;
    bits[0] |= (c == 0 ? 1u : 0u) << b;
    bits[1] |= (c == 1 ? 1u : 0u) << b;
    bits[2] |= (c == 2 ? 1u : 0u) << b;
    bits[3] |= (c == 3 ? 1u : 0u) << b;
  }
  const long long plane = static_cast<long long>(n_words) * P;
  const long long at = static_cast<long long>(w) * P + p;
#pragma unroll
  for (int c = 0; c < 4; ++c) peq[c * plane + at] = bits[c];
}

// One block step of one pattern word for one text column.  eq is the word's
// PEq for the column's code (0 for codes >= 4); hin the horizontal delta
// entering the word from above (+1, 0 or -1).  Updates vp and vn, returns
// the word's horizontal output delta, and gives ph and mh before the shift
// (the score is read there).  uint32 arithmetic wraps as the reference's
// masked sum does, and the left shifts drop the top bit.
__device__ __forceinline__ int myers_word_step(uint32_t eq, int hin, uint32_t& vp,
                                               uint32_t& vn, uint32_t& ph, uint32_t& mh) {
  if (hin < 0) eq |= 1u;
  const uint32_t xv = eq | vn;
  const uint32_t xh = (((eq & vp) + vp) ^ vp) | eq;
  ph = vn | ~(xh | vp);
  mh = vp & xh;
  const int hout = (ph & 0x80000000u) ? 1 : ((mh & 0x80000000u) ? -1 : 0);
  const uint32_t phs = (ph << 1) | (hin > 0 ? 1u : 0u);
  const uint32_t mhs = (mh << 1) | (hin < 0 ? 1u : 0u);
  vp = mhs | ~(xv | phs);
  vn = phs & xv;
  return hout;
}

}  // namespace
}  // namespace ms
