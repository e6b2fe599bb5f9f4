// The reduce half of the two-step NTT level: per output element, fold
// 4 n16 - 1 base-256 columns into the integer t = sum_c cols[c] 256^c
// (t < radix * p^2), reduce it to t * R^-1 mod p, and multiply by the
// level's twiddle.
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_wide_reduce
// (_wide_reduce_kernel). The TPU kernel folds the columns into relaxed
// 16-bit limbs in two interleaved halves because it has no 64-bit
// integer; here a 64-bit running carry emits t one byte per column.
// Bound on the H100: device-memory bytes, (4 n16 - 1) * 4 bytes of
// columns read per element (252 at n16 = 16) beside 64 written and 64 of
// twiddle, against about 500 integer operations.
// Design: one thread per element. The columns arrive as the int8 product
// before this kernel writes them, plane-major (C, S, B, Cc): plane c is
// one row-major (S, B * Cc) matrix, so a warp reads 32 consecutive int32
// of one plane. The output goes straight to the level's (B, S, Cc, n16)
// layout, so no transpose stands on either side.
#include "field.cuh"

namespace hodor {

// t = sum_c col(c) * 256^c over n_cols = 8 NW - 1 columns, each below
// 2^31, as 2 NW words (t[2 NW] = 0).
template <int NW, typename ColFn>
__device__ __forceinline__ void fold_columns(uint32_t (&t)[2 * NW + 1], ColFn col) {
  uint64_t run = 0;
#pragma unroll
  for (int q = 0; q < 2 * NW; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = 4 * q + b;
      if (c < 8 * NW - 1) run += col(c);
      word |= (uint32_t)(run & 0xFFu) << (8 * b);
      run >>= 8;
    }
    t[q] = word;
  }
  t[2 * NW] = 0;
}

template <int N16>
__global__ void wide_reduce_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ cols,
                                   long long batch, int size, long long ccols, int tw_mode,
                                   const int32_t* __restrict__ tw, LevelConsts lc) {
  constexpr int NW = N16 / 2;
  const long long plane = (long long)size * batch * ccols;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= plane) return;
  const long long cc = e % ccols;
  const long long b = (e / ccols) % batch;
  const long long k = e / (ccols * batch);

  uint32_t t[2 * NW + 1];
  fold_columns<NW>(t, [&](int c) { return (uint32_t)cols[c * plane + e]; });
  uint32_t u[NW];
  mont_reduce_wide<NW>(u, t, lc);
  apply_twiddle<NW>(u, tw_mode, tw, k * ccols + cc, lc.f);
  store_words_v4<NW>(out + ((b * size + k) * ccols + cc) * N16, u);
}

template <int N16>
static int launch_wide_reduce(int32_t* out, const int32_t* cols, long long batch, int size,
                              long long ccols, int tw_mode, const int32_t* tw,
                              const uint32_t* p_words, uint32_t pinv0, const uint32_t* chain,
                              int n_chain, cudaStream_t stream) {
  if (n_chain > kMaxChain || size < 1 || batch < 1 || ccols < 1)
    return (int)cudaErrorInvalidValue;
  const LevelConsts lc = make_level_consts(N16 / 2, p_words, pinv0, chain, n_chain);
  const long long total = (long long)size * batch * ccols;
  const int threads = 128;
  wide_reduce_kernel<N16><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      out, cols, batch, size, ccols, tw_mode, tw, lc);
  return (int)cudaGetLastError();
}

}  // namespace hodor

extern "C" int hodor_wide_reduce(int n16, int32_t* out, const int32_t* cols, long long batch,
                                 int size, long long ccols, int tw_mode, const int32_t* tw,
                                 const uint32_t* p_words, uint32_t pinv0,
                                 const uint32_t* chain, int n_chain, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n16 == 4)
    return hodor::launch_wide_reduce<4>(out, cols, batch, size, ccols, tw_mode, tw, p_words,
                                        pinv0, chain, n_chain, s);
  if (n16 == 16)
    return hodor::launch_wide_reduce<16>(out, cols, batch, size, ccols, tw_mode, tw, p_words,
                                         pinv0, chain, n_chain, s);
  return (int)cudaErrorInvalidValue;
}
