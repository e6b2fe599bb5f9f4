// One radix-S DFT level of the four-step NTT (S <= 128):
//   out[b, k, c] = mont_reduce(sum_j W[k, j] * x[b, j, c]) (* tw)
// with W[k, j] = w^(kj) in Montgomery form, so the reduced sum is the
// DFT in Montgomery form. The optional twiddle is a Montgomery factor
// per (k, c) that wraps over b (the four-step level twiddle), or one
// scalar (the inverse transform's 1/N).
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_ntt_level
// (_ntt_level_kernel). The TPU kernel splits W and x into byte planes to
// feed its int8/bf16 matrix unit; none of that is carried over.
// Bound on the H100: integer multiplies. Each output needs S products of
// two 256-bit numbers (64 mad.wide.u32 each, 8192 at S = 128) against
// 64 bytes read and written, so this is compute bound by a wide margin.
// Design: the exact 512-bit sum t < S * p^2 is accumulated without any
// reduction in 2*NW + 1 64-bit column accumulators (each column takes
// at most 2 * NW terms below 2^32 per product, so 128 products stay
// below 2^44); one word-serial Montgomery reduction and the
// conditional-subtract chain derived from the bound bring it below p
// (hodor_tpu/ntt/matmul.py _reduction_chain). A block computes an 8 x 32
// tile of (k, column) outputs and streams W and x through shared memory
// in steps of 8 j, x stored word-major so a warp reads 32 consecutive
// words.
#include "field.cuh"

namespace hodor {

constexpr int kTileK = 8;
constexpr int kTileCols = 32;
constexpr int kTileJ = 8;

template <int N16>
__global__ void __launch_bounds__(kTileK * kTileCols)
    ntt_level_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                     const int32_t* __restrict__ w, long long batch, int size, long long cols,
                     int tw_mode, const int32_t* __restrict__ tw, LevelConsts lc) {
  constexpr int NW = N16 / 2;
  __shared__ uint32_t xs[kTileJ][NW][kTileCols];
  __shared__ uint32_t ws[kTileK][kTileJ][NW];

  const int tx = threadIdx.x;  // column within the tile
  const int ty = threadIdx.y;  // k within the tile
  const long long total_cols = batch * cols;
  const long long col = (long long)blockIdx.x * kTileCols + tx;
  const int k = blockIdx.y * kTileK + ty;
  const bool col_ok = col < total_cols;
  const long long b = col_ok ? col / cols : 0;
  const long long c = col_ok ? col % cols : 0;
  const int tid = ty * kTileCols + tx;

  uint64_t acc[2 * NW + 1];
#pragma unroll
  for (int q = 0; q < 2 * NW + 1; ++q) acc[q] = 0;

  for (int j0 = 0; j0 < size; j0 += kTileJ) {
    // x tile: thread (ty, tx) loads x[b, j0 + ty, c]
    {
      const int j = j0 + ty;
      uint32_t v[NW];
      if (col_ok && j < size) {
        load_words<NW>(x + ((b * size + j) * cols + c) * N16, v);
      } else {
#pragma unroll
        for (int q = 0; q < NW; ++q) v[q] = 0;
      }
#pragma unroll
      for (int q = 0; q < NW; ++q) xs[ty][q][tx] = v[q];
    }
    // W tile: kTileK * kTileJ * NW words of the (S, S, n16) limb matrix
    for (int e = tid; e < kTileK * kTileJ * NW; e += kTileK * kTileCols) {
      const int kk = e / (kTileJ * NW);
      const int jj = (e / NW) % kTileJ;
      const int q = e % NW;
      const int kg = blockIdx.y * kTileK + kk;
      const int jg = j0 + jj;
      uint32_t word = 0;
      if (kg < size && jg < size) {
        const int32_t* wp = w + ((long long)kg * size + jg) * N16 + 2 * q;
        word = (uint32_t)wp[0] | ((uint32_t)wp[1] << 16);
      }
      ws[kk][jj][q] = word;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kTileJ; ++jj) {
      uint32_t xv[NW];
#pragma unroll
      for (int q = 0; q < NW; ++q) xv[q] = xs[jj][q][tx];
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const uint32_t wi = ws[ty][jj][i];
#pragma unroll
        for (int l = 0; l < NW; ++l) {
          const uint64_t prod = (uint64_t)wi * xv[l];
          acc[i + l] += (uint32_t)prod;
          acc[i + l + 1] += prod >> 32;
        }
      }
    }
    __syncthreads();
  }
  if (!col_ok || k >= size) return;

  // carry the columns into 2*NW + 1 words of t
  uint32_t t[2 * NW + 1];
  uint64_t carry = 0;
#pragma unroll
  for (int q = 0; q < 2 * NW + 1; ++q) {
    const uint64_t s = acc[q] + carry;
    t[q] = (uint32_t)s;
    carry = s >> 32;
  }
  uint32_t u[NW];
  mont_reduce_wide<NW>(u, t, lc);
  apply_twiddle<NW>(u, tw_mode, tw, (long long)k * cols + c, lc.f);
  store_words<NW>(out + ((b * size + k) * cols + c) * N16, u);
}

template <int N16>
static int launch_ntt_level(int32_t* out, const int32_t* x, const int32_t* w, long long batch,
                            int size, long long cols, int tw_mode, const int32_t* tw,
                            const uint32_t* p_words, uint32_t pinv0, const uint32_t* chain,
                            int n_chain, cudaStream_t stream) {
  constexpr int NW = N16 / 2;
  if (n_chain > kMaxChain || size < 1 || size > 128) return (int)cudaErrorInvalidValue;
  const LevelConsts lc = make_level_consts(NW, p_words, pinv0, chain, n_chain);
  const long long total_cols = batch * cols;
  dim3 block(kTileCols, kTileK);
  dim3 grid((unsigned)((total_cols + kTileCols - 1) / kTileCols),
            (unsigned)((size + kTileK - 1) / kTileK));
  ntt_level_kernel<N16><<<grid, block, 0, stream>>>(out, x, w, batch, size, cols, tw_mode, tw,
                                                    lc);
  return (int)cudaGetLastError();
}

}  // namespace hodor

extern "C" int hodor_ntt_level(int n16, int32_t* out, const int32_t* x, const int32_t* w,
                               long long batch, int size, long long cols, int tw_mode,
                               const int32_t* tw, const uint32_t* p_words, uint32_t pinv0,
                               const uint32_t* chain, int n_chain, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n16 == 4)
    return hodor::launch_ntt_level<4>(out, x, w, batch, size, cols, tw_mode, tw, p_words, pinv0,
                                      chain, n_chain, s);
  if (n16 == 16)
    return hodor::launch_ntt_level<16>(out, x, w, batch, size, cols, tw_mode, tw, p_words,
                                       pinv0, chain, n_chain, s);
  return (int)cudaErrorInvalidValue;
}
