// The fused NTT level on int8 byte planes: a size-S DFT as an int8
// contraction of depth S * P (P = 2 n16 byte planes) per base-256 column,
// the -128 offset corrections, then the wide Montgomery reduction and the
// level's twiddle, without the columns ever reaching device memory:
//   col[c][k][m] = sum_d (w_s8[c][k][d] + 128) (x_s8[m][d] + 128)
//                = dot + 128 sx[m] + 128 w_sum[c][k] - 128^2 S P
//   out[b][k][cc] = mont_reduce(sum_c col[c] 256^c) (* tw),  m = b Cc + cc
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_dft_reduce
// (_dft_reduce_kernel), and, as hodor_s8dot, the bare int8 -> int32
// product probed by scripts/tpu_qualify.py check_s8dot. The TPU kernel
// walks the columns as its innermost grid axis and carries relaxed limbs
// in scratch between grid steps; here the column loop runs inside the
// block and a 64-bit running carry emits t one byte per column.
// Bound on the H100: integer operations. Each output element takes
// (4 n16 - 1) * S * P int8 multiply-adds (258,048 at n16 = 16, S = 128)
// against 32 bytes of x read and 64 written.
// Design: a block computes 32 k x 32 m outputs, a thread 4 k for one m.
// Per column it streams W and x through shared memory in 128-byte steps
// of depth and contracts with __dp4a (four int8 products per
// instruction); W words are read as 16-byte broadcasts, x words
// conflict-free. x_s8 is (B, Cc, S * P) with the depth contiguous, so
// four consecutive depth bytes are one dp4a operand. This first form
// rereads all of W for every 32 m and uses no tensor cores.
#include "field.cuh"

namespace hodor {

constexpr int kTileK = 32;   // outputs k per block
constexpr int kTileM = 32;   // outputs m per block
constexpr int kPerK = 4;     // k per thread
constexpr int kDepthW = 32;  // depth words (4 int8 each) per step
constexpr int kDotThreads = kTileM * (kTileK / kPerK);

struct DotTiles {
  uint32_t w[kTileK][kDepthW];
  uint32_t x[kDepthW][kTileM + 1];
};

// acc[kk] += sum over the step's depth of w[ty * kPerK + kk] . x[.][tx]
__device__ __forceinline__ void tile_dot(const DotTiles& tl, int ty, int tx, int (&acc)[kPerK]) {
#pragma unroll
  for (int d = 0; d < kDepthW; d += 4) {
    const int x0 = (int)tl.x[d][tx], x1 = (int)tl.x[d + 1][tx];
    const int x2 = (int)tl.x[d + 2][tx], x3 = (int)tl.x[d + 3][tx];
#pragma unroll
    for (int kk = 0; kk < kPerK; ++kk) {
      const uint4 wv = *reinterpret_cast<const uint4*>(&tl.w[ty * kPerK + kk][d]);
      acc[kk] = __dp4a((int)wv.x, x0, acc[kk]);
      acc[kk] = __dp4a((int)wv.y, x1, acc[kk]);
      acc[kk] = __dp4a((int)wv.z, x2, acc[kk]);
      acc[kk] = __dp4a((int)wv.w, x3, acc[kk]);
    }
  }
}

// sum of the step's x bytes of column tx (as signed int8)
__device__ __forceinline__ int tile_x_sum(const DotTiles& tl, int tx) {
  int s = 0;
#pragma unroll
  for (int d = 0; d < kDepthW; ++d) s = __dp4a(0x01010101, (int)tl.x[d][tx], s);
  return s;
}

template <int N16>
__global__ void __launch_bounds__(kDotThreads)
    dft_reduce_kernel(int32_t* __restrict__ out, const uint32_t* __restrict__ w_words,
                      const int32_t* __restrict__ w_sum, const uint32_t* __restrict__ x_words,
                      long long batch, int size, long long ccols, int tw_mode,
                      const int32_t* __restrict__ tw, LevelConsts lc) {
  constexpr int NW = N16 / 2;
  constexpr int NC = 4 * N16 - 1;
  __shared__ __align__(16) DotTiles tl;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileM + tx;
  const long long total_m = batch * ccols;
  const long long m0 = (long long)blockIdx.x * kTileM;
  const int k0 = blockIdx.y * kTileK;
  const int depth_w = size * (2 * N16) / 4;  // S * P bytes as words
  const int sp = size * 2 * N16;

  uint32_t t[kPerK][2 * NW + 1];
  uint64_t run[kPerK];
  uint32_t word[kPerK];
#pragma unroll
  for (int kk = 0; kk < kPerK; ++kk) run[kk] = 0, word[kk] = 0;
  int sx = 128 * sp;

  for (int c = 0; c < NC; ++c) {
    int acc[kPerK];
#pragma unroll
    for (int kk = 0; kk < kPerK; ++kk) acc[kk] = 0;
    for (int d0 = 0; d0 < depth_w; d0 += kDepthW) {
      for (int e = tid; e < kTileK * kDepthW; e += kDotThreads) {
        const int row = e / kDepthW, dw = e % kDepthW;
        const bool d_ok = d0 + dw < depth_w;
        const int k = k0 + row;
        tl.w[row][dw] =
            (d_ok && k < size) ? w_words[((long long)c * size + k) * depth_w + d0 + dw] : 0u;
        const long long m = m0 + row;
        tl.x[dw][row] = (d_ok && m < total_m) ? x_words[m * depth_w + d0 + dw] : 0u;
      }
      __syncthreads();
      tile_dot(tl, ty, tx, acc);
      if (c == 0) sx += tile_x_sum(tl, tx);
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < kPerK; ++kk) {
      const int k = k0 + ty * kPerK + kk;
      const int ws = k < size ? w_sum[c * size + k] : 0;
      // the exact non-negative column sum, below 2^31
      const int col = acc[kk] + 128 * sx + 128 * ws - 128 * 128 * sp;
      run[kk] += (uint32_t)col;
      word[kk] |= (uint32_t)(run[kk] & 0xFFu) << (8 * (c & 3));
      run[kk] >>= 8;
      if ((c & 3) == 3) {
        t[kk][c >> 2] = word[kk];
        word[kk] = 0;
      }
    }
  }

  const long long m = m0 + tx;
  if (m >= total_m) return;
  const long long b = m / ccols, cc = m % ccols;
#pragma unroll
  for (int kk = 0; kk < kPerK; ++kk) {
    const int k = k0 + ty * kPerK + kk;
    if (k >= size) continue;
    // NC = 3 mod 4: the carry left after the last column is t's top byte
    uint32_t tt[2 * NW + 1];
#pragma unroll
    for (int q = 0; q < 2 * NW - 1; ++q) tt[q] = t[kk][q];
    tt[2 * NW - 1] = word[kk] | ((uint32_t)(run[kk] & 0xFFu) << 24);
    tt[2 * NW] = 0;
    uint32_t u[NW];
    mont_reduce_wide<NW>(u, tt, lc);
    apply_twiddle<NW>(u, tw_mode, tw, (long long)k * ccols + cc, lc.f);
    store_words_v4<NW>(out + ((b * size + k) * ccols + cc) * N16, u);
  }
}

// The contraction alone: out (M, N) int32 = a (M, K) int8 . b (K, N) int8,
// both row-major, through the same tiles and tile_dot.
__global__ void __launch_bounds__(kDotThreads)
    s8dot_kernel(int32_t* __restrict__ out, const int8_t* __restrict__ a,
                 const int8_t* __restrict__ b, int m_rows, int depth, int n_cols) {
  __shared__ __align__(16) DotTiles tl;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileM + tx;
  const int j0 = blockIdx.x * kTileM;
  const int i0 = blockIdx.y * kTileK;
  int acc[kPerK];
#pragma unroll
  for (int kk = 0; kk < kPerK; ++kk) acc[kk] = 0;
  for (int d0 = 0; d0 < depth; d0 += 4 * kDepthW) {
    for (int e = tid; e < kTileK * kDepthW; e += kDotThreads) {
      const int row = e / kDepthW, dw = e % kDepthW;
      uint32_t wa = 0, wb = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = d0 + 4 * dw + q;
        if (d < depth && i0 + row < m_rows)
          wa |= (uint32_t)(uint8_t)a[(long long)(i0 + row) * depth + d] << (8 * q);
        if (d < depth && j0 + row < n_cols)
          wb |= (uint32_t)(uint8_t)b[(long long)d * n_cols + j0 + row] << (8 * q);
      }
      tl.w[row][dw] = wa;
      tl.x[dw][row] = wb;
    }
    __syncthreads();
    tile_dot(tl, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int kk = 0; kk < kPerK; ++kk) {
    const int i = i0 + ty * kPerK + kk;
    if (i < m_rows && j0 + tx < n_cols) out[(long long)i * n_cols + j0 + tx] = acc[kk];
  }
}

template <int N16>
static int launch_dft_reduce(int32_t* out, const int8_t* w_s8, const int32_t* w_sum,
                             const int8_t* x_s8, long long batch, int size, long long ccols,
                             int tw_mode, const int32_t* tw, const uint32_t* p_words,
                             uint32_t pinv0, const uint32_t* chain, int n_chain,
                             cudaStream_t stream) {
  if (n_chain > kMaxChain || size < 1 || size > 128 || batch < 1 || ccols < 1)
    return (int)cudaErrorInvalidValue;
  const LevelConsts lc = make_level_consts(N16 / 2, p_words, pinv0, chain, n_chain);
  const long long total_m = batch * ccols;
  dim3 block(kTileM, kTileK / kPerK);
  dim3 grid((unsigned)((total_m + kTileM - 1) / kTileM), (unsigned)((size + kTileK - 1) / kTileK));
  dft_reduce_kernel<N16><<<grid, block, 0, stream>>>(
      out, reinterpret_cast<const uint32_t*>(w_s8), w_sum,
      reinterpret_cast<const uint32_t*>(x_s8), batch, size, ccols, tw_mode, tw, lc);
  return (int)cudaGetLastError();
}

}  // namespace hodor

// w_s8 (4 n16 - 1, S, S * 2 n16) int8, w_sum (4 n16 - 1, S) int32,
// x_s8 (batch, ccols, S * 2 n16) int8, all contiguous and 4-byte aligned;
// out (batch, S, ccols, n16) int32.
extern "C" int hodor_dft_reduce(int n16, int32_t* out, const int8_t* w_s8, const int32_t* w_sum,
                                const int8_t* x_s8, long long batch, int size, long long ccols,
                                int tw_mode, const int32_t* tw, const uint32_t* p_words,
                                uint32_t pinv0, const uint32_t* chain, int n_chain,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n16 == 4)
    return hodor::launch_dft_reduce<4>(out, w_s8, w_sum, x_s8, batch, size, ccols, tw_mode, tw,
                                       p_words, pinv0, chain, n_chain, s);
  if (n16 == 16)
    return hodor::launch_dft_reduce<16>(out, w_s8, w_sum, x_s8, batch, size, ccols, tw_mode, tw,
                                        p_words, pinv0, chain, n_chain, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int hodor_s8dot(int32_t* out, const int8_t* a, const int8_t* b, int m_rows, int depth,
                           int n_cols, void* stream) {
  if (m_rows < 1 || depth < 1 || n_cols < 1) return (int)cudaErrorInvalidValue;
  dim3 block(hodor::kTileM, hodor::kTileK / hodor::kPerK);
  dim3 grid((unsigned)((n_cols + hodor::kTileM - 1) / hodor::kTileM),
            (unsigned)((m_rows + hodor::kTileK - 1) / hodor::kTileK));
  hodor::s8dot_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(out, a, b, m_rows, depth, n_cols);
  return (int)cudaGetLastError();
}
