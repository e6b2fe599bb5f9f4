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
// block and a running carry emits t one byte per column. W is taken as it
// comes: any int8 with its row sums, a fold of a DFT matrix or not.
//
// Bound on the H100: int8 operations, (4 n16 - 1) * S * P multiply-adds
// an output (258,048 at n16 = 16, S = 128) against 32 bytes of x read and
// 64 written. What the kernel meets long before that is the way of W:
// every block needs all 4 n16 - 1 columns of its k rows, so all of W (33
// MB, resident in the L2 cache) crosses to each block once per tile of m,
// 8.4 GB for 2^20 outputs at 32 m a tile. With the products taken out the
// copies alone take 1.8 ms (4.7 TB/s from the L2), and that is where the
// whole kernel now sits; with the copies taken out the products take
// 1.2-1.7 ms, of which the fragment loads (512 bytes a product from shared
// memory) and the barriers are about 0.4 ms each.
//
// Two bodies compute the same function (the wrapper picks one from n16
// and S alone):
//
// hodor_dft_reduce_mma, for 256-bit fields at S = 32, 64, 128: s8 x s8
// mma.sync.m16n8k32 products (byte_plane_mma.cuh: ldmatrix fragments over
// rows padded by 16 bytes). Design:
// - x resident, W streamed. The block's x tile (32 columns m at full
//   depth, 128 KB at S = 128) is loaded once and serves all 63 columns;
//   sx comes from one pass over it. W arrives through a cp.async ring of
//   kMmaStages stages, each 256 bytes of depth of the tile's k rows of one
//   column, flat over (column, depth), so copies run ahead of products
//   across column boundaries.
// - State sets the tile: 64 bytes of t an output through 63 columns. A
//   warp owns 16 k x 16 m, a lane eight whole outputs (two m16n8
//   accumulators) with t in 128 registers; a block of eight warps owns
//   64 k x 32 m (32 k at S = 32). More m a block would cut the W traffic,
//   which falls with the tile's m and does not depend on its k, but 48 m
//   fill shared memory with x, leave six warps and measured slower
//   (2.3-2.7 ms); more outputs a lane have no registers.
// - Row groups run free of each other. The two warps that share 16 rows k
//   copy exactly those rows of a stage and meet at a named barrier of
//   their own, one a stage; no barrier spans the block inside the column
//   walk (2.1 -> 1.8 ms against __syncthreads a stage).
// - Copies cost a few instructions. A thread's copies differ from stage to
//   stage by one 32-bit offset; a first form that recomputed row, piece
//   and a 64-bit address per copy spent more instructions on starting
//   the copies than on the products (3.2 against 2.4 ms).
// - The column loop is unrolled by words of t (four columns a word), so t
//   is written with static indices; a column's exact sum is below 2^29
//   and the carry fits 32 bits.
// Measured and not kept, because none was faster in this form: two or
// four columns contracted at once over the same x fragments (fewer
// fragment loads a product); fragments loaded a depth step ahead by hand
// (the compiler already orders them so); deeper rings (five stages, or ten
// of 128 bytes); blocks walking a column's depth from different starting
// chunks to spread their reads of W over the L2. Not tried: a thread-block
// cluster whose blocks share one copy of a W stage (multicast), which
// would divide the L2 traffic the kernel sits on.
//
// hodor_dft_reduce, for everything else (64-bit fields, whose depth
// S * 8 is short, and S < 32): a block computes 32 k x 32 m outputs, a
// thread 4 k for one m; per column it streams W and x through shared
// memory in 128-byte steps of depth and contracts with __dp4a on the
// integer pipe; a 64-bit running carry.
//
// hodor_s8dot runs the mma tile code with the corrections off and both
// operands streamed through a two-stage buffer: 128 x 64 outputs a block,
// 32 x 32 a warp (no t to hold, so two A and four B fragment sets feed
// eight products); b is (K, N) row-major, so its tile is transposed on the
// way into shared memory with byte permutes, the four words of a thread
// stored in rotated order so that a warp's stores fall on 32 banks.
#include "byte_plane_mma.cuh"
#include "field.cuh"

namespace hodor {

// ------------------------------------------------------------ dp4a body

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

// ------------------------------------------------------- mma tile code

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[i][j] += A tile i . B tile j of this warp over KS depth steps of 32
// bytes: WTM A fragments (16 rows each) and WTN B fragments (8 rows each,
// loaded in pairs) feed WTM * WTN products a step. a_addr: the lane's
// a_fragment_offset address in A tile 0, b_addr its b_pair_fragment_offset
// address in B tiles 0 and 1, both at the first depth byte; the tile
// strides are the bytes from one A tile, or one pair of B tiles, to the
// next. The loop is unrolled and the compiler moves each step's loads
// above the products of the step before it.
template <int WTM, int WTN, int KS>
__device__ __forceinline__ void warp_tile_mma(int (&acc)[WTM][WTN][4], uint32_t a_addr,
                                              uint32_t a_tile_stride, uint32_t b_addr,
                                              uint32_t b_pair_stride) {
  static_assert(WTN % 2 == 0, "B fragments are loaded two tiles at a time");
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[WTM][4], bf[WTN / 2][4];
#pragma unroll
    for (int i = 0; i < WTM; ++i) ldmatrix_x4(af[i], a_addr + i * a_tile_stride + ks * 32);
#pragma unroll
    for (int j = 0; j < WTN / 2; ++j) ldmatrix_x4(bf[j], b_addr + j * b_pair_stride + ks * 32);
#pragma unroll
    for (int i = 0; i < WTM; ++i)
#pragma unroll
      for (int j = 0; j < WTN; ++j)
        mma_s8_m16n8k32(acc[i][j], af[i], bf[j / 2][2 * (j & 1)], bf[j / 2][2 * (j & 1) + 1]);
  }
}

// ------------------------------------------------------------- mma body

constexpr int kMmaWarpsK = 4;  // warps along k: 16 k each
constexpr int kMmaWarpsM = 2;  // warps along m: 16 m each
constexpr int kMmaStages = 4;  // stages of the W ring
constexpr int kMmaDC = 256;    // depth bytes of W a stage
constexpr int kMmaStageStride = kMmaDC + kRowPad;

template <int WK, int WM, int NST>
__global__ void __launch_bounds__(32 * WK * WM, 1)
    dft_reduce_mma_kernel(int32_t* __restrict__ out, const int8_t* __restrict__ w,
                          const int32_t* __restrict__ w_sum, const int8_t* __restrict__ x,
                          long long batch, int size, long long ccols, int tw_mode,
                          const int32_t* __restrict__ tw, LevelConsts lc) {
  constexpr int N16 = 16, NW = 8, NC = 4 * N16 - 1;
  constexpr int TK = 16 * WK, TM = 16 * WM, NT = 32 * WK * WM;
  constexpr int STAGE = TK * kMmaStageStride;
  constexpr int PIECES = kMmaDC / 16;  // 16-byte pieces of a stage row
  extern __shared__ __align__(16) uint8_t smem[];

  const int depth = size * 2 * N16;  // S * P bytes
  const int xs_stride = depth + kRowPad;
  uint8_t* xs = smem;
  uint8_t* ring = smem + TM * xs_stride;
  int* sxs = reinterpret_cast<int*>(ring + NST * STAGE);
  const uint32_t xs_addr = (uint32_t)__cvta_generic_to_shared(xs);
  const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kr = 16 * (warp % WK), mr = 16 * (warp / WK);  // the warp's corner in the tile
  const long long total_m = batch * ccols;
  const long long m0 = (long long)blockIdx.x * TM;
  const int k0 = blockIdx.y * TK;
  const int chunks = depth / kMmaDC;  // stages a column: a power of two
  const int chunk_shift = __ffs(chunks) - 1;
  const int n_stages = NC * chunks;

  // the x tile, whole depth; rows beyond the last m repeat it (never stored)
  {
    const int ppr = depth / 16;
    for (int e = tid; e < TM * ppr; e += NT) {
      const int row = e / ppr, piece = e % ppr;
      const long long m = m0 + row < total_m ? m0 + row : total_m - 1;
      cp_async16(xs_addr + row * xs_stride + piece * 16, x + m * depth + piece * 16);
    }
    cp_async_commit();
  }
  // Stage g of the flat (column, depth) walk of W goes into slot g % NST.
  // The launcher gives a block only whole tiles of k (S is a multiple of
  // TK). The WM warps that share 16 rows k copy those rows themselves and
  // meet at a barrier of their own, so the row groups of a block run free
  // of each other. A thread copies the same 16-byte piece of rows ROWS_PASS
  // apart, so all that changes from stage to stage is one 32-bit offset (W
  // is below 2^32 bytes). Always commits, so groups count stages.
  constexpr int GT = 32 * WM;  // threads of a row group
  constexpr int ROWS_PASS = GT / PIECES, PASSES = 16 / ROWS_PASS;
  static_assert(GT % PIECES == 0 && 16 % ROWS_PASS == 0, "a pass copies whole rows of the group");
  const int gtid = (warp / WK) * 32 + lane;  // the thread's index in its row group
  const int grow = kr + gtid / PIECES;
  const int8_t* w_thread = w + (long long)(k0 + grow) * depth + (gtid % PIECES) * 16;
  const uint32_t dst_thread = grow * kMmaStageStride + (gtid % PIECES) * 16;
  const uint32_t col_bytes = (uint32_t)size * depth, pass_bytes = (uint32_t)ROWS_PASS * depth;
  auto copy_stage = [&](int g) {
    if (g < n_stages) {
      const uint32_t c = g >> chunk_shift, ch = g & (chunks - 1);
      const int8_t* src = w_thread + (c * col_bytes + ch * kMmaDC);
      const uint32_t dst = ring_addr + (g % NST) * STAGE + dst_thread;
#pragma unroll
      for (int ps = 0; ps < PASSES; ++ps)
        cp_async16(dst + ps * ROWS_PASS * kMmaStageStride, src + ps * pass_bytes);
    }
    cp_async_commit();
  };
  // the barrier of this warp's row group (barrier 0 is the block's)
  auto group_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + warp % WK), "n"(GT) : "memory");
  };
#pragma unroll
  for (int g = 0; g < NST - 1; ++g) copy_stage(g);
  cp_async_wait<NST - 1>();  // the x tile has landed
  __syncthreads();
  for (int r = warp; r < TM; r += NT / 32) {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(xs + r * xs_stride);
    int s = 0;
    for (int wd = lane; wd < depth / 4; wd += 32) s = __dp4a(0x01010101, (int)row[wd], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
    if (lane == 0) sxs[r] = s + 128 * depth;  // the sum of the unshifted bytes
  }
  __syncthreads();

  // The lane's eight outputs o = 4 j + r: rows kr + g + 8 (r >> 1), columns
  // mr + 8 j + 2 t + (r & 1), g = lane >> 2, t = lane & 3.
  const int gq = lane >> 2, tq = lane & 3;
  int base[2][2];  // 128 sx[m] - 128^2 S P of the lane's four columns
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) base[j][h] = 128 * sxs[mr + 8 * j + 2 * tq + h] - 128 * 128 * depth;
  const int krow0 = k0 + kr + gq, krow1 = krow0 + 8;  // the lane's two rows k

  const uint32_t a_off = a_fragment_offset(lane, kr, kMmaStageStride);
  const uint32_t b_base = xs_addr + b_pair_fragment_offset(lane, mr, xs_stride);

  uint32_t t[8][2 * NW];
  uint32_t run[8], word[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) run[o] = 0, word[o] = 0;
  int g = 0;  // the stage being contracted

#pragma unroll
  for (int wq = 0; wq < 2 * NW; ++wq) {
#pragma unroll 1
    for (int cc = 0; cc < 4; ++cc) {
      const int c = 4 * wq + cc;
      if (c >= NC) break;
      // 128 w_sum of the lane's two rows, asked for before the products
      const int ws[2] = {128 * w_sum[c * size + krow0], 128 * w_sum[c * size + krow1]};
      int acc[1][2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[0][j][r] = 0;
#pragma unroll 1
      for (int ch = 0; ch < chunks; ++ch, ++g) {
        cp_async_wait<NST - 2>();  // stage g has landed for this thread ...
        group_sync();              // ... and for its row group, and stage g - 1 is read
        copy_stage(g + NST - 1);   // into the slot of stage g - 1
        warp_tile_mma<1, 2, kMmaDC / 32>(acc, ring_addr + (g % NST) * STAGE + a_off, 0,
                                         b_base + ch * kMmaDC, 0);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int o = 4 * j + r;
          // the exact non-negative column sum, below 2^29
          const int col = acc[0][j][r] + base[j][r & 1] + ws[r >> 1];
          run[o] += (uint32_t)col;
          word[o] |= (run[o] & 0xFFu) << (8 * cc);
          run[o] >>= 8;
        }
    }
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      // NC = 3 mod 4: the carry left after the last column is t's top byte
      t[o][wq] = wq < 2 * NW - 1 ? word[o] : (word[o] | ((run[o] & 0xFFu) << 24));
      word[o] = 0;
    }
  }

#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int k = (o >> 1) & 1 ? krow1 : krow0;
    const long long m = m0 + mr + 8 * (o >> 2) + 2 * tq + (o & 1);
    if (m >= total_m) continue;
    const long long b = m / ccols, cc = m % ccols;
    uint32_t tt[2 * NW + 1], u[NW];
#pragma unroll
    for (int q = 0; q < 2 * NW; ++q) tt[q] = t[o][q];
    tt[2 * NW] = 0;
    mont_reduce_wide<NW>(u, tt, lc);
    apply_twiddle<NW>(u, tw_mode, tw, (long long)k * ccols + cc, lc.f);
    store_words_v4<NW>(out + ((b * size + k) * ccols + cc) * N16, u);
  }
}

// WK: the warps along k of a block, whose tile is 16 WK rows k.
template <int WK>
static int launch_dft_reduce_mma(int32_t* out, const int8_t* w_s8, const int32_t* w_sum,
                                 const int8_t* x_s8, long long batch, int size, long long ccols,
                                 int tw_mode, const int32_t* tw, const LevelConsts& lc,
                                 cudaStream_t stream) {
  constexpr int TK = 16 * WK, TM = 16 * kMmaWarpsM;
  constexpr int ring = kMmaStages * TK * kMmaStageStride;
  const int depth = size * 32;
  const int smem = TM * (depth + kRowPad) + ring + TM * 4;
  if (size % TK != 0) return (int)cudaErrorInvalidValue;
  static bool attribute_set = false;
  if (!attribute_set) {
    const int most = TM * (128 * 32 + kRowPad) + ring + TM * 4;
    const cudaError_t err = cudaFuncSetAttribute(
        dft_reduce_mma_kernel<WK, kMmaWarpsM, kMmaStages>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const long long total_m = batch * ccols;
  dim3 grid((unsigned)((total_m + TM - 1) / TM), (unsigned)(size / TK));
  dft_reduce_mma_kernel<WK, kMmaWarpsM, kMmaStages>
      <<<grid, 32 * WK * kMmaWarpsM, smem, stream>>>(out, w_s8, w_sum, x_s8, batch, size, ccols,
                                                     tw_mode, tw, lc);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- s8dot

constexpr int kSdTileM = 128;  // rows of a per block: four warps of 32
constexpr int kSdTileN = 64;   // columns of b per block: two warps of 32
constexpr int kSdDC = 128;     // depth bytes a stage
constexpr int kSdStride = kSdDC + kRowPad;
constexpr int kSdThreads = 256;
constexpr int kSdStage = (kSdTileM + kSdTileN) * kSdStride;

// Rows a0..a3 of four bytes each -> columns: o[j] holds byte j of a0..a3.
__device__ __forceinline__ void transpose_4x4_bytes(uint32_t (&o)[4], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3) {
  const uint32_t lo01 = __byte_perm(a0, a1, 0x5140), lo23 = __byte_perm(a2, a3, 0x5140);
  const uint32_t hi01 = __byte_perm(a0, a1, 0x7362), hi23 = __byte_perm(a2, a3, 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The contraction alone: out (M, N) int32 = a (M, K) int8 . b (K, N) int8,
// both row-major. A thread stages, through registers, four 16-byte pieces
// of the a tile and two 4 x 4 byte units of the b tile (four depth rows of
// four columns), which it transposes so that shared memory holds b's
// columns with the depth contiguous; what lies beyond M, N or K is zero.
// a_vec / b_vec: the operand may be read in 16-byte / 4-byte words.
__global__ void __launch_bounds__(kSdThreads, 2)
    s8dot_mma_kernel(int32_t* __restrict__ out, const int8_t* __restrict__ a,
                     const int8_t* __restrict__ b, int m_rows, int depth, int n_cols, int a_vec,
                     int b_vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = 32 * (warp & 3), wn = 32 * (warp >> 2);  // the warp's corner in the tile
  const int i0 = blockIdx.y * kSdTileM, j0 = blockIdx.x * kSdTileN;
  const int n_chunks = (depth + kSdDC - 1) / kSdDC;
  const uint32_t smem_addr = (uint32_t)__cvta_generic_to_shared(smem);

  uint4 va[4];
  uint32_t vb[2][4];
  // b units: lane -> 8 groups of four columns x 4 groups of four depth rows;
  // the 16 warp-loads of a stage cover 2 x 8 such patches
  const int n4_lane = lane & 7, d4_lane = lane >> 3;

  auto load = [&](int ch) {
    const int d0 = ch * kSdDC;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * kSdThreads;
      const int row = e >> 3, d = d0 + (e & 7) * 16;
      const long long i = i0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (i < m_rows && d < depth) {
        const int8_t* src = a + i * depth + d;
        if (a_vec && d + 16 <= depth) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          uint32_t wd[4] = {0u, 0u, 0u, 0u};
          for (int z = 0; z < 16 && d + z < depth; ++z)
            wd[z >> 2] |= (uint32_t)(uint8_t)src[z] << (8 * (z & 3));
          v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      }
      va[q] = v;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int patch = warp + 8 * q;  // 0..15: 2 along n, 8 along depth
      const int n = j0 + 4 * (8 * (patch & 1) + n4_lane);
      const int d = d0 + 4 * (4 * (patch >> 1) + d4_lane);
      uint32_t rows[4];
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        uint32_t wd = 0u;
        if (d + z < depth && n < n_cols) {
          const int8_t* src = b + (long long)(d + z) * n_cols + n;
          if (b_vec && n + 4 <= n_cols) {
            wd = *reinterpret_cast<const uint32_t*>(src);
          } else {
            for (int y = 0; y < 4 && n + y < n_cols; ++y)
              wd |= (uint32_t)(uint8_t)src[y] << (8 * y);
          }
        }
        rows[z] = wd;
      }
      transpose_4x4_bytes(vb[q], rows[0], rows[1], rows[2], rows[3]);
    }
  };

  auto store = [&](int stage) {
    uint8_t* as = smem + stage * kSdStage;
    uint8_t* bs = as + kSdTileM * kSdStride;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * kSdThreads;
      *reinterpret_cast<uint4*>(as + (e >> 3) * kSdStride + (e & 7) * 16) = va[q];
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int patch = warp + 8 * q;
      const int n4 = 8 * (patch & 1) + n4_lane, d4 = 4 * (patch >> 1) + d4_lane;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // column 4 n4 + y in turn s, y rotated by n4 / 2: the rows of a
        // warp's 32 stores then start on 8 different banks four apart
        const int y = (s + (n4_lane >> 1)) & 3;
        const uint32_t lo = (y & 1) ? vb[q][1] : vb[q][0], hi = (y & 1) ? vb[q][3] : vb[q][2];
        *reinterpret_cast<uint32_t*>(bs + (4 * n4 + y) * kSdStride + 4 * d4) = (y & 2) ? hi : lo;
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  const uint32_t a_off = a_fragment_offset(lane, wm, kSdStride);
  const uint32_t b_off = kSdTileM * kSdStride + b_pair_fragment_offset(lane, wn, kSdStride);

  load(0);
  store(0);
  __syncthreads();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const bool more = ch + 1 < n_chunks;
    if (more) load(ch + 1);
    const uint32_t stage_addr = smem_addr + (ch & 1) * kSdStage;
    warp_tile_mma<2, 4, kSdDC / 32>(acc, stage_addr + a_off, 16 * kSdStride, stage_addr + b_off,
                                    16 * kSdStride);
    if (more) store((ch + 1) & 1);  // the stage read before the last barrier
    __syncthreads();
  }

  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long row = i0 + wm + 16 * i + gq + 8 * (r >> 1);
        const int col = j0 + wn + 8 * j + 2 * tq + (r & 1);
        if (row < m_rows && col < n_cols) out[row * n_cols + col] = acc[i][j][r];
      }
}

}  // namespace hodor

// w_s8 (4 n16 - 1, S, S * 2 n16) int8, w_sum (4 n16 - 1, S) int32,
// x_s8 (batch, ccols, S * 2 n16) int8, all contiguous and 4-byte aligned;
// out (batch, S, ccols, n16) int32. The __dp4a body: n16 of 4 or 16, any
// S <= 128.
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

// The same operands, w_s8 and x_s8 16-byte aligned. The tensor-core body:
// n16 = 16 and S = 32, 64 or 128.
extern "C" int hodor_dft_reduce_mma(int n16, int32_t* out, const int8_t* w_s8,
                                    const int32_t* w_sum, const int8_t* x_s8, long long batch,
                                    int size, long long ccols, int tw_mode, const int32_t* tw,
                                    const uint32_t* p_words, uint32_t pinv0,
                                    const uint32_t* chain, int n_chain, void* stream) {
  if (n16 != 16 || (size != 32 && size != 64 && size != 128) || n_chain > hodor::kMaxChain ||
      batch < 1 || ccols < 1)
    return (int)cudaErrorInvalidValue;
  const hodor::LevelConsts lc = hodor::make_level_consts(8, p_words, pinv0, chain, n_chain);
  // a block's k tile: kMmaWarpsK * 16 rows, half of that at S = 32
  if (size == 32)
    return hodor::launch_dft_reduce_mma<hodor::kMmaWarpsK / 2>(
        out, w_s8, w_sum, x_s8, batch, size, ccols, tw_mode, tw, lc, (cudaStream_t)stream);
  return hodor::launch_dft_reduce_mma<hodor::kMmaWarpsK>(out, w_s8, w_sum, x_s8, batch, size, ccols,
                                                         tw_mode, tw, lc, (cudaStream_t)stream);
}

extern "C" int hodor_s8dot(int32_t* out, const int8_t* a, const int8_t* b, int m_rows, int depth,
                           int n_cols, void* stream) {
  if (m_rows < 1 || depth < 1 || n_cols < 1) return (int)cudaErrorInvalidValue;
  constexpr int smem = 2 * hodor::kSdStage;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        hodor::s8dot_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const int a_vec = depth % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int b_vec = n_cols % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  dim3 grid((unsigned)((n_cols + hodor::kSdTileN - 1) / hodor::kSdTileN),
            (unsigned)((m_rows + hodor::kSdTileM - 1) / hodor::kSdTileM));
  hodor::s8dot_mma_kernel<<<grid, hodor::kSdThreads, smem, (cudaStream_t)stream>>>(
      out, a, b, m_rows, depth, n_cols, a_vec, b_vec);
  return (int)cudaGetLastError();
}
