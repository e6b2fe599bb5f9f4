// One radix-S DFT level of the four-step NTT (S <= 128):
//   out[b, k, c] = mont_reduce(sum_j W[k, j] * x[b, j, c]) (* tw)
// with W[k, j] = w^(kj) in Montgomery form, so the reduced sum is the
// DFT in Montgomery form. The optional twiddle is a Montgomery factor
// per (k, c) that wraps over b (the four-step level twiddle), or one
// scalar (the inverse transform's 1/N).
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_ntt_level
// (_ntt_level_kernel). Two bodies compute the same function:
//
// hodor_ntt_level_mma, for 256-bit fields at S = 32, 64, 128: the TPU
// kernel's byte-plane algebra on the int8 tensor cores
// (byte_plane_mma.cuh). Bound on the H100: int8 operations, 2 S P^2 per
// output (P = 32 byte planes) against 128 bytes moved; what the kernel
// meets first is shared-memory bandwidth for the fragments. Design: state,
// not arithmetic, sets the tile. A block of four warps owns 32 k x 16 m
// outputs, a warp 16 x 8, a lane four whole outputs (the m16n8 accumulator
// layout), each with its 64 bytes of t in registers, so the epilogue
// (Montgomery reduction, chain, twiddle, store) needs no shuffle. All 32
// planes of the block's 32 W rows and of its 16 x columns are resident in
// shared memory at full depth (32 (32 + 16) (S + 16) bytes, 216 KB at
// S = 128, one block a multiprocessor): nothing streams inside the column
// walk. The grid is persistent: a block keeps its W slab and walks the m
// tiles, so W (the (P, S, S) byte-plane matrix, built once per table) is
// read once per block and x once per k tile. x is byte-split on the way
// in: a thread loads four consecutive j of one column with 16-byte loads,
// transposes them to one word per plane with byte permutes and stores the
// 32 words bank-conflict free; no int8 copy of x reaches device memory.
//
// hodor_ntt_level, for every other shape (S <= 128 of any size, 64-bit
// fields): limb arithmetic on the integer pipe, S products of 2 NW x 2 NW
// words per output (64 mad.wide.u32 each at NW = 8), bound by integer
// multiplies. The exact sum t < S * p^2 is accumulated without any
// reduction in 2*NW + 1 64-bit column accumulators (each column takes
// at most 2 * NW terms below 2^32 per product, so 128 products stay
// below 2^44). A block computes an 8 x 32 tile of (k, column) outputs and
// streams W and x through shared memory in steps of 8 j, x stored
// word-major so a warp reads 32 consecutive words.
//
// Both end the same way: one word-serial Montgomery reduction and the
// conditional-subtract chain derived from the bound bring t below p
// (hodor_tpu/ntt/matmul.py _reduction_chain), then the twiddle. The
// reduction keeps u in NW words; why that holds for the fields whose top
// word is nearly full (F_BLS, F_P63, at S = 4 and 2 only), and the test
// at every x = p - 1 that holds it, are at field.cuh mont_reduce_wide.
//
// At S = 4 (S = 2) the limb body's 8 x 32 tile leaves half (three
// quarters) of a block's threads without an output and as much of each
// 8-j step zero padding: slow, not wrong.
#include "byte_plane_mma.cuh"
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
        load_words_v4<NW>(x + ((b * size + j) * cols + c) * N16, v);
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
  store_words_v4<NW>(out + ((b * size + k) * cols + c) * N16, u);
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

// ---------------------------------------------------------------- mma body

constexpr int kMmaTileK = 32;   // W rows (outputs k) a block keeps resident
constexpr int kMmaTileM = 16;   // x columns (outputs m = b * cols + c) per step
constexpr int kMmaThreads = 128;

// The block's W slab: rows k0 .. k0 + 31 of each of the P planes of the
// (P, S, S) byte-plane matrix, into rows S + kRowPad apart.
template <int S, int P>
__device__ __forceinline__ void load_w_slab(uint8_t* ws, const uint8_t* __restrict__ wb, int k0,
                                            int tid) {
  constexpr int RS = S + kRowPad, CH = S / 16;
  for (int e = tid; e < P * kMmaTileK * CH; e += kMmaThreads) {
    const int chunk = e % CH, row = (e / CH) % kMmaTileK, q = e / (CH * kMmaTileK);
    const uint4 v =
        *reinterpret_cast<const uint4*>(wb + ((long long)q * S + k0 + row) * S + chunk * 16);
    *reinterpret_cast<uint4*>(ws + (q * kMmaTileK + row) * RS + chunk * 16) = v;
  }
}

// Bytes 0 of a, b, c, d (lo) and bytes 1 (hi) as two words.
__device__ __forceinline__ void transpose_bytes(uint32_t& lo, uint32_t& hi, int a, int b, int c,
                                                int d) {
  const uint32_t ab = __byte_perm((uint32_t)a, (uint32_t)b, 0x5140);  // a0 b0 a1 b1
  const uint32_t cd = __byte_perm((uint32_t)c, (uint32_t)d, 0x5140);
  lo = __byte_perm(ab, cd, 0x5410);
  hi = __byte_perm(ab, cd, 0x7632);
}

// The byte planes of x columns m0 .. m0 + 15 over the whole depth: plane q,
// row mi holds byte q of x[b, j, c] at depth byte j. A unit is four
// consecutive j of one column; the lanes of a warp take 8 columns x 4
// units, which puts their 32 word stores of a plane on 32 banks.
template <int S, int N16>
__device__ __forceinline__ void load_x_planes(uint8_t* xs, const int32_t* __restrict__ x,
                                              long long m0, long long total_m, long long cols,
                                              int tid) {
  constexpr int RS = S + kRowPad, P = 2 * N16;
  const long long j_stride = cols * (N16 / 4);  // int4 units between j and j + 1
  for (int u = tid; u < (S / 4) * kMmaTileM; u += kMmaThreads) {
    const int lane = u & 31, group = u >> 5;
    const int mi = (lane & 7) + 8 * (group & 1);
    const int j4 = (lane >> 3) + 4 * (group >> 1);
    const long long m = m0 + mi;
    uint32_t words[P];
    if (m < total_m) {
      const long long b = m / cols, c = m % cols;
      const int4* src = reinterpret_cast<const int4*>(x + ((b * S + 4 * j4) * cols + c) * N16);
#pragma unroll
      for (int part = 0; part < N16 / 4; ++part) {
        const int4 v0 = src[part], v1 = src[part + j_stride], v2 = src[part + 2 * j_stride],
                   v3 = src[part + 3 * j_stride];
        transpose_bytes(words[8 * part + 0], words[8 * part + 1], v0.x, v1.x, v2.x, v3.x);
        transpose_bytes(words[8 * part + 2], words[8 * part + 3], v0.y, v1.y, v2.y, v3.y);
        transpose_bytes(words[8 * part + 4], words[8 * part + 5], v0.z, v1.z, v2.z, v3.z);
        transpose_bytes(words[8 * part + 6], words[8 * part + 7], v0.w, v1.w, v2.w, v3.w);
      }
    } else {
#pragma unroll
      for (int q = 0; q < P; ++q) words[q] = 0;
    }
#pragma unroll
    for (int q = 0; q < P; ++q)
      *reinterpret_cast<uint32_t*>(xs + (q * kMmaTileM + mi) * RS + 4 * j4) = words[q];
  }
}

template <int S, int N16>
__global__ void __launch_bounds__(kMmaThreads, 1)
    ntt_level_mma_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                         const uint8_t* __restrict__ wb, long long batch, long long cols,
                         int tw_mode, const int32_t* __restrict__ tw, LevelConsts lc) {
  constexpr int NW = N16 / 2, P = 2 * N16, RS = S + kRowPad, KS = S / 32;
  constexpr int NKT = S / kMmaTileK;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ws = smem;
  uint8_t* xs = smem + P * kMmaTileK * RS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = (warp & 1) * 16, wm = (warp >> 1) * 8;  // the warp's corner in the tile
  const int k0 = (blockIdx.x % NKT) * kMmaTileK;
  const long long total_m = batch * cols;
  const long long m_tiles = (total_m + kMmaTileM - 1) / kMmaTileM;

  load_w_slab<S, P>(ws, wb, k0, tid);
  const uint32_t a_addr =
      (uint32_t)__cvta_generic_to_shared(ws) + a_fragment_offset(lane, wk, RS);
  const uint32_t b_addr =
      (uint32_t)__cvta_generic_to_shared(xs) + b_fragment_offset(lane, wm, RS);

  for (long long mt = blockIdx.x / NKT; mt < m_tiles; mt += gridDim.x / NKT) {
    const long long m0 = mt * kMmaTileM;
    __syncthreads();  // the previous tile's fragments are read
    load_x_planes<S, N16>(xs, x, m0, total_m, cols, tid);
    __syncthreads();

    uint32_t t[4][2 * NW];
    contract_byte_planes<NW, KS>(t, a_addr, kMmaTileK * RS, b_addr, kMmaTileM * RS);

#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int k = k0 + wk + (lane >> 2) + (o >> 1) * 8;
      const long long m = m0 + wm + 2 * (lane & 3) + (o & 1);
      if (m >= total_m) continue;
      const long long b = m / cols, c = m % cols;
      uint32_t tt[2 * NW + 1], u[NW];
#pragma unroll
      for (int q = 0; q < 2 * NW; ++q) tt[q] = t[o][q];
      tt[2 * NW] = 0;
      mont_reduce_wide<NW>(u, tt, lc);
      apply_twiddle<NW>(u, tw_mode, tw, (long long)k * cols + c, lc.f);
      store_words_v4<NW>(out + ((b * S + k) * cols + c) * N16, u);
    }
  }
}

template <int S, int N16>
static int launch_ntt_level_mma(int32_t* out, const int32_t* x, const uint8_t* wb,
                                long long batch, long long cols, int tw_mode, const int32_t* tw,
                                const LevelConsts& lc, cudaStream_t stream) {
  constexpr int P = 2 * N16, NKT = S / kMmaTileK;
  constexpr int smem = P * (kMmaTileK + kMmaTileM) * (S + kRowPad);
  static int sm_count = 0;
  if (sm_count == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ntt_level_mma_kernel<S, N16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      sm_count = 0;
      return (int)err;
    }
  }
  const long long m_tiles = (batch * cols + kMmaTileM - 1) / kMmaTileM;
  const long long resident = (long long)(sm_count / NKT > 0 ? sm_count / NKT : 1) * NKT;
  const long long blocks = m_tiles * NKT < resident ? m_tiles * NKT : resident;
  ntt_level_mma_kernel<S, N16><<<(unsigned)blocks, kMmaThreads, smem, stream>>>(
      out, x, wb, batch, cols, tw_mode, tw, lc);
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

// wb: the (2 n16, S, S) uint8 byte-plane matrix of W, contiguous and
// 16-byte aligned; x and out contiguous (batch, S, cols, n16). Takes
// n16 = 16 and S = 32, 64, 128.
extern "C" int hodor_ntt_level_mma(int n16, int32_t* out, const int32_t* x, const uint8_t* wb,
                                   long long batch, int size, long long cols, int tw_mode,
                                   const int32_t* tw, const uint32_t* p_words, uint32_t pinv0,
                                   const uint32_t* chain, int n_chain, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n16 != 16 || n_chain > hodor::kMaxChain || batch < 1 || cols < 1)
    return (int)cudaErrorInvalidValue;
  const hodor::LevelConsts lc = hodor::make_level_consts(8, p_words, pinv0, chain, n_chain);
  if (size == 32)
    return hodor::launch_ntt_level_mma<32, 16>(out, x, wb, batch, cols, tw_mode, tw, lc, s);
  if (size == 64)
    return hodor::launch_ntt_level_mma<64, 16>(out, x, wb, batch, cols, tw_mode, tw, lc, s);
  if (size == 128)
    return hodor::launch_ntt_level_mma<128, 16>(out, x, wb, batch, cols, tw_mode, tw, lc, s);
  return (int)cudaErrorInvalidValue;
}
