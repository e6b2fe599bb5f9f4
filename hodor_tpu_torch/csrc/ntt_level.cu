// One radix-S DFT level of the four-step NTT (S <= 128; to 2^12 in the
// shared body):
//   out[b, k, c] = mont_reduce(sum_j W[k, j] * x[b, j, c]) (* tw)
// with W[k, j] = w^(kj) in Montgomery form, so the reduced sum is the
// DFT in Montgomery form. The optional twiddle is a Montgomery factor
// per (k, c) that wraps over b (the four-step level twiddle), or one
// scalar (the inverse transform's 1/N).
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_ntt_level
// (_ntt_level_kernel). Three bodies compute the same canonical limbs. The
// shared body is a new design that takes the TPU kernel's place on the
// 16-limb fields' transforms from 2^8 to 2^24 points (ntt/matmul.py
// shared_passes); of the other two, the wrapper (field/kernels.py
// ntt_level_body) picks one from S:
//
// hodor_ntt_level_pass, the shared body, for n16 = 16: one DFT of S = 2^1
// to 2^12 points per column as radix-2 decimation-in-frequency stages on
// canonical values, the exchanges between stages in shared memory, then
// the four-step twiddle w_N^(k c) or the inverse's 1/N, written in natural
// order at any strides (the caller's out=, the LDE's rows at stride
// factor): a transform of 2^13 to 2^24 points is two such passes, the
// (n1, n2) reshape's columns, then its rows. Bound on the H100: 32-bit
// integer multiply-adds, (S/2) log2 S Montgomery products per S outputs
// (the roofline's bytes, one read and one write a pass, come to a quarter
// of the time: at 2^20 the two passes take 0.37 ms against 0.09 ms of
// copies). Design: a block holds 2^11 points (64 KB, three blocks a
// multiprocessor; a 2^12-point column takes two blocks, each doing the
// first stage on its loads and keeping the sums or the differences), a
// thread does 2^10 / 256 butterflies a stage; the arithmetic is the carry-
// chain forms of field.cuh (mod_add8, mod_sub8, mont_mul8), whose
// reduction skips p's zero words where the host finds them (words 1 to 5
// of 2^251 + 17 2^192 + 1: 3 products a row, not 8); it reads roots of
// unity (S/2 entries, packed) and two twiddle tables of about sqrt(N)
// entries, no DFT matrix. Why no DFT-matrix level carries these
// transforms, not even on the int8 tensor cores: a contraction with W
// costs 2 S P^2 int8 operations an output (P = 32 byte planes), so the
// radix-128 plan's three levels at 2^20 cost 0.347 ms at the card's full
// int8 rate alone, against the radix-2 count's 0.043; measured, such
// levels took 1.47 ms, the shared passes 0.37 (PERF.md section 6).
//
// hodor_ntt_level_butterfly, for the small radices (S = 2, 4, 8) of
// every field (n16 = 4 or 16): the F_BLS and F_P63 transforms (radix 4,
// 2 last), the terminal levels of the others, the mesh's W-point NTTs.
// Bound on the H100: bytes, x, the twiddle table and out once each (2 or
// 3 x 64 bytes an output at n16 = 16); the operations are
// (S/2) log2 S modular adds and subs and fewer Montgomery products per S
// outputs. Design: two lanes own one column m = b C + c and hold it in
// registers, S x NW words, loaded with 16-byte loads in which the pair
// reads 32 contiguous bytes (neighbouring pairs on neighbouring c, or on
// neighbouring b when C = 1) and completed by one shuffle; the first
// radix-2 decimation-in-frequency stage gives one lane the sums, the
// other the differences, and each runs the remaining log2 S - 1 stages
// on canonical values (mod_add, mod_sub, mont_mul_words by a root),
// multiplies its S/2 outputs by the twiddle and stores them in natural k
// order (the bit reversal is register indexing), the pair again writing
// 32 contiguous bytes. The points of the limb body it answers: no block
// tile and no idle thread or zero padding at any S (1); no wide sum, so
// neither mont_reduce_wide nor the chain nor the bound radix * p^2 <
// 2^(32 n16) enters, and S = 2 is one add and one sub, S = 4 one product
// a column (2); no shared memory and no __syncthreads (3). It reads no
// W: its input is the roots w^e, row 1 of the DFT matrix (W[1, e]), so it
// computes the level only when W is a DFT matrix, as every caller's is
// (ntt/matmul.py dft_matrix); hodor_ntt_level takes any W. S = 16 stays
// on the limb body: at n16 = 16 a lane would hold the whole column, 128
// words, and the S = 16 levels the paths give are small, where a pair of
// lanes a column runs long serial chains (PERF.md section 6).
//
// hodor_ntt_level, for every other S <= 128 at either width (the radix
// plan's levels of 16-limb transforms shorter than 2^8 or longer than
// 2^24 points, the FRI's 16-point interpolation), and by name for any W:
// limb arithmetic on the integer pipe, S products of 2 NW x 2 NW words
// per output (64 mad.wide.u32 each at NW = 8), bound by integer
// multiplies. The exact sum t < S * p^2 is
// accumulated without any reduction in 2*NW + 1 64-bit column
// accumulators (each column takes at most 2 * NW terms below 2^32 per
// product, so 128 products stay below 2^44). A block computes an 8 x 32
// tile of (k, column) outputs and streams W and x through shared memory
// in steps of 8 j, x stored word-major so a warp reads 32 consecutive
// words. At S = 4 (S = 2) the tile leaves half (three quarters) of a
// block's threads without an output and as much of each 8-j step zero
// padding: the butterfly body takes those radices.
//
// The limb body ends with one word-serial Montgomery reduction and the
// conditional-subtract chain derived from the bound, which bring t below
// p (hodor_tpu/ntt/matmul.py _reduction_chain), then the twiddle. The
// reduction keeps u in NW words; why that holds for the fields whose top
// word is nearly full (F_BLS, F_P63, at S = 4 and 2 only), and the test
// at every x = p - 1 that holds it, are at field.cuh mont_reduce_wide.
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

// ---------------------------------------------------------- butterfly body

constexpr int kButterflyThreads = 128;

template <int S>
__host__ __device__ constexpr int bit_reverse(int k) {
  int r = 0;
  for (int s = 1; s < S; s <<= 1, k >>= 1) r = (r << 1) | (k & 1);
  return r;
}

// The radix-2 decimation-in-frequency stages from half-span H down to 1 on
// the N elements of v (natural order in, bit-reversed out): an N-point DFT
// by the root w^(S / N) of the level's S-point root w. A pair (a, b) at
// distance H becomes (a + b, (a - b) w^e), e = i (N / 2 H) (S / N) for the
// pair's offset i in its block; e = 0 needs no product. w^e is roots[e].
template <int S, int N, int H, int NW>
__device__ __forceinline__ void dif_stages(uint32_t (&v)[N][NW],
                                           const int32_t* __restrict__ roots,
                                           const FieldConsts& fc) {
#pragma unroll
  for (int s0 = 0; s0 < N; s0 += 2 * H) {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      uint32_t sum[NW], dif[NW];
      mod_add<NW>(sum, v[s0 + i], v[s0 + i + H], fc);
      mod_sub<NW>(dif, v[s0 + i], v[s0 + i + H], fc);
#pragma unroll
      for (int r = 0; r < NW; ++r) v[s0 + i][r] = sum[r];
      const int e = i * (N / (2 * H)) * (S / N);
      if (e == 0) {
#pragma unroll
        for (int r = 0; r < NW; ++r) v[s0 + i + H][r] = dif[r];
      } else {
        uint32_t root[NW];
        load_words_v4<NW>(roots + e * (2 * NW), root);
        mont_mul_words<NW>(v[s0 + i + H], dif, root, fc);
      }
    }
  }
  if constexpr (H > 1) dif_stages<S, N, H / 2, NW>(v, roots, fc);
}

// Lanes 2 i and 2 i + 1 share column m = b C + c. The column is S n16 / 4
// units of 16 bytes (unit u: element u / UE, its words 2 (u % UE) and
// 2 (u % UE) + 1, UE = n16 / 4 units an element); lane q loads the units
// of parity q, so a pair reads 32 contiguous bytes at a time (two
// quarters of one element, or two neighbouring elements when C = 1), and
// takes the others from its partner by shuffle. The first stage splits
// the work: lane 0 keeps the sums (the even outputs), lane 1 the
// differences times w^i (the odd outputs); each then runs the S/2-point
// stages alone, twiddles its S/2 outputs and stores them, a pair again
// writing 32 contiguous bytes at a time. Both lanes of a pair are live or
// neither; a dead pair still shuffles.
template <int S, int N16>
__global__ void __launch_bounds__(kButterflyThreads)
    ntt_level_butterfly_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                               const int32_t* __restrict__ roots, long long total_m,
                               long long cols,
                               int tw_mode, const int32_t* __restrict__ tw, FieldConsts fc) {
  constexpr int NW = N16 / 2, UE = N16 / 4, U = S * UE, HS = S / 2;
  const long long t = (long long)blockIdx.x * kButterflyThreads + threadIdx.x;
  const long long m = t >> 1;
  const int q = (int)(t & 1);
  const bool live = m < total_m;
  const long long c = live ? m % cols : 0;
  const long long base = live ? (m - c) * S + c : 0;  // element (b, 0, c) of x and out

  uint32_t mine[U / 2][2], theirs[U / 2][2];
#pragma unroll
  for (int p = 0; p < U / 2; ++p) {
    const int u = 2 * p + q;
    int4 d = make_int4(0, 0, 0, 0);
    if (live) d = *reinterpret_cast<const int4*>(x + (base + (u / UE) * cols) * N16 + 4 * (u % UE));
    mine[p][0] = (uint32_t)d.x | ((uint32_t)d.y << 16);
    mine[p][1] = (uint32_t)d.z | ((uint32_t)d.w << 16);
  }
#pragma unroll
  for (int p = 0; p < U / 2; ++p)
#pragma unroll
    for (int r = 0; r < 2; ++r) theirs[p][r] = __shfl_xor_sync(0xffffffffu, mine[p][r], 1);
  uint32_t v[S][NW];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      v[u / UE][2 * (u % UE) + r] = (u & 1) == q ? mine[u >> 1][r] : theirs[u >> 1][r];

  uint32_t y[HS][NW];
  if (q == 0) {
#pragma unroll
    for (int i = 0; i < HS; ++i) mod_add<NW>(y[i], v[i], v[i + HS], fc);
  } else {
#pragma unroll
    for (int i = 0; i < HS; ++i) {
      if (i == 0) {
        mod_sub<NW>(y[i], v[i], v[i + HS], fc);
      } else {
        uint32_t dif[NW], root[NW];
        mod_sub<NW>(dif, v[i], v[i + HS], fc);
        load_words_v4<NW>(roots + i * N16, root);
        mont_mul_words<NW>(y[i], dif, root, fc);
      }
    }
  }
  if constexpr (HS > 1) dif_stages<S, HS, HS / 2, NW>(y, roots, fc);

  // y[i] = out[k0 + q], k0 = 2 bitrev(i); the pair stores out[k0], out[k0 + 1]
#pragma unroll
  for (int i = 0; i < HS; ++i) {
    const int k0 = 2 * bit_reverse<HS>(i);
    apply_twiddle<NW>(y[i], tw_mode, tw, (k0 + q) * cols + c, fc);
    if constexpr (UE == 1) {
      // the two outputs are the pair's units already
      if (live) store_words_v4<NW>(out + (base + (k0 + q) * cols) * N16, y[i]);
    } else {
      // lane q writes the units 2 p + q of both outputs: its own, and the
      // partner's through one shuffle of the units of the other parity
      uint32_t send[UE / 2][2], recv[UE / 2][2];
#pragma unroll
      for (int p = 0; p < UE / 2; ++p)
#pragma unroll
        for (int r = 0; r < 2; ++r) send[p][r] = q ? y[i][4 * p + r] : y[i][4 * p + 2 + r];
#pragma unroll
      for (int p = 0; p < UE / 2; ++p)
#pragma unroll
        for (int r = 0; r < 2; ++r) recv[p][r] = __shfl_xor_sync(0xffffffffu, send[p][r], 1);
      if (!live) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int p = 0; p < UE / 2; ++p) {
          const uint32_t a0 = e != q ? recv[p][0] : q ? y[i][4 * p + 2] : y[i][4 * p];
          const uint32_t a1 = e != q ? recv[p][1] : q ? y[i][4 * p + 3] : y[i][4 * p + 1];
          *reinterpret_cast<int4*>(out + (base + (k0 + e) * cols) * N16 + 4 * (2 * p + q)) =
              make_int4((int)(a0 & 0xFFFFu), (int)(a0 >> 16), (int)(a1 & 0xFFFFu),
                        (int)(a1 >> 16));
        }
      }
    }
  }
}

template <int S, int N16>
static int launch_ntt_level_butterfly(int32_t* out, const int32_t* x, const int32_t* roots,
                                      long long total_m, long long cols, int tw_mode,
                                      const int32_t* tw, const FieldConsts& fc,
                                      cudaStream_t stream) {
  const long long blocks = (2 * total_m + kButterflyThreads - 1) / kButterflyThreads;
  ntt_level_butterfly_kernel<S, N16><<<(unsigned)blocks, kButterflyThreads, 0, stream>>>(
      out, x, roots, total_m, cols, tw_mode, tw, fc);
  return (int)cudaGetLastError();
}

template <int N16>
static int dispatch_ntt_level_butterfly(int32_t* out, const int32_t* x, const int32_t* roots,
                                        long long total_m, int size, long long cols,
                                        int tw_mode, const int32_t* tw, const FieldConsts& fc,
                                        cudaStream_t s) {
  if (size == 2)
    return launch_ntt_level_butterfly<2, N16>(out, x, roots, total_m, cols, tw_mode, tw, fc, s);
  if (size == 4)
    return launch_ntt_level_butterfly<4, N16>(out, x, roots, total_m, cols, tw_mode, tw, fc, s);
  if (size == 8)
    return launch_ntt_level_butterfly<8, N16>(out, x, roots, total_m, cols, tw_mode, tw, fc, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------ shared body

constexpr int kPassThreads = 256;
constexpr int kPassLogPoints = 11;  // points of a block's columns in shared memory (64 KB)

// int32 strides of a pass's operands: x by batch, column and point j; out
// by batch, column and frequency k.
struct PassStrides {
  long long xb, xc, xj, ob, oc, ok;
};

// A point in shared memory: words 0-3 in lo[e], 4-7 in hi[e], so that a
// warp's 16-byte accesses to neighbouring points are free of conflicts.
__device__ __forceinline__ void put_point(uint4* lo, uint4* hi, int e, const uint32_t (&v)[8]) {
  lo[e] = make_uint4(v[0], v[1], v[2], v[3]);
  hi[e] = make_uint4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void get_point(const uint4* lo, const uint4* hi, int e,
                                          uint32_t (&v)[8]) {
  const uint4 a = lo[e], b = hi[e];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// A table entry of packed words (8 int32 words an element, 32 bytes).
__device__ __forceinline__ void load_packed(const int32_t* p, uint32_t (&v)[8]) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0], b = reinterpret_cast<const uint4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// One S-point DFT per column m = b C + c, S = 2^log_sb (2^(log_sb + 1)
// with SPLIT), by radix-2 decimation-in-frequency stages in shared memory.
// A block holds G = 2^log_g columns, point j of column g at j G + g. With
// SPLIT the first stage runs on the loads: block 2 i + q reads all S
// points of its columns and keeps the sums (q = 0) or the differences
// times w^j (q = 1), the S/2-point DFTs of the even and of the odd
// frequencies. roots: w^e for e < S/2 as packed words. Each output k is
// multiplied by the scalar tw (tw_mode 1) or by w_N^(k c) = tw[kc mod
// 2^tw_shift] tw_hi[kc >> tw_shift] (tw_mode 3; packed words), then
// stored at out + b ob + c oc + k ok.
template <bool SPLIT, uint32_t ZW>
__global__ void __launch_bounds__(kPassThreads, 3)
    ntt_level_butterfly_kernel_pass(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                                    const int32_t* __restrict__ roots, int log_sb, int log_g,
                                    long long total_m, long long cols, PassStrides st,
                                    int tw_mode, const int32_t* __restrict__ tw,
                                    const int32_t* __restrict__ tw_hi, int tw_shift,
                                    FieldConsts fc) {
  constexpr int NW = 8;
  extern __shared__ uint4 tile[];
  const int points = 1 << (log_sb + log_g), gmask = (1 << log_g) - 1;
  uint4* lo = tile;
  uint4* hi = tile + points;
  const int q = SPLIT ? (int)(blockIdx.x & 1) : 0;
  const long long m0 = (long long)(SPLIT ? blockIdx.x >> 1 : blockIdx.x) << log_g;

  for (int e = threadIdx.x; e < points; e += kPassThreads) {
    const long long m = m0 + (e & gmask);
    const int j = e >> log_g;
    uint32_t v[NW];
    if (m < total_m) {
      const long long b = m / cols, c = m - b * cols;
      const int32_t* src = x + b * st.xb + c * st.xc + j * st.xj;
      load_words_v4<NW>(src, v);
      if constexpr (SPLIT) {
        uint32_t u[NW], d[NW];
        load_words_v4<NW>(src + (st.xj << log_sb), u);
        if (q == 0) {
          mod_add8(d, v, u, fc);
        } else {
          mod_sub8(d, v, u, fc);
          if (j != 0) {
            load_packed(roots + (long long)j * NW, u);
            mont_mul8<ZW>(d, d, u, fc);
          }
        }
#pragma unroll
        for (int r = 0; r < NW; ++r) v[r] = d[r];
      }
    } else {
#pragma unroll
      for (int r = 0; r < NW; ++r) v[r] = 0;
    }
    put_point(lo, hi, e, v);
  }
  __syncthreads();

  for (int lh = log_sb - 1; lh >= 0; --lh) {
    const int root_shift = log_sb - 1 - lh + (SPLIT ? 1 : 0);
    for (int u = threadIdx.x; u < points / 2; u += kPassThreads) {
      const int r = u >> log_g, o = r & ((1 << lh) - 1);
      const int ea = ((((r >> lh) << (lh + 1)) | o) << log_g) | (u & gmask);
      const int eb = ea + (1 << (lh + log_g));
      uint32_t a[NW], b[NW], s[NW];
      get_point(lo, hi, ea, a);
      get_point(lo, hi, eb, b);
      mod_add8(s, a, b, fc);
      mod_sub8(b, a, b, fc);
      if (o != 0) {
        load_packed(roots + ((long long)o << root_shift) * NW, a);
        mont_mul8<ZW>(b, b, a, fc);
      }
      put_point(lo, hi, ea, s);
      put_point(lo, hi, eb, b);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < points; e += kPassThreads) {
    const long long m = m0 + (e & gmask);
    if (m >= total_m) continue;
    const long long k =
        ((long long)(__brev((unsigned)(e >> log_g)) >> (32 - log_sb)) << (SPLIT ? 1 : 0)) + q;
    const long long b = m / cols, c = m - b * cols;
    uint32_t v[NW], t[NW];
    get_point(lo, hi, e, v);
    if (tw_mode == 1) {
      load_words_v4<NW>(tw, t);
      mont_mul8<ZW>(v, v, t, fc);
    } else if (tw_mode == 3) {
      const long long kc = k * c;
      load_packed(tw + (kc & ((1LL << tw_shift) - 1)) * NW, t);
      mont_mul8<ZW>(v, v, t, fc);
      load_packed(tw_hi + (kc >> tw_shift) * NW, t);
      mont_mul8<ZW>(v, v, t, fc);
    }
    store_words_v4<NW>(out + b * st.ob + c * st.oc + k * st.ok, v);
  }
}

template <bool SPLIT, uint32_t ZW>
static int launch_ntt_level_pass(int32_t* out, const int32_t* x, const int32_t* roots,
                                 int log_sb, long long total_m, long long cols,
                                 const PassStrides& st, int tw_mode, const int32_t* tw,
                                 const int32_t* tw_hi, int tw_shift, const FieldConsts& fc,
                                 cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(ntt_level_butterfly_kernel_pass<SPLIT, ZW>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (2 << kPassLogPoints) * (int)sizeof(uint4));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  // as many columns a block as fill its 2^11 points, no more than there are
  int log_g = kPassLogPoints - log_sb;
  while (log_g > 0 && (1LL << (log_g - 1)) >= total_m) --log_g;
  const long long blocks = ((total_m + (1LL << log_g) - 1) >> log_g) * (SPLIT ? 2 : 1);
  const int smem = (2 << (log_sb + log_g)) * (int)sizeof(uint4);
  ntt_level_butterfly_kernel_pass<SPLIT, ZW><<<(unsigned)blocks, kPassThreads, smem, stream>>>(
      out, x, roots, log_sb, log_g, total_m, cols, st, tw_mode, tw, tw_hi, tw_shift, fc);
  return (int)cudaGetLastError();
}

template <uint32_t ZW>
static int dispatch_ntt_level_pass(int32_t* out, const int32_t* x, const int32_t* roots,
                                   int log_size, long long total_m, long long cols,
                                   const PassStrides& st, int tw_mode, const int32_t* tw,
                                   const int32_t* tw_hi, int tw_shift, const FieldConsts& fc,
                                   cudaStream_t s) {
  if (log_size > kPassLogPoints)
    return launch_ntt_level_pass<true, ZW>(out, x, roots, log_size - 1, total_m, cols, st,
                                           tw_mode, tw, tw_hi, tw_shift, fc, s);
  return launch_ntt_level_pass<false, ZW>(out, x, roots, log_size, total_m, cols, st, tw_mode,
                                          tw, tw_hi, tw_shift, fc, s);
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

// roots: (S, n16) Montgomery w^e, e < S, for the level's S-point root w
// (row 1 of the DFT matrix); x and out contiguous (batch, S, cols, n16),
// all 16-byte aligned. Takes n16 = 4 and 16 at S = 2, 4, 8.
extern "C" int hodor_ntt_level_butterfly(int n16, int32_t* out, const int32_t* x,
                                         const int32_t* roots, long long batch, int size,
                                         long long cols, int tw_mode, const int32_t* tw,
                                         const uint32_t* p_words, uint32_t pinv0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (batch < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const long long total_m = batch * cols;
  if (n16 == 4)
    return hodor::dispatch_ntt_level_butterfly<4>(out, x, roots, total_m, size, cols, tw_mode, tw,
                                                  hodor::make_field_consts(2, p_words, pinv0), s);
  if (n16 == 16)
    return hodor::dispatch_ntt_level_butterfly<16>(out, x, roots, total_m, size, cols, tw_mode, tw,
                                                   hodor::make_field_consts(8, p_words, pinv0),
                                                   s);
  return (int)cudaErrorInvalidValue;
}

// One pass of the shared body over (batch, S, cols) points of x, S = 2^log_size
// with 1 <= log_size <= 12, into out (strides: x by batch, column, point;
// out by batch, column, frequency; int32 units, multiples of 4, every
// pointer 16-byte aligned). roots: (S/2, 8) packed words of w^e; tw_mode 0
// none, 1 the (16,) limbs of one scalar at tw, 3 the packed power tables
// tw and tw_hi (w_N^(k c)); zero_words: bit j set where p's word j is 0.
// Takes n16 = 16.
extern "C" int hodor_ntt_level_pass(int n16, int32_t* out, const int32_t* x,
                                    const int32_t* roots, long long batch, int log_size,
                                    long long cols, const long long* strides, int tw_mode,
                                    const int32_t* tw, const int32_t* tw_hi, int tw_shift,
                                    const uint32_t* p_words, uint32_t pinv0, uint32_t zero_words,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n16 != 16 || batch < 1 || cols < 1 || log_size < 1 ||
      log_size > hodor::kPassLogPoints + 1 || (tw_mode != 0 && tw_mode != 1 && tw_mode != 3))
    return (int)cudaErrorInvalidValue;
  const hodor::PassStrides st{strides[0], strides[1], strides[2],
                              strides[3], strides[4], strides[5]};
  const hodor::FieldConsts fc = hodor::make_field_consts(8, p_words, pinv0);
  const long long total_m = batch * cols;
  constexpr uint32_t kSparse = 0x3Eu;  // words 1-5 zero: 2^251 + 17 2^192 + 1 among others
  if ((zero_words & kSparse) == kSparse)
    return hodor::dispatch_ntt_level_pass<kSparse>(out, x, roots, log_size, total_m, cols, st,
                                                   tw_mode, tw, tw_hi, tw_shift, fc, s);
  return hodor::dispatch_ntt_level_pass<0u>(out, x, roots, log_size, total_m, cols, st, tw_mode,
                                            tw, tw_hi, tw_shift, fc, s);
}
