// One FRI fold round in one pass, its challenge and its twiddles made on
// the card:
//   out[j] = (lo + hi + mont(mont(lo - hi, T_lo[a]), mont(T_hi[h], c))) / 2
// for e = ((first + j) * stride) mod N, a = e mod 2^s, h = e >> s: with
// T_lo[a] T_hi[h] = W^(-e) this is ((lo + hi) + c * W^(-e) * (lo - hi)) / 2
// in Montgomery form, for every lane of a batch of proofs in the same
// launch.
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_fri_fold
// (_fri_fold_kernel), with the round's twiddle vector and the challenge
// (hodor_tpu/merkle/blake2s.py digest_to_challenge_mont) that the JAX
// ladder makes apart before it; and the same kernel under jax.vmap over a
// batch of proofs (hodor_tpu/fri/fri.py fri_chain_pair_batch). Every
// product is a canonical Montgomery product and the halving is exact, so
// the limbs equal those of the elementwise fold over the same field
// elements in any association.
//
// Bound on the H100: device-memory bytes and integer issue together, 192
// bytes an output at n16 = 16 (lo and hi read, out written) against two
// products, three modular adds and a halving (the Pallas kernel's third
// product, by 1/2, is a shift and a conditional add of p here). The round's
// inputs cost the host nothing: the challenge c is drawn from the previous
// tree's root digest on the card (repr_size bytes read big-endian, the top
// u64 limb shaved: Field.from_be_with_shave; times R^2 into Montgomery
// form), so no round waits for the host, and the twiddle W^(-e) is the
// product of two entries of the l0 domain's inverse-root tables (about
// sqrt(N) entries each, ntt/matmul.py power_twiddles), so no round builds
// a K-entry table.
//
// Design: one output a thread, every load issued before the first
// product. The rows of a block that share an h share T_hi[h] c: the first
// row of each such run (a = 0, or the block's first row) derives c and
// writes the product into shared memory while the others wait on their
// loads, and every row reads its run's after one barrier. While stride <
// 2^s a run covers 2^s / stride rows, so the early rounds, which hold
// nearly all of the work, make one or two such products a block; from
// stride >= 2^s on every row is its own run. lo and hi are the two halves
// of the round's values and come as row-strided views, never copied. The
// lanes (one per proof) sit on the grid's y axis: lo, hi and out step by
// their lane strides, the tables are shared, and each lane reads its own
// root.
#include "field.cuh"

namespace hodor {

constexpr int kFoldThreads = 128;

// The field constants of a fold beyond p: R^2 mod p, which takes a
// challenge's canonical words to Montgomery form, and the challenge's
// shave mask.
struct FoldConsts {
  FieldConsts f;
  uint32_t r2[kMaxWords];
  uint32_t mask[kMaxWords];
};

// The round: the output row j's twiddle index is ((first + j) << log_stride)
// mod 2^log_n; the tables split it at bit `shift`.
struct FoldRound {
  long long first, half;
  int log_stride, log_n, shift;
};

template <int NW, uint32_t ZW>
__device__ __forceinline__ void fold_mul(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                         const uint32_t (&b)[NW], const FieldConsts& fc) {
  if constexpr (NW == 8)
    mont_mul8<ZW>(r, a, b, fc);
  else
    mont_mul_words<NW>(r, a, b, fc);
}

template <int NW>
__device__ __forceinline__ void fold_add(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                         const uint32_t (&b)[NW], const FieldConsts& fc) {
  if constexpr (NW == 8)
    mod_add8(r, a, b, fc);
  else
    mod_add<NW>(r, a, b, fc);
}

template <int NW>
__device__ __forceinline__ void fold_sub(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                         const uint32_t (&b)[NW], const FieldConsts& fc) {
  if constexpr (NW == 8)
    mod_sub8(r, a, b, fc);
  else
    mod_sub<NW>(r, a, b, fc);
}

// r = y / 2 mod p for y < p, p odd: y >> 1 where y is even, (y + p) >> 1
// where it is odd, the sum's carry shifted into the top bit. Canonical,
// so the same limbs as mont(y, 1/2) at a few adds and shifts.
template <int NW>
__device__ __forceinline__ void mod_half(uint32_t (&r)[NW], const uint32_t (&y)[NW],
                                         const FieldConsts& fc) {
  uint32_t m[NW], s[NW];
  const uint32_t odd = 0u - (y[0] & 1u);
#pragma unroll
  for (int i = 0; i < NW; ++i) m[i] = fc.p[i] & odd;
  const uint32_t carry = add_words<NW>(s, y, m);
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) r[i] = __funnelshift_r(s[i], s[i + 1], 1);
  r[NW - 1] = __funnelshift_r(s[NW - 1], carry, 1);
}

template <int NW>
__device__ __forceinline__ void load_packed_words(const int32_t* p, uint32_t (&v)[NW]) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i];
      v[4 * i] = q.x, v[4 * i + 1] = q.y, v[4 * i + 2] = q.z, v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      const uint2 q = reinterpret_cast<const uint2*>(p)[i];
      v[2 * i] = q.x, v[2 * i + 1] = q.y;
    }
  }
}

template <int N16, uint32_t ZW>
__global__ void __launch_bounds__(kFoldThreads)
    fri_fold_kernel(int32_t* __restrict__ out, long long out_lane,
                    const int32_t* __restrict__ lo, long long lo_stride, long long lo_lane,
                    const int32_t* __restrict__ hi, long long hi_stride, long long hi_lane,
                    const int32_t* __restrict__ roots, long long root_lane,
                    const int32_t* __restrict__ t_lo, const int32_t* __restrict__ t_hi,
                    FoldRound rd, FoldConsts k) {
  constexpr int NW = N16 / 2;
  __shared__ uint32_t run_tw[NW][kFoldThreads];  // T_hi[h] c of the run a row begins
  const int t = threadIdx.x;
  const long long j = (long long)blockIdx.x * kFoldThreads + t;
  const long long lane = blockIdx.y;
  const bool live = j < rd.half;
  const long long cycle = (1LL << (rd.log_n - rd.log_stride)) - 1;  // first + j mod N / stride
  const long long e = ((rd.first + j) & cycle) << rd.log_stride;
  const long long a_idx = e & ((1LL << rd.shift) - 1);
  const long long back = a_idx >> rd.log_stride;  // rows since the run's first
  const int start = back < t ? t - (int)back : 0;
  const bool leader = live && start == t;
  // every load first: the leader's root words and T_hi entry, then lo,
  // hi and T_lo
  uint32_t a[NW], b[NW], tl[NW], th[NW], x[NW], u[NW];
  if (leader) {
    const int32_t* root = roots + lane * root_lane;
#pragma unroll
    for (int i = 0; i < NW; ++i) x[i] = (uint32_t)root[NW - 1 - i];
    load_packed_words<NW>(t_hi + (e >> rd.shift) * NW, th);
  }
  if (live) {
    load_words_v4<NW>(lo + lane * lo_lane + j * lo_stride, a);
    load_words_v4<NW>(hi + lane * hi_lane + j * hi_stride, b);
    load_packed_words<NW>(t_lo + a_idx * NW, tl);
  }
  if (leader) {
    // c: canonical word i is digest word NW - 1 - i byte-swapped (repr_size
    // = 4 NW bytes read big-endian), shaved, times R^2; the run's T_hi[h] c
    // into shared memory
    uint32_t c[NW], r2[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      x[i] = __byte_perm(x[i], 0, 0x0123) & k.mask[i];
      r2[i] = k.r2[i];
    }
    fold_mul<NW, ZW>(c, x, r2, k.f);
    fold_mul<NW, ZW>(x, th, c, k.f);
#pragma unroll
    for (int q = 0; q < NW; ++q) run_tw[q][t] = x[q];
  }
  if (live) {
    // u = mont(lo - hi, T_lo[a]); b = lo + hi
    fold_sub<NW>(x, a, b, k.f);
    fold_mul<NW, ZW>(u, x, tl, k.f);
    fold_add<NW>(b, a, b, k.f);
  }
  __syncthreads();
  if (!live) return;
  // out = (lo + hi + mont(u, T_hi[h] c)) / 2
#pragma unroll
  for (int q = 0; q < NW; ++q) th[q] = run_tw[q][start];
  fold_mul<NW, ZW>(a, u, th, k.f);
  fold_add<NW>(x, b, a, k.f);
  mod_half<NW>(a, x, k.f);
  store_words_v4<NW>(out + lane * out_lane + j * N16, a);
}

template <int N16, uint32_t ZW>
static int launch_fri_fold(int32_t* out, const long long* g, const int32_t* lo,
                           const int32_t* hi, const int32_t* roots, const int32_t* t_lo,
                           const int32_t* t_hi, const FoldRound& rd, const FoldConsts& k,
                           cudaStream_t stream) {
  const dim3 grid((unsigned)((rd.half + kFoldThreads - 1) / kFoldThreads), (unsigned)g[7]);
  fri_fold_kernel<N16, ZW><<<grid, kFoldThreads, 0, stream>>>(
      out, g[0], lo, g[1], g[2], hi, g[3], g[4], roots, g[5], t_lo, t_hi, rd, k);
  return (int)cudaGetLastError();
}

}  // namespace hodor

// geometry: 8 values in int32 units, (out's lane stride, lo's row and
// lane strides, hi's row and lane strides, the roots' lane stride, half,
// lanes); out is lanes x half contiguous elements. roots: 8 digest words a
// lane; t_lo: 2^shift entries, t_hi: 2^(log_n - shift), NW packed words
// each. r2_words, mask_words: R^2 mod p and the shave mask, n16 / 2 words;
// zero_words: bit i set where p's word i is 0.
extern "C" int hodor_fri_fold(int n16, int32_t* out, const int32_t* lo, const int32_t* hi,
                              const int32_t* roots, const int32_t* t_lo, const int32_t* t_hi,
                              const long long* geometry, long long first, int log_stride,
                              int log_n, int shift, const uint32_t* p_words, uint32_t pinv0,
                              const uint32_t* r2_words, const uint32_t* mask_words,
                              uint32_t zero_words, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const hodor::FoldRound rd{first, geometry[6], log_stride, log_n, shift};
  if (rd.half < 1 || geometry[7] < 1 || geometry[7] > 65535 || first < 0 || log_stride < 0 ||
      log_stride > log_n || shift < 0 || shift > log_n || log_n > 62)
    return (int)cudaErrorInvalidValue;
  if (n16 != 4 && n16 != 16) return (int)cudaErrorInvalidValue;
  const int nw = n16 / 2;
  hodor::FoldConsts k{};
  k.f = hodor::make_field_consts(nw, p_words, pinv0);
  for (int i = 0; i < nw; ++i) k.r2[i] = r2_words[i], k.mask[i] = mask_words[i];
  constexpr uint32_t kSparse = 0x3Eu;  // words 1-5 zero: 2^251 + 17 2^192 + 1 among others
  if (n16 == 4)
    return hodor::launch_fri_fold<4, 0u>(out, geometry, lo, hi, roots, t_lo, t_hi, rd, k, s);
  if ((zero_words & kSparse) == kSparse)
    return hodor::launch_fri_fold<16, kSparse>(out, geometry, lo, hi, roots, t_lo, t_hi, rd, k,
                                               s);
  return hodor::launch_fri_fold<16, 0u>(out, geometry, lo, hi, roots, t_lo, t_hi, rd, k, s);
}
