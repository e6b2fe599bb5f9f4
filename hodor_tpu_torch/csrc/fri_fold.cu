// One FRI fold round in one pass:
//   out = mont(mont(lo - hi, w), c/2) + mont(lo + hi, 1/2)   (all mod p)
// which is ((lo + hi) + c * w * (lo - hi)) / 2 in Montgomery form, for
// every lane of a batch of proofs in the same launch.
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_fri_fold
// (_fri_fold_kernel), and the same kernel under jax.vmap over a batch of
// proofs (hodor_tpu/fri/fri.py fri_chain_pair_batch). The same association
// and the same canonical intermediates, so the limbs equal the six-launch
// elementwise fold.
// Bound on the H100: device-memory bytes. Three Montgomery products and
// three modular adds are about 1,000 integer operations for 256 bytes
// moved at n16 = 16 (lo, hi, w read, out written), about 100 for 64 bytes
// at n16 = 4; the six separate launches move 4.5 times the bytes.
// Design: everything in registers, each operand read once through 16-byte
// loads, all of a thread's loads issued before its first product. One
// output a thread at n16 = 16 (two measured 20% slower on the H100); at
// n16 = 4, kFoldOutputsN16x4 outputs a block's width apart, the ragged end
// masked, set from the card's times (PERF.md, tools/launch_cost.py with
// L2 defeated). lo and hi are the two halves of the round's values and
// come as row-strided views, never copied. The lanes (one per proof) sit
// on the grid's y axis: lo, hi and out step by their lane strides, w is
// shared by every lane (the twiddles depend only on the round) and c/2
// steps by its own lane stride, since every proof draws its own
// challenge. The two scalars (c/2, made on the device from the lane's
// Merkle root, and 1/2) are read once a thread from device memory, so
// the challenges never visit the host.
#include "field.cuh"

namespace hodor {

constexpr int kFoldThreads = 128;

// Outputs a thread makes at a width, a block's width apart, so that in
// each step neighbouring threads take neighbouring elements.
constexpr int kFoldOutputsN16x4 = 1;
template <int N16>
constexpr int kFoldOutputs = N16 == 4 ? kFoldOutputsN16x4 : 1;

template <int N16>
__global__ void __launch_bounds__(kFoldThreads)
    fri_fold_kernel(int32_t* __restrict__ out, long long out_lane,
                    const int32_t* __restrict__ lo, long long lo_stride, long long lo_lane,
                    const int32_t* __restrict__ hi, long long hi_stride, long long hi_lane,
                    const int32_t* __restrict__ w, long long w_stride,
                    const int32_t* __restrict__ c_scaled, long long c_lane,
                    const int32_t* __restrict__ inv2, long long half, FieldConsts fc) {
  constexpr int NW = N16 / 2, E = kFoldOutputs<N16>;
  const long long i0 = (long long)blockIdx.x * kFoldThreads * E + threadIdx.x;
  if (i0 >= half) return;
  const long long lane = blockIdx.y;
  uint32_t a[E][NW], b[E][NW], tw[E][NW], cs[NW], h2[NW], s[NW], t[NW], d[NW];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = i0 + e * kFoldThreads;
    if (i < half) {
      load_words_v4<NW>(lo + lane * lo_lane + i * lo_stride, a[e]);
      load_words_v4<NW>(hi + lane * hi_lane + i * hi_stride, b[e]);
      load_words_v4<NW>(w + i * w_stride, tw[e]);
    }
  }
  load_words_v4<NW>(c_scaled + lane * c_lane, cs);
  load_words_v4<NW>(inv2, h2);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = i0 + e * kFoldThreads;
    if (i < half) {
      // t = mont(mont(lo - hi, w), c/2)
      mod_sub<NW>(s, a[e], b[e], fc);
      mont_mul_words<NW>(t, s, tw[e], fc);
      mont_mul_words<NW>(s, t, cs, fc);
      // d = mont(lo + hi, 1/2)
      mod_add<NW>(d, a[e], b[e], fc);
      mont_mul_words<NW>(t, d, h2, fc);
      mod_add<NW>(d, s, t, fc);
      store_words_v4<NW>(out + lane * out_lane + i * N16, d);
    }
  }
}

template <int N16>
static int launch_fri_fold(int32_t* out, long long out_lane, const int32_t* lo,
                           long long lo_stride, long long lo_lane, const int32_t* hi,
                           long long hi_stride, long long hi_lane, const int32_t* w,
                           long long w_stride, const int32_t* c_scaled, long long c_lane,
                           const int32_t* inv2, long long half, long long lanes,
                           const uint32_t* p_words, uint32_t pinv0, cudaStream_t stream) {
  const FieldConsts fc = make_field_consts(N16 / 2, p_words, pinv0);
  const long long per_block = (long long)kFoldThreads * kFoldOutputs<N16>;
  const dim3 grid((unsigned)((half + per_block - 1) / per_block), (unsigned)lanes);
  fri_fold_kernel<N16><<<grid, kFoldThreads, 0, stream>>>(out, out_lane, lo, lo_stride, lo_lane,
                                                          hi, hi_stride, hi_lane, w, w_stride,
                                                          c_scaled, c_lane, inv2, half, fc);
  return (int)cudaGetLastError();
}

}  // namespace hodor

// geometry: 9 values in int32 units, (out's lane stride, lo's row and
// lane strides, hi's row and lane strides, w's row stride, c_scaled's lane
// stride, half, lanes); out is lanes x half contiguous elements.
extern "C" int hodor_fri_fold(int n16, int32_t* out, const int32_t* lo, const int32_t* hi,
                              const int32_t* w, const int32_t* c_scaled, const int32_t* inv2,
                              const long long* geometry, const uint32_t* p_words, uint32_t pinv0,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long out_lane = geometry[0], lo_stride = geometry[1], lo_lane = geometry[2],
                  hi_stride = geometry[3], hi_lane = geometry[4], w_stride = geometry[5],
                  c_lane = geometry[6], half = geometry[7], lanes = geometry[8];
  if (half < 1 || lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  if (n16 == 4)
    return hodor::launch_fri_fold<4>(out, out_lane, lo, lo_stride, lo_lane, hi, hi_stride,
                                     hi_lane, w, w_stride, c_scaled, c_lane, inv2, half, lanes,
                                     p_words, pinv0, s);
  if (n16 == 16)
    return hodor::launch_fri_fold<16>(out, out_lane, lo, lo_stride, lo_lane, hi, hi_stride,
                                      hi_lane, w, w_stride, c_scaled, c_lane, inv2, half, lanes,
                                      p_words, pinv0, s);
  return (int)cudaErrorInvalidValue;
}
