// One FRI fold round in one pass:
//   out = mont(mont(lo - hi, w), c/2) + mont(lo + hi, 1/2)   (all mod p)
// which is ((lo + hi) + c * w * (lo - hi)) / 2 in Montgomery form.
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_fri_fold
// (_fri_fold_kernel). The same association and the same canonical
// intermediates, so the limbs equal the six-launch elementwise fold.
// Bound on the H100: device-memory bytes. Three Montgomery products and
// three modular adds are about 1,000 integer operations for 256 bytes
// moved (lo, hi, w read, out written); the six separate launches move
// 1,152 bytes per output.
// Design: one thread per output element, everything in registers, each
// operand read once through 16-byte loads. lo and hi are the two halves
// of the round's values and come as row-strided views, never copied. The
// two scalars (c/2, made on the device from the round's Merkle root, and
// 1/2) are read by every thread from device memory, so the challenge
// never visits the host.
#include "field.cuh"

namespace hodor {

template <int N16>
__global__ void fri_fold_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ lo,
                                long long lo_stride, const int32_t* __restrict__ hi,
                                long long hi_stride, const int32_t* __restrict__ w,
                                long long w_stride, const int32_t* __restrict__ c_scaled,
                                const int32_t* __restrict__ inv2, long long half,
                                FieldConsts fc) {
  constexpr int NW = N16 / 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= half) return;
  uint32_t a[NW], b[NW], tw[NW], k[NW], s[NW], t[NW], d[NW];
  load_words_v4<NW>(lo + i * lo_stride, a);
  load_words_v4<NW>(hi + i * hi_stride, b);
  load_words_v4<NW>(w + i * w_stride, tw);
  // t = mont(mont(lo - hi, w), c/2)
  mod_sub<NW>(s, a, b, fc);
  mont_mul_words<NW>(t, s, tw, fc);
  load_words_v4<NW>(c_scaled, k);
  mont_mul_words<NW>(s, t, k, fc);
  // d = mont(lo + hi, 1/2)
  mod_add<NW>(d, a, b, fc);
  load_words_v4<NW>(inv2, k);
  mont_mul_words<NW>(t, d, k, fc);
  mod_add<NW>(d, s, t, fc);
  store_words_v4<NW>(out + i * N16, d);
}

template <int N16>
static int launch_fri_fold(int32_t* out, const int32_t* lo, long long lo_stride,
                           const int32_t* hi, long long hi_stride, const int32_t* w,
                           long long w_stride, const int32_t* c_scaled, const int32_t* inv2,
                           long long half, const uint32_t* p_words, uint32_t pinv0,
                           cudaStream_t stream) {
  const FieldConsts fc = make_field_consts(N16 / 2, p_words, pinv0);
  const int threads = 128;
  const long long blocks = (half + threads - 1) / threads;
  fri_fold_kernel<N16><<<(unsigned)blocks, threads, 0, stream>>>(
      out, lo, lo_stride, hi, hi_stride, w, w_stride, c_scaled, inv2, half, fc);
  return (int)cudaGetLastError();
}

}  // namespace hodor

// Strides are in int32 units between consecutive elements (rows).
extern "C" int hodor_fri_fold(int n16, int32_t* out, const int32_t* lo, long long lo_stride,
                              const int32_t* hi, long long hi_stride, const int32_t* w,
                              long long w_stride, const int32_t* c_scaled, const int32_t* inv2,
                              long long half, const uint32_t* p_words, uint32_t pinv0,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (half < 1) return (int)cudaErrorInvalidValue;
  if (n16 == 4)
    return hodor::launch_fri_fold<4>(out, lo, lo_stride, hi, hi_stride, w, w_stride, c_scaled,
                                     inv2, half, p_words, pinv0, s);
  if (n16 == 16)
    return hodor::launch_fri_fold<16>(out, lo, lo_stride, hi, hi_stride, w, w_stride, c_scaled,
                                      inv2, half, p_words, pinv0, s);
  return (int)cudaErrorInvalidValue;
}
