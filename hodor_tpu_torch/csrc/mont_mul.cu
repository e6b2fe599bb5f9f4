// Elementwise Montgomery product a * b * R^-1 mod p.
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_mont_mul_v2
// (_mont_mul_kernel_v2) and its unrolled twin pallas_mont_mul.
// Bound on the H100: device-memory bytes. A 256-bit product is 64
// mad.wide.u32 for the schoolbook part plus 64 for the reduction, about
// 300 integer instructions for 192 bytes moved (two operands and the
// result as int32-held 16-bit limbs), well under the card's
// operations-per-byte line.
// Design: one thread per element, packed 32-bit words and CIOS in
// registers, one read of each operand and one write. A broadcast operand
// (a scalar, or a period of the output) arrives with stride 0 on its
// broadcast dims, so it is read from cache and never materialised.
#include "field.cuh"

namespace hodor {

template <int N16>
__global__ void mont_mul_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                                Strides3 as, const int32_t* __restrict__ b, Strides3 bs,
                                Dims3 dims, long long total, FieldConsts fc) {
  constexpr int NW = N16 / 2;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  uint32_t x[NW], y[NW], r[NW];
  load_words<NW>(element_at(a, as, dims, i), x);
  load_words<NW>(element_at(b, bs, dims, i), y);
  mont_mul_words<NW>(r, x, y, fc);
  store_words<NW>(out + i * N16, r);
}

template <int N16>
static int launch_mont_mul(int32_t* out, const int32_t* a, const long long* a_strides,
                           const int32_t* b, const long long* b_strides,
                           const long long* dims, const uint32_t* p_words, uint32_t pinv0,
                           cudaStream_t stream) {
  Strides3 as{{a_strides[0], a_strides[1], a_strides[2]}};
  Strides3 bs{{b_strides[0], b_strides[1], b_strides[2]}};
  Dims3 d{{dims[0], dims[1], dims[2]}};
  long long total = dims[0] * dims[1] * dims[2];
  const FieldConsts fc = make_field_consts(N16 / 2, p_words, pinv0);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  mont_mul_kernel<N16><<<(unsigned)blocks, threads, 0, stream>>>(out, a, as, b, bs, d, total, fc);
  return (int)cudaGetLastError();
}

}  // namespace hodor

extern "C" int hodor_mont_mul(int n16, int32_t* out, const int32_t* a,
                              const long long* a_strides, const int32_t* b,
                              const long long* b_strides, const long long* dims,
                              const uint32_t* p_words, uint32_t pinv0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n16 == 4)
    return hodor::launch_mont_mul<4>(out, a, a_strides, b, b_strides, dims, p_words, pinv0, s);
  if (n16 == 16)
    return hodor::launch_mont_mul<16>(out, a, a_strides, b, b_strides, dims, p_words, pinv0, s);
  return (int)cudaErrorInvalidValue;
}
