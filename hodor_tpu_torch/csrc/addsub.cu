// Elementwise modular a + b (mode 0) and a - b (mode 1).
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_addsub
// (_addsub_kernel). The same conditions: the sum loses p when the add
// carries out of the top word or is >= p; the difference gains p back on
// a borrow.
// Bound on the H100: device-memory bytes (about 20 integer instructions
// for 192 bytes moved).
// Design: one thread per element, words in registers, one read of each
// operand and one write, all through 16-byte accesses; broadcast operands
// by stride 0 over three dims (mont_mul.cu's general body).
#include "field.cuh"

namespace hodor {

template <int N16>
__global__ void addsub_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                              Strides3 as, const int32_t* __restrict__ b, Strides3 bs,
                              Dims3 dims, long long total, int mode, FieldConsts fc) {
  constexpr int NW = N16 / 2;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  uint32_t x[NW], y[NW], r[NW];
  load_words_v4<NW>(element_at(a, as, dims, i), x);
  load_words_v4<NW>(element_at(b, bs, dims, i), y);
  if (mode == 0)
    mod_add<NW>(r, x, y, fc);
  else
    mod_sub<NW>(r, x, y, fc);
  store_words_v4<NW>(out + i * N16, r);
}

template <int N16>
static int launch_addsub(int mode, int32_t* out, const int32_t* a, const long long* a_strides,
                         const int32_t* b, const long long* b_strides, const long long* dims,
                         const uint32_t* p_words, cudaStream_t stream) {
  Strides3 as{{a_strides[0], a_strides[1], a_strides[2]}};
  Strides3 bs{{b_strides[0], b_strides[1], b_strides[2]}};
  Dims3 d{{dims[0], dims[1], dims[2]}};
  long long total = dims[0] * dims[1] * dims[2];
  const FieldConsts fc = make_field_consts(N16 / 2, p_words, 0);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  addsub_kernel<N16><<<(unsigned)blocks, threads, 0, stream>>>(out, a, as, b, bs, d, total,
                                                                mode, fc);
  return (int)cudaGetLastError();
}

}  // namespace hodor

extern "C" int hodor_addsub(int n16, int mode, int32_t* out, const int32_t* a,
                            const long long* a_strides, const int32_t* b,
                            const long long* b_strides, const long long* dims,
                            const uint32_t* p_words, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (n16 == 4)
    return hodor::launch_addsub<4>(mode, out, a, a_strides, b, b_strides, dims, p_words, s);
  if (n16 == 16)
    return hodor::launch_addsub<16>(mode, out, a, a_strides, b, b_strides, dims, p_words, s);
  return (int)cudaErrorInvalidValue;
}
