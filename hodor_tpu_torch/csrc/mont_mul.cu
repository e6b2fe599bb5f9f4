// Elementwise Montgomery product a * b * R^-1 mod p (hodor_mont_mul), and
// the static power x^e by the same product (hodor_mont_pow).
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_mont_mul_v2
// (_mont_mul_kernel_v2) and its unrolled twin pallas_mont_mul; mont_pow is
// the port's form of the one-program exponent loop of
// hodor_tpu/field/limbs.py LimbOps.inv_fermat and pow_static.
// Bound on the H100: device-memory bytes. A 256-bit product is 64
// mad.wide.u32 for the schoolbook part plus 64 for the reduction, about
// 300 integer instructions for 192 bytes moved (two operands and the
// result as int32-held 16-bit limbs), well under the card's
// operations-per-byte line. A power of one element is bound by neither:
// it is one thread's chain of dependent products, and what it saves is
// launches (one instead of one per squaring and multiply).
// Design: one thread per element, packed 32-bit words and CIOS in
// registers, every operand read and the result written through 16-byte
// accesses. Three bodies, picked by the launcher from the collapsed
// layout alone, so that no thread divides to find its element on the
// common layouts:
//   flat     one element dim: offset = i * stride, stride 0 for a scalar
//            operand (both contiguous, one scalar, a strided 1-D view);
//   grid     three dims with the outer two on blockIdx.z and blockIdx.y
//            (the LDE's coset shift (R,1,T) x (F,T) and every period or
//            broadcast form whose inner dim is at least a warp wide); an
//            operand broadcast over the middle dim stays in registers for
//            up to 16 products;
//   general  three dims by 64-bit division (element_at), for the rest.
// A broadcast operand arrives with stride 0 on its broadcast dims, so it
// is read from cache and never materialised. Each thread reads its
// element as a 64-byte run of four 16-byte loads; staging a block's
// elements through shared memory so that device memory sees consecutive
// lanes on consecutive chunks measured no faster and was not kept.
#include "field.cuh"

namespace hodor {

constexpr int kMulThreads = 256;
constexpr long long kMaxGridYZ = 65535;
constexpr long long kMinGridInner = 32;
constexpr long long kGridRun = 16;  // middle-dim indices a thread of the grid body walks

template <int N16>
__device__ __forceinline__ void mul_element(int32_t* out, const int32_t* a, const int32_t* b,
                                            const FieldConsts& fc) {
  constexpr int NW = N16 / 2;
  uint32_t x[NW], y[NW], r[NW];
  load_words_v4<NW>(a, x);
  load_words_v4<NW>(b, y);
  mont_mul_words<NW>(r, x, y, fc);
  store_words_v4<NW>(out, r);
}

template <int N16>
__global__ void __launch_bounds__(kMulThreads)
    mont_mul_flat_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                         long long a_stride, const int32_t* __restrict__ b, long long b_stride,
                         long long total, FieldConsts fc) {
  const long long i = (long long)blockIdx.x * kMulThreads + threadIdx.x;
  if (i >= total) return;
  mul_element<N16>(out + i * N16, a + i * a_stride, b + i * b_stride, fc);
}

// A thread walks `run` consecutive indices of the middle dim and loads an
// operand again only where its stride over that dim is not 0: the operand
// that is broadcast over the middle dim (the LDE shift's coefficients over
// the 16 cosets) is read once per `run` products instead of once per product.
template <int N16>
__global__ void __launch_bounds__(kMulThreads)
    mont_mul_grid_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a, Strides3 as,
                         const int32_t* __restrict__ b, Strides3 bs, Dims3 dims, int run,
                         FieldConsts fc) {
  constexpr int NW = N16 / 2;
  const long long i2 = (long long)blockIdx.x * kMulThreads + threadIdx.x;
  if (i2 >= dims.d[2]) return;
  const long long i0 = blockIdx.z, first = (long long)blockIdx.y * run;
  const long long last = first + run < dims.d[1] ? first + run : dims.d[1];
  const int32_t* ap = a + i0 * as.s[0] + first * as.s[1] + i2 * as.s[2];
  const int32_t* bp = b + i0 * bs.s[0] + first * bs.s[1] + i2 * bs.s[2];
  int32_t* op = out + ((i0 * dims.d[1] + first) * dims.d[2] + i2) * N16;
  uint32_t x[NW], y[NW], r[NW];
  for (long long i1 = first; i1 < last; ++i1) {
    if (i1 == first || as.s[1] != 0) load_words_v4<NW>(ap, x);
    if (i1 == first || bs.s[1] != 0) load_words_v4<NW>(bp, y);
    mont_mul_words<NW>(r, x, y, fc);
    store_words_v4<NW>(op, r);
    ap += as.s[1];
    bp += bs.s[1];
    op += dims.d[2] * N16;
  }
}

template <int N16>
__global__ void __launch_bounds__(kMulThreads)
    mont_mul_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a, Strides3 as,
                    const int32_t* __restrict__ b, Strides3 bs, Dims3 dims, long long total,
                    FieldConsts fc) {
  const long long i = (long long)blockIdx.x * kMulThreads + threadIdx.x;
  if (i >= total) return;
  mul_element<N16>(out + i * N16, element_at(a, as, dims, i), element_at(b, bs, dims, i), fc);
}

template <int N16>
static int launch_mont_mul(int32_t* out, const int32_t* a, const long long* a_strides,
                           const int32_t* b, const long long* b_strides,
                           const long long* dims, const uint32_t* p_words, uint32_t pinv0,
                           cudaStream_t stream) {
  const Strides3 as{{a_strides[0], a_strides[1], a_strides[2]}};
  const Strides3 bs{{b_strides[0], b_strides[1], b_strides[2]}};
  const Dims3 d{{dims[0], dims[1], dims[2]}};
  const long long total = dims[0] * dims[1] * dims[2];
  const FieldConsts fc = make_field_consts(N16 / 2, p_words, pinv0);
  const auto blocks = [](long long n) { return (unsigned)((n + kMulThreads - 1) / kMulThreads); };
  if (dims[0] == 1 && dims[1] == 1) {
    mont_mul_flat_kernel<N16><<<blocks(total), kMulThreads, 0, stream>>>(
        out, a, as.s[2], b, bs.s[2], total, fc);
  } else if (dims[0] <= kMaxGridYZ && dims[1] <= kMaxGridYZ && dims[2] >= kMinGridInner) {
    // a run only where it saves reads
    const bool broadcast = dims[1] > 1 && (as.s[1] == 0 || bs.s[1] == 0);
    const int run = broadcast ? (int)(dims[1] < kGridRun ? dims[1] : kGridRun) : 1;
    const dim3 grid(blocks(dims[2]), (unsigned)((dims[1] + run - 1) / run), (unsigned)dims[0]);
    mont_mul_grid_kernel<N16><<<grid, kMulThreads, 0, stream>>>(out, a, as, b, bs, d, run, fc);
  } else {
    mont_mul_kernel<N16><<<blocks(total), kMulThreads, 0, stream>>>(out, a, as, b, bs, d, total,
                                                                    fc);
  }
  return (int)cudaGetLastError();
}

// A static exponent, little-endian words; n_bits its bit length (0 for e = 0).
struct Exponent {
  uint32_t w[kMaxWords];
  int n_bits;
};

// out[i] = x[i]^e in Montgomery form, MSB-first square-and-multiply; one_m
// is the Montgomery one (the result for e = 0).
template <int N16>
__global__ void __launch_bounds__(kMulThreads)
    mont_pow_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x, long long total,
                    Exponent e, FieldConsts one_m, FieldConsts fc) {
  constexpr int NW = N16 / 2;
  const long long i = (long long)blockIdx.x * kMulThreads + threadIdx.x;
  if (i >= total) return;
  uint32_t base[NW], acc[NW], r[NW];
  load_words_v4<NW>(x + i * N16, base);
#pragma unroll
  for (int q = 0; q < NW; ++q) acc[q] = e.n_bits ? base[q] : one_m.p[q];
  for (int bit = e.n_bits - 2; bit >= 0; --bit) {
    mont_mul_words<NW>(r, acc, acc, fc);
    if ((e.w[bit >> 5] >> (bit & 31)) & 1u) {
      mont_mul_words<NW>(acc, r, base, fc);
    } else {
#pragma unroll
      for (int q = 0; q < NW; ++q) acc[q] = r[q];
    }
  }
  store_words_v4<NW>(out + i * N16, acc);
}

template <int N16>
static int launch_mont_pow(int32_t* out, const int32_t* x, long long total,
                           const uint32_t* e_words, int e_bits, const uint32_t* one_words,
                           const uint32_t* p_words, uint32_t pinv0, cudaStream_t stream) {
  constexpr int NW = N16 / 2;
  if (e_bits < 0 || e_bits > 32 * NW || total < 1) return (int)cudaErrorInvalidValue;
  Exponent e{};
  for (int i = 0; i < (e_bits + 31) / 32; ++i) e.w[i] = e_words[i];
  e.n_bits = e_bits;
  const FieldConsts fc = make_field_consts(NW, p_words, pinv0);
  const FieldConsts one_m = make_field_consts(NW, one_words, 0);
  mont_pow_kernel<N16><<<(unsigned)((total + kMulThreads - 1) / kMulThreads), kMulThreads, 0,
                         stream>>>(out, x, total, e, one_m, fc);
  return (int)cudaGetLastError();
}

}  // namespace hodor

// Strides in int32 units over the output's element dims collapsed to three
// (dims), 0 on a broadcast dim; every element 16-byte aligned.
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

// x and out contiguous (total, n16); e_words the exponent's e_bits bits,
// one_words the Montgomery one.
extern "C" int hodor_mont_pow(int n16, int32_t* out, const int32_t* x, long long total,
                              const uint32_t* e_words, int e_bits, const uint32_t* one_words,
                              const uint32_t* p_words, uint32_t pinv0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n16 == 4)
    return hodor::launch_mont_pow<4>(out, x, total, e_words, e_bits, one_words, p_words, pinv0,
                                     s);
  if (n16 == 16)
    return hodor::launch_mont_pow<16>(out, x, total, e_words, e_bits, one_words, p_words, pinv0,
                                      s);
  return (int)cudaErrorInvalidValue;
}
