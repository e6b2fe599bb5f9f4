// Elementwise modular a + b (mode 0) and a - b (mode 1).
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_addsub
// (_addsub_kernel). The same conditions: the sum loses p when the add
// carries out of the top word or is >= p; the difference gains p back on
// a borrow.
// Bound on the H100: device-memory bytes. Two carry chains and a select
// are about 3 NW integer instructions for 3 * 16 * n16 bytes moved (two
// operands read once, the result written once): 24 for 192 bytes at
// n16 = 16, 6 for 48 bytes at n16 = 4, far under the card's
// operations-per-byte line.
// Design: the three bodies of mont_mul.cu, picked by the launcher from the
// collapsed layout by the same rule, so that no thread divides to find its
// element on the layouts a prove issues:
//   flat     one element dim: offset = i * stride, stride 0 for a scalar;
//   grid     three dims with the outer two on blockIdx.z and blockIdx.y;
//   general  three dims by 64-bit division (element_at), for the rest.
// Neighbouring threads take neighbouring elements; at n16 = 4 a flat or
// grid thread may take kAddElemsN16x4 elements a block's width apart, set
// from the card's times (PERF.md, tools/launch_cost.py with L2 defeated).
// The add or subtract is a template argument, not a branch. A thread
// issues all its loads before its first add: the loads and the adds sit
// in two loops under the same bound checks with an empty volatile asm
// between them, which nvcc does not merge. With load, load, add in one
// block nvcc interleaved the carry chain with the loads and kept half of
// the 16-byte loads in flight at n16 = 16, 7-19% slower on the H100.
#include "field.cuh"

namespace hodor {

constexpr int kAddThreads = 256;
constexpr long long kAddMaxGridYZ = 65535;
constexpr long long kAddMinGridInner = 32;

template <int NW, int MODE>
__device__ __forceinline__ void addsub_words(uint32_t (&r)[NW], const uint32_t (&x)[NW],
                                             const uint32_t (&y)[NW], const FieldConsts& fc) {
  if (MODE == 0)
    mod_add<NW>(r, x, y, fc);
  else
    mod_sub<NW>(r, x, y, fc);
}

// Elements a thread takes at a width, a block's width apart, so that in
// each step neighbouring threads take neighbouring elements.
constexpr int kAddElemsN16x4 = 1;
template <int N16>
constexpr int kAddElems = N16 == 4 ? kAddElemsN16x4 : 1;

// The E elements i0, i0 + kAddThreads, ... below `count` of a run whose
// element k sits at a + k * a_stride and b + k * b_stride, written to
// out + k * N16: every load issued before the first add.
template <int N16, int MODE>
__device__ __forceinline__ void addsub_run(int32_t* __restrict__ out,
                                           const int32_t* __restrict__ a, long long a_stride,
                                           const int32_t* __restrict__ b, long long b_stride,
                                           long long i0, long long count, const FieldConsts& fc) {
  constexpr int NW = N16 / 2, E = kAddElems<N16>;
  uint32_t x[E][NW], y[E][NW];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = i0 + e * kAddThreads;
    if (i < count) {
      load_words_v4<NW>(a + i * a_stride, x[e]);
      load_words_v4<NW>(b + i * b_stride, y[e]);
    }
  }
  asm volatile("" ::: "memory");  // the loads above all issue first
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = i0 + e * kAddThreads;
    if (i < count) {
      uint32_t r[NW];
      addsub_words<NW, MODE>(r, x[e], y[e], fc);
      store_words_v4<NW>(out + i * N16, r);
    }
  }
}

template <int N16, int MODE>
__global__ void __launch_bounds__(kAddThreads)
    addsub_flat_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                       long long a_stride, const int32_t* __restrict__ b, long long b_stride,
                       long long total, FieldConsts fc) {
  const long long i0 = (long long)blockIdx.x * kAddThreads * kAddElems<N16> + threadIdx.x;
  addsub_run<N16, MODE>(out, a, a_stride, b, b_stride, i0, total, fc);
}

template <int N16, int MODE>
__global__ void __launch_bounds__(kAddThreads)
    addsub_grid_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a, Strides3 as,
                       const int32_t* __restrict__ b, Strides3 bs, Dims3 dims, FieldConsts fc) {
  const long long i0 = (long long)blockIdx.x * kAddThreads * kAddElems<N16> + threadIdx.x;
  const long long z = blockIdx.z, y = blockIdx.y;
  addsub_run<N16, MODE>(out + (z * dims.d[1] + y) * dims.d[2] * N16,
                        a + z * as.s[0] + y * as.s[1], as.s[2], b + z * bs.s[0] + y * bs.s[1],
                        bs.s[2], i0, dims.d[2], fc);
}

template <int N16, int MODE>
__global__ void __launch_bounds__(kAddThreads)
    addsub_general_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a, Strides3 as,
                          const int32_t* __restrict__ b, Strides3 bs, Dims3 dims,
                          long long total, FieldConsts fc) {
  constexpr int NW = N16 / 2;
  const long long i = (long long)blockIdx.x * kAddThreads + threadIdx.x;
  uint32_t x[NW], y[NW], r[NW];
  if (i < total) {
    load_words_v4<NW>(element_at(a, as, dims, i), x);
    load_words_v4<NW>(element_at(b, bs, dims, i), y);
  }
  asm volatile("" ::: "memory");  // the loads above all issue first
  if (i < total) {
    addsub_words<NW, MODE>(r, x, y, fc);
    store_words_v4<NW>(out + i * N16, r);
  }
}

template <int N16, int MODE>
static int launch_addsub(int32_t* out, const int32_t* a, const long long* a_strides,
                         const int32_t* b, const long long* b_strides, const long long* dims,
                         const uint32_t* p_words, cudaStream_t stream) {
  const Strides3 as{{a_strides[0], a_strides[1], a_strides[2]}};
  const Strides3 bs{{b_strides[0], b_strides[1], b_strides[2]}};
  const Dims3 d{{dims[0], dims[1], dims[2]}};
  const long long total = dims[0] * dims[1] * dims[2];
  const FieldConsts fc = make_field_consts(N16 / 2, p_words, 0);
  const auto blocks = [](long long n, long long per_thread) {
    return (unsigned)((n + kAddThreads * per_thread - 1) / (kAddThreads * per_thread));
  };
  if (dims[0] == 1 && dims[1] == 1) {
    const unsigned grid = blocks(total, kAddElems<N16>);
    addsub_flat_kernel<N16, MODE><<<grid, kAddThreads, 0, stream>>>(out, a, as.s[2], b, bs.s[2],
                                                                    total, fc);
  } else if (dims[0] <= kAddMaxGridYZ && dims[1] <= kAddMaxGridYZ &&
             dims[2] >= kAddMinGridInner) {
    const dim3 grid(blocks(dims[2], kAddElems<N16>), (unsigned)dims[1], (unsigned)dims[0]);
    addsub_grid_kernel<N16, MODE><<<grid, kAddThreads, 0, stream>>>(out, a, as, b, bs, d, fc);
  } else {
    addsub_general_kernel<N16, MODE><<<blocks(total, 1), kAddThreads, 0, stream>>>(
        out, a, as, b, bs, d, total, fc);
  }
  return (int)cudaGetLastError();
}

template <int N16>
static int launch_addsub_mode(int mode, int32_t* out, const int32_t* a,
                              const long long* a_strides, const int32_t* b,
                              const long long* b_strides, const long long* dims,
                              const uint32_t* p_words, cudaStream_t stream) {
  if (mode == 0)
    return launch_addsub<N16, 0>(out, a, a_strides, b, b_strides, dims, p_words, stream);
  return launch_addsub<N16, 1>(out, a, a_strides, b, b_strides, dims, p_words, stream);
}

}  // namespace hodor

// Strides in int32 units over the output's element dims collapsed to three
// (dims), 0 on a broadcast dim; every element 16-byte aligned.
extern "C" int hodor_addsub(int n16, int mode, int32_t* out, const int32_t* a,
                            const long long* a_strides, const int32_t* b,
                            const long long* b_strides, const long long* dims,
                            const uint32_t* p_words, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (n16 == 4)
    return hodor::launch_addsub_mode<4>(mode, out, a, a_strides, b, b_strides, dims, p_words, s);
  if (n16 == 16)
    return hodor::launch_addsub_mode<16>(mode, out, a, a_strides, b, b_strides, dims, p_words,
                                         s);
  return (int)cudaErrorInvalidValue;
}
