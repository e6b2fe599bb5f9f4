// Keyed Blake2s-256 of one final block of at most 64 bytes per message.
//
// Replaces: hodor_tpu/field/pallas_kernels.py pallas_blake2s
// (_blake2s_kernel). The key block is constant, so a keyed hash of a
// <= 64-byte message is one compression from the post-key midstate with
// byte counter t = 64 + message_bytes and the final-block flag set.
// Bound on the H100: integer instructions (10 rounds x 8 G functions,
// about 900 32-bit operations for at most 96 bytes moved).
// Design: one thread per message; the 16-word state lives in registers,
// the message words in a thread-private array, SIGMA in constant memory.
// Messages are read as they lie: 8 words for a 32-byte leaf (the zero
// padding is never stored), 16 for a 64-byte node, so a level of the
// tree is hashed straight from the level below.
#include <cstdint>
#include <cuda_runtime.h>

namespace hodor {

__constant__ uint8_t kSigma[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
};

__constant__ uint32_t kIv[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                                0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};

struct Midstate {
  uint32_t h[8];
};

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int r) { return __funnelshift_r(x, x, r); }

__device__ __forceinline__ void g(uint32_t (&v)[16], int a, int b, int c, int d, uint32_t x,
                                  uint32_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr32(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr32(v[b] ^ v[c], 12);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr32(v[d] ^ v[a], 8);
  v[c] = v[c] + v[d];
  v[b] = rotr32(v[b] ^ v[c], 7);
}

__global__ void blake2s_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ msg,
                               long long n, int msg_words, Midstate mid, uint32_t t_total) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t m[16];
  const int32_t* src = msg + i * msg_words;
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = k < msg_words ? (uint32_t)src[k] : 0u;
  uint32_t v[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = mid.h[k];
    v[k + 8] = kIv[k];
  }
  v[12] ^= t_total;
  v[14] = ~v[14];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint8_t* s = kSigma[r];
    g(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    g(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    g(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    g(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    g(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    g(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    g(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    g(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  int32_t* dst = out + i * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) dst[k] = (int32_t)(mid.h[k] ^ v[k] ^ v[k + 8]);
}

}  // namespace hodor

extern "C" int hodor_blake2s(int32_t* out, const int32_t* msg, long long n, int msg_words,
                             const uint32_t* midstate, uint32_t t_total, void* stream) {
  if (msg_words != 8 && msg_words != 16) return (int)cudaErrorInvalidValue;
  hodor::Midstate mid;
  for (int k = 0; k < 8; ++k) mid.h[k] = midstate[k];
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  hodor::blake2s_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      out, msg, n, msg_words, mid, t_total);
  return (int)cudaGetLastError();
}
