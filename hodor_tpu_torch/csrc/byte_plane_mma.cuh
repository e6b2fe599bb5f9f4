// The int8 tensor-core helpers of the port, and on top of them the
// byte-plane contraction of ntt_level.
//
// Two kernels share the lower half of this header: the fragment loads
// (ldmatrix_x4 / ldmatrix_x2), the lane's fragment offsets, the padded-row
// rule (kRowPad) and the m16n8k32 products, unsigned (mma_u8_m16n8k32) and
// signed (mma_s8_m16n8k32). ntt_level.cu goes on to contract_byte_planes
// below. dft_reduce.cu does not: its operands are signed, offset by -128,
// and the plane convolution is already folded into its W, so it runs a
// tile loop of its own over the folded depth (warp_tile_mma) and uses from
// here only the shared half.
//
// The byte-plane contraction on the int8 tensor cores: the exact integer
//   t[k, m] = sum_j W[k, j] * x[j, m]
// of 2 NW-word operands (P = 4 NW bytes each, base 256), from byte planes
// resident in shared memory, as 2 P bytes per output.
//
// Algebra (hodor_tpu/field/pallas_kernels.py _ntt_level_kernel, thought
// through again for this card): base-256 column c of t is
//   col[c][k, m] = sum_{qi + qj = c} sum_j Wb[qi][k, j] * xb[qj][j, m],
// at most P pairs of depth-S byte dots. Bytes are unsigned and the
// u8 x u8 -> s32 form of mma.sync.m16n8k32 multiplies them as they are,
// so there is no -128 offset and no correction term; a whole column stays
// below P * S * 255^2 < 2^28 at S = 128 and sums in s32 accumulators with
// no add outside the tensor core. The columns are walked in order; a
// complete column takes the running carry, gives one byte of t and
// carries the rest.
//
// What bounds it: the throughput of mma.sync, then shared-memory
// bandwidth. From registers alone an H100 completes one m16n8k32 on bytes
// every 6 clocks a tensor core (tools/mma_rate.py: about 1,290 of the data
// sheet's 1,979 int8 TOP/s, which only wgmma reaches). One product is
// 4,096 multiply-adds for 768 bytes of fragments, and an SM delivers 128
// bytes a clock, so fragments fetched per product would cost 6 clocks a
// product for the SM's four tensor cores together. So the planes are
// walked in blocks of kPB x kPB (qi, qj) pairs: kPB A fragments and kPB B
// fragments, loaded once with ldmatrix, feed kPB^2 products (192 bytes a
// product at kPB = 4, 1.5 clocks of shared memory), which touch 2 kPB - 1
// neighbouring columns. The blocks of one anti-diagonal d (ci + cj = d)
// complete columns kPB d .. kPB d + kPB - 1, one 32-bit word of t at
// kPB = 4; the partial sums of the next kPB - 1 columns carry into the
// next anti-diagonal. Each (i, j) pair of a block has an accumulator of
// its own, so the kPB^2 products of a depth step are independent and one
// warp a scheduler keeps its tensor core fed. Measured and not kept,
// because neither was faster: loading the next step's fragments a step
// ahead by hand, and 4 x 8 blocks (128 bytes a product) over swizzled rows
// with t in shared memory.
//
// Layout the caller provides: plane q of an operand is a row-major byte
// matrix with the depth (j) contiguous, rows kRowPad bytes apart beyond
// the depth, so that the eight rows of an ldmatrix phase fall on distinct
// 16-byte bank groups (row stride S + 16 for S = 32, 64, 128). A rows are
// the outputs k, B rows the outputs m.
#pragma once

#include <cstdint>

namespace hodor {

constexpr int kPB = 4;        // planes per block: one word of t per anti-diagonal
constexpr int kRowPad = 16;   // bytes of padding after each plane row

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a (16 x 32 bytes, row-major) . b (32 x 8 bytes, column-major), unsigned
// bytes, s32 sums. Lane l = 4 g + t holds d0, d1 = (row g, cols 2 t, 2 t + 1)
// and d2, d3 = (row g + 8, the same cols).
__device__ __forceinline__ void mma_u8_m16n8k32(int (&d)[4], const uint32_t (&a)[4],
                                                const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same product on signed bytes (s8 x s8 -> s32), b given as its two
// registers: the contraction of operands offset by -128.
__device__ __forceinline__ void mma_s8_m16n8k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This lane's ldmatrix row address inside a plane, relative to the plane's
// first byte, for the A fragment of a 16-row tile starting at row0 (x4:
// rows 0-7 and 8-15 at depth bytes 0-15, then the same rows at 16-31) ...
__device__ __forceinline__ uint32_t a_fragment_offset(int lane, int row0, int row_stride) {
  return (uint32_t)((row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * row_stride + (lane >> 4) * 16);
}

// ... and for the B fragment of an 8-row tile (x2: depth bytes 0-15, 16-31;
// lanes 16-31 repeat valid addresses that the instruction ignores).
__device__ __forceinline__ uint32_t b_fragment_offset(int lane, int row0, int row_stride) {
  return (uint32_t)((row0 + (lane & 7)) * row_stride + ((lane >> 3) & 1) * 16);
}

// ... and for the B fragments of two neighbouring 8-row tiles in one x4
// load: registers 0, 1 are the tile at row0 (depth bytes 0-15, 16-31),
// registers 2, 3 the tile at row0 + 8.
__device__ __forceinline__ uint32_t b_pair_fragment_offset(int lane, int row0, int row_stride) {
  return (uint32_t)((row0 + (lane & 7) + ((lane >> 4) & 1) * 8) * row_stride +
                    ((lane >> 3) & 1) * 16);
}

// One kPB x kPB block of plane pairs over the whole depth: acc[i][j] +=
// A plane (a0 + i) . B plane (b0 + j) for this warp's 16 x 8 outputs.
// a_addr, b_addr: the lane's shared-memory fragment addresses in planes
// a0 and b0; KS depth steps of 32 bytes.
template <int KS>
__device__ __forceinline__ void plane_block_mma(int (&acc)[kPB][kPB][4], uint32_t a_addr,
                                                uint32_t a_plane_bytes, uint32_t b_addr,
                                                uint32_t b_plane_bytes) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[kPB][4], bf[kPB][2];
#pragma unroll
    for (int i = 0; i < kPB; ++i) ldmatrix_x4(af[i], a_addr + i * a_plane_bytes + ks * 32);
#pragma unroll
    for (int j = 0; j < kPB; ++j) ldmatrix_x2(bf[j], b_addr + j * b_plane_bytes + ks * 32);
#pragma unroll
    for (int i = 0; i < kPB; ++i)
#pragma unroll
      for (int j = 0; j < kPB; ++j) mma_u8_m16n8k32(acc[i][j], af[i], bf[j]);
  }
}

// The whole contraction for this warp's 16 x 8 outputs, of which the lane
// owns four (see mma_u8_m16n8k32): t[o] gets the 2 NW words of output o.
// NPB = P / kPB plane blocks per operand; the anti-diagonals d = 0 ..
// 2 NPB - 2 are walked in order and one more step flushes the carry.
template <int NW, int KS>
__device__ __forceinline__ void contract_byte_planes(uint32_t (&t)[4][2 * NW], uint32_t a_addr,
                                                     uint32_t a_plane_bytes, uint32_t b_addr,
                                                     uint32_t b_plane_bytes) {
  static_assert(kPB == 4, "one anti-diagonal must complete one 32-bit word of t");
  constexpr int NPB = 4 * NW / kPB;
  int acc[kPB][kPB][4];
#pragma unroll
  for (int i = 0; i < kPB; ++i)
#pragma unroll
    for (int j = 0; j < kPB; ++j)
#pragma unroll
      for (int o = 0; o < 4; ++o) acc[i][j][o] = 0;
  uint32_t run[4] = {0, 0, 0, 0};  // column sum + carry < 2^28 + 2^24

#pragma unroll
  for (int d = 0; d < 2 * NPB; ++d) {
    const int lo = d < NPB ? 0 : d - NPB + 1;
    const int hi = d < NPB ? d : NPB - 1;  // empty for the flush step d = 2 NPB - 1
#pragma unroll 1
    for (int ci = lo; ci <= hi; ++ci)
      plane_block_mma<KS>(acc, a_addr + ci * kPB * a_plane_bytes, a_plane_bytes,
                          b_addr + (d - ci) * kPB * b_plane_bytes, b_plane_bytes);
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      // columns kPB d + cc of this anti-diagonal: complete for cc < kPB
      int col[2 * kPB - 1];
#pragma unroll
      for (int cc = 0; cc < 2 * kPB - 1; ++cc) col[cc] = 0;
#pragma unroll
      for (int i = 0; i < kPB; ++i)
#pragma unroll
        for (int j = 0; j < kPB; ++j) col[i + j] += acc[i][j][o];
      uint32_t word = 0;
#pragma unroll
      for (int cc = 0; cc < kPB; ++cc) {
        run[o] += (uint32_t)col[cc];
        word |= (run[o] & 0xFFu) << (8 * cc);
        run[o] >>= 8;
      }
      t[o][d] = word;
      // the partial sums of the next kPB - 1 columns open the next anti-diagonal
#pragma unroll
      for (int i = 0; i < kPB; ++i)
#pragma unroll
        for (int j = 0; j < kPB; ++j)
          acc[i][j][o] = (i == 0 && j < kPB - 1) ? col[kPB + j] : 0;
    }
  }
}

}  // namespace hodor
