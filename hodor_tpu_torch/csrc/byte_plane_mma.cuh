// The int8 tensor-core helpers of dft_reduce.cu: the fragment load
// (ldmatrix_x4), the lane's fragment offsets, the padded-row rule
// (kRowPad) and the signed m16n8k32 product (mma_s8_m16n8k32). Its
// operands are byte planes offset by -128, so the products are signed;
// dft_reduce.cu's warp_tile_mma walks them over the folded depth.
//
// Layout the caller provides: an operand tile is a row-major byte matrix
// with the depth contiguous, rows kRowPad bytes apart beyond the depth,
// so that the eight rows of an ldmatrix phase fall on distinct 16-byte
// bank groups. A rows are the outputs k, B rows the outputs m.
#pragma once

#include <cstdint>

namespace hodor {

constexpr int kRowPad = 16;   // bytes of padding after each operand row

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 32 bytes, row-major) . b (32 x 8 bytes, column-major), signed
// bytes, s32 sums, b given as its two registers. Lane l = 4 g + t holds
// d0, d1 = (row g, cols 2 t, 2 t + 1) and d2, d3 = (row g + 8, the same cols).
__device__ __forceinline__ void mma_s8_m16n8k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This lane's ldmatrix row address inside a tile, relative to the tile's
// first byte, for the A fragment of a 16-row tile starting at row0 (x4:
// rows 0-7 and 8-15 at depth bytes 0-15, then the same rows at 16-31) ...
__device__ __forceinline__ uint32_t a_fragment_offset(int lane, int row0, int row_stride) {
  return (uint32_t)((row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * row_stride + (lane >> 4) * 16);
}

// ... and for the B fragments of two neighbouring 8-row tiles in one x4
// load: registers 0, 1 are the tile at row0 (depth bytes 0-15, 16-31),
// registers 2, 3 the tile at row0 + 8.
__device__ __forceinline__ uint32_t b_pair_fragment_offset(int lane, int row0, int row_stride) {
  return (uint32_t)((row0 + (lane & 7) + ((lane >> 4) & 1) * 8) * row_stride +
                    ((lane >> 3) & 1) * 16);
}

}  // namespace hodor
