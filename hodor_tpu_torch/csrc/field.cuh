// Shared device helpers for the prime-field kernels.
//
// A field element crosses the kernel boundary as n16 int32 values, each
// holding one 16-bit limb, little-endian, in Montgomery form (the port's
// limb layout, hodor_tpu_torch/field/limbs.py). Inside a kernel it is
// packed into NW = n16 / 2 32-bit words, so products are 32x32 -> 64-bit
// (mad.wide.u32) instead of the TPU kernels' 16x16 -> 32-bit planes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hodor {

constexpr int kMaxWords = 8;  // 256-bit moduli (n16 = 16)
constexpr int kMaxChain = 8;  // conditional-subtract multiples of p

struct FieldConsts {
  uint32_t p[kMaxWords];
  uint32_t pinv0;  // -p^-1 mod 2^32
};

// A level's constants: the field and the conditional-subtract chain that
// brings the Montgomery reduction of a radix-term sum below p.
struct LevelConsts {
  FieldConsts f;
  uint32_t chain[kMaxChain][kMaxWords];
  int n_chain;
};

inline FieldConsts make_field_consts(int nw, const uint32_t* p_words, uint32_t pinv0) {
  FieldConsts fc{};
  for (int i = 0; i < nw; ++i) fc.p[i] = p_words[i];
  fc.pinv0 = pinv0;
  return fc;
}

// chain: n_chain multiples of p, nw words each.
inline LevelConsts make_level_consts(int nw, const uint32_t* p_words, uint32_t pinv0,
                                     const uint32_t* chain, int n_chain) {
  LevelConsts lc{};
  lc.f = make_field_consts(nw, p_words, pinv0);
  for (int s = 0; s < n_chain; ++s)
    for (int i = 0; i < nw; ++i) lc.chain[s][i] = chain[s * nw + i];
  lc.n_chain = n_chain;
  return lc;
}

// Element strides (in int32 units) of a broadcast operand over the
// output's index space collapsed to three dims; 0 marks a broadcast dim.
struct Strides3 {
  long long s[3];
};

struct Dims3 {
  long long d[3];
};

// An element's limbs <-> its packed words through 16-byte loads and
// stores; limbs must be 16-byte aligned (every element of a limb tensor
// is: n16 is a multiple of 4, and the wrappers check the base pointer and
// the strides).
template <int NW>
__device__ __forceinline__ void load_words_v4(const int32_t* limbs, uint32_t (&w)[NW]) {
  const int4* v = reinterpret_cast<const int4*>(limbs);
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int4 q = v[i];
    w[2 * i] = (uint32_t)q.x | ((uint32_t)q.y << 16);
    w[2 * i + 1] = (uint32_t)q.z | ((uint32_t)q.w << 16);
  }
}

template <int NW>
__device__ __forceinline__ void store_words_v4(int32_t* limbs, const uint32_t (&w)[NW]) {
  int4* v = reinterpret_cast<int4*>(limbs);
#pragma unroll
  for (int i = 0; i < NW / 2; ++i)
    v[i] = make_int4((int)(w[2 * i] & 0xFFFFu), (int)(w[2 * i] >> 16),
                     (int)(w[2 * i + 1] & 0xFFFFu), (int)(w[2 * i + 1] >> 16));
}

// d = a - b; returns the borrow out (1 when a < b).
template <int NW>
__device__ __forceinline__ uint32_t sub_words(uint32_t (&d)[NW], const uint32_t (&a)[NW],
                                              const uint32_t* b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 32) & 1u;
  }
  return borrow;
}

// s = a + b; returns the carry out.
template <int NW>
__device__ __forceinline__ uint32_t add_words(uint32_t (&s)[NW], const uint32_t (&a)[NW],
                                              const uint32_t* b) {
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = (uint64_t)a[i] + b[i] + carry;
    s[i] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return carry;
}

// u -= m when u >= m.
template <int NW>
__device__ __forceinline__ void cond_sub(uint32_t (&u)[NW], const uint32_t* m) {
  uint32_t d[NW];
  uint32_t borrow = sub_words<NW>(d, u, m);
#pragma unroll
  for (int i = 0; i < NW; ++i) u[i] = borrow ? u[i] : d[i];
}

// r = a + b mod p; a, b < p.
template <int NW>
__device__ __forceinline__ void mod_add(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW], const FieldConsts& fc) {
  uint32_t alt[NW];
  const uint32_t carry = add_words<NW>(r, a, b);
  const uint32_t borrow = sub_words<NW>(alt, r, fc.p);
  const bool ge = carry != 0 || borrow == 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) r[k] = ge ? alt[k] : r[k];
}

// r = a - b mod p; a, b < p.
template <int NW>
__device__ __forceinline__ void mod_sub(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW], const FieldConsts& fc) {
  uint32_t alt[NW];
  const uint32_t borrow = sub_words<NW>(r, a, b);
  add_words<NW>(alt, r, fc.p);
#pragma unroll
  for (int k = 0; k < NW; ++k) r[k] = borrow ? alt[k] : r[k];
}

// r = a * b * 2^(-32 NW) mod p by CIOS; a, b < p, r canonical (< p).
template <int NW>
__device__ __forceinline__ void mont_mul_words(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                               const uint32_t (&b)[NW], const FieldConsts& fc) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * fc.pinv0;
    c = ((uint64_t)m * fc.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      uint64_t s2 = (uint64_t)m * fc.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s2;
      c = s2 >> 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  uint32_t lo[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) lo[i] = t[i];
  uint32_t d[NW];
  uint32_t borrow = sub_words<NW>(d, lo, fc.p);
  bool ge = (t[NW] != 0) || (borrow == 0);
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = ge ? d[i] : lo[i];
}

// u = t * 2^(-32 NW) mod p for the integer t < radix * p^2 held in the
// low 2 NW words of t (t[2 NW] must be 0; it takes the carry of t + m p):
// one word-serial Montgomery reduction, then the level's subtract chain.
//
// u is kept in NW words and t[2 NW] is dropped, so (t + m p) / R must stay
// below R = 2^(32 NW). max_radix's test, radix * p^2 < R^2
// (ntt/matmul.py), bounds t alone, not t + m p with m up to R - 1. What
// keeps u below R for a DFT level is the matrix: in Montgomery form w^j
// and w^(j + S/2) = -w^j sum to p, so a row of W sums to at most
// (S/2) p (row 0 to S (R mod p)), t <= (S/2) p (p - 1) and
// u <= ((S/2) p (p - 1) + (R - 1) p) / R. At S = 4 that leaves
// R - u_max = 9.0e10 against R = 1.8e19 for F_P63 (R/p = 2.00), and
// u_max / R = 0.86 for F_BLS (R/p = 2.21); the fields with more room
// (F_STARK, F257) take larger radices. tests/test_torch_cuda.py
// test_level_kernels_at_worst_case_inputs and chip_smoke.py phase 3 run
// the level kernels at every x = p - 1 against the plain version, which
// keeps the top word.
template <int NW>
__device__ __forceinline__ void mont_reduce_wide(uint32_t (&u)[NW], uint32_t (&t)[2 * NW + 1],
                                                 const LevelConsts& lc) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = t[i] * lc.f.pinv0;
    uint64_t cc = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t s = (uint64_t)m * lc.f.p[j] + t[i + j] + cc;
      t[i + j] = (uint32_t)s;
      cc = s >> 32;
    }
#pragma unroll
    for (int q = i + NW; q < 2 * NW + 1; ++q) {
      const uint64_t s = (uint64_t)t[q] + cc;
      t[q] = (uint32_t)s;
      cc = s >> 32;
    }
  }
#pragma unroll
  for (int q = 0; q < NW; ++q) u[q] = t[NW + q];
  for (int s = 0; s < lc.n_chain; ++s) cond_sub<NW>(u, lc.chain[s]);
}

// u *= tw (Montgomery) for a level's twiddle: tw_mode 0 none, 1 one
// scalar, 2 the table entry at tw + index * 2 NW.
template <int NW>
__device__ __forceinline__ void apply_twiddle(uint32_t (&u)[NW], int tw_mode, const int32_t* tw,
                                              long long index, const FieldConsts& fc) {
  if (tw_mode == 0) return;
  uint32_t tv[NW], r[NW];
  load_words_v4<NW>(tw_mode == 1 ? tw : tw + index * (2 * NW), tv);
  mont_mul_words<NW>(r, u, tv, fc);
#pragma unroll
  for (int q = 0; q < NW; ++q) u[q] = r[q];
}

__device__ __forceinline__ const int32_t* element_at(const int32_t* base, const Strides3& st,
                                                     const Dims3& dims, long long i) {
  long long i2 = i % dims.d[2];
  long long rest = i / dims.d[2];
  long long i1 = rest % dims.d[1];
  long long i0 = rest / dims.d[1];
  return base + i0 * st.s[0] + i1 * st.s[1] + i2 * st.s[2];
}

}  // namespace hodor
