// Host witness chains of the models: the VDFs' squaring and cubing
// recurrences in Fp2 = F[x]/(x^2 - nr), and the Poseidon (Hades) chain
// of models/poseidon.py, on 4 x 64-bit Montgomery words (CIOS), for odd
// moduli up to 256 bits. Not a device kernel: each chain
// is sequential, a million steps of a few products each, and runs on one
// host core in a fraction of a second where the Python int chain takes
// seconds. The port's counterpart of native/vdf_witness.cpp (the
// reference generates its witnesses with 4 x u64 Montgomery arithmetic
// too, src/experiments/vdf.rs:143-150, cubic_vdf.rs:160-175).
//
// Built at first use by hodor_tpu_torch/utils/native.py:
//   g++ -O3 -shared -fPIC -o build/libhodor_host_<hash>.so vdf_witness.cpp
// All operands are canonical little-endian 4 x u64; r2 = 2^512 mod p,
// inv = -p^-1 mod 2^64. Outputs are canonical, (num_ops + 1) rows of 4.

#include <cstdint>
#include <cstring>

namespace {

using u64 = uint64_t;
using u128 = __uint128_t;

struct Fp {
  u64 p[4];
  u64 inv;
};

// out = a * b * 2^-256 mod p, canonical for a, b < p.
inline void mont_mul(const Fp& f, const u64 a[4], const u64 b[4], u64 out[4]) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      const u128 cur = (u128)a[i] * b[j] + t[j] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[4] + carry;
    t[4] = (u64)cur;
    t[5] = (u64)(cur >> 64);

    const u64 m = t[0] * f.inv;
    carry = ((u128)m * f.p[0] + t[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      const u128 c2 = (u128)m * f.p[j] + t[j] + carry;
      t[j - 1] = (u64)c2;
      carry = c2 >> 64;
    }
    cur = (u128)t[4] + carry;
    t[3] = (u64)cur;
    t[4] = t[5] + (u64)(cur >> 64);
  }
  u64 borrow = 0, d[4];
  for (int j = 0; j < 4; ++j) {
    const u128 cur = (u128)t[j] - f.p[j] - borrow;
    d[j] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  const bool ge = (t[4] != 0) || !borrow;
  for (int j = 0; j < 4; ++j) out[j] = ge ? d[j] : t[j];
}

inline void add_mod(const Fp& f, const u64 a[4], const u64 b[4], u64 out[4]) {
  u64 carry = 0, s[4];
  for (int j = 0; j < 4; ++j) {
    const u128 cur = (u128)a[j] + b[j] + carry;
    s[j] = (u64)cur;
    carry = (u64)(cur >> 64);
  }
  u64 borrow = 0, d[4];
  for (int j = 0; j < 4; ++j) {
    const u128 cur = (u128)s[j] - f.p[j] - borrow;
    d[j] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  const bool ge = carry || !borrow;
  for (int j = 0; j < 4; ++j) out[j] = ge ? d[j] : s[j];
}

inline void sub_mod(const Fp& f, const u64 a[4], const u64 b[4], u64 out[4]) {
  u64 borrow = 0, d[4];
  for (int j = 0; j < 4; ++j) {
    const u128 cur = (u128)a[j] - b[j] - borrow;
    d[j] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  u64 carry = 0;
  for (int j = 0; j < 4; ++j) {
    const u128 cur = (u128)d[j] + (borrow ? f.p[j] : 0) + carry;
    out[j] = (u64)cur;
    carry = (u64)(cur >> 64);
  }
}

// The chain's constants and the two Fp2 operations, in Montgomery form.
struct Chain {
  Fp f;
  u64 nr[4];

  Chain(const u64* p_limbs, u64 inv, const u64* r2, const u64* nr_in) {
    std::memcpy(f.p, p_limbs, 32);
    f.inv = inv;
    mont_mul(f, nr_in, r2, nr);
  }

  void to_mont(const u64* canonical, const u64* r2, u64 out[4]) const {
    mont_mul(f, canonical, r2, out);
  }

  void store(const u64 v[4], u64* canonical) const {
    const u64 one[4] = {1, 0, 0, 0};
    mont_mul(f, v, one, canonical);
  }

  // (a, b)^2 = (a^2 + nr b^2, 2 a b)
  void square(const u64 a[4], const u64 b[4], u64 o0[4], u64 o1[4]) const {
    u64 a2[4], b2[4], ab[4];
    mont_mul(f, a, a, a2);
    mont_mul(f, b, b, b2);
    mont_mul(f, a, b, ab);
    mont_mul(f, b2, nr, b2);
    add_mod(f, a2, b2, o0);
    add_mod(f, ab, ab, o1);
  }

  // (a, b) (c, d) = (a c + nr b d, a d + b c)
  void mul(const u64 a[4], const u64 b[4], const u64 c[4], const u64 d[4], u64 o0[4],
           u64 o1[4]) const {
    u64 ac[4], bd[4], ad[4], bc[4];
    mont_mul(f, a, c, ac);
    mont_mul(f, b, d, bd);
    mont_mul(f, a, d, ad);
    mont_mul(f, b, c, bc);
    mont_mul(f, bd, nr, bd);
    add_mod(f, ac, bd, o0);
    add_mod(f, ad, bc, o1);
  }
};

}  // namespace

extern "C" {

// Quadratic VDF (src/experiments/vdf.rs:12-131): row i + 1 is the square
// of row i. out0, out1: the c0 and c1 registers.
void hodor_vdf_witness(const u64* p_limbs, u64 inv, const u64* r2, const u64* nr_in,
                       const u64* c0_in, const u64* c1_in, long num_ops, u64* out0, u64* out1) {
  const Chain ch(p_limbs, inv, r2, nr_in);
  u64 v0[4], v1[4];
  ch.to_mont(c0_in, r2, v0);
  ch.to_mont(c1_in, r2, v1);
  ch.store(v0, out0);
  ch.store(v1, out1);
  for (long i = 1; i <= num_ops; ++i) {
    u64 n0[4], n1[4];
    ch.square(v0, v1, n0, n1);
    std::memcpy(v0, n0, 32);
    std::memcpy(v1, n1, 32);
    ch.store(v0, out0 + 4 * i);
    ch.store(v1, out1 + 4 * i);
  }
}

// Cubic VDF (src/experiments/cubic_vdf.rs:13-265): each row holds the
// element (c0, c1) and its square (sq0, sq1); the next element is their
// product.
void hodor_cubic_vdf_witness(const u64* p_limbs, u64 inv, const u64* r2, const u64* nr_in,
                             const u64* c0_in, const u64* c1_in, long num_ops, u64* out0,
                             u64* out1, u64* outs0, u64* outs1) {
  const Chain ch(p_limbs, inv, r2, nr_in);
  u64 v0[4], v1[4], s0[4], s1[4];
  ch.to_mont(c0_in, r2, v0);
  ch.to_mont(c1_in, r2, v1);
  for (long i = 0; i <= num_ops; ++i) {
    if (i > 0) {
      u64 n0[4], n1[4];
      ch.mul(s0, s1, v0, v1, n0, n1);
      std::memcpy(v0, n0, 32);
      std::memcpy(v1, n1, 32);
    }
    ch.square(v0, v1, s0, s1);
    ch.store(v0, out0 + 4 * i);
    ch.store(v1, out1 + 4 * i);
    ch.store(s0, outs0 + 4 * i);
    ch.store(s1, outs1 + 4 * i);
  }
}

// Poseidon chain (models/poseidon.py): Starknet's Hades permutation of
// width 3 (x^3, 4 full rounds, 83 partial, 4 full; MDS [[3,1,1],[1,-1,1],
// [1,1,-2]]), one round a row, permutation after permutation. Row r is
// round r mod 91: x = state + rc[round], a = x^3, k = rc[round], f = 1 in
// a full round. rc: 91 x 3 canonical constants; start: the 3 elements of
// the first state; out: the 10 registers (x0..x2, a0..a2, k0..k2, f), each
// num_ops + 1 rows of 4 words.
void hodor_poseidon_witness(const u64* p_limbs, u64 inv, const u64* r2, const u64* rc,
                            const u64* start, long num_ops, u64* out) {
  constexpr int kRounds = 91, kHalfFull = 4;
  Fp f;
  std::memcpy(f.p, p_limbs, 32);
  f.inv = inv;
  const long rows = num_ops + 1;
  const u64 one[4] = {1, 0, 0, 0}, zero[4] = {0, 0, 0, 0};
  u64 rc_m[kRounds][3][4], s[3][4];
  for (int r = 0; r < kRounds; ++r)
    for (int j = 0; j < 3; ++j) mont_mul(f, rc + 4 * (3 * r + j), r2, rc_m[r][j]);
  for (int j = 0; j < 3; ++j) mont_mul(f, start + 4 * j, r2, s[j]);
  auto reg = [&](int i, long row) { return out + 4 * (i * rows + row); };
  for (long row = 0; row < rows; ++row) {
    const int round = (int)(row % kRounds);
    const bool full = round < kHalfFull || round >= kRounds - kHalfFull;
    u64 x[3][4], a[3][4], y[3][4];
    for (int j = 0; j < 3; ++j) {
      add_mod(f, s[j], rc_m[round][j], x[j]);
      mont_mul(f, x[j], x[j], a[j]);
      mont_mul(f, a[j], x[j], a[j]);
      mont_mul(f, x[j], one, reg(j, row));
      mont_mul(f, a[j], one, reg(3 + j, row));
      std::memcpy(reg(6 + j, row), rc + 4 * (3 * round + j), 32);
      std::memcpy(y[j], (full || j == 2) ? a[j] : x[j], 32);
    }
    std::memcpy(reg(9, row), full ? one : zero, 32);
    u64 t[4];
    add_mod(f, y[0], y[2], t);            // y0 + y2
    sub_mod(f, t, y[1], s[1]);            // y0 - y1 + y2
    add_mod(f, t, y[1], s[0]);            // y0 + y1 + y2
    sub_mod(f, s[0], y[2], s[2]);
    sub_mod(f, s[2], y[2], s[2]);
    sub_mod(f, s[2], y[2], s[2]);         // y0 + y1 - 2 y2
    add_mod(f, s[0], y[0], s[0]);
    add_mod(f, s[0], y[0], s[0]);         // 3 y0 + y1 + y2
  }
}

}  // extern "C"
