// Native host Blake2s + Merkle helpers.
//
// The reference hashes Merkle leaves/nodes on a crossbeam thread pool
// (src/iop/blake2s_trivial_iop.rs:147-219). In this framework the
// prover hashes on-device; the HOST side (verifier path checks,
// transcript replay, proof (de)serialization) uses this C extension so
// scalar verification does not bottleneck on Python hashlib dispatch.
// Exposed via ctypes (no pybind11 in the image).
//
// A copy of native/blake2s.cpp. The port builds it with g++ (without
// -fopenmp, so the loops below run on one thread) into its host library
// beside vdf_witness.cpp: hodor_tpu_torch/utils/native.py.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

constexpr uint8_t SIGMA[10][16] = {
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

inline uint32_t rotr(uint32_t x, int r) { return (x >> r) | (x << (32 - r)); }

inline void g(uint32_t v[16], int a, int b, int c, int d, uint32_t x, uint32_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 12);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr(v[d] ^ v[a], 8);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 7);
}

void compress(uint32_t h[8], const uint8_t block[64], uint64_t t, bool final) {
  uint32_t m[16];
  std::memcpy(m, block, 64);
  uint32_t v[16];
  for (int i = 0; i < 8; i++) v[i] = h[i];
  for (int i = 0; i < 8; i++) v[8 + i] = IV[i];
  v[12] ^= (uint32_t)(t & 0xFFFFFFFFu);
  v[13] ^= (uint32_t)(t >> 32);
  if (final) v[14] ^= 0xFFFFFFFFu;
  for (int r = 0; r < 10; r++) {
    const uint8_t* s = SIGMA[r];
    g(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    g(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    g(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    g(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    g(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    g(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    g(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    g(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

struct KeyedState {
  uint32_t h[8];
};

// state after absorbing the padded key block for our fixed params
// (digest 32, key, fanout 1, depth 1, personal)
KeyedState keyed_midstate(const uint8_t* key, int key_len, const uint8_t* personal,
                          int personal_len) {
  uint8_t param[32] = {0};
  param[0] = 32;                       // digest_length
  param[1] = (uint8_t)key_len;         // key_length
  param[2] = 1;                        // fanout
  param[3] = 1;                        // depth
  for (int i = 0; i < personal_len && i < 8; i++) param[24 + i] = personal[i];
  KeyedState st;
  for (int i = 0; i < 8; i++) {
    uint32_t w;
    std::memcpy(&w, param + 4 * i, 4);
    st.h[i] = IV[i] ^ w;
  }
  uint8_t key_block[64] = {0};
  std::memcpy(key_block, key, key_len);
  compress(st.h, key_block, 64, false);
  return st;
}

const uint8_t KEY[] = "Squeamish Ossifrage";
const uint8_t PERSONAL[] = "Shaftoe";

KeyedState& midstate() {
  static KeyedState st = keyed_midstate(KEY, 19, PERSONAL, 7);
  return st;
}

// keyed hash of a message that fits in whole blocks <= 64 bytes each
void keyed_hash(const uint8_t* msg, int len, uint8_t out[32]) {
  if (len == 0) {
    // empty message: the padded key block itself is the final block
    uint8_t param[32] = {0};
    param[0] = 32;
    param[1] = 19;
    param[2] = 1;
    param[3] = 1;
    std::memcpy(param + 24, PERSONAL, 7);
    uint32_t h[8];
    for (int i = 0; i < 8; i++) {
      uint32_t w;
      std::memcpy(&w, param + 4 * i, 4);
      h[i] = IV[i] ^ w;
    }
    uint8_t key_block[64] = {0};
    std::memcpy(key_block, KEY, 19);
    compress(h, key_block, 64, true);
    std::memcpy(out, h, 32);
    return;
  }
  KeyedState st = midstate();
  uint64_t t = 64;
  while (len > 64) {
    t += 64;
    compress(st.h, msg, t, false);
    msg += 64;
    len -= 64;
  }
  uint8_t block[64] = {0};
  std::memcpy(block, msg, len);
  t += len;
  compress(st.h, block, t, true);
  std::memcpy(out, st.h, 32);
}

}  // namespace

extern "C" {

// Keyed Blake2s with the protocol's key/personalization.
void hodor_blake2s(const uint8_t* msg, int len, uint8_t* out32) {
  keyed_hash(msg, len, out32);
}

// Hash n 32-byte leaves (raw Montgomery LE reprs) into 32-byte digests.
void hodor_hash_leaves(const uint8_t* leaves, long n, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) {
    keyed_hash(leaves + 32 * i, 32, out + 32 * i);
  }
}

// One Merkle level: out[i] = H(in[2i] || in[2i+1]), n = number of parents.
void hodor_hash_level(const uint8_t* children, long n, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) {
    keyed_hash(children + 64 * i, 64, out + 32 * i);
  }
}

// Verify a Merkle path (reference Blake2sIopTree::verify,
// src/iop/blake2s_trivial_iop.rs:259-279). Returns 1 if valid.
int hodor_verify_path(const uint8_t* leaf32, const uint8_t* path, int path_len,
                      long tree_index, const uint8_t* root32) {
  uint8_t hash[32];
  keyed_hash(leaf32, 32, hash);
  uint8_t block[64];
  long idx = tree_index;
  for (int lvl = 0; lvl < path_len; lvl++) {
    const uint8_t* sibling = path + 32 * lvl;
    if ((idx & 1) == 0) {
      std::memcpy(block, hash, 32);
      std::memcpy(block + 32, sibling, 32);
    } else {
      std::memcpy(block, sibling, 32);
      std::memcpy(block + 32, hash, 32);
    }
    keyed_hash(block, 64, hash);
    idx >>= 1;
  }
  return std::memcmp(hash, root32, 32) == 0 ? 1 : 0;
}

// Build a full Merkle tree: leaves (n x 32B) -> nodes array (n x 32B,
// heap layout: nodes[1] = root) plus leaf hashes (n x 32B).
void hodor_build_tree(const uint8_t* leaves, long n, uint8_t* leaf_hashes,
                      uint8_t* nodes) {
  hodor_hash_leaves(leaves, n, leaf_hashes);
  // bottom internal level: nodes[n/2 + i] = H(leaf_hashes[2i] || [2i+1])
  hodor_hash_level(leaf_hashes, n / 2, nodes + 32 * (n / 2));
  for (long level = n / 4; level >= 1; level /= 2) {
    hodor_hash_level(nodes + 32 * (2 * level), level, nodes + 32 * level);
  }
}

}  // extern "C"
