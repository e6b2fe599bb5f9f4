"""The reference's negative-path and conformance cases, run against the
port (hodor_tpu_torch) on the CPU.

Negative cases (tests/test_verifier_negative.py, on hodor_tpu): a proof
made by the port's Prover (F257 Fibonacci, final_b=5, at_step=3, lde 16,
FRI to a constant) is tampered with - corrupt f paths, the g query's
index, a FRI query value, the final coefficients and roots, single bytes
of its serialization, truncation - and every tamper must be rejected,
by a False verdict or a SynthesisError. Each tampered proof is also
carried by its bytes to hodor_tpu's proof_io and Verifier: both packages
must give the same verdict.

Conformance cases (tests/test_conformance_vectors.py, docs/CONFORMANCE.md):
the hand-derived bytes of the keyed Blake2s, the leaf encoding, the
transcript's commit and first challenge, the shave mask, root to
challenge and a fold by hand over F257, on the port's host Blake2s (both
its hashlib form and the native library's), merkle tree, transcript and
fri_fold_plain. Every expectation is recomputed inline from Python ints
and hashlib.

No JAX prove runs here: the reference side only deserializes and
verifies on the host."""

import copy
import hashlib
import random
from functools import lru_cache

import pytest
import torch

import hodor_tpu.air as jair
import hodor_tpu.proof_io as jproof_io
from hodor_tpu.errors import SynthesisError as JSynthesisError
from hodor_tpu.field import F257 as JF257
from hodor_tpu.verifier import Verifier as JVerifier
import hodor_tpu_torch.air as tair
from hodor_tpu_torch.errors import SynthesisError
from hodor_tpu_torch.field import F257, F_STARK, LimbOps
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.fri.fri import fold_round
from hodor_tpu_torch.merkle import blake2s as tblake2s
from hodor_tpu_torch.merkle.tree import MerkleTree
from hodor_tpu_torch.proof_io import deserialize_proof, serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.transcript import Blake2sTranscript
from hodor_tpu_torch.utils import native
from hodor_tpu_torch.verifier import Verifier

torch.set_num_threads(1)

KEY = b"Squeamish Ossifrage"
PERSON = b"Shaftoe"
FUZZ_MUTATIONS = 30


def H(data: bytes = b"") -> bytes:
    return hashlib.blake2s(data, key=KEY, person=PERSON).digest()


def _fib(air, field):
    fib = air.Fibonacci(field, final_b=5, at_step=3)
    tracer = air.TestTraceSystem(field)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    return tracer.into_arp()


@lru_cache(maxsize=None)
def _proved():
    """(port proof, port props, hodor_tpu props): one CPU prove, shared."""
    witness, props = _fib(tair, F257)
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cpu")
    _, jprops = _fib(jair, JF257)
    return prover.prove(witness), props, jprops


def _port_verdict(proof) -> bool:
    _, props, _ = _proved()
    try:
        return Verifier(props, lde_factor=16).verify(proof)
    except SynthesisError:
        return False


def _verdicts(blob: bytes):
    """(port, hodor_tpu) verdicts on proof bytes: False where the bytes do
    not deserialize or the proof is rejected (a False verdict or a
    SynthesisError), as tests/test_verifier_negative.py counts them."""
    _, props, jprops = _proved()
    try:
        port = Verifier(props, lde_factor=16).verify(deserialize_proof(blob, F257))
    except SynthesisError:
        port = False
    try:
        ref = JVerifier(jprops, lde_factor=16).verify(jproof_io.deserialize_proof(blob, JF257))
    except JSynthesisError:
        ref = False
    return port, ref


def _f_path_first(p):
    p.f_queries[0].path[0] = bytes(32)


def _f_path_last(p):
    p.f_queries[0].path[-1] = b"\xff" * 32


def _g_query_index(p):
    p.g_query.index ^= 1


def _fri_query_value(p):
    q = p.fri_proof_h1.queries[0]
    q.value = (q.value + 1) % F257.p


def _fri_final_coefficients(p):
    p.fri_proof_h2.final_coefficients = [(c + 1) % F257.p
                                         for c in p.fri_proof_h2.final_coefficients]


def _f_root(p):
    p.f_iop_roots[0] = bytes(32)


def _h1_last_root(p):
    p.h1_iop_roots[-1] = bytes(32)


def _h2_last_root(p):
    p.h2_iop_roots[-1] = bytes(32)


TAMPERS = {f.__name__[1:]: f for f in (_f_path_first, _f_path_last, _g_query_index,
                                       _fri_query_value, _fri_final_coefficients, _f_root,
                                       _h1_last_root, _h2_last_root)}


def test_baseline_accepted_by_both():
    proof, _, _ = _proved()
    assert _port_verdict(proof)
    assert _verdicts(serialize_proof(proof, F257)) == (True, True)


@pytest.mark.parametrize("tamper", sorted(TAMPERS))
def test_tamper_rejected_by_both(tamper):
    """The reference's corrupt f paths (first and last sibling), g query
    index, FRI query value, final coefficients and roots (f, and the last
    h1 / h2 roots, which the transcript binds): the port rejects the
    tampered object, and both packages reject its bytes."""
    proof, _, _ = _proved()
    p2 = copy.deepcopy(proof)
    TAMPERS[tamper](p2)
    assert not _port_verdict(p2)
    blob = serialize_proof(p2, F257)
    assert blob != serialize_proof(proof, F257)
    assert _verdicts(blob) == (False, False)


@lru_cache(maxsize=None)
def _unchecked_spans():
    """Byte spans of the non-final h1/h2_iop_roots entries, which neither
    verifier reads (the reference's src/verifier/mod.rs:271, :305-310
    checks the FRI proofs' roots instead), located by diffing the port's
    serializations."""
    proof, _, _ = _proved()
    base = serialize_proof(proof, F257)
    spans = []
    for name in ("h1_iop_roots", "h2_iop_roots"):
        for i in range(len(getattr(proof, name)) - 1):
            p2 = copy.deepcopy(proof)
            getattr(p2, name)[i] = bytes(b ^ 0xFF for b in getattr(p2, name)[i])
            other = serialize_proof(p2, F257)
            diff = [k for k in range(len(base)) if base[k] != other[k]]
            spans.append(range(diff[0], diff[-1] + 1))
    return tuple(spans)


@lru_cache(maxsize=None)
def _mutations():
    """The reference's fuzz: 30 single-byte mutations (position, added
    value) from random.Random(99), past the magic and version and outside
    the unchecked spans."""
    proof, _, _ = _proved()
    size = len(serialize_proof(proof, F257))
    rng = random.Random(99)
    out = []
    while len(out) < FUZZ_MUTATIONS:
        pos = rng.randrange(8, size)
        if any(pos in s for s in _unchecked_spans()):
            continue
        out.append((pos, rng.randrange(1, 256)))
    return tuple(out)


@pytest.mark.parametrize("k", range(FUZZ_MUTATIONS))
def test_byte_mutation_rejected_by_both(k):
    proof, _, _ = _proved()
    blob = bytearray(serialize_proof(proof, F257))
    pos, add = _mutations()[k]
    blob[pos] = (blob[pos] + add) % 256
    assert _verdicts(bytes(blob)) == (False, False)


def test_unchecked_spans_accepted_by_both():
    """A flip inside the redundant roots changes the bytes but neither
    verdict: both verifiers skip the same spans."""
    proof, _, _ = _proved()
    blob = bytearray(serialize_proof(proof, F257))
    for span in _unchecked_spans():
        mutated = bytearray(blob)
        mutated[span[0]] ^= 0xFF
        assert _verdicts(bytes(mutated)) == (True, True)


@pytest.mark.parametrize("cut", ["10", "half", "all but one"])
def test_truncated_proof_rejected_by_both(cut):
    proof, _, _ = _proved()
    blob = serialize_proof(proof, F257)
    n = {"10": 10, "half": len(blob) // 2, "all but one": len(blob) - 1}[cut]
    with pytest.raises(SynthesisError):
        deserialize_proof(blob[:n], F257)
    with pytest.raises(JSynthesisError):
        jproof_io.deserialize_proof(blob[:n], JF257)


# ------------------------------------------------------ conformance vectors

@pytest.mark.parametrize("impl", ["hashlib", "native"])
def test_doc_s1_empty_digest(impl):
    keyed = tblake2s.blake2s_keyed if impl == "hashlib" else native.blake2s_keyed
    want = "a61dd261a9b23522c19ebdecc9b5755882c1b4f3940d3437029d99120ab1b437"
    assert H(b"").hex() == want
    assert keyed(b"").hex() == want
    assert keyed(b"conformance") == H(b"conformance")


def test_doc_s2_f257_montgomery_r_is_one():
    assert (1 << 64) % 257 == 1
    assert F257.to_mont(5) == 5


def test_doc_s2_leaf_encoding_f257():
    # raw Montgomery repr, LE, zero-padded to 32 bytes
    # (src/iop/blake2s_trivial_iop.rs:33-43)
    leaf5 = (5).to_bytes(8, "little") + b"\x00" * 24
    leaf6 = (6).to_bytes(8, "little") + b"\x00" * 24
    assert H(leaf5).hex() == "11e29fa14ed6f8adec507e5e97223adf2695ac98b61cd23824452614359e755f"
    assert F257.raw_repr_le(5) == leaf5[:8]
    ops = LimbOps(F257, "cpu")
    tree = MerkleTree.create(ops.encode([5, 6]), F257)
    assert tree.get_root() == H(H(leaf5) + H(leaf6))
    # the plain device hash of the two leaves is the same pair of digests
    digests = tblake2s.hash_leaf_limbs(ops.encode([5, 6]))
    assert [tblake2s.digest_to_bytes(d) for d in digests] == [H(leaf5), H(leaf6)]


def test_doc_s2_leaf_encoding_f_stark():
    p = F_STARK.p
    r_mod_p = (1 << 256) % p
    assert hex(r_mod_p) == "0x7fffffffffffdf0ffffffffffffffffffffffffffffffffffffffffffffffe1"
    assert F_STARK.raw_repr_le(1) == r_mod_p.to_bytes(32, "little")


def test_doc_s3_transcript_commit_is_canonical_be():
    # canonical repr, BE (src/transcript/mod.rs:49-57)
    t = Blake2sTranscript(F257)
    t.commit_field_element(5)
    expected = hashlib.blake2s((5).to_bytes(8, "big"), key=KEY, person=PERSON).digest()
    assert t.get_challenge() == expected[7]  # top-limb mask 0xFF keeps byte 7


def test_doc_s4_first_challenge_fresh_transcript():
    assert H(b"")[7] == 0x22
    assert Blake2sTranscript(F257).get_challenge() == 0x22


def test_doc_s4_shave_mask_f_stark():
    # NUM_BITS 252 -> CAPACITY 251 -> SHAVE_BITS 5 -> top-limb mask
    shave = 256 - (F_STARK.num_bits - 1)
    assert shave == 5
    mask = 0xFFFFFFFFFFFFFFFF >> (shave % 64)
    assert mask == 0x07FFFFFFFFFFFFFF
    d = H(b"conformance")
    val = int.from_bytes(d, "big")
    expected = (val & ((1 << 192) - 1)) | (((val >> 192) & mask) << 192)
    if expected < F_STARK.p:
        assert F_STARK.from_be_with_shave(d) == expected
    # the device form of the same mapping, on the digest's words
    ops = LimbOps(F_STARK, "cpu")
    words = torch.tensor(list(memoryview(d).cast("i")), dtype=torch.int32)
    got = tblake2s.digest_to_challenge_mont(ops, words)
    assert ops.decode(got[None])[0] == F_STARK.from_be_with_shave(d)


def test_doc_s6_root_to_challenge():
    ops = LimbOps(F257, "cpu")
    tree = MerkleTree.create(ops.encode([5, 6]), F257)
    assert tree.get_challenge_scalar_from_root() == tree.get_root()[7]


def test_doc_s7_fri_fold_by_hand_f257():
    # N=2 fold in F257: next[0] = (v0+v1 + c*(v0-v1)) * inv(2); with
    # v=[3,7], c=5 -> 252 (docs/CONFORMANCE.md §7)
    assert (10 + 5 * (3 - 7)) * pow(2, -1, 257) % 257 == 252
    ops = LimbOps(F257, "cpu")
    values = ops.encode([3, 7])
    challenge = ops.encode([5])[0]
    # a root whose first 8 bytes read big-endian and shaved to F257's 8
    # bits give 5: byte 7, the top byte of word 1
    root = torch.tensor([0, 5 << 24, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    assert F257.from_be_with_shave(root.numpy().astype("<i4").tobytes()) == 5
    out = fold_round(ops, values, root, 1, 1)  # w^0 = 1
    assert int(ops.decode(out)[0]) == 252
    c_scaled = ops.mul(challenge, ops.two_inv_m)
    plain = K.fri_fold_plain(F257, values[:1], values[1:], ops.encode([1]), c_scaled,
                             ops.two_inv_m)
    assert int(ops.decode(plain)[0]) == 252
