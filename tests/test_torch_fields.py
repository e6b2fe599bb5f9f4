"""The port over the two fields off F_STARK and F257, on CPU tensors:
F_BLS (the BLS12-381 scalar field, 255 bits, 16 limbs, R/p = 2.21) and
F_P63 (a 63-bit prime in 4 limbs, R/p = 2.00). For both, max_radix is 4,
so an NTT's radix plan is radix-4 levels (radix 2 last at odd log sizes),
where hodor_tpu runs Pease levels; F_BLS's transforms from 2^8 points run
the shared-body passes of the 16-limb fields instead.

- Field arithmetic over all four fields against Python ints
  (tests/test_field.py).
- The radix-4 NTT bit-equal to hodor_tpu's Pease schedule, forward and
  inverse (tests/test_ntt.py:120-140), and the LDE at factor 8 and 16
  equal to the scalar oracle's.
- Quadratic-VDF proofs at 32 rows (F_BLS at lde 16; F_P63 at lde 8 with
  FRI to a constant and to degree 4): bytes and challenge log equal to the
  scalar oracle's, accepted by both packages' verifiers; a proof of a
  tampered witness rejected by both.
- prove_batch of two F_P63 lanes equal to the two single proves.
- The three NTT level forms agree over F_BLS at 2^10.

Tolerance 0 throughout: limbs, proof bytes and challenge logs compared
whole."""

import os
import random
import sys
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

import hodor_tpu.field as jfield
import hodor_tpu.proof_io as jproof_io
from hodor_tpu.models import VDF as JVDF
from hodor_tpu.ntt import _ntt_pease
from hodor_tpu.verifier import Verifier as JVerifier
from hodor_tpu_torch.field import F257, F_BLS, F_P63, F_STARK, LimbOps, from_numpy_limbs
from hodor_tpu_torch.field import to_numpy_limbs
from hodor_tpu_torch.models import VDF
from hodor_tpu_torch.ntt import intt, lde, ntt
from hodor_tpu_torch.ntt import matmul as M
from hodor_tpu_torch.ntt.matmul import max_radix
from hodor_tpu_torch.proof_io import deserialize_proof, serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.verifier import Verifier

sys.path.insert(0, os.path.dirname(__file__))
import scalar_oracle as so  # noqa: E402

torch.set_num_threads(1)

FIELDS = {"F257": F257, "F_STARK": F_STARK, "F_BLS": F_BLS, "F_P63": F_P63}
NEW_FIELDS = ["F_BLS", "F_P63"]


def _oracle_field(field):
    return so.OField(field.p, field.generator)


# ------------------------------------------------------ field arithmetic

@pytest.mark.parametrize("name", list(FIELDS))
def test_arithmetic_against_python_ints(name):
    field = FIELDS[name]
    random.seed(42)
    ops = LimbOps(field, "cpu")
    xs = [random.randrange(field.p) for _ in range(128)]
    ys = [random.randrange(field.p) for _ in range(128)]
    a, b = ops.encode(xs), ops.encode(ys)
    mul, add, sub = ops.decode(ops.mul(a, b)), ops.decode(ops.add(a, b)), ops.decode(ops.sub(a, b))
    for i in range(128):
        assert mul[i] == xs[i] * ys[i] % field.p
        assert add[i] == (xs[i] + ys[i]) % field.p
        assert sub[i] == (xs[i] - ys[i]) % field.p


@pytest.mark.parametrize("name", list(FIELDS))
def test_edge_values(name):
    """0, 1, p - 1, p - 2 and p / 2: the carries out of the top word."""
    field = FIELDS[name]
    ops = LimbOps(field, "cpu")
    edge = [0, 1, field.p - 1, field.p - 2, field.p // 2]
    a = ops.encode(edge)
    sq, neg = ops.decode(ops.mul(a, a)), ops.decode(ops.neg(a))
    dbl = ops.decode(ops.add(a, a))
    for i, x in enumerate(edge):
        assert sq[i] == x * x % field.p
        assert neg[i] == (-x) % field.p
        assert dbl[i] == 2 * x % field.p


@pytest.mark.parametrize("name", list(FIELDS))
def test_batch_inverse(name):
    """Every power-of-two size up to 256, as the reference
    (src/polynomials/mod.rs:958-985), and one ragged size."""
    field = FIELDS[name]
    random.seed(7)
    ops = LimbOps(field, "cpu")
    for size in (1, 2, 4, 64, 256, 37):
        xs = [random.randrange(1, field.p) for _ in range(size)]
        inv = ops.decode(ops.batch_inverse(ops.encode(xs)))
        for i in range(size):
            assert inv[i] * xs[i] % field.p == 1


@pytest.mark.parametrize("name", list(FIELDS))
def test_two_adicity_and_root(name):
    """src/experiments/mod.rs:23-51."""
    field = FIELDS[name]
    p, s = field.p, field.S
    assert pow(field.root_of_unity, 1 << s, p) == 1
    assert pow(field.root_of_unity, 1 << (s - 1), p) != 1
    assert pow(field.generator, (p - 1) // 2, p) != 1


# ------------------------------------------------------------------ NTT

@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("name", NEW_FIELDS)
def test_radix4_ntt_equals_hodor_tpu_pease(name, inverse, monkeypatch):
    """n = 512 = 2^9, an odd log size: levels of radix 4, 4, 4, 4 and 2
    (F_BLS: its shared-body pass, and the radix levels forced)."""
    field = FIELDS[name]
    assert max_radix(field) == 4
    random.seed(61)
    jops = jfield.ops_for(getattr(jfield, name))
    a = jops.encode([random.randrange(field.p) for _ in range(512)])
    want = np.asarray(_ntt_pease(jops, a, 9, inverse))
    got = ntt(LimbOps(field, "cpu"), from_numpy_limbs(np.asarray(a), "cpu"), inverse)
    assert np.array_equal(to_numpy_limbs(got), want)
    monkeypatch.setattr(M, "SHARED_MIN_POINTS", 1 << 30)
    got = ntt(LimbOps(field, "cpu"), from_numpy_limbs(np.asarray(a), "cpu"), inverse)
    assert np.array_equal(to_numpy_limbs(got), want)


@pytest.mark.parametrize("factor", [8, 16])
@pytest.mark.parametrize("name", NEW_FIELDS)
def test_lde_equals_the_oracle(name, factor):
    """32 coefficients (levels 4, 4, 2) blown up by `factor`, on the plain
    and on the coset domain, and the inverse transform back."""
    field = FIELDS[name]
    ofield = _oracle_field(field)
    random.seed(62)
    coeffs = [random.randrange(field.p) for _ in range(32)]
    ops = LimbOps(field, "cpu")
    x = ops.encode(coeffs)
    for coset in (False, True):
        got = lde(ops, x, factor, coset=coset)
        assert list(ops.decode(got)) == so.lde(coeffs, factor, ofield, coset=coset)
    assert list(ops.decode(intt(ops, ntt(ops, x)))) == coeffs


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_level_forms_agree_over_f_bls(inverse):
    """"level" (one shared-body pass), "two_step" and "fused" (five
    radix-4 levels) at n = 2^10 over two rows: on the card the last two
    run wide_reduce and the __dp4a body of dft_reduce at S = 4."""
    rng = np.random.default_rng(63)
    limbs = rng.integers(0, 1 << 16, size=(2, 1 << 10, F_BLS.n16), dtype=np.uint32)
    limbs[..., -1] &= (1 << (F_BLS.num_bits - 1 - 16 * (F_BLS.n16 - 1))) - 1
    x = from_numpy_limbs(limbs, "cpu")
    outs = [ntt(LimbOps(F_BLS, "cpu", impl), x, inverse) for impl in ("level", "two_step", "fused")]
    assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0])


# --------------------------------------------------------------- proofs

# name -> (field name, lde factor, FRI final degree + 1)
PROOF_CASES = {
    "f_bls_lde16": ("F_BLS", 16, 1),
    "f_p63_lde8": ("F_P63", 8, 1),
    "f_p63_lde8_fri_degree_4": ("F_P63", 8, 4),
}
ROWS = 32


@lru_cache(maxsize=None)
def _port_proofs(name):
    """The port's proof of the 32-row VDF from (1, 2) and of the same
    witness with c0[9] changed, one Prover for both: (bytes, challenge
    log, tampered bytes)."""
    field_name, lde_factor, fri = PROOF_CASES[name]
    field = FIELDS[field_name]
    witness, props = VDF(field, 1, 2, ROWS - 1, witness="python").into_arp()
    prover = Prover(props.clone(), lde_factor=lde_factor, fri_final_degree_plus_one=fri,
                    device="cpu")
    blob = serialize_proof(prover.prove(witness), field)
    log = [(k, v if isinstance(v, str) else str(v)) for k, v in prover.last_transcript.log]
    witness[0][9] = (witness[0][9] + 1) % field.p
    return blob, log, serialize_proof(prover.prove(witness), field)


@lru_cache(maxsize=None)
def _oracle_proof(name):
    field_name, lde_factor, fri = PROOF_CASES[name]
    ofield = _oracle_field(FIELDS[field_name])
    witness, props = so.vdf_instance(ofield, 1, 2, ROWS - 1)
    proof, log = so.prove(ofield, witness, props, lde_factor=lde_factor,
                          fri_final_degree_plus_one=fri)
    return so.serialize(proof, ofield), log


def _verifiers(name):
    field_name, lde_factor, _ = PROOF_CASES[name]
    field, jf = FIELDS[field_name], getattr(jfield, field_name)
    _, props = VDF(field, 1, 2, ROWS - 1, witness="python").into_arp()
    _, jprops = JVDF(jf, 1, 2, ROWS - 1).into_arp()
    return ((Verifier(props, lde_factor=lde_factor), field),
            (JVerifier(jprops, lde_factor=lde_factor), jf))


@pytest.mark.parametrize("name", list(PROOF_CASES))
def test_proof_bytes_equal_the_oracle(name):
    assert _port_proofs(name)[0] == _oracle_proof(name)[0]


@pytest.mark.parametrize("name", list(PROOF_CASES))
def test_challenge_log_equals_the_oracle(name):
    assert _port_proofs(name)[1] == _oracle_proof(name)[1]


@pytest.mark.parametrize("name", list(PROOF_CASES))
def test_both_verifiers_accept_the_port_proof(name):
    blob = _port_proofs(name)[0]
    (verifier, field), (jverifier, jf) = _verifiers(name)
    assert verifier.verify(deserialize_proof(blob, field))
    assert jverifier.verify(jproof_io.deserialize_proof(blob, jf))
    if PROOF_CASES[name][2] > 1:
        proof = deserialize_proof(blob, field)
        assert len(proof.fri_proof_h1.final_coefficients) == PROOF_CASES[name][2]


@pytest.mark.parametrize("name", list(PROOF_CASES))
def test_both_verifiers_reject_a_proof_of_a_tampered_witness(name):
    blob = _port_proofs(name)[2]
    (verifier, field), (jverifier, jf) = _verifiers(name)
    assert not verifier.verify(deserialize_proof(blob, field))
    assert not jverifier.verify(jproof_io.deserialize_proof(blob, jf))


def test_prove_batch_f_p63_equals_single_proves():
    """tests/test_batch.py:95-111 without its mesh: two lanes, the starts
    (1, 2) and (3, 5) under one instance, each lane byte-equal to its own
    prove; the first lane is the oracle's proof."""
    witness0, props = VDF(F_P63, 1, 2, ROWS - 1, witness="python").into_arp()
    witness1, _ = VDF(F_P63, 3, 5, ROWS - 1, witness="python").into_arp()
    prover = Prover(props.clone(), lde_factor=8, fri_final_degree_plus_one=1, device="cpu")
    singles = [serialize_proof(prover.prove(w), F_P63) for w in (witness0, witness1)]
    batch = [serialize_proof(p, F_P63) for p in prover.prove_batch([witness0, witness1])]
    assert batch == singles and batch[0] != batch[1]
    assert batch[0] == _oracle_proof("f_p63_lde8")[0]
