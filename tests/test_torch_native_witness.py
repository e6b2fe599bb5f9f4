"""The port's native witness chains (hodor_tpu_torch/utils/native.py over
csrc/host/vdf_witness.cpp, compiled here with g++) and the packed witness
path into ARPInstance.encode_witness, on CPU tensors: against the Python
chains limb for limb, against the JAX package's native arrays byte for
byte, against its encode_witness through to_numpy_limbs, and the goldens
from the native witness. Tolerance 0 everywhere (canonical values)."""

import json
import os

import numpy as np
import pytest
import torch

import hodor_tpu.utils.native as jnative
from hodor_tpu.arp import ARPInstance as JARPInstance
from hodor_tpu.field import F257 as JF257, F_BLS as JF_BLS, F_STARK as JF_STARK
from hodor_tpu.models import VDF as JVDF
from hodor_tpu_torch.arp import ARPInstance
from hodor_tpu_torch.errors import UnsatisfiedError
from hodor_tpu_torch.field import F257, F_BLS, F_STARK, Field, LimbOps, to_numpy_limbs
from hodor_tpu_torch.field.limbs import is_u64_rows, pack_ints, u64_rows_to_limbs
from hodor_tpu_torch.models import VDF, CubicVDF
from hodor_tpu_torch.models.vdf import _NATIVE_MIN_OPS, use_native_witness
from hodor_tpu_torch.proof_io import serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.utils import native
from hodor_tpu_torch.verifier import Verifier

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIELDS = {"F257": (F257, JF257), "F_STARK": (F_STARK, JF_STARK), "F_BLS": (F_BLS, JF_BLS)}
MODELS = {"quadratic": (VDF, (1, 2)), "cubic": (CubicVDF, (1, 1))}


def _both_forms(model, field, start, num_ops):
    lists, props_l = model(field, *start, num_ops, witness="python").into_arp()
    packed, props_n = model(field, *start, num_ops, witness="native").into_arp()
    assert isinstance(lists, list) and is_u64_rows(packed)
    return lists, props_l, packed, props_n


@pytest.mark.parametrize("name", ["F257", "F_STARK", "F_BLS"])
def test_quadratic_native_chain_matches_python_and_jax(name):
    field, jfield = FIELDS[name]
    num_ops = 300
    lists, props_l, packed, props_n = _both_forms(VDF, field, (3, 5), num_ops)
    assert packed.shape == (2, num_ops + 1, 4) and packed.dtype == np.uint64
    for reg in range(2):
        assert native.u64_rows_to_ints(packed[reg]) == lists[reg]
        assert np.array_equal(u64_rows_to_limbs(packed[reg], field.n16).astype(np.uint32),
                              pack_ints(lists[reg], field.n16))
    assert [b.value for b in props_n.boundary_constraints] == \
        [b.value for b in props_l.boundary_constraints]
    theirs = jnative.vdf_witness_native(jfield, 3, 5, num_ops)
    assert theirs is not None
    assert np.stack(theirs).tobytes() == packed.tobytes()


@pytest.mark.parametrize("name", ["F257", "F_STARK"])
def test_cubic_native_chain_matches_python_and_jax(name):
    field, jfield = FIELDS[name]
    num_ops = 200
    lists, props_l, packed, props_n = _both_forms(CubicVDF, field, (2, 7), num_ops)
    assert packed.shape == (4, num_ops + 1, 4)
    for reg in range(4):
        assert native.u64_rows_to_ints(packed[reg]) == lists[reg]
    assert [b.value for b in props_n.boundary_constraints] == \
        [b.value for b in props_l.boundary_constraints]
    theirs = jnative.cubic_vdf_witness_native(jfield, 2, 7, num_ops)
    assert theirs is not None
    assert np.stack(theirs).tobytes() == packed.tobytes()


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_encode_witness_packed_equals_lists_and_jax(kind):
    """99 and 100 operations: 100 rows are no power of two, 101 neither;
    the padding rows are zero in both forms."""
    model, start = MODELS[kind]
    ops = LimbOps(F_STARK, "cpu")
    for num_ops in (99, 100):
        lists, props_l, packed, props_n = _both_forms(model, F_STARK, start, num_ops)
        from_lists = ARPInstance.from_instance(props_l.clone(), ops).encode_witness(lists)
        from_packed = ARPInstance.from_instance(props_n.clone(), ops).encode_witness(packed)
        assert from_packed.dtype == torch.int32 and from_packed.shape == (len(lists), 128, 16)
        assert torch.equal(from_packed, from_lists)
        assert not bool(from_packed[:, num_ops + 1:].any())
    # the JAX package's encode_witness on the same packed array (its quadratic instance
    # routes the same number of rows; only num_rows is read)
    _, jprops = JVDF(JF_STARK, 1, 2, num_ops).into_arp()
    theirs = np.asarray(JARPInstance.from_instance(jprops).encode_witness(packed))
    assert np.array_equal(to_numpy_limbs(from_packed), theirs)


def test_encode_witness_packed_small_field():
    ops = LimbOps(F257, "cpu")
    lists, props_l, packed, props_n = _both_forms(VDF, F257, (3, 5), 50)
    a = ARPInstance.from_instance(props_l.clone(), ops).encode_witness(lists)
    b = ARPInstance.from_instance(props_n.clone(), ops).encode_witness(packed)
    assert b.shape == (2, 64, 4) and torch.equal(a, b)
    too_wide = packed.copy()
    too_wide[0, 3, 1] = 1  # a value of 2^64 does not fit the field's four limbs
    with pytest.raises(ValueError):
        ARPInstance.from_instance(props_n.clone(), ops).encode_witness(too_wide)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_is_satisfied_on_the_packed_witness(kind):
    model, start = MODELS[kind]
    ops = LimbOps(F_STARK, "cpu")
    packed, props = model(F_STARK, *start, 45, witness="native").into_arp()
    ARPInstance.is_satisfied(props, packed, ops)
    bad = packed.copy()
    bad[1, 17, 0] ^= 1
    with pytest.raises(UnsatisfiedError, match="row 1[67]"):
        ARPInstance.is_satisfied(props, bad, ops)
    bad = packed.copy()
    bad[0, 45, 2] ^= 1  # the last row: only the boundary constraint reads it
    with pytest.raises(UnsatisfiedError):
        ARPInstance.is_satisfied(props, bad, ops)


@pytest.mark.parametrize("name", ["vdf_fstark_t32", "cubic_vdf_fstark_t32"])
def test_goldens_from_the_native_witness(name):
    model, start = MODELS["quadratic" if name.startswith("vdf") else "cubic"]
    witness, props = model(F_STARK, *start, 31, witness="native").into_arp()
    assert is_u64_rows(witness)
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cpu")
    proof = prover.prove(witness)
    assert Verifier(props, lde_factor=16).verify(proof)
    with open(os.path.join(GOLDEN, f"{name}.proof"), "rb") as f:
        assert serialize_proof(proof, F_STARK) == f.read()
    with open(os.path.join(GOLDEN, f"{name}.challenges.json")) as f:
        expected = [tuple(e) for e in json.load(f)]
    assert [(k, v if isinstance(v, str) else str(v))
            for k, v in prover.last_transcript.log] == expected


def test_witness_form_is_an_argument():
    assert not use_native_witness("auto", _NATIVE_MIN_OPS - 1)
    assert use_native_witness("auto", _NATIVE_MIN_OPS)
    assert use_native_witness("native", 1) and not use_native_witness("python", 1 << 20)
    assert VDF(F_STARK, 1, 2, 31).native is False
    assert CubicVDF(F_STARK, 1, 1, _NATIVE_MIN_OPS).native is True
    with pytest.raises(ValueError):
        VDF(F_STARK, 1, 2, 31, witness="fast")
    witness, _ = VDF(F_STARK, 1, 2, _NATIVE_MIN_OPS).into_arp()
    assert is_u64_rows(witness) and witness.shape == (2, _NATIVE_MIN_OPS + 1, 4)


def test_native_chain_refuses_what_it_cannot_take():
    wide = Field(p=(1 << 300) + 157, generator=3, name="wide")
    with pytest.raises(ValueError):
        native.vdf_witness_native(wide, 1, 2, 10)
    with pytest.raises(ValueError):
        CubicVDF(wide, 1, 1, 10, witness="native").into_arp()
    even = Field(p=1 << 61, generator=3, name="even")
    with pytest.raises(ValueError):
        native.cubic_vdf_witness_native(even, 1, 1, 10)
    # the Python chain has no such limit
    lists, _ = VDF(wide, 1, 2, 10, witness="python").into_arp()
    assert len(lists[0]) == 11


def test_failed_build_raises(monkeypatch, tmp_path):
    """No compiler, or a source that does not compile: an error, not a
    quiet step back to the Python chain."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native.build_host_library()
    monkeypatch.undo()
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "HOST_SRC", str(broken))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        native.build_host_library()
