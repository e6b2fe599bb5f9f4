"""The port's smaller public helpers against their hodor_tpu counterparts
on the same inputs, on CPU tensors: ntt.evaluate_at_domain_for_degree_one,
ntt.bit_reverse_indices, ntt.matmul.intt_matmul, field.ops_for,
merkle.blake2s.compress, utils.native.available, checkpoint.ProveCheckpoint.clear,
profiling.SpanRecorder.as_dict and LimbOps.assert_nonzero. Tolerance 0."""

import os
import random
import shutil

import jax
import numpy as np
import pytest
import torch

import hodor_tpu.checkpoint as jcheckpoint
import hodor_tpu.errors as jerrors
import hodor_tpu.field as jfield
import hodor_tpu.profiling as jprofiling
import hodor_tpu.merkle.blake2s as jblake2s
import hodor_tpu.ntt as jntt
import hodor_tpu.ntt.matmul as jmatmul
import hodor_tpu.utils.native as jnative
from hodor_tpu_torch.checkpoint import STAGES, ProveCheckpoint
from hodor_tpu_torch.domain import Domain
from hodor_tpu_torch.errors import DivisionByZeroError
from hodor_tpu_torch.field import F257, F_BLS, F_STARK, LimbOps, from_numpy_limbs, ops_for
from hodor_tpu_torch.field import to_numpy_limbs
from hodor_tpu_torch.merkle.blake2s import compress
from hodor_tpu_torch.ntt import bit_reverse_indices, evaluate_at_domain_for_degree_one
from hodor_tpu_torch.ntt.matmul import intt_matmul
from hodor_tpu_torch.profiling import Span, SpanRecorder
from hodor_tpu_torch.utils import native

torch.set_num_threads(1)


@pytest.mark.parametrize("coset", [True, False])
def test_degree_one_evaluation_over_the_domain_f257(coset):
    """tests/test_ntt.py:109-118: c0 + c1 x at the 16 points of the
    (coset) domain, against Python ints and hodor_tpu."""
    ops = LimbOps(F257, "cpu")
    dom = Domain.new_for_size(F257, 16)
    c0, c1 = 5, 7
    got = evaluate_at_domain_for_degree_one(ops, ops.const(c0), ops.const(c1), 16, coset=coset)
    vals = ops.decode(got)
    for i in range(16):
        x = (F257.generator if coset else 1) * pow(dom.generator, i, F257.p) % F257.p
        assert int(vals[i]) == (c0 + c1 * x) % F257.p
    jops = jfield.ops_for(jfield.F257)
    want = jax.jit(lambda a, b: jntt.evaluate_at_domain_for_degree_one(
        jops, a, b, 16, coset=coset))(jops.const(c0), jops.const(c1))
    assert np.array_equal(to_numpy_limbs(got), np.asarray(want))


def test_degree_one_evaluation_over_the_domain_f_stark_2_10():
    """Over F_STARK at 2^10 points of the coset, with random c0 and c1."""
    rng = random.Random(11)
    c0, c1 = rng.randrange(F_STARK.p), rng.randrange(F_STARK.p)
    ops = LimbOps(F_STARK, "cpu")
    got = evaluate_at_domain_for_degree_one(ops, ops.const(c0), ops.const(c1), 1 << 10,
                                            coset=True)
    jops = jfield.ops_for(jfield.F_STARK)
    want = jax.jit(lambda a, b: jntt.evaluate_at_domain_for_degree_one(
        jops, a, b, 1 << 10, coset=True))(jops.const(c0), jops.const(c1))
    assert np.array_equal(to_numpy_limbs(got), np.asarray(want))
    assert int(ops.decode(got[1])) == (c0 + c1 * F_STARK.generator
                                       * Domain.new_for_size(F_STARK, 1 << 10).generator) \
        % F_STARK.p


@pytest.mark.parametrize("log_n", [0, 1, 5, 10])
def test_bit_reverse_indices(log_n):
    got = bit_reverse_indices(log_n, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), jntt.bit_reverse_indices(log_n))


@pytest.mark.parametrize("name,n", [("F_STARK", 256), ("F_BLS", 32)])
def test_intt_matmul(name, n):
    """The inverse transform with its 1/N at radix 128 (two levels) and at
    F_BLS's radix 4 (an odd log size: 4, 4, 2), against hodor_tpu's."""
    field = {"F_STARK": F_STARK, "F_BLS": F_BLS}[name]
    jops = jfield.ops_for(getattr(jfield, name))
    rng = random.Random(12)
    x = jops.encode([[rng.randrange(field.p) for _ in range(n)] for _ in range(2)])
    want = np.asarray(jax.jit(lambda a: jmatmul.intt_matmul(jops, a))(x))
    got = intt_matmul(LimbOps(field, "cpu"), from_numpy_limbs(np.asarray(x), "cpu"))
    assert np.array_equal(to_numpy_limbs(got), want)


def test_ops_for_is_one_limbops_a_field_and_device():
    ops = ops_for(F_STARK, "cpu")
    assert ops is ops_for(F_STARK, torch.device("cpu"))
    assert ops.field == F_STARK and ops.device == torch.device("cpu")
    assert ops is not ops_for(F257, "cpu")
    jops = jfield.ops_for(jfield.F_STARK)
    for name in ("p_limbs", "one_m", "r2", "two_inv_m"):
        assert np.array_equal(to_numpy_limbs(getattr(ops, name)), np.asarray(getattr(jops, name)))
    rng = random.Random(13)
    xs = [rng.randrange(F_STARK.p) for _ in range(9)]
    prod = ops.mul(ops.encode(xs), ops.const(3))
    assert np.array_equal(to_numpy_limbs(prod), np.asarray(jops.jmul(jops.encode(xs),
                                                                       jops.const(3))))


def test_ops_for_raises_without_a_card():
    """The default device is the card: without one it raises, and never
    hands back CPU ops."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops_for(F_STARK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops_for(F_STARK, "cuda:0")


@pytest.mark.parametrize("t,final", [(64, False), (96, True), ((1 << 32) + 5, True)])
def test_blake2s_compress(t, final):
    """A batch of states and blocks (u32 words above 2^31 among them)
    against hodor_tpu's host loop on the same numpy words."""
    rng = np.random.default_rng(14)
    h = rng.integers(0, 1 << 32, (5, 8), dtype=np.uint64).astype(np.uint32)
    m = rng.integers(0, 1 << 32, (5, 16), dtype=np.uint64).astype(np.uint32)
    want = jblake2s.compress(h, m, t, final)
    got = compress(torch.from_numpy(h.view(np.int32)), torch.from_numpy(m.view(np.int32)), t,
                   final)
    assert got.dtype == torch.int32 and got.shape == (5, 8)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_native_available_matches_the_build():
    """The host library builds wherever g++ is, as hodor_tpu's does."""
    assert native.available() == (shutil.which("g++") is not None)
    assert native.available() == jnative.available()


def test_native_available_is_false_when_the_build_fails(monkeypatch):
    """A failed build: available() says so, and the chains still raise
    rather than stepping back to Python."""

    def no_compiler():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "build_host_library", no_compiler)
    native._lib.cache_clear()
    try:
        assert native.available() is False
        with pytest.raises(RuntimeError, match="g.. not found"):
            native.vdf_witness_native(F_STARK, 1, 2, 3)
    finally:
        native._lib.cache_clear()


def test_checkpoint_clear_empties_the_directory(tmp_path):
    """Both packages' clear() delete every saved stage of a directory
    either wrote, and nothing else in it."""
    for make, other in ((ProveCheckpoint, jcheckpoint.ProveCheckpoint),
                        (jcheckpoint.ProveCheckpoint, ProveCheckpoint)):
        ckdir = str(tmp_path / make.__module__)
        ck = make(ckdir)
        for stage in STAGES:
            ck.save(stage, {"a": np.arange(3, dtype=np.uint32)}, {"stage": stage})
        (tmp_path / make.__module__ / "keep.txt").write_text("kept")
        assert other(ckdir).completed_prefix() == list(STAGES)
        other(ckdir).clear()
        assert ck.completed_prefix() == [] and make(ckdir).completed_prefix() == []
        assert sorted(os.listdir(ckdir)) == ["keep.txt"]
        other(ckdir).clear()  # clearing an empty directory is no error


def test_stage_timer_as_dict():
    """Seconds by stage name, repeated names summed, as hodor_tpu's."""
    records = [("a", 0.5), ("b", 0.25), ("a", 1.0), ("c(resumed)", 0.125)]
    timer, jtimer = SpanRecorder("cpu"), jprofiling.StageTimer()
    timer.spans = [Span(n, 0, int(t * 1e9), stage=True) for n, t in records]
    jtimer.records = [jprofiling.StageRecord(n, t) for n, t in records]
    assert timer.as_dict() == jtimer.as_dict() == {"a": 1.5, "b": 0.25, "c(resumed)": 0.125}
    with timer.stage("d"):
        pass
    assert list(timer.as_dict()) == ["a", "b", "c(resumed)", "d"]
    assert SpanRecorder("cpu").as_dict() == {}


@pytest.mark.parametrize("field", [F257, F_STARK], ids=["F257", "F_STARK"])
def test_assert_nonzero(field):
    """Raises DivisionByZeroError on an array with a zero element, in
    Montgomery or canonical form, as hodor_tpu's; passes without one."""
    ops, jops = LimbOps(field, "cpu"), jfield.ops_for(getattr(jfield, field.name))
    rng = random.Random(3)
    vals = [rng.randrange(1, field.p) for _ in range(7)]
    for values, raises in ((vals, False), (vals[:3] + [0] + vals[3:], True), ([0], True)):
        enc = ops.encode(values)
        for arr in (enc, ops.from_mont_arr(enc)):
            if raises:
                with pytest.raises(DivisionByZeroError, match="zero element"):
                    ops.assert_nonzero(arr)
            else:
                ops.assert_nonzero(arr)
        if raises:
            with pytest.raises(jerrors.DivisionByZeroError):
                jops.assert_nonzero(jops.encode(values))
        else:
            jops.assert_nonzero(jops.encode(values))
