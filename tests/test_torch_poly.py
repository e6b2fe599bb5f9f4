"""The port's Polynomial (hodor_tpu_torch.poly) on CPU tensors: the
cases of tests/test_poly.py, and the results' limbs against
hodor_tpu.poly.Polynomial on the same inputs. Tolerance 0: the limbs are
canonical Montgomery forms.

hodor_tpu's Polynomial runs op by op, and on a fresh CPU worker each of
its transforms compiles for seconds; the 120-root product tree compiles
once per tree level. So the JAX references are taken in three jitted
programs (the transforms, the elementwise algebra, the 3-root tree), the
inverse and coset transforms are held to round trips and to the plain
transform of the shifted polynomial, and the 120-root tree's
coefficients to the product expanded on Python ints."""

import random
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from hodor_tpu.field import F257 as JF257, ops_for
from hodor_tpu.poly import Polynomial as JPolynomial
from hodor_tpu_torch.errors import DivisionByZeroError
from hodor_tpu_torch.field import F257, to_numpy_limbs
from hodor_tpu_torch.poly import COEFFICIENTS, VALUES, Polynomial

torch.set_num_threads(1)

random.seed(51)
FFT_COEFFS = [random.randrange(257) for _ in range(16)]
random.seed(52)
LDE_COEFFS = [random.randrange(257) for _ in range(8)]
random.seed(53)
A_INTS = [random.randrange(257) for _ in range(8)]
B_INTS = [random.randrange(257) for _ in range(8)]
ROOTS = [3, 7, 11]
OPS = ("mul", "add", "sub", "scale", "pow", "add_constant", "add_assign_scaled", "negate",
       "square", "distribute_powers", "batch_inversion")


def _elementwise(a, b, op):
    """One elementwise case on either package's Polynomial."""
    return {
        "mul": lambda: a.mul(b), "add": lambda: a.add(b), "sub": lambda: a.sub(b),
        "scale": lambda: a.scale(5), "pow": lambda: a.pow(3),
        "add_constant": lambda: a.add_constant(9),
        "add_assign_scaled": lambda: a.add_assign_scaled(b, 7), "negate": lambda: a.negate(),
        "square": lambda: a.square(), "distribute_powers": lambda: a.distribute_powers(3),
        "batch_inversion": lambda: a._new(a.ops.batch_inverse(a.data))
        if isinstance(a, Polynomial) else JPolynomial(a.ops.batch_inverse(a.data), a.form,
                                                      a.field),
    }[op]()


@lru_cache(maxsize=None)
def _jax():
    """The JAX package's limbs for every case, as numpy arrays."""
    ops = ops_for(JF257)

    @jax.jit
    def transforms(c16, c8):
        return (JPolynomial(c16, COEFFICIENTS, JF257).fft().data,
                JPolynomial(c8, COEFFICIENTS, JF257).lde(4).data)

    @jax.jit
    def elementwise(a, b):
        pa, pb = JPolynomial(a, VALUES, JF257), JPolynomial(b, VALUES, JF257)
        return [_elementwise(pa, pb, op).data for op in OPS]

    fft, lde4 = transforms(ops.encode(FFT_COEFFS), ops.encode(LDE_COEFFS))
    out = {"encoded": np.asarray(ops.encode(FFT_COEFFS)), "fft": np.asarray(fft),
           "lde4": np.asarray(lde4),
           "from_roots": np.asarray(jax.jit(lambda: JPolynomial.from_roots(JF257, ROOTS).data)())}
    out.update(zip(OPS, map(np.asarray, elementwise(ops.encode(A_INTS), ops.encode(B_INTS)))))
    return out


def _same(port, name):
    """The port's limbs (on the CPU) equal the JAX package's."""
    assert port.data.device.type == "cpu"
    assert np.array_equal(to_numpy_limbs(port.data), _jax()[name])


def test_fft_roundtrip_and_coset():
    p = Polynomial.from_coeffs(F257, FFT_COEFFS, device="cpu")
    _same(p, "encoded")
    _same(p.fft(), "fft")
    assert p.fft().ifft().as_ints() == FFT_COEFFS
    assert p.coset_fft().icoset_fft().as_ints() == FFT_COEFFS
    assert p.coset_fft().as_ints() == p.distribute_powers(F257.generator).fft().as_ints()


def test_lde_matches_fft_of_padded():
    p = Polynomial.from_coeffs(F257, LDE_COEFFS, device="cpu")
    wide = Polynomial.from_coeffs(F257, LDE_COEFFS + [0] * 24, device="cpu")
    assert p.lde(4).as_ints() == wide.fft().as_ints()
    _same(p.lde(4), "lde4")
    assert p.coset_lde(4).as_ints() == wide.distribute_powers(F257.generator).fft().as_ints()


def test_from_roots():
    p = Polynomial.from_roots(F257, ROOTS, device="cpu")
    assert p.form == COEFFICIENTS and p.size == 4
    _same(p, "from_roots")
    for r in ROOTS:
        assert p.evaluate_at(r) == 0
    assert p.evaluate_at(5) == (5 - 3) * (5 - 7) * (5 - 11) % 257


@pytest.mark.parametrize("op", OPS)
def test_elementwise_algebra(op):
    a = Polynomial.from_values(F257, A_INTS, device="cpu")
    b = Polynomial.from_values(F257, B_INTS, device="cpu")
    want = {
        "mul": [x * y % 257 for x, y in zip(A_INTS, B_INTS)],
        "add": [(x + y) % 257 for x, y in zip(A_INTS, B_INTS)],
        "sub": [(x - y) % 257 for x, y in zip(A_INTS, B_INTS)],
        "scale": [x * 5 % 257 for x in A_INTS],
        "pow": [pow(x, 3, 257) for x in A_INTS],
        "add_constant": [(x + 9) % 257 for x in A_INTS],
        "add_assign_scaled": [(x + 7 * y) % 257 for x, y in zip(A_INTS, B_INTS)],
        "negate": [(-x) % 257 for x in A_INTS],
        "square": [x * x % 257 for x in A_INTS],
        "distribute_powers": [x * pow(3, i, 257) % 257 for i, x in enumerate(A_INTS)],
        "batch_inversion": [pow(x, 255, 257) for x in A_INTS],
    }[op]
    got = a.batch_inversion() if op == "batch_inversion" else _elementwise(a, b, op)
    assert got.as_ints() == want
    assert got.form == VALUES
    _same(got, op)


def test_batch_inversion_rejects_zero():
    assert all(A_INTS)  # the elementwise operands invert
    with pytest.raises(DivisionByZeroError):  # a zero from the padding to 8
        Polynomial.from_values(F257, [1, 2, 3, 4, 5], device="cpu").batch_inversion()
    with pytest.raises(DivisionByZeroError):
        Polynomial.from_values(F257, [1, 0, 3, 4], device="cpu").batch_inversion()
def test_from_roots_product_tree_large():
    """The product tree at depth (120 roots): zero at every root, a direct
    product elsewhere, and the coefficients of the product expanded on
    Python ints."""
    random.seed(71)
    p = F257.p
    roots = [random.randrange(p) for _ in range(120)]
    poly = Polynomial.from_roots(F257, roots, device="cpu")
    assert poly.size == 128 and poly.form == COEFFICIENTS
    expanded = [1]
    for r in roots:  # times (X - r)
        expanded = [((expanded[i - 1] if i else 0) - r * (expanded[i] if i < len(expanded)
                                                          else 0)) % p
                    for i in range(len(expanded) + 1)]
    assert poly.as_ints() == expanded + [0] * (128 - len(expanded))
    for r in random.sample(roots, 5):
        assert poly.evaluate_at(r) == 0
    x = 123456789
    expect = 1
    for r in roots:
        expect = expect * (x - r) % p
    assert poly.evaluate_at(x) == expect


def test_constructors_default_to_the_card():
    """Without a device the data goes to the card; the tests ask for the
    CPU. Here, with no card, the default raises instead of stepping back."""
    if torch.cuda.is_available():
        assert Polynomial.from_values(F257, [1, 2]).data.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            Polynomial.from_values(F257, [1, 2])
    p = Polynomial.from_values(F257, [1, 2, 3], device="cpu")
    assert p.size == 4 and p.form == VALUES and p.domain.size == 4


def test_forms_and_sizes_are_checked():
    values = Polynomial.from_values(F257, [1, 2, 3, 4], device="cpu")
    coeffs = Polynomial.from_coeffs(F257, [1, 2, 3, 4], device="cpu")
    for call in (values.fft, values.coset_fft, lambda: values.lde(2), coeffs.ifft,
                 lambda: coeffs.mul(coeffs), lambda: coeffs.pow(2),
                 lambda: values.evaluate_at(1), lambda: values.add(coeffs),
                 lambda: values.add(Polynomial.from_values(F257, [1, 2], device="cpu"))):
        with pytest.raises(ValueError):
            call()
