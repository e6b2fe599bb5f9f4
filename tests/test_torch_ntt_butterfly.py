"""The arithmetic of the butterfly body of ntt_level on CPU tensors.

`ntt_level_butterfly_plain` (radix-2 decimation-in-frequency stages on
canonical values, the roots read from row 1 of the DFT matrix, the
outputs from their bit-reversed places) against the schoolbook level
`ntt_level_plain` over F_STARK, F_BLS, F_P63 and F257, at S = 2, 4, 8, 16,
both directions, every twiddle mode, random and all-(p - 1) inputs; and
whole NTTs over F_BLS and F_P63 assembled from butterfly-plain levels
against hodor_tpu's Pease schedule (as tests/test_torch_fields.py holds
the radix-4 schedule). Inputs from numpy seeds; tolerance 0: every output
is a canonical limb array.
"""

import random

import numpy as np
import pytest
import torch

import hodor_tpu.field as jfield
from hodor_tpu.ntt import _ntt_pease
from hodor_tpu_torch.field import F257, F_BLS, F_P63, F_STARK, LimbOps, from_numpy_limbs
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.field import to_numpy_limbs
from hodor_tpu_torch.ntt import ntt
from hodor_tpu_torch.ntt import matmul as M
from hodor_tpu_torch.ntt.matmul import dft_matrix, max_radix

torch.set_num_threads(1)

FIELDS = {"F_STARK": F_STARK, "F_BLS": F_BLS, "F_P63": F_P63, "F257": F257}


def _limbs(field, rng, shape):
    """Seeded canonical limbs: uniform below p for a one-limb prime, else
    uniform limbs with the top one cut below p's top bit."""
    if field.num_bits <= 16:
        limbs = np.zeros(shape + (field.n16,), dtype=np.uint32)
        limbs[..., 0] = rng.integers(0, field.p, size=shape)
    else:
        limbs = rng.integers(0, 1 << 16, size=shape + (field.n16,), dtype=np.uint32)
        limbs[..., -1] &= (1 << (field.num_bits - 1 - 16 * (field.n16 - 1))) - 1
    return from_numpy_limbs(limbs, "cpu")


def _worst(field, shape):
    """Every element p - 1, the largest canonical value."""
    top = [((field.p - 1) >> (16 * i)) & 0xFFFF for i in range(field.n16)]
    return torch.tensor(top, dtype=torch.int32).expand(shape + (field.n16,)).contiguous()


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("size", [2, 4, 8, 16])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_butterfly_plain_equals_the_schoolbook_level(name, size, inverse):
    """Shapes (1, S, 5) and (3, S, 1) (B = 1; C = 1), twiddle none, an
    (n16,) scalar and an (S, C) table, random and all-(p - 1) x."""
    field = FIELDS[name]
    rng = np.random.default_rng(1000 * size + 2 * field.n16 + inverse)
    w = dft_matrix(LimbOps(field, "cpu"), size, inverse)
    for bsz, cols in ((1, 5), (3, 1)):
        for x in (_limbs(field, rng, (bsz, size, cols)), _worst(field, (bsz, size, cols))):
            for tw in (None, _limbs(field, rng, ()), _limbs(field, rng, (size, cols))):
                got = K.ntt_level_butterfly_plain(field, x, w, tw)
                assert got.dtype == torch.int32 and got.shape == x.shape
                assert torch.equal(got, K.ntt_level_plain(field, x, w, tw))


@pytest.mark.parametrize("log_n", [6, 7, 8])
@pytest.mark.parametrize("name,inverse", [("F_BLS", False), ("F_P63", True)])
def test_ntt_of_butterfly_levels_equals_hodor_tpu_pease(monkeypatch, name, inverse, log_n):
    """Every level of the port's radix-4 NTT (radix 2 last at log_n = 7)
    through ntt_level_butterfly_plain, against hodor_tpu's Pease levels."""
    field = FIELDS[name]
    assert max_radix(field) == 4
    sizes = []

    def butterfly_level(fld, x, w, tw=None, body=None):
        sizes.append(x.shape[1])
        return K.ntt_level_butterfly_plain(fld, x, w, tw)

    monkeypatch.setattr(K, "ntt_level", butterfly_level)
    # F_BLS from 2^8 points runs the shared-body passes; the radix plan is
    # what these levels assemble
    monkeypatch.setattr(M, "SHARED_MIN_POINTS", 1 << 30)
    random.seed(70 + log_n)
    jops = jfield.ops_for(getattr(jfield, name))
    a = jops.encode([random.randrange(field.p) for _ in range(1 << log_n)])
    want = np.asarray(_ntt_pease(jops, a, log_n, inverse))
    got = ntt(LimbOps(field, "cpu"), from_numpy_limbs(np.asarray(a), "cpu"), inverse)
    assert sizes == [4] * (log_n // 2) + [2] * (log_n % 2)
    assert np.array_equal(to_numpy_limbs(got), want)
