"""The shared body of ntt_level and the plan of passes around it, on CPU
tensors.

`ntt_level_shared_plain` (log2 S radix-2 decimation-in-frequency stages
on canonical values, roots read from the packed table, natural order out,
then the twiddle), reached through the `ntt_level_shared` wrapper and
written into strided `out=` views, against the schoolbook level
`ntt_level_plain` at S = 2, 8 and 64 over F_STARK and F_BLS, both
directions: no twiddle, an (n16,) scalar, and the four-step power
twiddle, held against the (n1, n2) table of `level_twiddles`; random and
all-(p - 1) inputs. Then the whole plan (`ntt/matmul.py _ntt_shared`, one
pass and two) at 2^4 to 2^12 points, forward and inverse with 1/N, into a
strided `out=`, against hodor_tpu's Pease NTT; `ntt` and `intt` take it
from 2^8 points on. Tolerance 0: every output is a canonical limb array.
"""

import random

import numpy as np
import pytest
import torch

import hodor_tpu.field as jfield
from hodor_tpu.ntt import _ntt_pease
from hodor_tpu_torch.field import F_BLS, F_STARK, LimbOps, from_numpy_limbs
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.ntt import intt, ntt
from hodor_tpu_torch.ntt import matmul as M

torch.set_num_threads(1)

FIELDS = {"F_STARK": F_STARK, "F_BLS": F_BLS}


def _limbs(field, rng, shape):
    limbs = rng.integers(0, 1 << 16, size=shape + (field.n16,), dtype=np.uint32)
    limbs[..., -1] &= (1 << (field.num_bits - 1 - 16 * (field.n16 - 1))) - 1
    return from_numpy_limbs(limbs, "cpu")


def _worst(field, shape):
    top = [((field.p - 1) >> (16 * i)) & 0xFFFF for i in range(field.n16)]
    return torch.tensor(top, dtype=torch.int32).expand(shape + (field.n16,)).contiguous()


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("tw_kind", ["none", "scalar", "power"])
@pytest.mark.parametrize("size", [2, 8, 64])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_shared_pass_equals_the_schoolbook_level(name, size, tw_kind, inverse):
    """(2, S, 3) inputs; the power twiddle of N = 4 S against the first
    three columns of the (S, 4) table of `level_twiddles`; the output
    written into every other column of a wider tensor."""
    field = FIELDS[name]
    ops = LimbOps(field, "cpu")
    rng = np.random.default_rng(100 * size + 10 * field.n16 + inverse)
    w = M.dft_matrix(ops, size, inverse)
    if tw_kind == "none":
        tw = want_tw = None
    elif tw_kind == "scalar":
        tw = want_tw = _limbs(field, rng, ())
    else:
        tw = M.power_twiddles(ops, 4 * size, inverse)
        want_tw = M.level_twiddles(ops, 4 * size, size, inverse)[:, :3].contiguous()
    for x in (_limbs(field, rng, (2, size, 3)), _worst(field, (2, size, 3))):
        want = K.ntt_level_plain(field, x, w, want_tw)
        wide = torch.zeros((2, size, 3, 2, field.n16), dtype=torch.int32)
        got = K.ntt_level_shared(field, x, M.pass_roots(ops, size, inverse), tw,
                                 out=wide[:, :, :, 1])
        assert got.data_ptr() == wide[:, :, :, 1].data_ptr()
        assert torch.equal(got, want)
        assert not wide[:, :, :, 0].any()


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("log_n", range(4, 13))
def test_shared_plan_equals_hodor_tpu_pease(log_n, inverse):
    """Two F_STARK rows of 2^log_n points: one pass, and two passes of
    2^(log_n // 2) and the rest, into rows at stride 2 of a wider tensor;
    the inverse with the 1/N scale against Pease's times 1/N."""
    n = 1 << log_n
    ops = LimbOps(F_STARK, "cpu")
    random.seed(180 + log_n)
    jops = jfield.ops_for(jfield.F_STARK)
    a = jops.encode([random.randrange(F_STARK.p) for _ in range(2 * n)]).reshape(2, n, -1)
    want = from_numpy_limbs(np.asarray(_ntt_pease(jops, a, log_n, inverse)), "cpu")
    scale = ops.const(F_STARK.inv(n)) if inverse else None
    if inverse:
        want = K.mont_mul_plain(F_STARK, want, scale)
    x = from_numpy_limbs(np.asarray(a), "cpu")
    for passes in ((n,), (1 << log_n // 2, n >> log_n // 2)):
        wide = torch.zeros((2, n, 2, F_STARK.n16), dtype=torch.int32)
        got = M._ntt_shared(ops, x, inverse, scale, wide[:, :, 1], passes)
        assert torch.equal(got, want) and torch.equal(wide[:, :, 1], want)
        assert not wide[:, :, 0].any()
    assert M.shared_passes(ops, n) == ((n,) if n >= M.SHARED_MIN_POINTS else None)
    assert torch.equal(intt(ops, x) if inverse else ntt(ops, x), want)


def test_table_bytes_counts_the_shared_plan_tables():
    """tools/memory_profile.py table_bytes over the tables of a 2^13-point
    transform: two passes' roots and the power twiddle's two tables (its
    int shift counts nothing)."""
    from hodor_tpu_torch.tools.memory_profile import table_bytes

    ops = LimbOps(F_STARK, "cpu")
    ntt(ops, torch.zeros((1, 1 << 13, F_STARK.n16), dtype=torch.int32))
    assert dict(table_bytes(ops.tables)) == {
        ("roots", 64, False): 32 * 32, ("roots", 128, False): 64 * 32,
        ("power_twiddle", 1 << 13, False): (128 + 64) * 32}
