"""The H100's bound on a function: the least time the card could take.

The larger of two times: the bytes the function must move (each input
read once, each output written once) over the card's memory rate, and
the operations it does on its inputs over the card's peak rate for their
type. `chip_smoke.py` holds every kernel case against it, and
`tools/bench.py` every NTT. Counts only: nothing here measures.
"""

from __future__ import annotations

from typing import Iterable, Tuple

# Published peaks of one H100 SXM: device memory 3.35 TB/s; int8 on the
# tensor cores 1,979 TOP/s (a multiply-add is two operations); 32-bit
# integer operations outside the tensor cores at half the float32 lanes
# (64 of 128 per SM and clock), so half of 67 TFLOP/s / 2 per operation.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "int32": 67e12 / 4}

# Least 32-bit integer operations per element of a field of n16 limbs
# (nw = n16 / 2 words), counted from the sources: a Montgomery product is
# 2 nw^2 multiply-adds and a compare-subtract; a modular add or sub two
# nw-word carry chains and a select; the two-step level's reduce folds
# 4 n16 - 1 columns, then a reduction and a three-step chain; a Blake2s
# block 10 rounds of 8 G at 14 operations.
OPS_BLAKE2S = 10 * 8 * 14 + 40


def ops_mont_mul(n16: int) -> int:
    return 2 * (n16 // 2) ** 2 + 3 * (n16 // 2)


def ops_addsub(n16: int) -> int:
    return 3 * (n16 // 2)


def ops_fri_fold(n16: int) -> int:
    """Two products (by the twiddle's two table entries, one of them times
    c), lo - hi, lo + hi, their sum, and the halving, a conditional add of
    p and a shift."""
    return 2 * ops_mont_mul(n16) + 4 * ops_addsub(n16)


def ops_wide_reduce(n16: int) -> int:
    return 4 * (4 * n16 - 1) + (n16 // 2) ** 2 + 9 * (n16 // 2)


def ops_ntt_level(size: int, n16: int = 16) -> int:
    """int8 operations of one level output as a byte-plane contraction on
    the tensor cores: P x P byte products of depth S, a multiply-add two
    operations, P = 2 n16 byte planes. The yardstick of a level whatever
    body computes it: the card's least time for the function is that
    contraction's at the int8 rate or the bytes', whichever is longer."""
    return 2 * size * (2 * n16) ** 2


def bound_ms(moved_bytes: int, n_ops: int, op_kind: str = "int32") -> Tuple[float, str]:
    """(least milliseconds, "bytes" or "operations": which of the two
    sets it) for a function that moves `moved_bytes` and does `n_ops`
    operations of `op_kind`."""
    by_bytes = 1e3 * moved_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * n_ops / PEAK_OPS_PER_S[op_kind]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def ntt_bound_ms(n: int, n16: int, batch: int = 1) -> Tuple[float, str]:
    """The bound of `batch` natural-order NTTs of length n over a field of
    n16 limbs, whatever radices run them: one read and one write of the
    (batch, n, n16) int32 array, and the int8 operations of log2 n radix-2
    levels at the `ops_ntt_level` yardstick. Radix 4 costs the same for
    each factor of two and every larger radix more, so no schedule of
    levels does fewer; the radix-2 butterflies as Montgomery products on
    the int32 lanes, (n/2)·log2 n of `ops_mont_mul`, take longer at every
    width the port has."""
    log_n = n.bit_length() - 1
    moved = 2 * batch * n * n16 * 4
    return bound_ms(moved, batch * n * log_n * ops_ntt_level(2, n16), "int8")


def levels_ms(level_sizes: Iterable[int], n: int, n16: int, batch: int = 1) -> float:
    """A diagnostic, not a bound: the int8 time of the levels of the given
    radices at the `ops_ntt_level` yardstick (each level writes n
    outputs), which holds one level's kernel to the card and counts the
    radix the port picked."""
    ops = batch * n * sum(ops_ntt_level(s, n16) for s in level_sizes)
    return 1e3 * ops / PEAK_OPS_PER_S["int8"]
