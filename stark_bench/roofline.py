"""The H100's least time for the work a configuration's protocol calls
for, and the arithmetic of the bound, copied from
hodor_tpu_torch/tools/roofline.py so that the yardstick does not move
with the program. The work is counted from the configuration's sizes,
never from the kernels, radices or forms the program picks."""

from __future__ import annotations

from typing import Tuple

# Published peaks of one H100 SXM: device memory 3.35 TB/s; int8 on the
# tensor cores 1,979 TOP/s (a multiply-add is two operations); 32-bit
# integer operations outside the tensor cores at half the float32 lanes
# (64 of 128 per SM and clock), so half of 67 TFLOP/s / 2 per operation.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "int32": 67e12 / 4}
# a Blake2s block: 10 rounds of 8 G at 14 operations, and the finish
OPS_BLAKE2S = 10 * 8 * 14 + 40
N16 = 16  # 16-bit limbs of an element of the 252-bit field


def ops_ntt_level(size: int, n16: int = N16) -> int:
    """int8 operations of one level output on the tensor cores: P x P byte
    products of depth S, a multiply-add two operations, P = 2 n16 byte
    planes."""
    return 2 * size * (2 * n16) ** 2


def bound_s(moved_bytes: float, n_ops: float, op_kind: str = "int32") -> float:
    return max(moved_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[op_kind])


def ntt_bound_s(n: int, n16: int = N16) -> float:
    """One natural-order transform of length n, whatever radices run it:
    one read and one write of the (n, n16) int32 array, or the int8
    operations of log2 n radix-2 levels, whichever is larger."""
    log_n = n.bit_length() - 1
    return bound_s(2 * n * n16 * 4, n * log_n * ops_ntt_level(2, n16), "int8")


def blake2s_bound_s(leaves: int, nodes: int) -> float:
    """Leaves (32 bytes in, a digest out) and nodes (64 in, one out)."""
    return bound_s(leaves * 64 + nodes * 96, (leaves + nodes) * OPS_BLAKE2S)


def sizes(registers: int, max_degree: int, log_rows: int, lde_factor: int) -> Tuple[int, int, int]:
    """(T rows, D points of the constraints domain, N_f points of the
    trace LDE), each a power of two."""
    t = 1 << log_rows
    d = t * (1 << (max_degree - 1).bit_length())
    return t, d, t * lde_factor


def ntt_work_s(registers: int, max_degree: int, log_rows: int, lde_factor: int) -> float:
    """The transforms a proof needs, each at its bound: each register's
    interpolation (T), its LDE as lde_factor cosets of T
    (upstream's lde_using_multiple_cosets) and its evaluation on the
    constraints domain's coset (D / T cosets of T); G's interpolation (D)
    and its LDE (lde_factor cosets of D)."""
    t, d, _ = sizes(registers, max_degree, log_rows, lde_factor)
    per_register = (1 + lde_factor + d // t) * ntt_bound_s(t)
    return registers * per_register + ntt_bound_s(d) + lde_factor * ntt_bound_s(d)


def merkle_work_s(registers: int, max_degree: int, log_rows: int, lde_factor: int,
                  final_dp1: int) -> float:
    """The Blake2s blocks of every tree a proof commits: one per register
    over the trace LDE, G's over its LDE, and each layer of the FRI
    ladders of h1 (from the trace LDE's size) and h2 (from G's) down to
    lde_factor * final_dp1 values."""
    t, d, n_f = sizes(registers, max_degree, log_rows, lde_factor)
    n_g = d * lde_factor
    leaves = nodes = 0
    for n, count in ((n_f, registers), (n_g, 1)):
        leaves, nodes = leaves + count * n, nodes + count * (n - 1)
    for n in (n_f, n_g):
        while n >= lde_factor * final_dp1:
            leaves, nodes = leaves + n, nodes + n - 1
            n //= 2
    return blake2s_bound_s(leaves, nodes)
