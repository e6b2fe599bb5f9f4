"""The plain reference of the Poseidon chain: Starknet's Hades permutation
(starkware-libs/poseidon `poseidon3`; cairo-lang poseidon_utils.py
hades_permutation) over the Stark prime, width 3, x^3, 4 full, 83 partial
and 4 full rounds, MDS [[3, 1, 1], [1, -1, 1], [1, 1, -2]], one round a
row and permutation after permutation from the state (c0, c1, 2).

10 registers: x0..x2 (the state after the round's constants), a0..a2
(their cubes), k0..k2 (the round's constants), f (1 in a full round);
3 dense degree-3 constraints a_j = x_j^3, 3 dense degree-2 constraints
x_i' - k_i' = sum_j M_ij s_j (s_j = f a_j + (1 - f) x_j for j < 2,
s_2 = a_2), and 6 boundary constraints on x at the first and last row.
The round constants: blake2s of "hodor-poseidon3-rc-<round>-<j>", little
endian, mod p."""

import hashlib

REGISTERS = 10
ROUNDS, HALF_FULL = 91, 4
M = [[3, 1, 1], [1, -1, 1], [1, 1, -2]]
_X, _A, _K, _F = [0, 1, 2], [3, 4, 5], [6, 7, 8], 9

CONSTRAINTS = [[(1, [(_A[j], 0, 1)]), (-1, [(_X[j], 0, 3)])] for j in range(3)] + [
    [(1, [(_X[i], 1, 1)]), (-1, [(_K[i], 1, 1)])]
    + [t for j in range(2) for t in ((-M[i][j], [(_F, 0, 1), (_A[j], 0, 1)]),
                                     (-M[i][j], [(_X[j], 0, 1)]),
                                     (M[i][j], [(_F, 0, 1), (_X[j], 0, 1)]))]
    + [(-M[i][2], [(_A[2], 0, 1)])]
    for i in range(3)]


def round_constants(p: int):
    return [[int.from_bytes(hashlib.blake2s(f"hodor-poseidon3-rc-{r}-{j}".encode()).digest(),
                            "little") % p for j in range(3)] for r in range(ROUNDS)]


def full_round(r: int) -> bool:
    return r < HALF_FULL or r >= ROUNDS - HALF_FULL


def hades_round(p: int, state, rc, full: bool):
    """(x, a, the next state) of one round from `state`."""
    x = [(s + k) % p for s, k in zip(state, rc)]
    a = [pow(v, 3, p) for v in x]
    y = a if full else [x[0], x[1], a[2]]
    return x, a, [sum(m * v for m, v in zip(row, y)) % p for row in M]


def hades(p: int, state):
    """One whole permutation."""
    for r, rc in enumerate(round_constants(p)):
        state = hades_round(p, state, rc, full_round(r))[2]
    return state


def witness(p: int, start, steps: int):
    """The register columns of `steps` rounds from (c0, c1, 2)."""
    rcs = round_constants(p)
    state = [start[0] % p, start[1] % p, 2]
    cols = [[] for _ in range(REGISTERS)]
    for row in range(steps + 1):
        r = row % ROUNDS
        x, a, state = hades_round(p, state, rcs[r], full_round(r))
        for reg, v in zip(_X + _A + _K + [_F], x + a + rcs[r] + [int(full_round(r))]):
            cols[reg].append(v)
    return cols


def boundary(columns, steps: int):
    """(register, row, value): x at the start and the end of the chain."""
    return [(j, 0, columns[j][0]) for j in range(3)] + \
        [(j, steps, columns[j][steps]) for j in range(3)]
