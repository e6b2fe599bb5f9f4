"""The plain reference of the cubic VDF (matter-labs/hodor
src/experiments/cubic_vdf.rs:13-265): a cubing chain in Fp2 =
F[x]/(x^2 - r), r = -1, through the square: 4 registers (c0, c1, sq0,
sq1), 4 dense degree-2 constraints and 4 boundary constraints."""

REGISTERS = 4
# sq0 = c0^2 + r c1^2, sq1 = 2 c0 c1, c0' = c0 sq0 + r c1 sq1,
# c1' = c0 sq1 + c1 sq0; terms in the order the upstream builder adds them
CONSTRAINTS = [
    [(-1, [(0, 0, 2)]), (1, [(1, 0, 2)]), (1, [(2, 0, 1)])],
    [(-2, [(0, 0, 1), (1, 0, 1)]), (1, [(3, 0, 1)])],
    [(-1, [(0, 0, 1), (2, 0, 1)]), (1, [(1, 0, 1), (3, 0, 1)]), (1, [(0, 1, 1)])],
    [(-1, [(0, 0, 1), (3, 0, 1)]), (-1, [(1, 0, 1), (2, 0, 1)]), (1, [(1, 1, 1)])],
]


def witness(p: int, start, steps: int):
    """The register columns of `steps` cubings from start = (c0, c1): each
    row holds the element and its square."""
    v0, v1 = start[0] % p, start[1] % p
    cols = [[], [], [], []]
    for _ in range(steps + 1):
        s0, s1 = (v0 * v0 - v1 * v1) % p, 2 * v0 * v1 % p
        for col, v in zip(cols, (v0, v1, s0, s1)):
            col.append(v)
        v0, v1 = (s0 * v0 - s1 * v1) % p, (s0 * v1 + s1 * v0) % p
    return cols


def boundary(columns, steps: int):
    """(register, row, value): the start and the end of the chain."""
    return [(0, 0, columns[0][0]), (1, 0, columns[1][0]),
            (0, steps, columns[0][steps]), (1, steps, columns[1][steps])]
