"""The plain reference of the quadratic VDF (matter-labs/hodor
src/experiments/vdf.rs:12-131): a squaring chain in Fp2 = F[x]/(x^2 - r),
r = -1, of (c0, c1) -> (c0^2 + r c1^2, 2 c0 c1), as 2 registers, 2 dense
degree-2 constraints and 4 boundary constraints."""

REGISTERS = 2
# c0' - c0^2 - r c1^2 = 0 and c1' - 2 c0 c1 = 0, terms in the order the
# upstream builder adds them; (coeff, [(register, step, power), ...])
CONSTRAINTS = [
    [(-1, [(0, 0, 2)]), (1, [(1, 0, 2)]), (1, [(0, 1, 1)])],
    [(-2, [(0, 0, 1), (1, 0, 1)]), (1, [(1, 1, 1)])],
]


def witness(p: int, start, steps: int):
    """The register columns of `steps` squarings from start = (c0, c1)."""
    v0, v1 = start[0] % p, start[1] % p
    c0, c1 = [v0], [v1]
    for _ in range(steps):
        v0, v1 = (v0 * v0 - v1 * v1) % p, 2 * v0 * v1 % p
        c0.append(v0)
        c1.append(v1)
    return [c0, c1]


def boundary(columns, steps: int):
    """(register, row, value): the start and the end of the chain."""
    return [(0, 0, columns[0][0]), (1, 0, columns[1][0]),
            (0, steps, columns[0][steps]), (1, steps, columns[1][steps])]
