"""The plain reference against the program on the CPU, at a size a test
run holds: the same proof bytes for both AIRs, and a tampered proof or
the control judged wrong. Also that the reference stands alone."""

import ast
import glob
import os
import random
import subprocess
import sys

import pytest
import torch

from stark_bench import judge
from stark_bench.program import flatten
from stark_bench.reference import stark
from stark_bench.reference.field import PlainField
from stark_bench.reference.hashing import Tree, blake2s_keyed, digest_bytes, hash_messages
from stark_bench.reference.poly import divide_by_linear, domain_generator, ntt
from stark_bench.spec import HERE, ROOT, Spec

P = int("0x800000000000011000000000000000000000000000000000000000000000001", 16)
STEPS = 15  # 16 rows


@pytest.fixture(scope="module")
def field():
    return PlainField(P, 3)


def test_field_arithmetic_matches_python_ints(field):
    rng = random.Random(1)
    xs = [rng.randrange(P) for _ in range(200)] + [0, 1, P - 1]
    ys = [rng.randrange(P) for _ in range(200)] + [P - 1, P - 1, P - 1]
    a, b = field.encode(xs), field.encode(ys)
    assert field.decode(a) == xs
    assert field.decode(field.mul(a, b)) == [x * y % P for x, y in zip(xs, ys)]
    assert field.decode(field.add(a, b)) == [(x + y) % P for x, y in zip(xs, ys)]
    assert field.decode(field.sub(a, b)) == [(x - y) % P for x, y in zip(xs, ys)]
    assert field.decode(field.suffix_sums(a[:, :37])) == [sum(xs[i + 1:37]) % P for i in range(37)]


@pytest.mark.parametrize("n", [2, 16, 64])
def test_ntt_and_division_match_python_ints(field, n):
    rng = random.Random(n)
    cs = [rng.randrange(P) for _ in range(n)]
    w = domain_generator(field, n)
    assert field.decode(ntt(field, field.encode(cs))) == [
        sum(c * pow(w, i * k, P) for i, c in enumerate(cs)) % P for k in range(n)]
    q, value = divide_by_linear(field, field.encode(cs), 99)
    f_at = sum(c * pow(99, i, P) for i, c in enumerate(cs)) % P
    assert field.decode(value) == [f_at]
    qs = field.decode(q)
    # (X - 99) q + f(99) == f, coefficient by coefficient
    assert qs[-1] == 0
    assert all(((qs[i - 1] if i else 0) - 99 * qs[i] + (f_at if i == 0 else 0) - c) % P == 0
               for i, c in enumerate(cs))


def test_blake2s_and_tree_match_hashlib():
    rng = random.Random(2)
    words = torch.tensor([[rng.randrange(1 << 32) for _ in range(64)] for _ in range(16)])
    for nb in (32, 64):
        d = hash_messages(words[:nb // 4], nb)
        for i in range(0, 64, 13):
            raw = b"".join(int(x).to_bytes(4, "little") for x in words[:nb // 4, i])
            assert digest_bytes(d[:, i]) == blake2s_keyed(raw)
    leaves = torch.tensor([[rng.randrange(1 << 31) for _ in range(2048)] for _ in range(8)],
                          dtype=torch.int32)
    tree = Tree(leaves)
    level = [blake2s_keyed(b"".join(int(x).to_bytes(4, "little") for x in leaves[:, i]))
             for i in range(2048)]
    levels = [level]
    while len(level) > 1:
        level = [blake2s_keyed(level[2 * i] + level[2 * i + 1]) for i in range(len(level) // 2)]
        levels.append(level)
    assert tree.root == level[0]
    for idx in (0, 5, 1500, 2047):
        assert tree.opening(idx)[1] == [levels[k][(idx >> k) ^ 1] for k in range(11)]


def _port_proof(model_name, start):
    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch import models
    from hodor_tpu_torch.prover import Prover

    witness, props = getattr(models, model_name)(F_STARK, *start, STEPS, witness="python").into_arp()
    return flatten(Prover(props, 16, 1, device="cpu").prove(witness))


@pytest.mark.parametrize("config", ["quadratic_vdf", "cubic_vdf"])
def test_reference_judges_program_proof_right_and_tampered_wrong(field, config):
    spec = Spec()
    cfg = spec.config(config)
    start = (123456789, 987654321)
    got = _port_proof(cfg["port"]["model"], start)
    want = stark.prove(field, spec.air(config), start, STEPS, cfg["lde_factor"],
                       cfg["fri_final_degree_plus_one"])
    checks = judge.compare(want, [got])
    assert judge.passed(checks) and judge.failed(want, [got]) == 0
    for key, layer in (("f_at_z", "deep_values"), ("h2_final", "fri_final"),
                       ("g_query", "openings")):
        bad = dict(got)
        bad[key] = list(bad[key])
        bad[key][1 if key == "g_query" else 0] = (bad[key][1 if key == "g_query" else 0] + 1) % P
        checks = judge.compare(want, [bad])
        assert not judge.passed(checks) and checks[f"{layer}_mismatched"]["value"] == 1
    other = _port_proof(cfg["port"]["model"], (start[0] + 1, start[1]))
    assert not judge.passed(judge.compare(want, [other]))


def test_control_comes_out_not_correct(tmp_path):
    from stark_bench import control

    spec = _tiny_spec(tmp_path)
    for seed in (1, 2, 3):
        assert not judge.passed(control.readings(spec, "quadratic_vdf.tiny", seed,
                                                 torch.device("cpu")))


def _tiny_spec(tmp_path):
    """A copy of the benchmark with a 16-row traffic mix and a cell of it."""
    import json
    import shutil

    shutil.copytree(HERE, tmp_path / "stark_bench")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "quadratic_vdf.tiny", "config": "quadratic_vdf",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "stark_bench" / "traffic" / "tiny.json").write_text(json.dumps(
        {"log_rows": 4, "pool": 2, "lanes": 1, "trace_calls": 1, "why": "test"}))
    return Spec(str(tmp_path / "BENCHMARK.json"), str(tmp_path / "stark_bench"))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(HERE, "reference", "*.py")) + \
        glob.glob(os.path.join(HERE, "configs", "*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("hodor_tpu_torch", "hodor_tpu", "jax", "jaxlib",
                                              "flax", "stark_bench"), (path, name)
    code = ("import sys; from stark_bench.reference import stark; "
            "from stark_bench.reference.field import PlainField; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'hodor_tpu_torch', 'hodor_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"
