"""The port's measuring and golden entry points on CPU tensors:
hodor_tpu_torch.tools.bench (its flags, its ntt, prove and fri modes) and
hodor_tpu_torch.tools.gen_golden. The NTT is held against hodor_tpu's
ntt_matmul on the same seeded input, the quadratic proof against the
golden vector, the cubic proof by its bytes against both verifiers, the
reference-prover estimate against bench.py's formula on the JAX
package's instance, and the goldens the tool writes against
tests/golden/. Equality is exact."""

import json
import math
import os
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

import hodor_tpu.proof_io as jproof_io
from hodor_tpu.ali.instance import get_mask_from_boundary_constraint, get_masks_from_constraint
from hodor_tpu.arp import ARPInstance as JARPInstance
from hodor_tpu.field import F257 as JF257, F_STARK as JF_STARK, ops_for as jops_for
from hodor_tpu.models import CubicVDF as JCubicVDF, VDF as JVDF
from hodor_tpu.ntt.matmul import ntt_matmul as jntt_matmul
from hodor_tpu.verifier import Verifier as JVerifier
from hodor_tpu_torch.field import F257, F_BLS, F_P63, F_STARK, LimbOps
from hodor_tpu_torch.fri.fri import NaiveFriIop
from hodor_tpu_torch.models import CubicVDF
from hodor_tpu_torch.ntt import matmul as M
from hodor_tpu_torch.ntt import ntt
from hodor_tpu_torch.proof_io import deserialize_proof, serialize_proof
from hodor_tpu_torch.tools import bench, gen_golden, roofline
from hodor_tpu_torch.verifier import Verifier

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CPU = torch.device("cpu")
NTT_CASES = [("F_STARK", 10), ("F257", 5)]
JFIELDS = {"F_STARK": JF_STARK, "F257": JF257}


def _args(*flags):
    return bench.parse_args(["--device", "cpu", *map(str, flags)])


@pytest.mark.parametrize("mode,reps", [("ntt", 50), ("prove", 5), ("fri", 5)])
def test_each_mode_parses_with_its_default_reps(mode, reps):
    args = _args("--mode", mode)
    assert (args.mode, args.reps, args.impl, args.field, args.batch, args.seed) == \
        (mode, reps, "level", "F_STARK", 1, 0)


@pytest.mark.parametrize("impl,ntt_impl", [("level", "level"), ("matmul", "level"),
                                           ("fused", "fused"), ("two_step", "two_step")])
def test_impl_names_the_level_form(impl, ntt_impl):
    assert _args("--impl", impl).impl == ntt_impl


def test_impl_pease_is_not_ported():
    with pytest.raises(ValueError, match="Pease"):
        _args("--impl", "pease")


def test_check_is_bounded_to_small_transforms():
    with pytest.raises(ValueError, match="--check"):
        _args("--check", "--log-n", "13")


@pytest.mark.parametrize("mode,flags", [
    ("prove", ["--field", "F_BLS"]), ("prove", ["--check"]), ("prove", ["--seed", 1]),
    ("prove", ["--log-n", 20]), ("fri", ["--check"]), ("fri", ["--batch", 2]),
    ("fri", ["--log-rows", 5]), ("ntt", ["--log-h1", 8]), ("ntt", ["--workload", "cubic"])])
def test_a_flag_the_mode_does_not_read_is_refused(mode, flags):
    with pytest.raises(ValueError, match=f"--mode {mode} reads no {flags[0]}"):
        _args("--mode", mode, *flags)


@pytest.mark.parametrize("mode,flags,name", [
    ("ntt", ["--field", "F257", "--log-n", 5], "cpu_ntt_2^5_F257_field_muls_per_s_per_chip"),
    ("ntt", ["--field", "F257", "--log-n", 5, "--impl", "fused", "--batch", 2],
     "cpu_ntt_2^5_F257_field_muls_per_s_per_chip_fused_batch2"),
    ("prove", ["--log-rows", 3, "--impl", "two_step"],
     "cpu_quadratic_vdf_2^3_rows_prove_wall_s_two_step"),
    ("prove", ["--log-rows", 3, "--batch", 2, "--impl", "fused"],
     "cpu_quadratic_vdf_2^3_rows_batch2_prove_per_proof_s_fused"),
    ("fri", ["--log-h1", 6, "--impl", "matmul"], "cpu_fri_pair_h1_2^6_ms"),
    ("fri", ["--log-h1", 6, "--field", "F_P63", "--impl", "two_step"],
     "cpu_fri_pair_h1_2^6_ms_F_P63_two_step")])
def test_the_metric_name_says_what_ran(mode, flags, name):
    """Every setting off its default that the mode reads is in the name."""
    line = bench.MODES[mode](_args("--mode", mode, "--reps", 1, *flags), CPU)[0]
    assert line["metric"] == name
    assert line.get("correct", line.get("verified")) is True


@pytest.mark.parametrize("tool,argv", [(bench.main, ["bench", "--mode", "ntt", "--log-n", "4"]),
                                       (gen_golden.main, ["gen_golden", "--out", "unused"])])
def test_without_a_card_the_tool_says_so_and_returns_1(tool, argv, capsys, monkeypatch, tmp_path):
    """No --device cpu and no card: no run on the CPU, no line, rc 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert tool(argv) == 1
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err and "--device cpu" in err
    assert not os.path.exists(tmp_path / "unused")


@lru_cache(maxsize=None)
def _ntt(field, log_n):
    """bench_ntt's (line, transform) at --check --batch 2."""
    return bench.bench_ntt(_args("--field", field, "--log-n", log_n, "--check", "--batch", 2,
                                 "--reps", 1), CPU)


@pytest.mark.parametrize("field,log_n", NTT_CASES)
def test_ntt_mode_prints_one_cpu_line(field, log_n, capsys):
    rc = bench.main(["bench", "--device", "cpu", "--field", field, "--log-n", str(log_n),
                     "--check", "--batch", "2", "--reps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == f"cpu_ntt_2^{log_n}_{field}_field_muls_per_s_per_chip_batch2"
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["correct"] is True and line["checked_against_cpu"] is True
    assert line["vs_sol"] is None and line["unit"] == "field_muls/s"
    assert len(line["samples"]) == bench.WINDOWS
    assert line["min"] <= line["median"] <= line["max"]
    assert line["value"] == pytest.approx(2 * (1 << log_n) // 2 * log_n / line["median"] * 1e3)


@pytest.mark.parametrize("field,log_n", NTT_CASES)
def test_ntt_mode_transform_equals_hodor_tpu(field, log_n):
    """The (2, 2^n) transform bench timed, against hodor_tpu's ntt_matmul
    on the same seeded limbs."""
    line, out = _ntt(field, log_n)
    assert line["correct"] is True
    x = bench.seeded_limbs(bench.field_of(field), (2, 1 << log_n), 0)
    jops = jops_for(JFIELDS[field])
    want = np.asarray(jax.jit(lambda a: jntt_matmul(jops, a))(x.numpy().astype(np.uint32)))
    assert out.shape == x.shape
    np.testing.assert_array_equal(out.numpy().astype(np.uint32), want)


def test_seeded_limbs_are_bench_py_input_and_below_p():
    """bench.py:366-375's limbs at 2^6 over F_STARK; every value below p."""
    rng = np.random.default_rng(0)
    limbs = rng.integers(0, 1 << 16, size=(64, 16), dtype=np.uint32)
    limbs[:, -1] &= (1 << (252 - 16 * 15 - 1)) - 1
    assert np.array_equal(bench.seeded_limbs(F_STARK, (64,), 0).numpy(), limbs.astype(np.int32))
    for field in (F_STARK, F_BLS, F257, F_P63):
        x = bench.seeded_limbs(field, (3, 50), 7).numpy().astype(object)
        vals = sum(x[..., i] << (16 * i) for i in range(field.n16))
        assert (vals < field.p).all()


@pytest.mark.parametrize("field,log_n", NTT_CASES)
def test_ntt_bound_is_the_count_by_hand(field, log_n):
    """2 transforms: one read and one write of (2, N, n16) int32, and
    log2 N radix-2 levels of 2 N outputs at 2·2·(2 n16)^2 int8 operations,
    whatever ran (F_STARK 2^10: one shared-body pass of 1024 points; F257
    2^5: a radix-32 level); both bound by their bytes at these sizes.
    `levels_int8_ms` counts the radix levels that ran, null for the
    shared passes."""
    line = _ntt(field, log_n)[0]
    n, n16, sizes = 1 << log_n, {"F_STARK": 16, "F257": 4}[field], \
        {"F_STARK": [1024], "F257": [32]}[field]
    by_bytes = 1e3 * 2 * 2 * n * n16 * 4 / 3.35e12
    by_ops = 1e3 * 2 * n * log_n * 2 * 2 * (2 * n16) ** 2 / 1979e12
    assert line["level_sizes"] == sizes
    assert line["bound_ms"] == pytest.approx(max(by_bytes, by_ops), rel=1e-12)
    assert line["bound_by"] == "bytes"
    if field == "F_STARK":
        assert line["levels_int8_ms"] is None
    else:
        assert line["levels_int8_ms"] == pytest.approx(
            1e3 * 2 * n * sum(2 * s * (2 * n16) ** 2 for s in sizes) / 1979e12, rel=1e-12)


@pytest.mark.parametrize("field,log_n,want,by", [
    (F_STARK, 20, 0.04340543, "operations"), (F_BLS, 20, 0.04340543, "operations"),
    (F_STARK, 16, 0.002504062, "bytes"), (F_P63, 20, 0.01001625, "bytes"),
    (F257, 8, 0.000002445373, "bytes")])
def test_ntt_bound_does_not_count_the_radix(field, log_n, want, by):
    """F_STARK and F_BLS share a width and so a bound at 2^20, though the
    port runs three radix-128 levels over one and ten radix-4 over the
    other; and the Montgomery products of radix-2 butterflies on the int32
    lanes would take longer than the int8 count at every width."""
    n = 1 << log_n
    bound, bound_by = roofline.ntt_bound_ms(n, field.n16)
    assert bound == pytest.approx(want, rel=1e-6) and bound_by == by
    int8_s = n * log_n * roofline.ops_ntt_level(2, field.n16) / roofline.PEAK_OPS_PER_S["int8"]
    int32_s = n // 2 * log_n * roofline.ops_mont_mul(field.n16) / roofline.PEAK_OPS_PER_S["int32"]
    assert int32_s > 2 * int8_s


@pytest.mark.parametrize("reps", [1, 2, 3, 4, 50])
def test_points_agree_with_the_last_output_of_any_chain(reps):
    """The host check holds at every parity of the chain: N^k x at row i
    or -i, or N^k out."""
    ops = LimbOps(F257, CPU)
    x = bench.seeded_limbs(F257, (2, 32), 3)
    out = last = ntt(ops, x)
    for _ in range(reps - 1):
        last = ntt(ops, last)
    assert bench.points_agree(F257, x, out, last, reps, 0)


def test_points_catch_what_the_round_trip_cannot():
    """A transform that writes its output in bit-reversed order, and an
    inverse that reads it so, give x back; the host points do not agree,
    nor does a chain's last output that is not the chain's."""
    ops = LimbOps(F_STARK, CPU)
    x = bench.seeded_limbs(F_STARK, (64,), 0)
    out = ntt(ops, x)
    rev = torch.tensor([int(f"{i:06b}"[::-1], 2) for i in range(64)])
    assert bench.points_agree(F_STARK, x, out, out, 1, 0)
    assert not bench.points_agree(F_STARK, x, out[rev], out[rev], 1, 0)
    assert not bench.points_agree(F_STARK, x, out, out, 2, 0)


@pytest.mark.parametrize("field,log_n,sizes,impl", [
    (F_STARK, 10, [128, 8], "two_step"), (F_STARK, 7, [128], "level"), (F_STARK, 0, [], "level"),
    (F257, 5, [32], "level"), (F_BLS, 3, [4, 2], "level"), (F_P63, 6, [4, 4, 4], "level")])
def test_level_sizes_are_the_levels_ntt_matmul_runs(field, log_n, sizes, impl, monkeypatch):
    """The radix plan's levels (F_STARK at 2^10 under "level" runs the
    shared-body pass instead, so its levels are asked of "two_step")."""
    seen = []
    level = M.dft_level

    def counting(ops, x, inverse, tw=None):
        seen.append(x.shape[1])
        return level(ops, x, inverse, tw)

    monkeypatch.setattr(M, "dft_level", counting)
    ntt(LimbOps(field, CPU, impl), bench.seeded_limbs(field, (1 << log_n,), 1))
    assert M.level_sizes(field, 1 << log_n) == seen == sizes


def test_level_sizes_at_the_main_path_size():
    assert M.level_sizes(F_STARK, 1 << 20) == [128, 128, 64]
    assert M.level_sizes(F_BLS, 1 << 20) == [4] * 10


@lru_cache(maxsize=None)
def _prove(workload):
    """bench_prove's (line, proofs) at 32 rows, one warm prove."""
    return bench.bench_prove(_args("--mode", "prove", "--log-rows", 5, "--reps", 1,
                                   "--workload", workload), CPU)


@pytest.mark.parametrize("workload", ["quadratic", "cubic"])
def test_prove_mode_verifies(workload):
    line, proofs = _prove(workload)
    assert line["verified"] is True and len(proofs) == 1
    assert line["metric"] == f"cpu_{workload}_vdf_2^5_rows_prove_wall_s"
    assert line["stage_walls_synced"] is True and line["peak_gib"] is None
    assert line["value"] == line["median"] == line["samples"][0]
    assert line["compile_est_s"] == line["cold_prove_s"] - line["value"]


def test_quadratic_proof_is_the_golden_vector():
    """bench.py's instance at 32 rows is the golden's, VDF(F_STARK, 1, 2, 31)."""
    with open(os.path.join(GOLDEN, "vdf_fstark_t32.proof"), "rb") as f:
        assert serialize_proof(_prove("quadratic")[1][0], F_STARK) == f.read()


def test_cubic_proof_is_accepted_by_both_verifiers_from_its_bytes():
    blob = serialize_proof(_prove("cubic")[1][0], F_STARK)
    _, props = CubicVDF(F_STARK, 1, 2, 31).into_arp()
    _, jprops = JCubicVDF(JF_STARK, 1, 2, 31).into_arp()
    assert Verifier(props, lde_factor=16).verify(deserialize_proof(blob, F_STARK))
    assert JVerifier(jprops, lde_factor=16).verify(jproof_io.deserialize_proof(blob, JF_STARK))


@pytest.mark.parametrize("workload,model", [("quadratic", JVDF), ("cubic", JCubicVDF)])
def test_reference_estimate_is_bench_py_formula_on_the_jax_instance(workload, model):
    """bench.py:214-251 evaluated here on hodor_tpu's instance: its routed
    properties, the masks its ALIInstance collects (constraints', then the
    boundary constraints'), its largest constraint degree."""
    _, jprops = model(JF_STARK, 1, 2, 31).into_arp()
    props = JARPInstance.from_instance(jprops).properties
    masks = {}
    for c in props.constraints:
        get_masks_from_constraint(masks, c)
    for bc in props.boundary_constraints:
        get_mask_from_boundary_constraint(masks, bc)
    r, m = props.num_registers, len(masks)
    p = max((c.degree for c in props.constraints), default=1)
    t, lde = 32, 16
    lg_t, d = int(math.log2(t)), t * p
    lg_d, h1, h2 = int(math.log2(d)), t * lde, d * lde
    muls = (r * (t // 2) * lg_t + r * lde * ((t // 2) * lg_t + t)
            + m * p * ((t // 2) * lg_t + t) + 5 * d
            + (d // 2) * lg_d + lde * ((d // 2) * lg_d + d)
            + (2 * m + 3) * h1 + 2 * h2 + 3 * (h1 + h2))
    assert _prove(workload)[0]["reference_estimate_s"] == muls / 6.4e8


def test_prove_mode_batch_of_two_prints_verified_lanes(capsys):
    rc = bench.main(["bench", "--device", "cpu", "--mode", "prove", "--log-rows", "5",
                     "--reps", "1", "--batch", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "cpu_quadratic_vdf_2^5_rows_batch2_prove_per_proof_s"
    assert line["verified"] is True and line["batch"] == 2 and line["device"] == "cpu"
    assert line["value"] == line["median"] / 2


def test_fri_mode_ladders_end_in_constants(capsys):
    rc = bench.main(["bench", "--device", "cpu", "--mode", "fri", "--log-h1", "8",
                     "--reps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "cpu_fri_pair_h1_2^8_ms" and line["correct"] is True
    assert line["device"] == "cpu" and line["unit"] == "ms"


def test_fri_mode_on_random_values_is_not_correct():
    """The fri mode's check, fed seeded random values in place of LDEs:
    no ladder folds them to a constant."""
    vals = [bench.seeded_limbs(F_STARK, (h,), i) for i, h in enumerate((256, 512))]
    protos = NaiveFriIop.proofs_from_ldes(LimbOps(F_STARK, CPU), vals, 16, 1)
    assert [p.initial_degree_plus_one for p in protos] == [16, 32]
    assert [bench.final_layer_constant(p, v) for p, v in zip(protos, vals)] == [False, False]


@pytest.fixture(scope="module")
def goldens_written(tmp_path_factory):
    out = tmp_path_factory.mktemp("golden")
    assert gen_golden.main(["gen_golden", "--device", "cpu", "--out", str(out)]) == 0
    return out


@pytest.mark.parametrize("name", [f"{n}.{ext}" for n in gen_golden.INSTANCES
                                  for ext in ("proof", "challenges.json")])
def test_gen_golden_writes_the_golden_files(goldens_written, name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        want = f.read()
    with open(goldens_written / name, "rb") as f:
        assert f.read() == want
    assert sorted(os.listdir(goldens_written)) == sorted(os.listdir(GOLDEN))
