"""The control of `correct`: the plain reference put in the program's
place with one guarantee of the configuration broken, judged as a run
judges the program's proofs. It has to come out as not correct.

    python -m stark_bench.control --workload <cell> --seed <n> [--seed <n> ...]

The guarantee broken is the configuration's FRI to a constant
(fri_final_degree_plus_one): the control's ladder stops one fold early,
so it commits one tree less and ends in twice the coefficients, the step
a change that wants fewer rounds would take. For each seed it prints the
numbers compared with their limits and whether the control passed;
exits 0 when it failed on every seed. Runs on the card where there is
one, else on the CPU (small traffic only). The benchmark's own runs do
not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from stark_bench import judge, traffic as gen
from stark_bench.reference import stark
from stark_bench.reference.field import PlainField
from stark_bench.spec import Spec


def readings(spec: Spec, workload: str, seed: int, device) -> dict:
    """The numbers compared when the control's proof of the judged
    witness stands in for the program's."""
    cell = spec.cell(workload)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    air = spec.air(cell["config"])
    p = int(config["field"]["p"], 16)
    starts, judged = gen.draw(mix, seed, p)
    F = PlainField(p, config["field"]["generator"], device)
    final = config["fri_final_degree_plus_one"]
    args = (F, air, starts[judged], gen.steps(mix), config["lde_factor"])
    honest = stark.prove(*args, final)
    broken = stark.prove(*args, 2 * final)
    return judge.compare(honest, [broken])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m stark_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    spec = Spec()
    all_failed = True
    for seed in args.seed:
        checks = readings(spec, args.workload, seed, device)
        ok = judge.passed(checks)
        all_failed = all_failed and not ok
        print(json.dumps({"workload": args.workload, "seed": seed, "control_correct": ok,
                          "compared": checks}), flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
