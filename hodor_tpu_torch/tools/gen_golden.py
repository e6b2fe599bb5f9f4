"""Write the golden conformance vectors from the port's prover.

    python -m hodor_tpu_torch.tools.gen_golden --out DIR [--device cpu] [NAME]

The counterpart of the JAX package's `scripts/gen_golden.py`, with the
same three instances and the same files: for each, `NAME.proof` (the
serialized proof at lde 16, FRI to a constant, verified before it is
written) and `NAME.challenges.json` (the transcript log as
[[kind, str(value)], ...], `json.dump(..., indent=1)`). NAME, one of
INSTANCES, writes that instance alone. `--out` is required: the tool
writes `tests/golden/` only where that directory is named. It runs on
the card unless `--device cpu` is given; with no card it says so and
returns 1. `tests/test_torch_bench.py` and `chip_smoke.py` hold what it
writes against `tests/golden/` byte for byte.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

INSTANCES = ("fib_f257", "vdf_fstark_t32", "cubic_vdf_fstark_t32")
LDE_FACTOR = 16


def instance(name: str):
    """(witness, properties, field) of a golden instance, with the
    arguments of scripts/gen_golden.py."""
    from ..air import Fibonacci, TestTraceSystem
    from ..field import F257, F_STARK
    from ..models import VDF, CubicVDF

    if name == "fib_f257":
        fib = Fibonacci(F257, final_b=5, at_step=3)
        tracer = TestTraceSystem(F257)
        fib.trace(tracer)
        tracer.calculate_witness(1, 1, 3)
        return tracer.into_arp() + (F257,)
    if name == "vdf_fstark_t32":
        return VDF(F_STARK, 1, 2, 31).into_arp() + (F_STARK,)  # T = 32 rows
    if name == "cubic_vdf_fstark_t32":
        return CubicVDF(F_STARK, 1, 1, 31).into_arp() + (F_STARK,)
    raise ValueError(f"no golden instance {name!r}; the instances are {INSTANCES}")


def emit(name: str, out_dir: str, device) -> None:
    """Prove `name` on `device`, verify the proof, write its two files."""
    from ..proof_io import serialize_proof
    from ..prover import Prover
    from ..verifier import Verifier

    witness, props, field = instance(name)
    prover = Prover(props.clone(), lde_factor=LDE_FACTOR, fri_final_degree_plus_one=1,
                    device=device)
    proof = prover.prove(witness)
    if not Verifier(props, lde_factor=LDE_FACTOR).verify(proof):
        raise RuntimeError(f"{name}: the verifier rejects the proof")
    blob = serialize_proof(proof, field)
    log = [[kind, v if isinstance(v, str) else str(v)] for kind, v in prover.last_transcript.log]
    with open(os.path.join(out_dir, f"{name}.proof"), "wb") as f:
        f.write(blob)
    with open(os.path.join(out_dir, f"{name}.challenges.json"), "w") as f:
        json.dump(log, f, indent=1)
    print(f"{name}: {len(blob)} proof bytes, {len(log)} challenges")


def main(argv) -> int:
    """argv[0] is the program's name."""
    ap = argparse.ArgumentParser(prog="python -m hodor_tpu_torch.tools.gen_golden",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("name", nargs="?", choices=INSTANCES, help="one instance (default: all)")
    ap.add_argument("--out", required=True, help="the directory to write the files into")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv[1:])
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("gen_golden: torch sees no CUDA device; pass --device cpu to prove on the CPU",
              file=sys.stderr)
        return 1
    if device.type == "cuda":
        from ..field import kernels as K

        K.build_kernels()
    os.makedirs(args.out, exist_ok=True)
    for name in INSTANCES if args.name is None else (args.name,):
        emit(name, args.out, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
