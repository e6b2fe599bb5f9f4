"""One rank of a multi-process job: the cross-rank pieces of the prove
pipeline held against this rank's single-device path (the port of
scripts/multihost_worker.py).

    python -m hodor_tpu_torch.tools.multihost_worker --init-method tcp://127.0.0.1:PORT \\
        --world-size 4 --rank K --backend gloo --device cpu

Every rank of the job runs it with its own --rank (and, on a machine with
cards, its own --device); all derive the same inputs from one seed.
Checks, each against the single-device function computed by this rank:

  1. four_step_ntt over the whole job (the transposes between the NTT
     stages are cross-rank all_to_alls, parallel_fft's gather/scatter,
     src/fft/fft.rs:80-124);
  2. sharded_lde (the coset-split LDE, src/polynomials/mod.rs:418-482);
  3. sharded_merkle_root (subtrees, one all_gather of their roots, the
     top levels) against MerkleTree.create's root;
  4. the collective counter, the port's audit of the exchanges:
     four_step_ntt makes 3 all_to_all and no all_gather, sharded_lde one
     all_to_all.

Prints WORKER_OK <rank> and the counts; a failed check raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from hodor_tpu_torch import parallel as par
from hodor_tpu_torch.field import F_P63
from hodor_tpu_torch.field.limbs import LimbOps
from hodor_tpu_torch.merkle.tree import MerkleTree
from hodor_tpu_torch.ntt import lde, ntt
from hodor_tpu_torch.parallel.multihost import (global_mesh, init_multihost, replicated,
                                                root_digest_bytes, row_sharded,
                                                sharded_merkle_root)


def _counted(fn):
    """fn() and the collectives it made: {kind: calls}."""
    before = par.collective_snapshot()
    out = fn()
    return out, {k: v["calls"] for k, v in par.collectives_since(before).items()}


LDE_FACTOR = 16


def run_checks(mesh, device, log_n: int) -> dict:
    """Checks 1-4 on this rank at 2^log_n points (the LDE from 2^log_n
    coefficients by LDE_FACTOR); returns the collective calls of checks 1
    and 2."""
    ops = LimbOps(F_P63, device)
    n = 1 << log_n
    rng = np.random.default_rng(7)  # the same seed on every rank
    host = ops.encode([int(v) for v in rng.integers(0, F_P63.p, size=n, dtype=np.uint64)]).cpu()
    full = host.to(device)

    out, ntt_calls = _counted(lambda: par.four_step_ntt(ops, row_sharded(mesh, host.numpy()),
                                                        mesh))
    if not par.gather_rows(out, mesh).equal(ntt(ops, full)):
        raise AssertionError("four_step_ntt across ranks differs from the local ntt")

    out, lde_calls = _counted(lambda: par.sharded_lde(ops, replicated(mesh, host.numpy()),
                                                      LDE_FACTOR, mesh))
    if not par.gather_rows(out, mesh).equal(lde(ops, full, LDE_FACTOR)):
        raise AssertionError("sharded_lde across ranks differs from the local lde")

    got = root_digest_bytes(sharded_merkle_root(ops, row_sharded(mesh, host.numpy()), mesh))
    want = MerkleTree.create(full, F_P63).get_root()
    if got != want:
        raise AssertionError(f"sharded Merkle root {got.hex()} != {want.hex()}")

    if mesh.size() > 1 and ntt_calls != {"all_to_all": 3, "all_gather": 0}:
        raise AssertionError(f"four_step_ntt made {ntt_calls}, not 3 all_to_all and no "
                             "all_gather")
    if lde_calls != {"all_to_all": 1, "all_gather": 0}:
        raise AssertionError(f"sharded_lde made {lde_calls}, not one all_to_all")
    return {"four_step_ntt": ntt_calls, "sharded_lde": lde_calls}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init-method", required=True, help="tcp://host:port or file:///path")
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda", help="this rank's device, e.g. cuda:0 or cpu")
    ap.add_argument("--log-n", type=int, default=11)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    init_multihost(args.init_method, args.world_size, args.rank, args.backend, args.device)
    try:
        counts = run_checks(global_mesh(args.device), args.device, args.log_n)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"WORKER_OK {args.rank} {json.dumps(counts)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
