"""Multi-rank dry runs of the port (the port of __graft_entry__.py's
dryrun_multichip and dryrun_multihost) and the launcher they share.

    python -m hodor_tpu_torch.tools.dryrun multichip 4 [--device cpu]
    python -m hodor_tpu_torch.tools.dryrun multihost 2 2 [--device cpu]

- `dryrun_multichip(n)`: a whole prove over an n-rank mesh (F_P63, a
  16-row VDF, lde max(n, 8)), every rank's proof the same and verified;
- `dryrun_multihost(n_processes, ranks_per_process)`: n_processes hosts
  of ranks_per_process ranks each, every rank a process of its own
  running tools/multihost_worker.py (the cross-rank NTT, LDE and Merkle
  root against the single-device path, and the collective counts);
- `run_ranks`: spawns the ranks of one job on this machine and returns
  what each rank's function returned.

Both dry runs default to the card (`device="cuda"`: rank r on card
r mod the card count, ranks sharing a card where there are more ranks
than cards) over gloo; `backend="nccl"` needs a card per rank. The CPU
(`device="cpu"`) takes gloo.
"""

from __future__ import annotations

import os
import queue as queue_mod
import socket
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_tcp_address() -> str:
    """tcp://127.0.0.1:<a free port> for a job on this machine."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def rank_device(device: str, rank: int):
    """This rank's device: "cpu", or for "cuda" card rank mod the card
    count (ranks share a card where there are more of them)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _rank_main(target, rank, world, init_method, backend, device, args, results):
    import torch
    import torch.distributed as dist

    from ..parallel import make_mesh
    from ..parallel.multihost import init_multihost

    try:
        dev = rank_device(device, rank)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        if backend == "gloo":
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # ranks of one machine
        init_multihost(init_method, world, rank, backend, dev)
        try:
            out = target(make_mesh(world, dev), dev, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def run_ranks(target, world: int, args=(), *, device="cuda", backend="gloo",
              init_method=None, timeout: float = 600.0):
    """Run target(mesh, device, *args) on `world` ranks, each a spawned
    process joined by torch.distributed, and return the ranks' results in
    rank order. target must be importable by name (a module-level
    function); its result is pickled back. init_method defaults to a free
    localhost port. Raises if a rank fails or the job outlasts `timeout`
    seconds; every rank is stopped before it returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = init_method or free_tcp_address()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, init_method, backend, device, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < world:
            try:
                rank, err, out = results.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue_mod.Empty:
                break
            if err is None:
                got[rank] = out
            else:
                errors[rank] = err
            if errors or time.monotonic() > deadline:
                break
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()) if not errors else 5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(f"rank {r}:\n{e}"
                                                         for r, e in sorted(errors.items())))
    if len(got) < world:
        raise RuntimeError(f"ranks {sorted(set(range(world)) - set(got))} gave no result within "
                           f"{timeout} s (exit codes {[p.exitcode for p in procs]})")
    return [got[r] for r in range(world)]


def _vdf_instance(field, log_rows):
    from ..models import VDF

    return VDF(field, start_c0=1, start_c1=2, num_operations=(1 << log_rows) - 1).into_arp()


def _multichip_rank(mesh, device, lde_factor):
    from ..field import F_P63
    from ..proof_io import serialize_proof
    from ..prover import Prover

    witness, props = _vdf_instance(F_P63, 4)
    prover = Prover(props, lde_factor=lde_factor, fri_final_degree_plus_one=1, device=device,
                    mesh=mesh)
    return serialize_proof(prover.prove(witness), F_P63)


def dryrun_multichip(n_devices: int, device="cuda", backend: str = "gloo") -> None:
    """A whole prove (witness iNTT, sharded f-LDEs and oracles, G and its
    oracle, DEEP, FRI for h1 and h2, queries) over an n-rank mesh on tiny
    shapes: F_P63, 16 rows, lde max(n, 8). Every rank's proof must be the
    same and verify."""
    from ..field import F_P63
    from ..proof_io import deserialize_proof
    from ..verifier import Verifier

    lde_factor = max(n_devices, 8)
    blobs = run_ranks(_multichip_rank, n_devices, (lde_factor,), device=device, backend=backend)
    if any(b != blobs[0] for b in blobs):
        raise AssertionError("the ranks' proofs differ")
    _, props = _vdf_instance(F_P63, 4)
    proof = deserialize_proof(blobs[0], F_P63)
    if not Verifier(props, lde_factor=lde_factor).verify(proof):
        raise AssertionError("multichip proof failed to verify")
    print(f"dryrun_multichip OK on {n_devices} ranks ({device}, {backend}): one proof on every "
          f"rank, verified, {len(proof.fri_proof_h1.queries)} h1 FRI queries")


def dryrun_multihost(n_processes: int = 2, ranks_per_process: int = 4, device="cuda",
                     backend: str = "gloo") -> None:
    """n_processes hosts of ranks_per_process ranks each, every rank a
    process of its own started from the command line (as a scheduler
    starts them) running tools/multihost_worker.py: the four-step NTT
    with cross-rank all_to_alls, the coset-split LDE and the sharded
    Merkle root bit-equal to the single-device path, and the collective
    counts. Rank r is host r // ranks_per_process; on cards, local rank
    r mod ranks_per_process takes card (local rank) mod the card count."""
    world = n_processes * ranks_per_process
    init = free_tcp_address()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    if backend == "gloo":
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    for r in range(world):
        dev = str(rank_device(device, r % ranks_per_process))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "hodor_tpu_torch.tools.multihost_worker", "--init-method",
             init, "--world-size", str(world), "--rank", str(r), "--backend", backend,
             "--device", dev],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + 600.0
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    rcs = [p.returncode for p in procs]
    if any(rcs) or not all(f"WORKER_OK {r} " in out for r, out in enumerate(outs)):
        raise AssertionError(f"multihost workers failed: exit codes {rcs}\n" + "\n".join(outs))
    print(f"dryrun_multihost OK: {n_processes} hosts x {ranks_per_process} ranks ({device}, "
          f"{backend}): NTT, LDE and Merkle root bit-equal, collective counts as audited")
    print(outs[0].strip().splitlines()[-1])


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="multi-rank dry runs of the port")
    ap.add_argument("which", choices=("multichip", "multihost"))
    ap.add_argument("sizes", type=int, nargs="+",
                    help="multichip: N ranks; multihost: N processes, ranks per process")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if args.which == "multichip":
        dryrun_multichip(args.sizes[0], args.device, args.backend)
    else:
        dryrun_multihost(*args.sizes[:2], device=args.device, backend=args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
