"""Device memory of a prove, stage by stage, on one GPU.

    python -m hodor_tpu_torch.tools.memory_profile LOG_ROWS [LOG_ROWS ...]

For each 2^LOG_ROWS, the quadratic VDF over F_STARK (lde factor 16, FRI
to a constant, the native witness chain): prover set-up, a cold prove
and a warm prove. For every stage of both proves it prints, on the
stage's own line, its wall, `torch.cuda.max_memory_allocated` and
`max_memory_reserved` with the peak statistics reset at the stage's
start, and the bytes still allocated at its end; a line at the start of
every stage gives the bytes allocated there, so a prove that runs out of
memory raises right after the line of the stage it ran out in, and
torch's message names the allocation. After the warm prove: the keys of
the prover's `ops.tables` with their bytes. Prints the card's name and
power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time

import torch

GIB = float(1 << 30)


def gib(nbytes: int) -> str:
    return f"{nbytes / GIB:.3f} GiB"


@contextlib.contextmanager
def stage_peaks(peaks: list, echo=None):
    """While active, every stage of a `profiling.SpanRecorder` resets the
    device's peak memory statistics at its start and appends at its end
    (name, max allocated, max reserved, allocated at the end), in bytes,
    to `peaks`; echo(line), if given, is called at each stage's start and
    end."""
    from hodor_tpu_torch.profiling import SpanRecorder

    plain = SpanRecorder.stage

    @contextlib.contextmanager
    def stage(self, name: str):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if echo is not None:
            echo(f"  stage {name}: start, allocated {gib(torch.cuda.memory_allocated())}")
        with plain(self, name):
            yield
        peaks.append((name, torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved(),
                      torch.cuda.memory_allocated()))
        if echo is not None:
            _, a, r, end = peaks[-1]
            echo(f"  stage {name}: {self.records[-1].seconds:.3f} s, peak allocated {gib(a)}, "
                 f"peak reserved {gib(r)}, allocated at its end {gib(end)}")

    SpanRecorder.stage = stage
    yield peaks
    SpanRecorder.stage = plain


def table_bytes(tables: dict) -> list:
    """(key, bytes) of each entry of an `ops.tables`, largest first; an
    entry may be a tensor or a tuple of them (a PowerTwiddle's int shift
    counts nothing)."""
    def size(v):
        if isinstance(v, torch.Tensor):
            return v.numel() * v.element_size()
        return sum(size(x) for x in v if not isinstance(x, int))

    return sorted(((k, size(v)) for k, v in tables.items()), key=lambda kv: -kv[1])


def log(msg: str) -> None:
    print(msg, flush=True)


def profile_rows(log_rows: int) -> None:
    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.verifier import Verifier

    t0 = time.perf_counter()
    witness, props = VDF(F_STARK, 1, 2, (1 << log_rows) - 1, witness="native").into_arp()
    log(f"2^{log_rows} rows: native witness {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cuda")
    torch.cuda.synchronize()
    log(f"2^{log_rows} rows: set-up {time.perf_counter() - t0:.3f} s, peak allocated "
        f"{gib(torch.cuda.max_memory_allocated())}")
    verifier = Verifier(props, lde_factor=16)
    for run in ("cold", "warm"):
        log(f"2^{log_rows} rows: {run} prove")
        with stage_peaks([], log) as peaks:
            t0 = time.perf_counter()
            proof = prover.prove(witness)
            wall = time.perf_counter() - t0
        top = max(a for _, a, _, _ in peaks)
        top_r = max(r for _, _, r, _ in peaks)
        log(f"2^{log_rows} rows: {run} prove {wall:.3f} s, peak allocated {gib(top)}, "
            f"peak reserved {gib(top_r)}; verified {verifier.verify(proof)}")
        del proof
    for key, nbytes in table_bytes(prover.ops.tables):
        log(f"2^{log_rows} rows: ops.tables {key}: {nbytes} bytes")


def main(argv) -> int:
    if len(argv) < 2 or not all(a.isdigit() for a in argv[1:]):
        print("usage: python -m hodor_tpu_torch.tools.memory_profile LOG_ROWS [LOG_ROWS ...]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("memory_profile: no CUDA device", file=sys.stderr)
        return 1
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.utils.native import build_host_library

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {smi}; torch {torch.__version__}; "
        f"{gib(torch.cuda.get_device_properties(0).total_memory)} on the card")
    K.build_kernels()
    build_host_library()
    for log_rows in map(int, argv[1:]):
        profile_rows(log_rows)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
