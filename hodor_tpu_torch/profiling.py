"""Per-stage wall times of a prove, and the memory-bounded forms it took.

`StageTimer` collects named stage wall times into a structured record.
On a CUDA device every stage boundary synchronizes the device, so each
stage's wall time holds its own device work and nothing of the stages
before it.

`form_counts` counts how often each memory-bounded form engaged since
the last `reset_form_counts()`; each form is picked by size against a
module constant of its own module:

  trees_dropped         a tree that kept only its root (merkle/tree.py
                        TREE_DROP_MIN)
  leaves_chunked        leaves hashed in row chunks (merkle/blake2s.py
                        HASH_CHUNK)
  ldes_by_coset         an LDE run one coset at a time (ntt LDE_SEQUENTIAL_MIN)
  deep_tables_not_kept  a DEEP whose domain points were built for the call,
                        chunk by chunk, and not kept (ali/instance.py
                        XS_KEEP_MAX)
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, List

import torch

FORMS = ("trees_dropped", "leaves_chunked", "ldes_by_coset", "deep_tables_not_kept")
form_counts: Dict[str, int] = dict.fromkeys(FORMS, 0)


def reset_form_counts() -> None:
    for k in FORMS:
        form_counts[k] = 0


@dataclasses.dataclass
class StageRecord:
    name: str
    seconds: float


class StageTimer:
    """Collects (stage, seconds) pairs for work on `device`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.records: List[StageRecord] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.records.append(StageRecord(name, time.perf_counter() - t0))

    def total(self) -> float:
        return sum(r.seconds for r in self.records)

    def as_dict(self) -> Dict[str, float]:
        """Seconds by stage name, a name's records summed."""
        out: Dict[str, float] = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0.0) + r.seconds
        return out

    def to_json(self) -> str:
        return json.dumps(
            {"stages": [[r.name, r.seconds] for r in self.records], "total_s": self.total()}
        )

    def report(self) -> str:
        lines = [f"  {r.seconds * 1e3:10.1f} ms  {r.name}" for r in self.records]
        lines.append(f"  {self.total() * 1e3:10.1f} ms  TOTAL")
        return "\n".join(lines)
