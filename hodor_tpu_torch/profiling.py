"""Per-stage wall times of a prove.

`StageTimer` collects named stage wall times into a structured record.
On a CUDA device every stage boundary synchronizes the device, so each
stage's wall time holds its own device work and nothing of the stages
before it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, List

import torch


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
