"""Spans of a prove, and the memory-bounded forms it took.

`SpanRecorder` keeps the spans of one proof in memory, under the id of
that proof: each span a name, a start and an end on the host's
`time.perf_counter_ns` clock and the index of its parent span.
`Prover.last_timings` holds the
record of the last prove. Its stage spans (`stage()`, the prove's five
stages) synchronize the device at their start and end, so a stage's
seconds hold its own device work and nothing of the stages before it.
Every other span (`span()`) is host time and never synchronizes: where it
holds a blocking fetch, it holds the wait for the device too.

Each span also opens a host operation of the same name for torch.profiler
(`torch._C._profiler._RecordFunctionFast`, about a microsecond when no
profiler runs), so that a profiled prove shows its spans on the
profiler's own timeline. A `torch.profiler.record_function` range would
be mirrored onto the device's timeline as well, and read as device work.

`span(name)` records into the recorder of the prove in progress, where
there is one, so the shared helpers (ALI, FRI, Merkle trees, NTT tables)
record their spans whichever prove path calls them.

`form_counts` counts how often each memory-bounded form engaged since
the last `reset_form_counts()`; each form is picked by size against a
module constant of its own module:

  trees_dropped         a tree that kept only its top levels, fewer than
                        2^(⌈log2 N / 2⌉ + 1) digests a lane
                        (merkle/tree.py TREE_DROP_MIN)
  leaves_chunked        leaves hashed in row chunks (merkle/blake2s.py
                        HASH_CHUNK)
  ldes_by_coset         an LDE run one coset at a time (ntt LDE_SEQUENTIAL_MIN)
  deep_tables_not_kept  a DEEP whose domain points were built for the call,
                        chunk by chunk, and not kept (ali/instance.py
                        XS_KEEP_MAX)

`reopen_counts` counts, since the last `reset_reopen_counts()`, what the
openings of dropped trees hashed again (merkle/tree.py
subtree_path_digests), outside FORMS:

  openings              a dropped tree opened (a batch's lanes at once
                        count once)
  leaves_hashed         leaves hashed again: Q 2^k a lane, the 2^k rows
                        under each of its Q indices, k = ⌊log2 N / 2⌋
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import time
from typing import Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

FORMS = ("trees_dropped", "leaves_chunked", "ldes_by_coset", "deep_tables_not_kept")
form_counts: Dict[str, int] = dict.fromkeys(FORMS, 0)


def reset_form_counts() -> None:
    for k in FORMS:
        form_counts[k] = 0


reopen_counts: Dict[str, int] = {"openings": 0, "leaves_hashed": 0}


def reset_reopen_counts() -> None:
    for k in reopen_counts:
        reopen_counts[k] = 0


@dataclasses.dataclass
class Span:
    """One interval of a prove. parent: the index of the enclosing span in
    its record's `spans`, -1 at the top; stage: one of the prove's
    synchronized stages."""

    name: str
    start_ns: int
    end_ns: int
    parent: int = -1
    stage: bool = False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class SpanRecorder:
    """The spans of one proof (a batch's lanes share one), in the order
    they opened, for work on `device`; proof: the proof's id."""

    def __init__(self, device, proof: int = -1):
        self.device = torch.device(device)
        self.proof = proof
        self.spans: List[Span] = []
        self._open = -1  # the innermost open span

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, stage: bool = False):
        """A span inside the innermost open one; a stage synchronizes the
        device before its start and before its end."""
        if stage:
            self._sync()
        parent, self._open = self._open, len(self.spans)
        s = Span(name, 0, 0, parent, stage)
        self.spans.append(s)
        with _RecordFunctionFast(name):
            s.start_ns = time.perf_counter_ns()
            try:
                yield s
            finally:
                if stage:
                    self._sync()
                s.end_ns = time.perf_counter_ns()
                self._open = parent

    def stage(self, name: str):
        return self.span(name, stage=True)

    @contextlib.contextmanager
    def active(self):
        """Module-level `span()` calls record here while this is open."""
        token = _current.set(self)
        try:
            yield self
        finally:
            _current.reset(token)

    @property
    def records(self) -> List[Span]:
        """The stage spans, in order."""
        return [s for s in self.spans if s.stage]

    def paths(self) -> List[str]:
        """Each span's path, "<parent path>/<name>"."""
        out: List[str] = []
        for s in self.spans:
            out.append(s.name if s.parent < 0 else f"{out[s.parent]}/{s.name}")
        return out

    def total(self) -> float:
        """Seconds under the top-level spans."""
        return sum(s.seconds for s in self.spans if s.parent < 0)

    def as_dict(self) -> Dict[str, float]:
        """Seconds by path, a path's spans summed: a stage's key is its
        name, a child's "<parent>/<child>"."""
        out: Dict[str, float] = {}
        for path, s in zip(self.paths(), self.spans):
            out[path] = out.get(path, 0.0) + s.seconds
        return out

    def self_times(self) -> Dict[str, float]:
        """Seconds by path, less the seconds of the path's children."""
        total = self.as_dict()
        out = dict(total)
        for path, seconds in total.items():
            if "/" in path:
                out[path.rsplit("/", 1)[0]] -= seconds
        return out

    def to_json(self) -> str:
        return json.dumps({
            "proof": self.proof,
            "stages": [[r.name, r.seconds] for r in self.records],
            "spans": [[s.name, s.start_ns, s.end_ns, s.parent] for s in self.spans],
            "total_s": self.total(),
        })

    def report(self) -> str:
        """The span tree, a path a line with its spans summed: count,
        milliseconds, and self milliseconds (less its children's)."""
        first: Dict[str, int] = {}
        count: Dict[str, int] = {}
        for i, path in enumerate(self.paths()):
            first.setdefault(path, i)
            count[path] = count.get(path, 0) + 1
        total, own = self.as_dict(), self.self_times()

        def tree_order(path: str):
            parts = path.split("/")
            return tuple(first["/".join(parts[:k])] for k in range(1, len(parts) + 1))

        lines = [f"  {'spans':>6} {'ms':>10} {'self ms':>10}  span"]
        for path in sorted(total, key=tree_order):
            depth = path.count("/")
            lines.append(f"  {count[path]:6d} {total[path] * 1e3:10.2f} {own[path] * 1e3:10.2f}  "
                         f"{'  ' * depth}{path.rsplit('/', 1)[-1]}")
        lines.append(f"  {'':6} {self.total() * 1e3:10.2f} {'':10}  TOTAL")
        return "\n".join(lines)


_current: contextvars.ContextVar[Optional[SpanRecorder]] = contextvars.ContextVar(
    "hodor_span_recorder", default=None)


def span(name: str):
    """A span of the prove in progress (its recorder active), inside its
    innermost open span; nothing outside a prove."""
    recorder = _current.get()
    return contextlib.nullcontext() if recorder is None else recorder.span(name)
