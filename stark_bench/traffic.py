"""The one generator of traffic: what a traffic file's parameters and a
seed give a run.

A traffic file (traffic/<name>.json) holds:
  log_rows     the trace of every proof has 2^log_rows rows (the chain
               takes 2^log_rows - 1 steps)
  pool         distinct witnesses built at set-up, each from its own
               start values drawn from the seed
  lanes        witnesses a call proves (1: Prover.prove; more:
               Prover.prove_batch of that many)
  trace_calls  calls traced under the profiler after the window
  why          one line: what the mix exercises

One client in a closed loop: call i proves the witnesses (i * lanes + j)
mod pool, j < lanes, so each proof proves another witness than the proof
before it. Every seed gives the same sizes and order; only the start
values, and which witness the judge recomputes, differ.
"""

from __future__ import annotations

import random
from typing import List, Tuple


def steps(traffic: dict) -> int:
    return (1 << traffic["log_rows"]) - 1


def draw(traffic: dict, seed: int, p: int) -> Tuple[List[Tuple[int, int]], int]:
    """(start values (c0, c1) of each witness of the pool, the index of
    the witness whose proofs the judge recomputes)."""
    rng = random.Random(seed)
    starts = [(rng.randrange(1, p), rng.randrange(1, p)) for _ in range(traffic["pool"])]
    return starts, rng.randrange(traffic["pool"])


def call(traffic: dict, i: int) -> List[int]:
    """The witnesses call i proves, one a lane."""
    lanes, pool = traffic["lanes"], traffic["pool"]
    return [(i * lanes + j) % pool for j in range(lanes)]
