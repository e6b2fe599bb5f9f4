"""Prove checkpoint/resume, a port of hodor_tpu/checkpoint.py with the
same stages, file layout and array names.

The prover's Fiat-Shamir stage boundaries (src/prover/mod.rs:82-127 -
witness/f-oracles, G, DEEP, FRI) are the natural checkpoints, because
each is already a host sync. After each completed stage
`Prover.prove(..., checkpoint_dir=...)` writes that stage's arrays plus a
transcript snapshot; a re-run with the same directory loads the
completed stages, restores the transcript byte stream, and continues
where the prove died. Limb arrays are stored as the JAX package stores
them, (..., n16) uint32 (field/limbs.py to_numpy_limbs), so a directory
written by either package resumes in the other. A checkpoint never
stores hash trees: on resume the port rebuilds each oracle from its
saved values and checks the rebuilt root against the saved one. The
resumed proof is byte-identical to an uninterrupted prove
(tests/test_torch_checkpoint.py).

Under a mesh (Prover(mesh=...)) the files are the same whole arrays:
rank 0 writes them, and a resume gives each rank its rows.

Layout: <dir>/<stage>.npz (arrays) + <dir>/<stage>.json (scalars +
transcript snapshot; written LAST, so its presence marks the stage
complete - a crash mid-write never yields a loadable half stage).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

STAGES = ("stage1", "stage_g", "deep", "fri")


class ProveCheckpoint:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _paths(self, stage: str) -> Tuple[str, str]:
        return (
            os.path.join(self.dir, f"{stage}.npz"),
            os.path.join(self.dir, f"{stage}.json"),
        )

    def has(self, stage: str) -> bool:
        npz, meta = self._paths(stage)
        return os.path.exists(meta) and os.path.exists(npz)

    def completed_prefix(self) -> List[str]:
        """Longest prefix of STAGES that is fully saved (a later stage
        without its predecessors is ignored — resume needs them all)."""
        done = []
        for s in STAGES:
            if not self.has(s):
                break
            done.append(s)
        return done

    def save(self, stage: str, arrays: Dict[str, np.ndarray], meta: dict) -> None:
        npz, meta_path = self._paths(stage)
        tmp = npz + ".tmp.npz"
        np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
        os.replace(tmp, npz)
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, meta_path)

    def load(self, stage: str) -> Tuple[dict, dict]:
        npz, meta_path = self._paths(stage)
        with open(meta_path) as f:
            meta = json.load(f)
        data = np.load(npz)
        return {k: data[k] for k in data.files}, meta

    def clear(self) -> None:
        """Delete every saved stage (the next prove starts afresh)."""
        for s in STAGES:
            for p in self._paths(s):
                if os.path.exists(p):
                    os.remove(p)
