"""Prover/verifier configuration, a port of hodor_tpu/config.py.

The reference configures everything through Rust generics - the
Prover/Verifier type parameters select field, transcript, IOP hash, FRI
implementation and ARP flavor (src/prover/mod.rs:29,
src/verifier/mod.rs:142) - plus two constructor scalars
(src/prover/mod.rs:46). One dataclass takes the generics' place: the
field travels with `InstanceProperties`, and everything else is named
here. The device is no field of it: `Prover.from_config` takes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

# registries for the generic type parameters' runtime analogs
TRANSCRIPTS = ("blake2s",)  # src/transcript/mod.rs Blake2sTranscript
IOP_HASHES = ("blake2s",)  # src/iop/blake2s_trivial_iop.rs
FRI_IMPLS = ("naive_on_values",)  # src/fri/fri_on_values.rs


@dataclasses.dataclass
class ProofSystemConfig:
    """Everything the reference expressed as generics + scalars.

    mesh: the devices to shard the prover's evaluation-domain axes over.
    The port runs on one device: anything but None raises until the
    multi-device work of ROADMAP.md (Queue 1, item 7) lands.
    """

    lde_factor: int = 16
    fri_final_degree_plus_one: int = 1
    transcript: str = "blake2s"
    iop_hash: str = "blake2s"
    fri_impl: str = "naive_on_values"
    mesh: Optional[Any] = None
    profile: bool = False  # collect StageTimer records on prove()

    def __post_init__(self):
        if self.lde_factor & (self.lde_factor - 1):
            raise ValueError("lde_factor must be a power of two")
        f = self.fri_final_degree_plus_one
        if f < 1 or f & (f - 1):
            raise ValueError("fri_final_degree_plus_one must be a power of two")
        if self.transcript not in TRANSCRIPTS:
            raise ValueError(f"unknown transcript {self.transcript!r}")
        if self.iop_hash not in IOP_HASHES:
            raise ValueError(f"unknown IOP hash {self.iop_hash!r}")
        if self.fri_impl not in FRI_IMPLS:
            raise ValueError(f"unknown FRI impl {self.fri_impl!r}")
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh: the port proves on one device; sharding over several is "
                "ROADMAP.md Queue 1 item 7 (multi-device), not ported yet")
