"""FRI low-degree testing (nu = 1, DEGREE = 2 folding).

Reference: src/fri/mod.rs (trait stack + proof containers),
src/fri/fri_on_values.rs (the by-values prover), src/fri/query_producer.rs,
src/fri/verifier.rs. The by-coefficients prover (used by the reference
only as a test cross-check, src/fri/mod.rs:156-249) is provided too.
"""

from .fri import (
    FRIProof,
    FRIProofPrototype,
    NaiveFriIop,
)

__all__ = ["FRIProof", "FRIProofPrototype", "NaiveFriIop"]
