"""Workload models: the AIR instances of the reference that the port runs.

- VDF (quadratic Fp2 squaring chain): src/experiments/vdf.rs
- CubicVDF (Fp2 cubing chain, 4 registers): src/experiments/cubic_vdf.rs
- PoseidonChain (Starknet's Hades permutation, width 3, x^3, 8 full and
  83 partial rounds, one round a row, 10 registers, degree-3 constraints):
  models/poseidon.py; no counterpart upstream
- Fibonacci gadget: hodor_tpu_torch.air.Fibonacci
  (src/air/test_trace_system.rs:158-246)

and the host helpers beside them: `fp2` (Fq2 with square roots, the
square-root calculator of src/experiments/square_root_calculator) and
`tensor_lde` (src/experiments/tensor_lde.rs).
"""

from .cubic_vdf import CubicVDF
from .poseidon import PoseidonChain
from .vdf import VDF

__all__ = ["CubicVDF", "PoseidonChain", "VDF"]
