"""Workload models: the AIR instances of the reference that the port runs.

- VDF (quadratic Fp2 squaring chain): src/experiments/vdf.rs
- CubicVDF (Fp2 cubing chain, 4 registers): src/experiments/cubic_vdf.rs
- Fibonacci gadget: hodor_tpu_torch.air.Fibonacci
  (src/air/test_trace_system.rs:158-246)

and the host helpers beside them: `fp2` (Fq2 with square roots, the
square-root calculator of src/experiments/square_root_calculator) and
`tensor_lde` (src/experiments/tensor_lde.rs).
"""

from .cubic_vdf import CubicVDF
from .vdf import VDF

__all__ = ["CubicVDF", "VDF"]
