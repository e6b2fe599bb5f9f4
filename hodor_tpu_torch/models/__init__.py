"""Workload models: the AIR instances of the reference that the port runs.

- VDF (quadratic Fp2 squaring chain): src/experiments/vdf.rs
- CubicVDF (Fp2 cubing chain, 4 registers): src/experiments/cubic_vdf.rs
- Fibonacci gadget: hodor_tpu_torch.air.Fibonacci
  (src/air/test_trace_system.rs:158-246)
"""

from .cubic_vdf import CubicVDF
from .vdf import VDF

__all__ = ["CubicVDF", "VDF"]
