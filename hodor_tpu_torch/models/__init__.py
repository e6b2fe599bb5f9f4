"""Workload models: the AIR instances of the reference that the port runs.

- VDF (quadratic Fp2 squaring chain): src/experiments/vdf.rs
- Fibonacci gadget: hodor_tpu_torch.air.Fibonacci
  (src/air/test_trace_system.rs:158-246)
"""

from .vdf import VDF

__all__ = ["VDF"]
