"""hodor_tpu_torch: the PyTorch/CUDA port of hodor_tpu.

The same zkSTARK pipeline (AIR -> ARP -> DEEP-ALI -> FRI -> Blake2s IOP)
on torch tensors, with the JAX package's TPU kernels replaced by CUDA
kernels written for Hopper (field/kernels.py, csrc/). Field arrays are
(..., n16) int32 tensors of 16-bit Montgomery limbs; a CPU tensor runs
the kernels' plain PyTorch versions, a CUDA tensor the kernels.
"""

from .errors import SynthesisError, TracingError

__version__ = "0.1.0"
