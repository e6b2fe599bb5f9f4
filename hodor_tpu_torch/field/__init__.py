"""Prime-field layer of the port.

- `Field`: per-modulus parameters and exact host scalar ops on Python
  ints (a copy of hodor_tpu/field/field.py);
- `LimbOps`: Montgomery arithmetic over (..., n16) int32 torch tensors
  of 16-bit limbs on one device;
- `kernels`: the hand-written CUDA kernels and their plain versions.
"""

from .field import Field, F257, F_STARK, F_BLS, F_P63
from .limbs import LimbOps, from_numpy_limbs, to_numpy_limbs

__all__ = ["Field", "F257", "F_STARK", "F_BLS", "F_P63", "LimbOps",
           "from_numpy_limbs", "to_numpy_limbs"]
