"""ALI + DEEP: constraint composition into the quotient polynomial G and
the DEEP out-of-domain part (H1, H2).

Reference: src/ali/mod.rs (mask collection), src/ali/per_register/mod.rs
(ALIInstance: divisor precompute + calculate_g), src/ali/per_register/deep.rs
(calculate_deep).
"""

from .instance import ALIInstance, MaskProperties, get_masks_from_constraint

__all__ = ["ALIInstance", "MaskProperties", "get_masks_from_constraint"]
