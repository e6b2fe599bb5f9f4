"""Error taxonomy mirroring the reference's error enums.

Reference: SynthesisError at src/lib.rs:40-62 (Error / Unsatisfied /
InvalidValue / DivisionByZero) and TracingError at src/air/mod.rs:125-145.
"""


class SynthesisError(Exception):
    """General synthesis error (reference src/lib.rs:41)."""


class UnsatisfiedError(SynthesisError):
    """Unsatisfied constraint (reference src/lib.rs:43)."""


class InvalidValueError(SynthesisError):
    """Invalid parameter value (reference src/lib.rs:44)."""


class DivisionByZeroError(SynthesisError):
    """Division by zero (reference src/lib.rs:45)."""


class TracingError(Exception):
    """AIR tracing error (reference src/air/mod.rs:125-131)."""
