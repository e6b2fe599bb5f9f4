"""Host-side helpers of the port that are neither field arithmetic nor
protocol: the native host library (`native`: the witness chains and keyed
Blake2s), scalar polynomial helpers (`poly_scalar`) and the reference's
hasher interface (`hashers`)."""
