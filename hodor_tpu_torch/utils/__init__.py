"""Host-side helpers of the port that are neither field arithmetic nor
protocol: the native witness chains (`native`)."""
