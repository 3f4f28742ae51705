"""Host-side evaluation helpers (numpy copies of the JAX package's)."""
