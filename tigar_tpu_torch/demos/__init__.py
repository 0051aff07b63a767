"""Demos of tigar_tpu_torch (the port's counterparts of ``demos/``),
written as functions that return what the JAX demos print."""
