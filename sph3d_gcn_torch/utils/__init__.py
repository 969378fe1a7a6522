"""Checkpoint conversion from the JAX package and window calibration."""
