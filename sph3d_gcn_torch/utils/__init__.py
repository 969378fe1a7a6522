"""Checkpoint conversion (from the JAX package's Flax trees, and from the
reference's TF1 bundles) and window calibration."""
