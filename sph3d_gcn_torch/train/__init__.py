"""Training-side protocols (eval voting)."""
