"""Point-cloud operators: locality sort, FPS, the dense windowed query,
conv and pool, and the classic ops of the global conv."""
