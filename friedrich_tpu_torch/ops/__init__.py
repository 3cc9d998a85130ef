"""Ops: pairwise features, covariance builders, Cholesky, and the CUDA
covariance-tile kernel (``ops/cuda``)."""
