"""Operators of the port (``gpquad/ops``): NUFFT backends, Toeplitz Gram,
CG, dense solve."""
