"""Operators and kernels: condensing, the ADMM operator, the fused K1 path."""
