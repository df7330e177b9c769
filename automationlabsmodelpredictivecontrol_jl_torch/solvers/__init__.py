"""Solver selection and the in-house solvers."""
