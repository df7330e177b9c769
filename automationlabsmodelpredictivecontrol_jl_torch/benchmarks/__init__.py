"""Benchmark plants."""
