"""Precision and device helpers."""
