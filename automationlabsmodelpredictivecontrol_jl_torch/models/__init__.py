"""Learned-dynamics model zoo."""
