"""Utilities: shapes, devices, JAX-state conversion."""
