"""Proximal maps and projections."""
