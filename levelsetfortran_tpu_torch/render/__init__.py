"""Differentiable sphere-traced renderer."""
