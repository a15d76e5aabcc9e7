"""Cartesian grid geometry."""
