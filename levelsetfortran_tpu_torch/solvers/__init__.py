"""Reinitialization, min/max flow and node advection."""
